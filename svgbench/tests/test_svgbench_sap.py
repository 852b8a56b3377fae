"""The SAP cell (families/wan_sap.py) at a tiny size on the CPU: a whole run
comes out correct; with each of svgbench/faults_sap.py's faults planted, or
the control in the program's place, it does not; the SAP work counts equal
hand counts and the program's own counters; the SAP readers read what they
should; and reference/sap.py imports nothing of the port."""

import copy
import os
import subprocess
import sys

import pytest
import torch

from svgbench import control, faults, faults_sap, flops_sap
from svgbench import run as R
from svgbench.families import wan_sap
from svgbench.reference import sap as RS
from svgbench.spec import ROOT, Benchmark, Cell
from svgbench.trace import Op, TraceView

CELL = "wan14b-720p-sap"
# Wan 14B's ratios: head dim 128, FFN 2.7 x d; token grid (5, 8, 16), S = 640
TINY_MODEL = dict(dim=256, ffn_dim=704, num_heads=2, num_layers=2, text_len=16, text_dim=64, freq_dim=32)
TINY_GEN = dict(height=128, width=256, num_frames=17)
TINY_SAP = dict(num_q_centroids=4, num_k_centroids=12, block_q=16, block_kv=128)
SEED = 2**31 + 11


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny():
    b = Benchmark()
    c = b.cell(CELL)
    cfg = copy.deepcopy(c.config)
    cfg["model"].update(TINY_MODEL)
    cfg["generation"].update(TINY_GEN)
    return b, Cell(c.name, 1, cfg, dict(c.traffic, **TINY_SAP), c.cell)


def run(trace=False):
    b, cell = tiny()
    return R.run_cell(b, cell, seed=SEED, seconds=0.3, trace=trace, device="cpu", t_start=0.0)


@pytest.fixture(scope="module")
def sound():
    return run()


def test_sound_run_is_correct(sound):
    assert sound["correct"], sound["checks"]
    assert set(sound["checks"]) == {"update_rel_l2", "attn_rows_rel", "sap_label_gap", "sap_map_gap"}
    assert 0 < sound["numbers"]["sap_density"] < 1
    assert sound["attempted"] >= 1 and set(sound["metrics"]) == {"step_s", "peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault", sorted(faults_sap.FAULTS))
def test_sap_fault_is_caught(fault, monkeypatch):
    faults_sap.FAULTS[fault](monkeypatch.setattr)
    out = run()
    assert not out["correct"], out["checks"]


def test_shuffled_labels_and_the_floor_map_are_caught_by_their_gaps(monkeypatch, sound):
    with monkeypatch.context() as m:
        faults_sap.labels_shuffled(m.setattr)
        out = run()["checks"]
    assert out["sap_label_gap"]["value"] > out["sap_label_gap"]["limit"]
    with monkeypatch.context() as m:
        faults_sap.map_floor(m.setattr)
        out = run()["checks"]
    assert out["sap_map_gap"]["value"] > out["sap_map_gap"]["limit"] > sound["checks"]["sap_map_gap"]["value"]


def test_step_that_returns_its_state_unchanged_is_caught(monkeypatch):
    faults.state_unchanged(monkeypatch.setattr)
    assert run()["checks"]["update_rel_l2"]["value"] > 0.99


def test_control_reads_not_correct(sound):
    b, cell = tiny()
    for seed in (1, 2, 3):
        r = control.readings(b, cell, seed, "cpu")
        assert not r["passes_limits"], r
        assert r["numbers"]["attn_rows_rel"] > 3 * sound["checks"]["attn_rows_rel"]["value"]


def test_parent_without_the_carry_fails_at_once(monkeypatch):
    from sparse_videogen_tpu_torch.sparse import svg2

    monkeypatch.setattr(svg2, "sap_sparse_attention", lambda q, k, v, state, **kw: None)
    with pytest.raises(RuntimeError, match="records no decisions"):
        wan_sap.check_port()


def test_sap_counts_equal_hand_counts():
    b, cell = tiny()
    c = wan_sap.model_cfg(cell.config)
    lay = wan_sap.layout(c)
    S, d, H, D, L = 640, 256, 2, 128, 2
    assert lay.seq == S
    got = wan_sap.counts(c, cell.traffic, {"sap.pairs": 3e5, "sap.lloyd.4": 16, "sap.lloyd.12": 16}, 2)
    assert got["attn_flops"] == 4 * D * 1.5e5
    assert got["attn_bytes"] == 4 * 2 * 2 * H * S * D * L
    linear = 2 * 2 * (S * (16 * 4 * d + L * (6 * d * d + 2 * d * 704) + d * 4 * 16)
                      + 16 * (64 * d + d * d + L * 2 * d * d) + (32 * d + d * d + 6 * d * d))
    assert got["flops"] == linear + 4 * D * 1.5e5 + 4 * D * H * 2 * L * S * 16
    fl = lambda k: 2 * S * k * D * H
    by = lambda k: H * (S * D * 2 + k * D * 2 + 4 * S + 4 * k * D + 4 * k)
    assert sorted(got["kmeans"]) == sorted([[8.0, fl(4), by(4)], [8.0, fl(12), by(12)]])
    assert flops_sap.kmeans_pass(S, 12, D, H) == (fl(12), by(12))
    assert wan_sap.counts(c, cell.traffic)["attn_flops"] == 0 and wan_sap.counts(c, cell.traffic)["kmeans"] == []


def test_counts_of_a_traced_run_are_the_recorded_maps_pairs(monkeypatch):
    """sap.pairs over a traced window is the recorded maps' pairs (the step's
    sizes times the map), and every step runs kmeans_iter_step passes a side
    a layer-stream."""
    from sparse_videogen_tpu_torch.utils import timer

    kept = {}
    orig = wan_sap.Run.captured

    def captured(self):
        out = orig(self)
        kept.update(out=out, steps=self.steps, counters=timer.counted_log())
        return out

    monkeypatch.setattr(wan_sap.Run, "captured", captured)
    out = run(trace=True)
    assert out["correct"] and set(out["metrics"]) == {"step_mfu"}  # no device: the host-clock metric only
    steps, ctr = kept["steps"], kept["counters"]
    assert ctr["sap.lloyd.4"] == ctr["sap.lloyd.12"] == steps * 2 * TINY_MODEL["num_layers"] * 2
    if steps == 1:
        pairs = sum(float(torch.einsum("hq,hqk,hk->", d["qsz"].double(), d["dyn"].double(), d["ksz"].double()))
                    for rec in kept["out"]["decisions"] for d in rec.values())
        assert ctr["sap.pairs"] == pairs


def view(counts, ops):
    b = Benchmark()
    return TraceView(ops=ops, steps=2, step_s=1.0, counts=counts, kernel_map=b.kernel_map(),
                     peaks={"bf16_flops": 1e12, "hbm_bytes_s": 1e11})


def reader(name):
    b = Benchmark()
    return b.reader(next(m for m in b.per_layer if m.name == name))


def test_kmeans_roofline_reads_k5_in_the_runtime_span():
    ops = [Op("void (anonymous namespace)::kmeans_assign_kernel<128, 0>(CUtensorMap)", 0, 3_000_000, "runtime"),
           Op("void (anonymous namespace)::kmeans_segsum_kernel<128>(bf16 const*)", 0, 1_000_000, "runtime"),
           Op("void (anonymous namespace)::kmeans_assign_kernel<128, 0>(CUtensorMap)", 0, 9_000_000, "forward"),
           Op("runs_kernel", 0, 5_000_000, "runtime")]
    # 3 passes a step, bound max(1e9 / 1e12, 1e7 / 1e11) = 1 ms a pass: 6 ms of 4 ms of K5
    assert reader("kmeans_roofline")(view({"kmeans": [[3, 1e9, 1e7]]}, ops)) == pytest.approx(150.0)
    assert reader("kmeans_roofline")(view({}, ops)) is None
    assert reader("kmeans_roofline")(view({"kmeans": [[3, 1e9, 1e7]]}, ops[3:])) is None


def test_sap_q_pad_reads_the_counters(monkeypatch):
    from sparse_videogen_tpu_torch.utils import timer

    ops = [Op("k", 0, 10, "runtime")]
    monkeypatch.setattr(timer, "counted_log", lambda clear=False: {"sap.q_rows": 300.0, "sap.q_real": 200.0})
    assert reader("sap_q_pad")(view({}, ops)) == 1.5
    monkeypatch.setattr(timer, "counted_log", lambda clear=False: {})
    assert reader("sap_q_pad")(view({}, ops)) is None
    monkeypatch.delattr(timer, "counted_log")
    assert reader("sap_q_pad")(view({}, ops)) is None


def test_top_p_map_keeps_the_prefix_past_top_p_and_the_floor():
    qc = torch.zeros(1, 1, 4)
    kc = torch.zeros(1, 5, 4)
    ksz = torch.tensor([[1.0, 4.0, 2.0, 2.0, 1.0]])  # equal scores: the mass is the sizes' share
    keep = RS.top_p_map(qc, kc, ksz, 0.5, 0.0)[0, 0].tolist()
    assert keep == [False, True, True, False, False]  # 0.4, then 0.2 (before it 0.4 <= 0.5), then 0.6 > 0.5
    assert RS.top_p_map(qc, kc, ksz, 0.0, 0.4)[0, 0].tolist() == [False, True, True, False, False]


def test_label_gap_counts_tokens_nearer_another_cluster():
    x = torch.tensor([[[0.0], [0.1], [10.0], [9.9]]])
    lab = torch.tensor([[0, 0, 1, 1]])
    m, n = RS.cluster_means(x, lab, 2)
    assert float(RS.label_gap(x, lab, m, n)[0]) == 0.0
    three = torch.tensor([[0, 0, 1, 2]])
    m, n = RS.cluster_means(x, three, 3)
    assert float(RS.label_gap(x, three, m, n)[0]) == 0.0
    wrong = torch.tensor([[0, 1, 1, 1]])
    m, n = RS.cluster_means(x, wrong, 2)
    assert float(RS.label_gap(x, wrong, m, n)[0]) == 0.25  # token 1 (0.1) sits nearer mean 0 than 6.67


def test_reference_sap_runs_without_the_port():
    code = ("import sys; import svgbench.reference.sap, svgbench.flops_sap\n"
            "print([m for m in sys.modules if m.split('.')[0].startswith(('sparse_videogen', 'jax'))])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
