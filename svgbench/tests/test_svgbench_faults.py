"""A whole run on the CPU at a tiny size (the harness's look for a card
skipped): sound, it comes out correct; with the timed path broken
underneath, or with the control in the program's place, it does not."""

import copy

import pytest
import torch

from svgbench import control, faults
from svgbench import run as R
from svgbench.spec import Benchmark, Cell

TINY = {
    "wan": (dict(dim=128, ffn_dim=256, num_heads=2, num_layers=2, text_len=16, text_dim=64, freq_dim=32),
            dict(height=256, width=256, num_frames=17)),
    "hyvideo": (dict(hidden_size=128, heads_num=2, mm_double_blocks_depth=1, mm_single_blocks_depth=1,
                     rope_dim_list=[16, 24, 24], text_states_dim=32, text_states_dim_2=16, text_len=16,
                     refiner_depth=1),
                dict(height=128, width=512, num_frames=17, prompt_length=5)),
}
CELLS = sorted(Benchmark().workloads)
CFG_CELLS = [c for c in CELLS if Benchmark().cell(c).config["family"] == "wan"]  # a CFG batch of two
SVG_CELLS = [c for c in CELLS if Benchmark().cell(c).traffic["pattern"] == "SVG"]


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny(name):
    b = Benchmark()
    c = b.cell(name)
    cfg = copy.deepcopy(c.config)
    model, gen = TINY[cfg["family"]]
    cfg["model"].update(model)
    cfg["generation"].update(gen)
    return b, Cell(c.name, 1, cfg, c.traffic, c.cell)


def run(name, seed=2**31 + 11, trace=False):
    b, cell = tiny(name)
    return R.run_cell(b, cell, seed=seed, seconds=0.3, trace=trace, device="cpu", t_start=0.0)


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(name):
    out = run(name)
    assert out["correct"], out["checks"]
    assert out["attempted"] >= 1 and out["failed"] == 0
    assert list(out)[-1] == "checks"
    assert set(out["metrics"]) == {"step_s", "peak_mem_gib", "setup_s"}
    assert out["setup_built"] is False  # nothing is built for the CPU


def test_traced_run_reports_the_per_layer_metrics_it_can_read():
    out = run(CELLS[0], trace=True)
    assert out["correct"]
    # no device on this host: only the host-clock metric has something to read
    assert set(out["metrics"]) == {"step_mfu"}
    assert {"busy_s", "window_s"} <= set(out["device"]) and "breakdown" in out


@pytest.mark.parametrize("name", CELLS)
def test_step_that_returns_its_state_unchanged_is_caught(name, monkeypatch):
    faults.state_unchanged(monkeypatch.setattr)
    out = run(name)
    assert not out["correct"]
    assert out["checks"]["update_rel_l2"]["value"] > 0.99


@pytest.mark.parametrize("name", CFG_CELLS)
def test_half_the_batch_left_out_is_caught(name, monkeypatch):
    faults.half_batch(monkeypatch.setattr)
    out = run(name)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("name", CELLS)
def test_attention_answer_altered_where_produced_is_caught(name, monkeypatch):
    faults.attention_altered(monkeypatch.setattr)
    out = run(name)
    assert not out["correct"], out["checks"]
    assert out["checks"]["attn_rows_rel"]["value"] > out["checks"]["attn_rows_rel"]["limit"]


@pytest.mark.parametrize("name", SVG_CELLS)
def test_wrong_class_is_caught(name, monkeypatch):
    """The attention is right for the class the profiler took, so only the
    class gap can catch a wrong class."""
    faults.invert_class(monkeypatch.setattr)
    out = run(name)
    assert not out["correct"], out["checks"]
    assert out["checks"]["svg1_class_gap"]["value"] > out["checks"]["svg1_class_gap"]["limit"]


@pytest.mark.parametrize("name", CELLS)
def test_control_reads_not_correct(name):
    """The reference in float8 in the program's place fails the cell's limits
    and reads well above the program's own plain path."""
    b, cell = tiny(name)
    sound = run(name)["checks"]
    for seed in (1, 2, 3):
        r = control.readings(b, cell, seed, "cpu")
        assert not r["passes_limits"], r
        assert r["numbers"]["update_rel_l2"] > 3 * sound["update_rel_l2"]["value"]
        assert r["numbers"]["attn_rows_rel"] > 3 * sound["attn_rows_rel"]["value"]
