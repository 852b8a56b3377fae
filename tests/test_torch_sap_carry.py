"""SAP's k-means carry across videos, its decision record and its counters
(a tiny Wan on the CPU): states handed to generate_latents start the first
sparse step with kmeans_iter_step Lloyd passes from their centroids, and
without them the latents do not change; the recorded labels and map give
exactly the key tokens of the run lists the attention received; the
counters record only under TIME_BENCH or a profiler, sap.pairs is the
density times S^2 summed over heads and layers, and sap.kv_rows / sap.kv_live
are the packed K3 walk's staged rows and live keys of the run lists."""

import numpy as np
import pytest
import torch

from sparse_videogen_tpu_torch.config import SAPConfig
from sparse_videogen_tpu_torch.core import kmeans as K
from sparse_videogen_tpu_torch.core import permute as P
from sparse_videogen_tpu_torch.models.wan import model as WM
from sparse_videogen_tpu_torch.ops import attention as A
from sparse_videogen_tpu_torch.ops import metadata as MD
from sparse_videogen_tpu_torch.pipelines.wan import WanPipeline
from sparse_videogen_tpu_torch.sparse import svg2
from sparse_videogen_tpu_torch.utils import timer as T

# token grid (3, 5, 8): S = 120, two heads of 64
WAN_KW = dict(dim=128, ffn_dim=256, num_heads=2, num_layers=2, freq_dim=32, text_dim=48, text_len=8)
SAP = SAPConfig(num_q_centroids=4, num_k_centroids=6, top_p_kmeans=0.6, kmeans_iter_init=3, kmeans_iter_step=2,
                block_q=16, block_kv=128)
S = 120


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("TIME_BENCH", raising=False)
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    T.get_counts(clear=True)
    T.counted_log(clear=True)
    yield
    T.get_counts(clear=True)
    T.counted_log(clear=True)
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def wan():
    cfg = WM.WanConfig(**WAN_KW)
    model = WM.WanModel(cfg, dtype=torch.float32).init_random(torch.Generator().manual_seed(0))
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=torch.Generator().manual_seed(1))
    return WanPipeline(model), ctx


def generate(wan, steps=1, seed=3, **kw):
    pipe, ctx = wan
    return pipe.generate_latents(ctx, torch.zeros_like(ctx), height=80, width=128, num_frames=9,
                                 num_inference_steps=steps, pattern="SAP", sap=SAP, seed=seed, **kw)


def spy_kmeans(monkeypatch):
    """Records (iterations, init centroids) of every batch_kmeans call."""
    calls = []
    orig = K.batch_kmeans

    def spy(x, n, iters, init, **kw):
        calls.append((iters, init.clone()))
        return orig(x, n, iters, init, **kw)

    monkeypatch.setattr(svg2, "batch_kmeans", spy)
    return calls


def test_carried_states_start_warm_from_their_centroids(wan, monkeypatch):
    states = [{}, {}]
    generate(wan, sap_states=states)
    assert all(sorted(s) == [0, 1] and all(st.initialized for st in s.values()) for s in states)
    carried = [(s, li, states[s][li].q_centroids.clone(), states[s][li].k_centroids.clone())
               for s in range(2) for li in range(2)]
    calls = spy_kmeans(monkeypatch)
    generate(wan, sap_states=states)
    # per forward (cond, then uncond) and layer: the q side, then the k side
    assert [c[0] for c in calls] == [SAP.kmeans_iter_step] * 8
    for j, (s, li, qc, kc) in enumerate(carried):
        assert torch.equal(calls[2 * j][1], qc.float()) and torch.equal(calls[2 * j + 1][1], kc.float())
    # the video left its own states in the list
    assert not torch.equal(states[0][0].q_centroids, carried[0][2])


def test_without_states_every_video_starts_cold_and_nothing_changes(wan, monkeypatch):
    calls = spy_kmeans(monkeypatch)
    a = generate(wan, steps=2)
    assert [c[0] for c in calls[:8]] == [SAP.kmeans_iter_init] * 8
    assert [c[0] for c in calls[8:]] == [SAP.kmeans_iter_step] * 8
    b = generate(wan, steps=2, sap_states=[{}, {}])
    c = generate(wan, steps=2)
    assert torch.equal(a, c) and torch.equal(a, b)


def test_decision_record_rebuilds_the_run_lists_the_attention_received(wan, monkeypatch):
    got = []
    orig = A.block_sparse_attention_runs

    def spy(q, k, v, meta, *a, **kw):
        got.append(meta.clone())
        return orig(q, k, v, meta, *a, **kw)

    monkeypatch.setattr(svg2, "block_sparse_attention_runs", spy)
    records = []
    orig_call = WanPipeline._sap_forward

    def recorded(self, runtime, *a, **kw):
        runtime.record = {}
        try:
            return orig_call(self, runtime, *a, **kw)
        finally:
            records.append(runtime.record)
            runtime.record = None

    monkeypatch.setattr(WanPipeline, "_sap_forward", recorded)
    generate(wan)
    assert len(records) == 2 and all(sorted(r) == [0, 1] for r in records)
    decs = [r[li] for r in records for li in range(2)]
    assert len(got) == len(decs) == 4
    for meta, d in zip(got, decs):
        BH = d.qlab.shape[0]
        assert d.qlab.shape == d.klab.shape == (BH, S) and d.dyn.dtype == torch.bool
        assert torch.equal(torch.bincount(d.qlab[0], minlength=d.qsz.shape[1]), d.qsz[0].long())
        s_pad = P.padded_seq_len(S, SAP.num_q_centroids, SAP.block_q)
        qmaps = P.padded_permutation(d.qlab, d.qsz, n_clusters=SAP.num_q_centroids, block=SAP.block_q, s_pad=s_pad)
        kperm = torch.sort(d.klab, dim=-1, stable=True).indices
        mask = MD.decode_run_meta(meta.numpy(), seq_kv=max(S, SAP.block_kv))
        for h in range(BH):
            for blk in range(s_pad // SAP.block_q):
                keys = set(kperm[h, np.flatnonzero(mask[h, blk])].tolist())
                if qmaps["kv_counts"][h, blk] == 0:
                    assert meta[h, blk, 0] == 0
                    continue
                c = int(qmaps["block_to_cluster"][h, blk])
                want = set(torch.nonzero(d.dyn[h, c][d.klab[h]]).flatten().tolist())
                assert keys == want, (h, blk)


def test_counters_record_only_under_time_bench_or_a_profiler(wan, monkeypatch):
    generate(wan)
    assert T.get_counts() == {} and T.counted_log() == {}
    monkeypatch.setenv("TIME_BENCH", "1")
    states = [{}, {}]
    generate(wan, sap_states=states)
    got = T.get_counts(clear=True)
    # both streams' forwards, 2 layers each: the cold start of a video without carried states
    assert got["sap.lloyd.4"] == got["sap.lloyd.6"] == 4 * SAP.kmeans_iter_init
    assert got["sap.q_real"] == 4 * 2 * S
    assert got["sap.q_rows"] >= got["sap.q_real"] and got["sap.q_rows"] % SAP.block_q == 0
    monkeypatch.delenv("TIME_BENCH")
    densities = []
    orig = svg2._map_and_density

    def spy(*a, **kw):
        out = orig(*a, **kw)
        densities.append(out[1])
        return out

    monkeypatch.setattr(svg2, "_map_and_density", spy)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]):
        generate(wan, sap_states=states)
    assert T.get_counts() == {}
    got = T.counted_log()
    assert got["sap.lloyd.4"] == got["sap.lloyd.6"] == 4 * SAP.kmeans_iter_step
    assert len(densities) == 4
    assert got["sap.pairs"] == pytest.approx(float(sum(d.double().sum() for d in densities)) * S * S, rel=1e-6)
    assert got["sap.pairs"] == int(got["sap.pairs"])


def test_count_adds_ints_on_the_host_and_tensors_on_their_device(monkeypatch):
    T.count("x", 1)
    assert T.get_counts() == {}
    monkeypatch.setenv("TIME_BENCH", "1")
    assert T.counting()
    T.count("x", 2)
    T.count("x", torch.tensor(5))
    T.count("y", torch.tensor(3, dtype=torch.int64))
    assert T.get_counts(clear=True) == {"x": 7.0, "y": 3.0}
    assert T.get_counts() == {}



def test_kv_counters_are_the_packed_walks_rows_and_live_keys(wan, monkeypatch):
    """Under TIME_BENCH a SAP video's sap.kv_rows is 128 x the stages of
    the K3 model's packed walk (ops/attention.py runs_packed_walk) and
    sap.kv_live its live keys, summed over every q block it walks of every
    layer and stream; with short clusters the rows exceed the live keys."""
    metas = []
    orig = svg2._cluster_prepare

    def spy(*a, **kw):
        out = orig(*a, **kw)
        metas.append(out.meta.clone())
        return out

    monkeypatch.setattr(svg2, "_cluster_prepare", spy)
    monkeypatch.setenv("TIME_BENCH", "1")
    generate(wan, sap_states=[{}, {}])
    got = T.get_counts(clear=True)
    assert len(metas) == 4
    rows = live = 0
    for meta in metas:
        for row in meta.reshape(-1, meta.shape[-1]).numpy():
            stages = A.runs_packed_walk(row, SAP.block_kv)
            rows += A.BQ * len(stages)
            live += sum(n for st in stages for _, n in st)
    assert live > 0 and (got["sap.kv_rows"], got["sap.kv_live"]) == (rows, live)
    assert got["sap.kv_rows"] > got["sap.kv_live"]
