"""Ulysses head sharding and USP (ring x heads) of the torch port against the
port's single-device runtimes and the JAX package's UlyssesRuntime and
ring runtimes with head_axis="sp" on conftest's virtual CPU devices.

The port's ranks are threads (parallel/comm.ThreadRanks(rp, sp)); JAX's
Pallas kernels run in interpret mode. f32 throughout: outputs differ by the
order of f32 sums only (atol 1e-5 on outputs of size ~1). SAP's k-means
labels must be equal: q and k are mixtures of well-separated anchors (the
data of tests/test_torch_ring.py), so no token sits near a tie. B = 2 (a
CFG batch): the state is sharded on H within each batch element.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.parallel import make_mesh as jax_make_mesh
from sparse_videogen_tpu.parallel.ring_runtime import RingDenseRuntime as JRingDense
from sparse_videogen_tpu.parallel.ring_runtime import RingSAPRuntime as JRingSAP
from sparse_videogen_tpu.parallel.ulysses import UlyssesRuntime as JUlysses
from sparse_videogen_tpu.sparse import runtimes as JRT
from sparse_videogen_tpu.sparse import svg1 as JS1
from sparse_videogen_tpu.sparse import svg2 as J2
from sparse_videogen_tpu_torch import config as TC
from sparse_videogen_tpu_torch.core import kmeans as TKM
from sparse_videogen_tpu_torch.parallel.comm import ThreadRanks
from sparse_videogen_tpu_torch.parallel.ring_runtime import RingDenseRuntime, RingSAPRuntime
from sparse_videogen_tpu_torch.parallel.ulysses import UlyssesRuntime, UlyssesSAPRuntime
from sparse_videogen_tpu_torch.pipelines.cog import make_cog_runtime
from sparse_videogen_tpu_torch.pipelines.hyvideo import make_hyvideo_runtime
from sparse_videogen_tpu_torch.pipelines.runtime import make_runtime
from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime
from sparse_videogen_tpu_torch.sparse import runtimes as TRT
from sparse_videogen_tpu_torch.sparse import svg1 as TS1
from sparse_videogen_tpu_torch.sparse import svg2 as T2

ATOL = 1e-5
B, H, D = 2, 4, 64
LAY_KW = dict(num_frames=4, frame_size=128)  # S = 512
LAY, JLAY = TC.VideoLayout(**LAY_KW), JC.VideoLayout(**LAY_KW)
S = LAY.seq_len
SVG_KW = dict(sparsity=0.4, num_sampled_rows=32, sample_mse_max_row=S)
QC, KC = 6, 10
SAP_KW = dict(num_q_centroids=QC, num_k_centroids=KC, top_p_kmeans=0.8, min_kc_ratio=0.0, kmeans_iter_init=3,
              kmeans_iter_step=2, block_q=128, block_kv=128)
WARM_KW = dict(first_layers=1, first_times=900.0)  # layer 1 at t = 500 is sparse
T_SPARSE, LAYER = 500.0, 1
t = lambda a: torch.from_numpy(np.array(a))


def _svg_qkv(seed=0):
    """Heads 1 and 3 of each batch element repeat one frame's tokens in
    every frame (plus noise), so the profiler picks the temporal mask for
    them and the spatial one for heads 0 and 2."""
    rng = np.random.default_rng(seed)
    fs, nf = LAY.frame_size, LAY.num_frames
    out = []
    for _ in range(3):
        x = rng.standard_normal((B, H, S, D)).astype(np.float32)
        base = rng.standard_normal((B, H // 2, 1, fs, D)).astype(np.float32)
        x[:, 1::2] = (base + 0.3 * rng.standard_normal((B, H // 2, nf, fs, D))).reshape(B, H // 2, S, D)
        out.append(x)
    return out


def _sap_qkv(seed=0):
    """q (k) from QC (KC) anchors a head, noise of norm ~1.2."""
    rng = np.random.default_rng(seed)
    qa = rng.standard_normal((B, H, QC, D)).astype(np.float32)
    ka = rng.standard_normal((B, H, KC, D)).astype(np.float32)
    pick = lambda a, n: np.take_along_axis(a, rng.integers(0, n, (B, H, S))[..., None], axis=2)
    noise = lambda: 0.15 * rng.standard_normal((B, H, S, D)).astype(np.float32)
    q, k = pick(qa, QC) + noise(), pick(ka, KC) + noise()
    return q, k, rng.standard_normal((B, H, S, D)).astype(np.float32)


def _jax_rows(key):
    return torch.as_tensor(np.array(jax.random.randint(key, (min(SVG_KW["num_sampled_rows"], S),), 0, S)))


def _jax_cold_draws(key, rows, n_tokens):
    """The token indices sap_cluster (or the ring's init_centroids_sharded)
    draws inside each shard from the replicated key, at `rows` rows."""
    rq, rk = jax.random.split(key)
    return (t(np.asarray(jax.random.randint(rq, (rows, QC), 0, n_tokens))),
            t(np.asarray(jax.random.randint(rk, (rows, KC), 0, n_tokens))))


def _tile_heads(idx, sp):
    """A head-local draw (B*H/sp rows) as the single-device draw it stands
    for: global head (b, h) takes local row b * H/sp + h % (H/sp)."""
    hl = H // sp
    return idx.reshape(B, hl, -1)[:, np.arange(H) % hl].reshape(B * H, -1)


def _plans(kind):
    inplace = kind == "svg_inplace"
    tp = TS1.make_svg1_plan(LAY, TC.SVGConfig(**SVG_KW), TC.WarmupSchedule(**WARM_KW), block_q=128, block_kv=128,
                            inplace_temporal=inplace)
    jp = JS1.make_svg1_plan(JLAY, JC.SVGConfig(**SVG_KW), JC.WarmupSchedule(**WARM_KW), block_q=128, block_kv=128)
    return tp, jp


def _sap_cfgs(kind):
    mode = "tile" if kind == "sap_tile" else "cluster"
    return TC.SAPConfig(**SAP_KW, block_mode=mode), JC.SAPConfig(**SAP_KW, block_mode=mode)


def _port_rt(kind, plan, sap=None, mesh=None):
    """The port's runtime of a test kind through pipelines/runtime.make_runtime."""
    pattern = "dense" if kind == "dense" else "SVG" if kind.startswith("svg") else "SAP"
    return make_runtime(plan, pattern, device="cpu", sap=sap, warmup=TC.WarmupSchedule(**WARM_KW), mesh=mesh)


def _jax_rt(kind, plan, sap=None):
    if kind == "dense":
        return JRT.DenseRuntime(plan)
    if kind.startswith("svg"):
        return JRT.SVG1Runtime(plan)
    return JRT.SAPRuntime(plan, sap, JC.WarmupSchedule(**WARM_KW))


def _bf16_close(a, b):
    """bf16 centroids within one bf16 ulp of each other: an f32 mean that
    sits at a rounding boundary may round either way after another order of
    f32 sums. The labels they give are held equal."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(b), 1e-30))) - 7)
    assert (np.abs(a - b) <= ulp).all()


def _labels(x, cent):
    """Each token's nearest centroid (one assignment, no update)."""
    return TKM.batch_kmeans(x.reshape(B * H, S, D), cent.shape[1], 0, cent.float())[0]


@pytest.mark.parametrize("sp", [2, 4])
@pytest.mark.parametrize("kind", ["dense", "svg", "svg_inplace", "sap_cluster", "sap_tile"])
def test_ulysses_matches_single_device_and_jax(kind, sp):
    """The Ulysses runtime over ThreadRanks(sp=sp) equals the port's single-device
    runtime (SVG1 on the same profiler rows; SAP cold from the same token
    draws, then warm from the carried state) and JAX's UlyssesRuntime on
    sp virtual devices: outputs within atol 1e-5, SAP's centroids within
    one bf16 ulp (the state keeps them in bf16) and the k-means labels they
    give equal. SVG1 in place is held to JAX's placement runtime
    (tests/test_torch_inplace_svg1.py). JAX runs at sp = 2, and at sp = 4
    for cluster SAP, whose cold draw depends on sp; elsewhere its shards
    compute what one device does, which the single-device check covers."""
    tplan, jplan = _plans(kind)
    sap, jsap = _sap_cfgs(kind) if kind.startswith("sap") else (None, None)
    q, k, v = _svg_qkv() if not kind.startswith("sap") else _sap_qkv()
    tq, tk, tv = t(q), t(k), t(v)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    key = jax.random.PRNGKey(7)
    one, uly = _port_rt(kind, tplan, sap), _port_rt(kind, tplan, sap, ThreadRanks(sp=sp))
    with_jax = sp == 2 or kind == "sap_cluster"
    jrt = JUlysses(_jax_rt(kind, jplan, jsap), jax_make_mesh(sp, sp=sp))
    jstate = J2.init_sap_state(B * H, D, jsap) if sap else jrt.init_state(B * H, D, 2)[LAYER]
    if sap is None:
        rows = _jax_rows(key)
        ours = uly(tq, tk, tv, T_SPARSE, LAYER, rows=rows)
        np.testing.assert_allclose(ours.numpy(), one(tq, tk, tv, T_SPARSE, LAYER, rows=rows).numpy(), atol=ATOL,
                                   rtol=0)
        if with_jax:
            ref, _ = jrt(jq, jk, jv, jnp.float32(T_SPARSE), key, LAYER, jstate, jrt.consts())
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
        return
    draws = _jax_cold_draws(key, B * H // sp, S)
    uly.kmeans_init = {LAYER: draws}
    one.kmeans_init = {LAYER: tuple(_tile_heads(d, sp) for d in draws)}
    for step in range(2):  # cold, then warm
        ours, single = uly(tq, tk, tv, T_SPARSE, LAYER), one(tq, tk, tv, T_SPARSE, LAYER)
        st = uly.states[LAYER]
        assert st.initialized and st.q_centroids.shape == (B * H, QC, D)
        np.testing.assert_allclose(ours.numpy(), single.numpy(), atol=ATOL, rtol=0)
        for x, c, sc in ((tq, st.q_centroids, one.states[LAYER].q_centroids),
                         (tk, st.k_centroids, one.states[LAYER].k_centroids)):
            _bf16_close(c.float().numpy(), sc.float().numpy())
            assert torch.equal(_labels(x, c), _labels(x, sc))
        if with_jax:
            ref, jstate = jrt(jq, jk, jv, jnp.float32(T_SPARSE), key, LAYER, jstate, jrt.consts())
            np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
            for x, c, jc in ((tq, st.q_centroids, jstate.q_centroids), (tk, st.k_centroids, jstate.k_centroids)):
                jc = np.asarray(jc.astype(jnp.float32))
                _bf16_close(c.float().numpy(), jc)
                assert torch.equal(_labels(x, c), _labels(x, t(jc)))
        uly.kmeans_init = one.kmeans_init = None


@pytest.mark.parametrize("sp", [1, 2])
def test_ulysses_sap_draws_once_for_every_rank(sp):
    """Without handed-in draws the SAP runtime (sp 1: the single-device one)
    draws the cold start once, at B*H/sp rows, from the forward's
    generator, q then k: two runs from equal generators agree, and equal the
    runtime handed those draws, every rank of a CFG batch element seeing the
    same token indices (JAX's replicated-key draw). On one device the draw
    is svg2.sap_cluster's own, bit for bit."""
    sap, _ = _sap_cfgs("sap_cluster")
    tplan, _ = _plans("sap_cluster")
    tq, tk, tv = (t(a) for a in _sap_qkv(1))
    outs = []
    for _ in range(2):
        rt = _port_rt("sap_cluster", tplan, sap, None if sp == 1 else ThreadRanks(sp=sp))
        assert isinstance(rt, TRT.SAPRuntime)
        outs.append(rt(tq, tk, tv, T_SPARSE, LAYER, generator=torch.Generator().manual_seed(3)))
    assert torch.equal(outs[0], outs[1])
    gen = torch.Generator().manual_seed(3)
    draws = tuple(torch.randint(0, S, (B * H // sp, c), generator=gen) for c in (QC, KC))
    one = _port_rt("sap_cluster", tplan, sap)
    one.kmeans_init = {LAYER: tuple(_tile_heads(d, sp) for d in draws)}
    np.testing.assert_allclose(outs[0].numpy(), one(tq, tk, tv, T_SPARSE, LAYER).numpy(), atol=ATOL, rtol=0)
    if sp == 1:
        own, _ = T2.sap_sparse_attention(tq, tk, tv, T2.init_sap_state(B * H, D, sap), layout=LAY, cfg=sap,
                                         generator=torch.Generator().manual_seed(3))
        assert torch.equal(outs[0], own)


@pytest.mark.parametrize("kind", ["dense", "sap"])
def test_usp_matches_jax_ring_with_head_axis(kind):
    """USP, rp 2 x sp 2 (four thread ranks): the port's ring runtimes split
    the heads over the head axis and ring each head group over its token
    shards, against JAX's ring runtimes with head_axis="sp" on a 2 x 2
    mesh. SAP runs cold from JAX's draws (global token indices at B*H/sp
    rows), then warm: outputs within 1e-5, centroids within 1e-5, labels
    equal; dense equals the single-device runtime too."""
    mesh, ranks = jax_make_mesh(4, rp=2, sp=2), ThreadRanks(2, 2)
    tplan, jplan = _plans("dense")
    key = jax.random.PRNGKey(11)
    if kind == "dense":
        q, k, v = _svg_qkv(2)
        ours = make_runtime(tplan, "dense", device="cpu", mesh=ranks)(t(q), t(k), t(v), T_SPARSE, LAYER)
        jrt = JRingDense(jplan, mesh, head_axis="sp")
        ref, _ = jrt(*(jnp.asarray(a) for a in (q, k, v)), jnp.float32(T_SPARSE), key, LAYER,
                     jrt.init_state(B * H, D, 2)[LAYER], jrt.consts())
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
        single = make_runtime(tplan, "dense", device="cpu")(t(q), t(k), t(v), T_SPARSE, LAYER)
        np.testing.assert_allclose(ours.numpy(), single.numpy(), atol=ATOL, rtol=0)
        return
    sap, jsap = _sap_cfgs("sap_cluster")
    q, k, v = _sap_qkv(2)
    rt = _port_rt("sap_cluster", tplan, sap, ranks)
    assert isinstance(rt, RingSAPRuntime)
    jrt = JRingSAP(jplan, jsap, JC.WarmupSchedule(**WARM_KW), mesh, head_axis="sp")
    jstate = J2.init_sap_state(B * H, D, jsap)
    rt.kmeans_init = {LAYER: _jax_cold_draws(key, B * H // 2, S)}
    for step in range(2):
        ours = rt(t(q), t(k), t(v), T_SPARSE, LAYER)
        ref, jstate = jrt(*(jnp.asarray(a) for a in (q, k, v)), jnp.float32(T_SPARSE), key, LAYER, jstate,
                          jrt.consts())
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=ATOL, rtol=0)
        st = rt.states[LAYER]
        for x, c, jc in ((t(q), st.q_centroids, jstate.q_centroids), (t(k), st.k_centroids, jstate.k_centroids)):
            jc = np.asarray(jc.astype(jnp.float32))
            _bf16_close(c.float().numpy(), jc)
            assert torch.equal(_labels(x, c), _labels(x, t(jc)))
        rt.kmeans_init = None


TEXT_LAST, TEXT_FIRST = (TC.VideoLayout(**LAY_KW, context_length=64, text_position=pos)
                          for pos in (TC.TextPosition.LAST, TC.TextPosition.FIRST))
# case -> the runtime built (and the one it wraps), or the error raised and its message
RULES = {
    "one_device": (TRT.DenseRuntime,),
    "ring_dense_usp": (RingDenseRuntime,),
    "ring_sap": (RingSAPRuntime,),
    "ulysses_dense": (UlyssesRuntime, TRT.DenseRuntime),
    "ulysses_svg": (UlyssesRuntime, TRT.SVG1Runtime),
    "ulysses_sap": (UlyssesSAPRuntime,),
    "ring_svg": (ValueError, "pattern=SVG on a layout with text_position=none does not compose with ring_degree>1; "
                             "use --ulysses_degree"),
    "ring_sap_text_last": (ValueError, "pattern=SAP on a layout with text_position=last does not compose"),
    "wan_ring_svg": (ValueError, "pattern=SVG on a layout with text_position=none does not compose"),
    "hyvideo_ring_svg": (ValueError, "pattern=SVG on a layout with text_position=last does not compose"),
    "hyvideo_ring_sap": (ValueError, "pattern=SAP on a layout with text_position=last does not compose"),
    "cog_sap": (NotImplementedError, "CogVideoX"),
    "cog_ring_sap": (NotImplementedError, "CogVideoX"),
    "heads_ulysses": (ValueError, "6 heads do not split over Ulysses degree sp=4"),
    "heads_usp": (ValueError, "6 heads do not split over Ulysses degree sp=4"),
}


def _rule_case(case):
    """Build the runtime of one case (the heads cases also call it)."""
    tplan, _ = _plans("dense")
    sap, warm = TC.SAPConfig(**SAP_KW), TC.WarmupSchedule(**WARM_KW)
    build = lambda plan, pattern, mesh: make_runtime(plan, pattern, device="cpu", sap=sap, warmup=warm, mesh=mesh)
    q = torch.zeros(1, 6, S, D)
    cases = {
        "one_device": lambda: build(tplan, "dense", None),
        "ring_dense_usp": lambda: build(tplan, "dense", ThreadRanks(2, 2)),
        "ring_sap": lambda: build(tplan, "SAP", ThreadRanks(2)),
        "ulysses_dense": lambda: build(tplan, "dense", ThreadRanks(sp=2)),
        "ulysses_svg": lambda: build(tplan, "SVG", ThreadRanks(sp=2)),
        "ulysses_sap": lambda: build(tplan, "SAP", ThreadRanks(sp=2)),
        "ring_svg": lambda: build(tplan, "SVG", ThreadRanks(2)),
        "ring_sap_text_last": lambda: build(TS1.make_svg1_plan(TEXT_LAST, TC.SVGConfig(**SVG_KW), warm, block_q=128,
                                                               block_kv=128), "SAP", ThreadRanks(2)),
        "wan_ring_svg": lambda: make_wan_runtime(LAY, device="cpu", pattern="SVG", mesh=ThreadRanks(2)),
        "hyvideo_ring_svg": lambda: make_hyvideo_runtime(TEXT_LAST, device="cpu", prompt_length=40, pattern="SVG",
                                                         mesh=ThreadRanks(2)),
        "hyvideo_ring_sap": lambda: make_hyvideo_runtime(TEXT_LAST, device="cpu", prompt_length=40, pattern="SAP",
                                                         mesh=ThreadRanks(2)),
        "cog_sap": lambda: make_cog_runtime(TEXT_FIRST, device="cpu", pattern="SAP"),
        "cog_ring_sap": lambda: make_cog_runtime(TEXT_FIRST, device="cpu", pattern="SAP", mesh=ThreadRanks(2)),
        "heads_ulysses": lambda: build(tplan, "dense", ThreadRanks(sp=4))(q, q, q, T_SPARSE, LAYER),
        "heads_usp": lambda: build(tplan, "dense", ThreadRanks(2, 4))(q, q, q, T_SPARSE, LAYER),
    }
    return cases[case]()


@pytest.mark.parametrize("case", list(RULES))
def test_parallelize_runtime_rules_and_refusals(case):
    """The JAX package's composition rules, held once by
    pipelines/runtime.make_runtime and reached through every family's
    make_*_runtime: the ring takes dense and video-only SAP (with the head
    axis, USP) and raises for SVG and for SAP with text in the sequence,
    one message naming the pattern and the layout; the head axis alone runs
    every pattern (dense and SVG1 wrapped, SAP its own SAPRuntime); no mesh
    builds the single-device runtime; CogVideoX's text-first SAP raises
    NotImplementedError. Heads that do not split over sp raise, naming
    both."""
    want = RULES[case]
    if isinstance(want[0], type) and issubclass(want[0], Exception):
        with pytest.raises(want[0], match=want[1]):
            _rule_case(case)
        return
    rt = _rule_case(case)
    assert type(rt) is want[0]
    if len(want) > 1:
        assert type(rt.inner) is want[1]
