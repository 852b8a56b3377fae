"""Placement-free SVG1 (`inplace_temporal`) of the torch port against the
JAX package: the temporal heads stay in original token order under K1's
dual per-head spec (band_sink for the spatial heads, band_sink_perm, the
band at permuted positions, for the temporal ones).

Integer and boolean results (block masks, metadata) must be equal. Float
results run in f32 on both sides and differ by summation order only: atol
1e-5 on attention outputs of size ~1, rel L2 1e-5 on runtimes and forwards.

The JAX package's own SVG1Runtime does not run the in-place path as its
top-level entry does (it hands svg1_sparse_impl the single stack where the
dual one belongs; ROADMAP.md section 3), so the port's in-place runtime is
held to JAX's *placement* runtime: both attend to the same pairs.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.core import masks as JM
from sparse_videogen_tpu.models.wan import model as JWM
from sparse_videogen_tpu.pipelines import wan as JPW
from sparse_videogen_tpu.sparse import runtimes as JRT
from sparse_videogen_tpu.sparse import svg1 as JS1
from sparse_videogen_tpu_torch import config as TC
from sparse_videogen_tpu_torch.core import masks as TM
from sparse_videogen_tpu_torch.io.from_jax import wan_params_from_numpy
from sparse_videogen_tpu_torch.models.wan import model as TWM
from sparse_videogen_tpu_torch.pipelines import wan as TPW
from sparse_videogen_tpu_torch.sparse import runtimes as TRT
from sparse_videogen_tpu_torch.sparse import svg1 as TS1

t = lambda a: torch.from_numpy(np.ascontiguousarray(a))


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("lay,mul,bq", [((3, 100), 0.7, 128), ((5, 96), 1.3, 256), ((4, 200), 0.4, 128)],
                         ids=["3x100", "5x96", "4x200"])
def test_block_perm_and_dual_meta_equal(lay, mul, bq):
    jl, tl = JC.VideoLayout(*lay), TC.VideoLayout(*lay)
    for bkv in (128, 256):
        np.testing.assert_array_equal(TM.execution_mask_block_perm(tl, mul, block_q=bq, block_kv=bkv),
                                      JM.execution_mask_block_perm(jl, mul, block_q=bq, block_kv=bkv))
    cfg = dict(sparsity=0.25)
    jp = JS1.make_svg1_plan(jl, JC.SVGConfig(**cfg), block_q=bq, block_kv=256, inplace_temporal=True)
    tp = TS1.make_svg1_plan(tl, TC.SVGConfig(**cfg), block_q=bq, block_kv=256, inplace_temporal=True)
    np.testing.assert_array_equal(tp.sparse_meta_dual(), np.asarray(jp.sparse_meta_dual()))
    assert tuple(vars(s) for s in tp.mask_spec_dual) == tuple(vars(s) for s in jp.mask_spec_dual)


# S = 6 x 320 = 1920 (the JAX package's in-place test layout)
LAY_KW = dict(num_frames=6, frame_size=320)
CFG_KW = dict(sparsity=0.4, num_sampled_rows=32, sample_mse_max_row=1920)
LAY, CFG = TC.VideoLayout(**LAY_KW), TC.SVGConfig(**CFG_KW)
JLAY, JCFG = JC.VideoLayout(**LAY_KW), JC.SVGConfig(**CFG_KW)


def _qkv(seed=0):
    """(1, 4, S, 64) f32; heads 1 and 3 repeat one frame's tokens in every
    frame (plus noise), so the profiler picks the other mask for them than
    for heads 0 and 2."""
    rng = np.random.default_rng(seed)
    S, fs = LAY.seq_len, LAY.frame_size
    out = []
    for _ in range(3):
        x = rng.standard_normal((1, 4, S, 64)).astype(np.float32)
        base = rng.standard_normal((1, 2, 1, fs, 64)).astype(np.float32)
        x[:, 1::2] = (base + 0.3 * rng.standard_normal((1, 2, LAY.num_frames, fs, 64))).reshape(1, 2, S, 64)
        out.append(x)
    return out


def _jax_rows(key):
    return np.array(jax.random.randint(key, (min(CFG.num_sampled_rows, LAY.seq_len),), 0,
                                       min(CFG.sample_mse_max_row, LAY.seq_len)))


def test_inplace_impl_and_runtime_match_jax():
    """svg1_sparse_impl in place (the dual stack as built, and classified
    cheap-first as the runtime holds it) against JAX's top-level
    svg1_sparse_attention in place, atol 1e-5; the port's in-place
    SVG1Runtime against JAX's placement SVG1Runtime, rel L2 1e-5. Both head
    classes are present."""
    q, k, v = _qkv()
    key = jax.random.PRNGKey(4)
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    jplan = JS1.make_svg1_plan(JLAY, JCFG, block_q=256, block_kv=512, inplace_temporal=True)
    ref = np.asarray(JS1.svg1_sparse_attention(jq, jk, jv, key, jplan))
    plan = TS1.make_svg1_plan(LAY, CFG, block_q=256, block_kv=512, inplace_temporal=True)
    rt = TRT.SVG1Runtime(plan, device="cpu")
    rows = torch.as_tensor(_jax_rows(key))
    raw = torch.as_tensor(plan.sparse_meta_dual())
    assert (rt.sparse_meta[..., 0] // 4096).sum() > 0  # the classified stack has cheap chunks
    for meta in (raw, rt.sparse_meta):
        ours = TS1.svg1_sparse_impl(t(q), t(k), t(v), rows, meta, plan, rt.aux)
        np.testing.assert_allclose(ours.numpy(), ref, atol=1e-5, rtol=0)
    from sparse_videogen_tpu_torch.core import profiler as TPR

    best = TPR.best_mask_idx(TPR.sample_mse(t(q), t(k), t(v), plan.profile_preds(), rows)).numpy()
    assert sorted(best[0].tolist()) == [0, 0, 1, 1]  # two heads of each class

    # the runtime against JAX's placement runtime at a sparse layer and step
    jp_place = JS1.make_svg1_plan(JLAY, JCFG, block_q=256, block_kv=512)
    jrt = JRT.SVG1Runtime(jp_place)
    ref_rt, _ = jrt(jq, jk, jv, jnp.float32(100.0), key, 1, jrt.init_state(4, 64, 2), jrt.consts())
    ours_rt = rt(t(q), t(k), t(v), 100.0, 1, rows=rows)
    assert rel_err(ours_rt.numpy(), ref_rt) <= 1e-5


def test_small_wan_forward_inplace_matches_jax_placement():
    """One forward of a small Wan (2 blocks, layer 0 dense warm-up, layer 1
    SVG1) in place against JAX's placement forward, f32: rel L2 1e-5."""
    cfg_kw = dict(dim=128, ffn_dim=256, num_heads=2, num_layers=2, freq_dim=32, text_dim=48, text_len=8)
    jcfg, tcfg = JWM.WanConfig(**cfg_kw), TWM.WanConfig(**cfg_kw)
    tree = JWM.init_wan_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(0)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree)
    model = TWM.WanModel(tcfg, dtype=torch.float32, device="cpu")
    model.load_state_dict(wan_params_from_numpy(params, tcfg))
    h, w, nf = 10, 16, 9  # token grid (3, 5, 8): S = 120, frame_size 40
    lay = JPW.wan_layout(jcfg, 8 * h, 8 * w, nf)
    x = rng.standard_normal((2, 16, lay.num_frames, h, w)).astype(np.float32)
    ctx = rng.standard_normal((2, jcfg.text_len, jcfg.text_dim)).astype(np.float32)
    tt = np.asarray([700.0, 700.0], np.float32)
    key = jax.random.PRNGKey(2)
    svg_kw = dict(sparsity=0.25, num_sampled_rows=32)
    jrt = JPW.make_wan_runtime(lay, pattern="SVG", warmup=JC.WarmupSchedule(first_layers=1),
                               svg=JC.SVGConfig(**svg_kw))
    ref, _ = JWM.wan_forward(params, jcfg, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(ctx), attention=jrt, rng=key)
    trt = TPW.make_wan_runtime(TPW.wan_layout(tcfg, 8 * h, 8 * w, nf), device="cpu", pattern="SVG",
                               warmup=TC.WarmupSchedule(first_layers=1), svg=TC.SVGConfig(**svg_kw),
                               inplace_temporal=True)
    assert trt.plan.inplace_temporal and trt.sparse_meta.shape[0] == 2
    n, mx = min(32, lay.seq_len), min(10000, lay.seq_len)
    rows = torch.as_tensor(np.stack([np.asarray(jax.random.randint(jax.random.fold_in(key, li), (n,), 0, mx))
                                     for li in range(jcfg.num_layers)]))
    ours = TWM.wan_forward(model, t(x), t(tt), t(ctx), attention=trt, profile_rows=rows)
    assert rel_err(ours.numpy(), ref) <= 1e-5
