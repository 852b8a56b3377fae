"""SVG1 pieces of the torch port against the JAX package: mask math, the
online profiler, per-head placement, and the dense / SVG1 attention entries.

Integer and boolean results (masks, maps, chosen mask per head) must be
equal. Float results run in f32 on both sides over the same inputs and
differ by summation order only: rtol 1e-5 for the profiler MSEs, atol 1e-5
for attention outputs of size ~1.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.core import masks as JM
from sparse_videogen_tpu.core import placement as JP
from sparse_videogen_tpu.core import profiler as JPR
from sparse_videogen_tpu.sparse import runtimes as JRT
from sparse_videogen_tpu.sparse import svg1 as JS1
from sparse_videogen_tpu_torch import config as TC
from sparse_videogen_tpu_torch.core import masks as TM
from sparse_videogen_tpu_torch.core import placement as TP
from sparse_videogen_tpu_torch.core import profiler as TPR
from sparse_videogen_tpu_torch.sparse import runtimes as TRT
from sparse_videogen_tpu_torch.sparse import svg1 as TS1

# (num_frames, frame_size); each package builds its own VideoLayout from them
LAYOUTS = [(3, 100), (4, 96), (2, 60), (5, 200)]
IDS = ["3x100", "4x96", "2x60", "5x200"]


@pytest.mark.parametrize("lay", LAYOUTS, ids=IDS)
def test_mask_math_equal(lay):
    jl, lay = JC.VideoLayout(*lay), TC.VideoLayout(*lay)
    for sp in (0.1, 0.25, 0.5):
        assert TM.sparsity_to_width(sp, lay.context_length, lay.num_frames, lay.frame_size) == \
            JM.sparsity_to_width(sp, lay.context_length, lay.num_frames, lay.frame_size)
    g = TM.temporal_index_map(lay)
    np.testing.assert_array_equal(g, JM.temporal_index_map(jl))
    np.testing.assert_array_equal(TM.inverse_permutation(g), JM.inverse_permutation(g))
    qi, ki = np.arange(lay.seq_len)[:, None], np.arange(lay.seq_len)[None, :]
    # the port's masks are Wan's: first-frame sink, band rounded up ("ceil")
    for name in ("spatial", "temporal"):
        for mul in (0.7, 2.0):
            ours = TM.profile_mask_predicate(lay, name, mul)(torch.as_tensor(qi), torch.as_tensor(ki))
            ref = JM.profile_mask_predicate(jl, name, mul, first_frame_sink=True)(qi, ki)
            np.testing.assert_array_equal(ours.numpy(), np.asarray(ref))
    for mul in (0.4, 1.3):
        for bq, bkv in ((128, 128), (256, 128)):
            np.testing.assert_array_equal(
                TM.execution_mask_block(lay, mul, block_q=bq, block_kv=bkv),
                JM.execution_mask_block(jl, mul, block_q=bq, block_kv=bkv, first_frame_sink=True, round_mode="ceil"))


@pytest.mark.parametrize("lay", LAYOUTS, ids=IDS)
def test_temporal_transpose_equal(lay):
    jl, lay = JC.VideoLayout(*lay), TC.VideoLayout(*lay)
    x = np.random.default_rng(0).standard_normal((2, 3, lay.seq_len, 8)).astype(np.float32)
    for inverse in (False, True):
        ours = TP.temporal_transpose(torch.from_numpy(x), lay, inverse=inverse).numpy()
        np.testing.assert_array_equal(ours, np.asarray(JP.temporal_transpose(jnp.asarray(x), jl, inverse=inverse)))
    g = TM.temporal_index_map(lay)
    np.testing.assert_array_equal(TP.temporal_transpose(torch.from_numpy(x), lay).numpy(), x[..., g, :])
    is_t = torch.tensor([[True, False, True], [False, False, True]])
    placed = TP.place_heads(torch.from_numpy(x), is_t, lay).numpy()
    np.testing.assert_array_equal(placed[0, 1], x[0, 1])
    np.testing.assert_array_equal(placed[1, 2], x[1, 2][g])


# S = 300: a padded tail in q and kv; each package builds its own layout and config
LAY_KW = dict(num_frames=3, frame_size=100)
CFG_KW = dict(sparsity=0.25, num_sampled_rows=32, sample_mse_max_row=250)
LAY, CFG = TC.VideoLayout(**LAY_KW), TC.SVGConfig(**CFG_KW)
JLAY, JCFG = JC.VideoLayout(**LAY_KW), JC.SVGConfig(**CFG_KW)


def _qkv(seed=0):
    """(B=2, H=4, S, 64) f32. Heads 1 and 3 repeat one frame's tokens in every
    frame (plus noise), so their attention follows the temporal axis."""
    rng = np.random.default_rng(seed)
    S, fs = LAY.seq_len, LAY.frame_size
    base = rng.standard_normal((2, 2, 1, fs, 64)).astype(np.float32)
    out = []
    for _ in range(3):
        x = rng.standard_normal((2, 4, S, 64)).astype(np.float32)
        x[:, 1::2] = (base + 0.3 * rng.standard_normal((2, 2, LAY.num_frames, fs, 64))).reshape(2, 2, S, 64)
        out.append(x)
    return out


def _jax_rows(key):
    return np.array(jax.random.randint(key, (min(CFG.num_sampled_rows, LAY.seq_len),), 0,
                                         min(CFG.sample_mse_max_row, LAY.seq_len)))


def test_sample_mse_with_jax_rows():
    q, k, v = _qkv()
    plan_j = JS1.make_svg1_plan(JLAY, JCFG)
    plan_t = TS1.make_svg1_plan(LAY, CFG)
    key = jax.random.PRNGKey(3)
    ref = np.asarray(JPR.sample_mse(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), plan_j.profile_preds(), key,
                                    num_sampled_rows=CFG.num_sampled_rows,
                                    sample_mse_max_row=CFG.sample_mse_max_row))
    t = torch.from_numpy
    ours = TPR.sample_mse(t(q), t(k), t(v), plan_t.profile_preds(), torch.as_tensor(_jax_rows(key)))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-5, atol=0)
    best = TPR.best_mask_idx(ours).numpy()
    np.testing.assert_array_equal(best, np.asarray(JPR.best_mask_idx(jnp.asarray(ref))))
    assert best[:, 1::2].all() and not best.all()  # both placements are exercised
    rows = TPR.sample_rows(LAY.seq_len, num_sampled_rows=CFG.num_sampled_rows,
                           sample_mse_max_row=CFG.sample_mse_max_row,
                           generator=torch.Generator().manual_seed(0), device="cpu")
    assert rows.shape == (32,) and int(rows.min()) >= 0 and int(rows.max()) < 250


@pytest.mark.parametrize("which", ["dense", "svg1"])
def test_attention_impls_match_jax(which):
    """dense_impl and svg1_sparse_impl at the runtimes' (cheap-first)
    metadata, through padding, placement and the inverse placement."""
    q, k, v = _qkv(1)
    plan_j = JS1.make_svg1_plan(JLAY, JCFG, block_q=128, block_kv=256)
    plan_t = TS1.make_svg1_plan(LAY, CFG, block_q=128, block_kv=256)
    consts = JRT.SVG1Runtime(plan_j).consts()
    rt = TRT.SVG1Runtime(plan_t, device="cpu")
    jq, jk, jv = (jnp.asarray(a) for a in (q, k, v))
    t = torch.from_numpy
    if which == "dense":
        ref = JS1.dense_impl(jq, jk, jv, consts["dense_meta"], plan_j, consts["aux"])
        ours = TS1.dense_impl(t(q), t(k), t(v), rt.dense_meta, plan_t, rt.aux)
        np.testing.assert_array_equal(rt.dense_meta.numpy(), np.asarray(consts["dense_meta"]))
    else:
        key = jax.random.PRNGKey(5)
        ref = JS1.svg1_sparse_impl(jq, jk, jv, key, consts["sparse_meta"], plan_j, consts["aux"])
        ours = TS1.svg1_sparse_impl(t(q), t(k), t(v), torch.as_tensor(_jax_rows(key)), rt.sparse_meta, plan_t, rt.aux)
        np.testing.assert_array_equal(rt.sparse_meta.numpy(), np.asarray(consts["sparse_meta"]))
    np.testing.assert_allclose(ours.numpy(), np.asarray(ref), atol=1e-5, rtol=0)
