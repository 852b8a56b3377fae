"""Quantized linears of the torch port (utils/quant.py, models/common/
layers.py) against the JAX package's utils/quant.py and layers.linear.

The codes and scales are equal bit for bit (e4m3 and int8 round to nearest,
ties to even, in both); the int8 x int8 -> int32 product is exact; the
linears' outputs agree within f32 rel L2 1e-6 (one matmul each, summed in
another order). The walkers pick the same linears as JAX's on a small Wan,
and at Wan 14B's widths the port leaves norm3 alone where JAX's rule takes
it (ROADMAP.md section 3).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch import nn

from sparse_videogen_tpu.models.common import layers as JL
from sparse_videogen_tpu.models.wan import model as JWM
from sparse_videogen_tpu.utils import quant as JQ
from sparse_videogen_tpu_torch.models.common import layers as TL
from sparse_videogen_tpu_torch.models.wan import model as TWM
from sparse_videogen_tpu_torch.utils import quant as TQ


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _linear(rng, d_in, d_out, scale=0.05):
    w = (scale * rng.standard_normal((d_in, d_out))).astype(np.float32)  # JAX layout (in, out)
    b = (0.1 * rng.standard_normal(d_out)).astype(np.float32)
    lin = nn.Linear(d_in, d_out)
    with torch.no_grad():
        lin.weight.copy_(torch.from_numpy(w.T))
        lin.bias.copy_(torch.from_numpy(b))
    return {"w": jnp.asarray(w), "b": jnp.asarray(b)}, lin


def test_fp8_codes_and_scales_equal_jax():
    """Per-tensor scales equal; e4m3 codes equal bit for bit, also per layer
    of a stacked (L, in, out) weight, where JAX keeps one scale a layer."""
    rng = np.random.default_rng(0)
    p, lin = _linear(rng, 96, 64)
    jq, tq = JQ.fp8_quantize_linear(p), TQ.fp8_quantize_linear(lin)
    assert tq.w8.dtype == torch.float8_e4m3fn and tq.w8.shape == (64, 96)
    np.testing.assert_array_equal(np.asarray(jq["w8"]).view(np.uint8).T, tq.w8.view(torch.uint8).numpy())
    np.testing.assert_array_equal(np.asarray(jq["scale"]).reshape(()), tq.scale.numpy())
    stacked = jnp.asarray(np.stack([(s * rng.standard_normal((32, 24))).astype(np.float32) for s in (0.01, 3.0)]))
    js = JQ.fp8_quantize_linear({"w": stacked})
    for i in range(2):
        lin_i = nn.Linear(32, 24, bias=False)
        with torch.no_grad():
            lin_i.weight.copy_(torch.from_numpy(np.array(stacked[i]).T))
        ti = TQ.fp8_quantize_linear(lin_i)
        np.testing.assert_array_equal(np.asarray(js["w8"][i]).view(np.uint8).T, ti.w8.view(torch.uint8).numpy())
        np.testing.assert_array_equal(np.asarray(js["scale"][i]).reshape(()), ti.scale.numpy())


def test_int8_codes_scales_and_exact_product():
    """Per-output-channel codes and wscale equal JAX's; the int32 product of
    int8_matmul equals numpy's int64 one, with and without the zero-row
    padding of 16 rows or fewer."""
    rng = np.random.default_rng(1)
    p, lin = _linear(rng, 80, 48)
    jq, tq = JQ.int8_quantize_linear(p), TQ.int8_quantize_linear(lin)
    np.testing.assert_array_equal(np.asarray(jq["wi8"]).T, tq.wi8.numpy())
    np.testing.assert_array_equal(np.asarray(jq["wscale"]).reshape(-1), tq.wscale.numpy())
    assert tq.wi8.is_contiguous() and int(tq.wi8.abs().max()) == 127
    for m in (1, 2, 16, 17, 40):
        xi = torch.from_numpy(rng.integers(-127, 128, (m, 80)).astype(np.int8))
        y = TQ.int8_matmul(xi, tq.wi8)
        assert y.dtype == torch.int32 and y.shape == (m, 48)
        np.testing.assert_array_equal(y.numpy(), xi.numpy().astype(np.int64) @ tq.wi8.numpy().astype(np.int64).T)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_linear_matches_jax(kind, dtype):
    """layers.linear on the quantized module against JAX's layers.linear on
    its quantized dict: rel L2 <= 1e-6 on x (2, 37, 96) in f32 and in bf16
    (both compared in f32 after the cast); a row-sliced pair of linears
    (layers.linear_slice) too. fp8 in bf16 is a bf16 matmul on the upcast
    weight, which equals JAX's bit for bit; XLA's and torch's bf16 matmuls
    accumulate in other orders, so there the outputs are held to one bf16
    rounding (rel L2 <= 4e-3, 2^-8) and to F.linear on that weight exactly."""
    rng = np.random.default_rng(2)
    p, lin = _linear(rng, 96, 64)
    quant = {"int8": (JQ.int8_quantize_linear, TQ.int8_quantize_linear),
             "fp8": (JQ.fp8_quantize_linear, TQ.fp8_quantize_linear)}[kind]
    jq, tq = quant[0](p), quant[1](lin)
    x = rng.standard_normal((2, 37, 96)).astype(np.float32)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    ref = np.asarray(JL.linear(jq, jx).astype(jnp.float32))
    ours = TL.linear(tq, tx)
    assert ours.dtype == tx.dtype
    tol = 4e-3 if (kind, dtype) == ("fp8", "bfloat16") else 1e-6
    assert rel_err(ours.float().numpy(), ref) <= tol
    if kind == "fp8":
        w = TL.fp8_weight(tq.w8, tq.scale, tx.dtype)
        jw = (jq["w8"].astype(jx.dtype) * jq["scale"].astype(jx.dtype)).astype(jnp.float32)
        np.testing.assert_array_equal(w.float().numpy().T, np.asarray(jw))
        assert torch.equal(ours, torch.nn.functional.linear(tx, w, tq.bias.to(tx.dtype)))
    # the rows [0, 40) with the bias and [40, 96) without, each its own input
    wk = "wi8" if kind == "int8" else "w8"
    j1 = {**jq, wk: jq[wk][:40]}
    j2 = {k: (v[40:] if k == wk else v) for k, v in jq.items() if k != "b"}
    ref = np.asarray((JL.linear(j1, jx[..., :40]) + JL.linear(j2, jx[..., 40:])).astype(jnp.float32))
    ours = TL.linear_slice(tq, tx[..., :40], rows=slice(0, 40)) + TL.linear_slice(tq, tx[..., 40:],
                                                                                   rows=slice(40, None), bias=False)
    assert rel_err(ours.float().numpy(), ref) <= tol


def test_pseudo_quantize_and_rotation_match_jax():
    """pseudo_quantize_absmax_perhead equals JAX's bit for bit (4 and 8
    bits); the rotation's QR of a given matrix within 1e-5, orthogonal."""
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, 3, 40, 16)).astype(np.float32)
    for n_bits in (4, 8):
        ref = np.asarray(JQ.pseudo_quantize_absmax_perhead(jnp.asarray(x), n_bits))
        np.testing.assert_array_equal(TQ.pseudo_quantize_absmax_perhead(torch.from_numpy(x), n_bits).numpy(), ref)
    a = rng.standard_normal((16, 16)).astype(np.float32)
    ref = np.asarray(jnp.linalg.qr(jnp.asarray(a))[0])
    ours = TQ.random_orthogonal(16, matrix=a).numpy()
    np.testing.assert_allclose(ours, ref, atol=1e-5, rtol=0)
    r = TQ.random_orthogonal(16, torch.Generator().manual_seed(0))
    np.testing.assert_allclose((r @ r.T).numpy(), np.eye(16), atol=1e-5)


def _jax_quantized_paths(tree, pre=""):
    if isinstance(tree, dict):
        if "wi8" in tree or "w8" in tree:
            return {pre}
        return set().union(*[_jax_quantized_paths(v, f"{pre}.{k}" if pre else k) for k, v in tree.items()])
    return set()


def _port_quantized_paths(blocks):
    out = set()
    for name, mod in blocks.named_modules():
        if isinstance(mod, (TQ.Int8Linear, TQ.FP8Linear)):
            out.add(name.split(".", 1)[1])  # drop the block index
    return out


@pytest.mark.parametrize("min_size", [1 << 12, 1 << 14])
@pytest.mark.parametrize("kind", ["int8", "fp8"])
def test_walkers_pick_the_jax_linears(kind, min_size):
    """A 2-layer, 64-wide Wan: the port's walker (the stacked size: 2 x the
    weight's elements) swaps the linears JAX's walker converts."""
    kw = dict(dim=64, ffn_dim=128, num_heads=1, num_layers=2, freq_dim=32, text_dim=32, text_len=8)
    tree = JWM.init_wan_params(jax.random.PRNGKey(0), JWM.WanConfig(**kw), dtype=jnp.float32)["blocks"]
    jfn, tfn = {"int8": (JQ.quantize_linears_int8, TQ.quantize_linears_int8),
                "fp8": (JQ.quantize_linears_fp8, TQ.quantize_linears_fp8)}[kind]
    jpaths = _jax_quantized_paths(jfn(tree, min_size=min_size))
    blocks = TWM.WanModel(TWM.WanConfig(**kw), dtype=torch.float32).blocks
    assert tfn(blocks, min_size=min_size) is blocks
    assert _port_quantized_paths(blocks) == jpaths and jpaths
    assert (min_size == 1 << 14) == (jpaths == {"ffn.fc1", "ffn.fc2"})


def test_wan14b_quantizes_the_block_linears_not_norm3():
    """At WAN_14B's widths (meta tensors) the port swaps exactly the 10
    block linears in every block. JAX's rule also takes norm3, whose stacked
    (40, 5120) weight has 204,800 elements: its forward then has no
    norm3 "w" (ROADMAP.md section 3)."""
    cfg = TWM.WAN_14B
    blocks = nn.ModuleList(TWM.WanBlock(cfg, torch.bfloat16, "meta") for _ in range(cfg.num_layers))
    TQ.quantize_linears_int8(blocks)
    linears = {"self_attn.q", "self_attn.k", "self_attn.v", "self_attn.o", "cross_attn.q", "cross_attn.k",
               "cross_attn.v", "cross_attn.o", "ffn.fc1", "ffn.fc2"}
    for blk in blocks:
        names = {n for n, m in blk.named_modules() if isinstance(m, TQ.Int8Linear)}
        assert names == linears and isinstance(blk.norm3, nn.LayerNorm)
    tree = jax.eval_shape(lambda: JWM.init_wan_params(jax.random.PRNGKey(0), JWM.WAN_14B, dtype=jnp.bfloat16)["blocks"])
    jpaths = _jax_quantized_paths(jax.eval_shape(JQ.quantize_linears_int8, tree))
    assert jpaths == linears | {"norm3"}
