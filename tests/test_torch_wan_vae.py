"""The port's Wan VAE decode (models/wan/vae.py, models/common/vae_tiling.py,
io/checkpoint.convert_wan_vae) against the JAX package's on the small
config of tests/test_wan_vae.py and the same numpy weights
(io/from_jax.wan_vae_params_from_numpy): the whole decode, the streamed one
(chunks of 1 and 2 latent frames) and the spatially tiled one, each within
rel L2 1e-5 in f32 (the two frameworks' convolutions sum in other orders)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu.io import checkpoint as JCK
from sparse_videogen_tpu.models.common import vae_tiling as JTILE
from sparse_videogen_tpu.models.wan import vae as JV
from sparse_videogen_tpu_torch.io import checkpoint as TCK
from sparse_videogen_tpu_torch.io.from_jax import wan_vae_params_from_numpy
from sparse_videogen_tpu_torch.models.common import vae_tiling as TTILE
from sparse_videogen_tpu_torch.models.wan import vae as TV
from tests.test_prompt_to_video import _make_vae_sd

CFG_KW = dict(dim=8, z_dim=4, dim_mult=(1, 2, 2), num_res_blocks=1, temporal_downsample=(False, True))
JCFG, TCFG = JV.WanVAEConfig(**CFG_KW), TV.WanVAEConfig(**CFG_KW)
SCALE = 4  # two spatial upsamples in this config
TILE, OVERLAP = 6, 2


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _leaf(rng, path, shape):
    """init_wan_vae_params' scales from numpy (running JAX's init eagerly
    compiles each small op): conv weights N(0, 1/fan_in), biases 0.05 N(0, 1),
    norm gammas 1 + 0.05 N(0, 1); no zero attention projection, no unit norm."""
    name = jax.tree_util.keystr(path)
    if name.endswith("['w']"):
        return (rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))).astype(np.float32)
    return ((0.0 if name.endswith("['b']") else 1.0) + 0.05 * rng.standard_normal(shape)).astype(np.float32)


@pytest.fixture(scope="module")
def weights():
    """Weights in the JAX package's tree (its init's structure) and the
    port's module holding the same values."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: JV.init_wan_vae_params(jax.random.PRNGKey(0), JCFG))
    tree = jax.tree_util.tree_map_with_path(lambda path, s: _leaf(rng, path, s.shape), shapes)
    vae = TV.WanVAE(TCFG)
    vae.load_state_dict(wan_vae_params_from_numpy(tree, TCFG))
    z = rng.standard_normal((1, 4, 3, 8, 10)).astype(np.float32)
    return tree, vae, z


@pytest.mark.parametrize("mode", ["whole", "stream1", "stream2", "tiled"])
def test_decode_matches_jax(weights, mode):
    tree, vae, z = weights
    if mode == "whole":
        ref, ours = JV.vae_decode(tree, JCFG, jnp.asarray(z)), vae.decode(torch.from_numpy(z))
    elif mode.startswith("stream"):
        chunk = int(mode[-1])
        ref = JV.vae_decode_streamed(tree, JCFG, jnp.asarray(z), chunk=chunk)
        ours = vae.decode_streamed(torch.from_numpy(z), chunk=chunk)
        # the streamed decode is the whole decode up to summation order
        assert rel_err(ours.numpy(), vae.decode(torch.from_numpy(z)).numpy()) <= 1e-6
    else:
        f = jax.jit(lambda zt: JV.vae_decode(tree, JCFG, zt))
        ref = JTILE.spatial_tiled_decode(f, jnp.asarray(z), tile=TILE, overlap=OVERLAP, scale=SCALE)
        ours = TTILE.spatial_tiled_decode(vae.decode, torch.from_numpy(z), tile=TILE, overlap=OVERLAP, scale=SCALE)
    ref = np.asarray(ref)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape == (1, 3, 5, 32, 40)
    assert np.isfinite(ours.numpy()).all() and ours.abs().max() <= 1.0
    assert (ours.abs() < 1.0).float().mean() > 0.5  # mostly unclipped: the comparison sees the values
    assert rel_err(ours.numpy(), ref) <= 1e-5


def test_tile_layout_equals_jax():
    for size, tile, stride in ((60, 32, 24), (104, 32, 24), (8, 6, 4), (5, 8, 6)):
        assert TTILE._starts(size, tile, stride) == JTILE._starts(size, tile, stride)
    for args in ((256, 64, True, True), (256, 64, False, True), (48, 8, True, False), (4, 8, True, True)):
        np.testing.assert_array_equal(TTILE._ramp_weight(*args), JTILE._ramp_weight(*args))


def test_convert_wan_vae_equals_jax_conversion():
    """The reference's names (tests/test_prompt_to_video.py's tiny checkpoint,
    z_dim 16) -> the port's decoder: the same f32 weights as JAX's
    convert_wan_vae after the channels-last -> (co, ci, k...) change; and the
    decode of the converted weights (the latent mean/std path) within rel L2
    1e-5 of JAX's."""
    kw = dict(dim=8, z_dim=16, dim_mult=(1, 2, 2), num_res_blocks=1, temporal_downsample=(False, True))
    jcfg, tcfg = JV.WanVAEConfig(**kw), TV.WanVAEConfig(**kw)
    sd = _make_vae_sd()
    jtree = jax.tree.map(np.asarray, JCK.convert_wan_vae(sd, jcfg))
    ref = TV.WanVAE(tcfg)
    ref.load_state_dict(wan_vae_params_from_numpy(jtree, tcfg))
    ours = TV.WanVAE(tcfg)
    ours.load_state_dict(TCK.convert_wan_vae({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg))
    want = ref.state_dict()
    for name, t in ours.state_dict().items():
        assert torch.equal(t, want[name]), name
    z = np.random.default_rng(4).standard_normal((1, 16, 2, 4, 6)).astype(np.float32)
    got = ours.decode(torch.from_numpy(z).to(torch.bfloat16))  # bf16 latents are promoted to f32
    assert got.dtype == torch.float32
    jz = jnp.asarray(z, jnp.bfloat16)
    assert rel_err(got.numpy(), np.asarray(JV.vae_decode(jtree, jcfg, jz))) <= 1e-5


def test_published_decoder_shapes_equal_jax():
    """WanVAEConfig() (dim 96, the published Wan VAE): every decoder and conv2
    parameter of the port's module has the shape of JAX's init after the
    layout change (built on the meta device: no memory)."""
    shapes = jax.eval_shape(lambda: JV.init_wan_vae_params(jax.random.PRNGKey(0), JV.WanVAEConfig()))
    tree = jax.tree.map(lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), shapes)
    sd = wan_vae_params_from_numpy({"decoder": tree["decoder"], "conv2": tree["conv2"]}, TV.WanVAEConfig())
    model = TV.WanVAE(TV.WanVAEConfig(), device="meta")
    got = {k: tuple(v.shape) for k, v in model.state_dict().items()}
    assert got == {k: tuple(v.shape) for k, v in sd.items()}
    assert dataclasses.asdict(TV.WanVAEConfig()) == dataclasses.asdict(JV.WanVAEConfig())


def test_spatial_upsample_is_nearest():
    """The expand + reshape 2x equals F.interpolate's nearest (and JAX's
    jnp.repeat) where both are right: under 2^31 elements."""
    x = torch.randn(1, 6, 3, 5, 7)
    ref = torch.nn.functional.interpolate(x, scale_factor=(1, 2, 2), mode="nearest")
    assert torch.equal(TV.nearest2x(x), ref)
    np.testing.assert_array_equal(TV.nearest2x(x).numpy(), np.repeat(np.repeat(x.numpy(), 2, 3), 2, 4))


def test_init_random_zeroes_attention_projections():
    """init_random as the JAX package's _attn_init: every attention block's
    proj weight and bias exactly 0; every other conv N(0, 1/fan_in) with a
    zero bias, drawn as if proj were drawn too (the same stream of draws)."""
    vae = TV.WanVAE(TCFG, encoder=True).init_random(torch.Generator().manual_seed(0))
    projs = [m.proj for m in vae.modules() if isinstance(m, TV.AttentionBlock)]
    assert projs and all(not p.weight.any() and not p.bias.any() for p in projs)
    g = torch.Generator().manual_seed(0)
    for mod in vae.modules():
        if isinstance(mod, (torch.nn.Conv2d, torch.nn.Conv3d)):
            w = torch.randn(mod.weight.shape, generator=g) / np.sqrt(mod.weight[0].numel())
            assert not mod.bias.any()
            if not any(mod is p for p in projs):
                torch.testing.assert_close(mod.weight, w, rtol=0, atol=0)
