"""The port's Wan VAE encoder (models/wan/vae.py: WanVAE.encode and
encode_streamed; io/checkpoint.convert_wan_vae's encoder side) against the
JAX package's vae_encode, on the same numpy weights
(io/from_jax.wan_vae_params_from_numpy with the encoder); tolerances are
stated per test."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu.io import checkpoint as JCK
from sparse_videogen_tpu.models.wan import vae as JV
from sparse_videogen_tpu_torch.io import checkpoint as TCK
from sparse_videogen_tpu_torch.io.from_jax import wan_vae_params_from_numpy
from sparse_videogen_tpu_torch.models.wan import vae as TV
from tests.test_prompt_to_video import _make_vae_sd
from tests.test_torch_wan_vae import _leaf, rel_err

# the published structure (3 spatial and 2 temporal downsamples, z_dim 16:
# the latent mean / std tables) at a small width
CFG_KW = dict(dim=4, z_dim=16, dim_mult=(1, 2, 4, 4), num_res_blocks=2, temporal_downsample=(False, True, True))
JCFG, TCFG = JV.WanVAEConfig(**CFG_KW), TV.WanVAEConfig(**CFG_KW)


@pytest.fixture(scope="module")
def weights():
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda: JV.init_wan_vae_params(jax.random.PRNGKey(0), JCFG))
    tree = jax.tree_util.tree_map_with_path(lambda path, s: _leaf(rng, path, s.shape), shapes)
    vae = TV.WanVAE(TCFG, encoder=True)
    vae.load_state_dict(wan_vae_params_from_numpy(tree, TCFG, encoder=True))
    video = rng.uniform(-1, 1, (1, 3, 9, 16, 24)).astype(np.float32)
    return tree, vae, video


def test_encode_matches_jax(weights):
    """vae_encode: video (1, 3, 9, 16, 24) -> latents (1, 16, 3, 2, 3), f32
    within rtol 1e-4 (atol 1e-5 for the values near zero)."""
    tree, vae, video = weights
    ref = np.asarray(JV.vae_encode(tree, JCFG, jnp.asarray(video)))
    ours = vae.encode(torch.from_numpy(video))
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape == (1, 16, 3, 2, 3)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-5)


def test_encode_streamed_equals_whole(weights):
    """The reference's chunks (frame 0, then 4 frames) with the per-conv
    cache: the same function as the whole encode, rel L2 <= 1e-6 (f32
    summation order), and JAX's within rtol 1e-4; T must be 1 + 4 k."""
    tree, vae, video = weights
    whole = vae.encode(torch.from_numpy(video))
    streamed = vae.encode_streamed(torch.from_numpy(video))
    assert streamed.shape == whole.shape
    assert rel_err(streamed.numpy(), whole.numpy()) <= 1e-6
    np.testing.assert_allclose(streamed.numpy(), np.asarray(JV.vae_encode(tree, JCFG, jnp.asarray(video))),
                               rtol=1e-4, atol=1e-5)
    with pytest.raises(ValueError, match="1 \\+ 4 k"):
        vae.encode_streamed(torch.from_numpy(video[:, :, :8]))


def test_convert_wan_vae_encoder_side_equals_jax():
    """The reference's names (tests/test_prompt_to_video.py's tiny
    checkpoint) -> the port's encoder, conv1 and decoder: the weights of
    JAX's convert_wan_vae after the layout change; the encode of the
    converted weights within rtol 1e-4 of JAX's; without `encoder` the
    state_dict is the decoder's, as before."""
    kw = dict(dim=8, z_dim=16, dim_mult=(1, 2, 2), num_res_blocks=1, temporal_downsample=(False, True))
    jcfg, tcfg = JV.WanVAEConfig(**kw), TV.WanVAEConfig(**kw)
    sd = _make_vae_sd()
    jtree = jax.tree.map(np.asarray, JCK.convert_wan_vae(sd, jcfg))
    ref = wan_vae_params_from_numpy(jtree, tcfg, encoder=True)
    ours = TCK.convert_wan_vae({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg, encoder=True)
    assert set(ours) == set(ref) == set(TV.WanVAE(tcfg, encoder=True).state_dict())
    assert any(k.startswith("encoder.down.1.resample.time_conv") for k in ours)
    for k, v in ref.items():
        assert torch.equal(ours[k], v), k
    assert set(TCK.convert_wan_vae({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)) == set(
        TV.WanVAE(tcfg).state_dict())
    vae = TV.WanVAE(tcfg, encoder=True)
    vae.load_state_dict(ours)
    video = np.random.default_rng(5).uniform(-1, 1, (1, 3, 5, 16, 16)).astype(np.float32)
    np.testing.assert_allclose(vae.encode(torch.from_numpy(video)).numpy(),
                               np.asarray(JV.vae_encode(jtree, jcfg, jnp.asarray(video))), rtol=1e-4, atol=1e-5)


def test_encoder_is_optional_and_keeps_the_decoders_draws():
    """encode without the encoder raises; WanVAE(encoder=True).init_random
    draws the decoder's weights as a decoder-only VAE does (the T2V paths
    keep their numbers)."""
    with pytest.raises(ValueError, match="encoder=True"):
        TV.WanVAE(TCFG).encode(torch.zeros(1, 3, 1, 8, 8))
    a = TV.WanVAE(TCFG).init_random(torch.Generator().manual_seed(0)).state_dict()
    b = TV.WanVAE(TCFG, encoder=True).init_random(torch.Generator().manual_seed(0)).state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert {k.split(".")[0] for k in set(b) - set(a)} == {"encoder", "conv1"}
