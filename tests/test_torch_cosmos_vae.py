"""Cosmos's CV8x8x8 tokenizer in the port (models/cosmos/vae.py,
io/checkpoint.convert_cosmos_vae, io/from_jax.tree_state_dict)
against the JAX package on the same numpy weights and inputs.

Tolerances: the converter bit for bit; the Haar patcher within 1e-6 of JAX
and its inverse exact to 1e-6 (orthonormal: a round trip); the f32 encoder
and decoder rel L2 1e-5 (summation order only)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu.io import checkpoint as JCK
from sparse_videogen_tpu.models.cosmos import vae as JV
from sparse_videogen_tpu_torch.io import checkpoint as TCK
from sparse_videogen_tpu_torch.io.from_jax import tree_state_dict
from sparse_videogen_tpu_torch.models.common.vae_tiling import spatial_tiled_decode
from sparse_videogen_tpu_torch.models.cosmos import vae as TV
from tests.test_cosmos_vae import _fake_sd

# the CLI's smoke tokenizer, attention queries in chunks of 16 rows (so the
# chunked spatial attention takes more than one chunk), latent statistics set
VAE_KW = dict(base_channels=16, channels_mult=(1, 2), num_res_blocks=1, attn_q_chunk=16,
              latents_mean=tuple(0.1 * i for i in range(16)), latents_std=tuple(1.0 + 0.05 * i for i in range(16)))


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def vaes():
    """The same f32 weights in both packages: Cosmos-Tokenizer-named state
    dict (chip_smoke.reference_cosmos_vae_sd) through each package's
    converter; JAX's encode and decode jitted."""
    import chip_smoke

    jcfg, tcfg = JV.CosmosVAEConfig(**VAE_KW), TV.CosmosVAEConfig(**VAE_KW)
    sd = chip_smoke.reference_cosmos_vae_sd(tcfg, torch.Generator().manual_seed(0))
    tree = JCK.convert_cosmos_vae({k: v.numpy() for k, v in sd.items()}, jcfg)
    vae = TV.CosmosVAE(tcfg)
    vae.load_state_dict(TCK.convert_cosmos_vae(sd, tcfg))
    return jcfg, tree, vae


@pytest.mark.parametrize("frames", [17, 9, 1])
def test_haar_patcher_matches_jax(frames):
    x = np.random.default_rng(0).standard_normal((1, 3, frames, 16, 24)).astype(np.float32)
    ref = np.asarray(JV.haar_patch3d(jnp.asarray(x), 2))
    ours = TV.haar_patch3d(torch.from_numpy(x), 2)
    np.testing.assert_allclose(ours.numpy(), ref, atol=1e-6)
    np.testing.assert_allclose(TV.haar_unpatch3d(ours, 2, frames).numpy(), x, atol=1e-6)


@pytest.mark.parametrize("frames", [17, 9])
def test_encode_matches_jax(vaes, frames):
    jcfg, tree, vae = vaes
    v = np.random.default_rng(1).uniform(-1, 1, (1, 3, frames, 32, 48)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda t, x: JV.vae_encode(t, jcfg, x))(tree, jnp.asarray(v)))
    out = vae.encode(torch.from_numpy(v)).numpy()
    assert out.shape == ref.shape == (1, 16, 1 + (frames - 1) // 8, 4, 6) and rel_err(out, ref) <= 1e-5


@pytest.mark.parametrize("latent_frames", [3, 1])
def test_decode_matches_jax(vaes, latent_frames):
    """Standardised latents -> video in [-1, 1]: the causal upsample (T ->
    2T - 1), the inverse Haar transform, the clip."""
    jcfg, tree, vae = vaes
    z = np.random.default_rng(2).standard_normal((1, 16, latent_frames, 4, 6)).astype(np.float32)
    ref = np.asarray(jax.jit(lambda t, x: JV.vae_decode(t, jcfg, x))(tree, jnp.asarray(z)))
    out = vae.decode(torch.from_numpy(z)).numpy()
    assert out.shape == ref.shape == (1, 3, 1 + 8 * (latent_frames - 1), 32, 48) and rel_err(out, ref) <= 1e-5


def test_tiled_decode_matches_jax(vaes):
    jcfg, tree, vae = vaes
    z = np.random.default_rng(3).standard_normal((1, 16, 2, 6, 7)).astype(np.float32)
    ref = np.asarray(JV.vae_decode_tiled(tree, jcfg, jnp.asarray(z), tile=4, overlap=2))
    out = spatial_tiled_decode(vae.decode, torch.from_numpy(z), tile=4, overlap=2, scale=8).numpy()
    assert rel_err(out, ref) <= 1e-5


def test_convert_cosmos_vae_matches_jax():
    """Cosmos-Tokenizer's names (tests/test_cosmos_vae._fake_sd): the port's
    convert_cosmos_vae equals JAX's carried over, bit for bit, and loads; a
    checkpoint without temporal attention raises as JAX's does."""
    jcfg, tcfg = JV.CosmosVAEConfig(**VAE_KW), TV.CosmosVAEConfig(**VAE_KW)
    sd = _fake_sd(jcfg)
    ref = tree_state_dict(jax.tree.map(np.asarray, JCK.convert_cosmos_vae(sd, jcfg)))
    ours = TCK.convert_cosmos_vae({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert torch.equal(ours[k].reshape(ref[k].shape), ref[k]), k
    TV.CosmosVAE(tcfg).load_state_dict(ours)
    with pytest.raises(KeyError, match="temporal attention"):
        TCK.convert_cosmos_vae({k: v for k, v in sd.items() if ".attn_2." not in k}, tcfg)
