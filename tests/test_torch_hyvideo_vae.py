"""The HunyuanVideo causal-3D VAE in the port against the JAX package, on
the same f32 weights (chip_smoke.reference_hyvideo_vae_sd through each
package's converter): the decode whole (3 latent
frames: the first frame upsampled in space only) and tiled through each
CLI's make_vae_decoder, the encode, the frame-causal mid attention in
query chunks against one chunk, the nearest upsample and replicate pad,
and convert_hyvideo_vae against the JAX conversion. f32: rel L2 at most
1e-5; the copies and the conversion exact."""

import argparse
import logging

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

import chip_smoke
import sparse_videogen_tpu.io.checkpoint as JCK
from sparse_videogen_tpu.cli import _common as JCOMMON
from sparse_videogen_tpu.models.hyvideo import vae as JV
from sparse_videogen_tpu_torch.cli import _common as TCOMMON
from sparse_videogen_tpu_torch.io import checkpoint as TCK
from sparse_videogen_tpu_torch.io.from_jax import hyvideo_vae_params_from_numpy
from sparse_videogen_tpu_torch.models.hyvideo import vae as TV

CFG = dict(block_out_channels=(8, 16, 16, 16), layers_per_block=1, latent_channels=16, norm_num_groups=4)
LOG = logging.getLogger("test")


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def ref_sd():
    return chip_smoke.reference_hyvideo_vae_sd(TV.HyVideoVAEConfig(**CFG), torch.Generator().manual_seed(5))


@pytest.fixture(scope="module")
def params(ref_sd):
    return JCK.convert_hyvideo_vae({k: v.numpy() for k, v in ref_sd.items()}, JV.HyVideoVAEConfig(**CFG))


@pytest.fixture(scope="module")
def vae(ref_sd):
    cfg = TV.HyVideoVAEConfig(**CFG)
    m = TV.HyVideoVAE(cfg)
    m.load_state_dict(TCK.convert_hyvideo_vae(ref_sd, cfg))
    return m


def test_decode_matches_jax(params, vae):
    """3 latent frames -> 9 frames (frame 0 upsampled in space only), f32."""
    z = np.random.default_rng(1).standard_normal((1, 16, 3, 6, 10)).astype(np.float32)
    ref = jax.jit(lambda p, z: JV.vae_decode(p, JV.HyVideoVAEConfig(**CFG), z))(params, jnp.asarray(z))
    ours = TV.vae_decode(vae, torch.from_numpy(z))
    assert ours.shape == (1, 3, 9, 48, 80) and rel(ours, ref) <= 1e-5


def test_encode_matches_jax(params, vae):
    """9 frames -> 3 latent frames (mean x scaling factor), and one frame -> 1."""
    encode = jax.jit(lambda p, v: JV.vae_encode(p, JV.HyVideoVAEConfig(**CFG), v))
    for t in (9, 1):
        video = np.random.default_rng(t).uniform(-1, 1, (1, 3, t, 16, 24)).astype(np.float32)
        ref = encode(params, jnp.asarray(video))
        ours = TV.vae_encode(vae, torch.from_numpy(video))
        assert ours.shape == (1, 16, 1 + (t - 1) // 4, 2, 3) and rel(ours, ref) <= 1e-5


@pytest.mark.parametrize("tiling", ["on", "off"])
def test_cli_decoder_matches_jax(params, vae, tiling):
    """Each CLI's make_vae_decoder: spatial tiles of 4 latents, overlap 2, on
    a 6 x 10 latent (2 x 4 tiles, blended), or the whole decode; the port's
    --vae_stream_chunk warns (no streamed decode here) and decodes whole."""
    ns = dict(vae_tiling=tiling, vae_tile=4, vae_tile_overlap=2, vae_stream_chunk=0)
    z = np.random.default_rng(2).standard_normal((1, 16, 2, 6, 10)).astype(np.float32)
    ref = JCOMMON.make_vae_decoder(argparse.Namespace(**ns), JV, params, JV.HyVideoVAEConfig(**CFG), LOG)(
        jnp.asarray(z))
    ours = TCOMMON.make_vae_decoder(argparse.Namespace(**ns), vae, LOG)(torch.from_numpy(z))
    assert rel(ours, ref) <= 1e-5
    streamed = TCOMMON.make_vae_decoder(argparse.Namespace(**dict(ns, vae_stream_chunk=1)), vae, LOG)
    assert torch.equal(streamed(torch.from_numpy(z)), ours)


def test_mid_attention_chunks(params, vae):
    """Query chunks of 37 rows (partial last chunk, chunks across frames)
    against one chunk and against JAX's mid_attention: rel L2 <= 1e-6 / 1e-5."""
    x = np.random.default_rng(3).standard_normal((1, 16, 3, 6, 8)).astype(np.float32)
    attn = vae.decoder.mid.attn
    whole = TV.mid_attention(attn, torch.from_numpy(x), 4, q_chunk=10**6)
    chunked = TV.mid_attention(attn, torch.from_numpy(x), 4, q_chunk=37)
    ref = JV.mid_attention(params["decoder"]["mid"]["attn"], jnp.asarray(x), 4, q_chunk=37)
    assert rel(chunked, whole) <= 1e-6 and rel(chunked, ref) <= 1e-5


@pytest.mark.parametrize("factor,t", [((2, 2, 2), 3), ((2, 2, 2), 1), ((1, 2, 2), 3)])
def test_copies_match(factor, t):
    """The nearest upsample (the first frame in space only) equals JAX's,
    and the replicate pad equals F.pad's replicate mode: exact."""
    x = np.random.default_rng(4).standard_normal((1, 2, t, 3, 5)).astype(np.float32)
    np.testing.assert_array_equal(TV.upsample_nearest(torch.from_numpy(x), factor).numpy(),
                                  np.asarray(JV.upsample_nearest(jnp.asarray(x), factor)))
    xt = torch.from_numpy(x)
    assert torch.equal(TV.replicate_pad(xt, 2, 1, 1), F.pad(xt, (1, 1, 1, 1, 2, 0), mode="replicate"))


def test_convert_hyvideo_vae_equals_jax(ref_sd, params):
    """hyvideo_orig names (chip_smoke.reference_hyvideo_vae_sd: a
    CausalConv3d's `.conv`, diffusers' to_q/to_k/to_v/to_out.0/group_norm);
    diffusers is not installed, so the names are written by hand."""
    cfg = TV.HyVideoVAEConfig(**CFG)
    ref = hyvideo_vae_params_from_numpy(jax.tree.map(np.asarray, params), cfg)
    ours = TCK.convert_hyvideo_vae(ref_sd, cfg)
    assert set(ours) == set(ref) == set(TV.HyVideoVAE(cfg).state_dict())
    for k in ref:
        assert torch.equal(torch.as_tensor(ours[k]), ref[k]), k
