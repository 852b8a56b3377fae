"""CogVideoX's VAE, its converters and the bilinear resize in the port
(models/cog/vae.py, io/checkpoint.convert_cog_vae / cog_vae_config_from_json /
convert_cog_dit / cog_config_from_json, models/common/resize.py) against
the JAX package on the same numpy weights and inputs.

Tolerances: configs and converters exact (bit for bit); the f32 VAE rel L2
1e-5 (summation order only); the bilinear resize within 1e-5 of
jax.image.resize (the same f32 weights; two matmuls)."""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu.io import checkpoint as JCK
from sparse_videogen_tpu.models.cog import model as JCM
from sparse_videogen_tpu.models.cog import vae as JV
from sparse_videogen_tpu_torch.io import checkpoint as TCK
from sparse_videogen_tpu_torch.io.from_jax import cog_params_from_numpy, tree_state_dict
from sparse_videogen_tpu_torch.io.image import load_image
from sparse_videogen_tpu_torch.models.cog import model as TCM
from sparse_videogen_tpu_torch.models.cog import vae as TV
from sparse_videogen_tpu_torch.models.common.resize import resize_bilinear
from sparse_videogen_tpu_torch.models.common.vae_tiling import spatial_tiled_decode
from tests.test_checkpoint import make_sd_cog, make_sd_cog_vae

VAE_KW = dict(block_out_channels=(16, 16, 32, 32), layers_per_block=1, norm_num_groups=4)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.fixture(scope="module")
def vaes():
    """The same f32 weights in both packages: a diffusers-named state dict
    (chip_smoke.reference_cog_vae_sd: norms and biases perturbed) through
    each package's converter; JAX's encode and decode jitted."""
    import chip_smoke

    jcfg, tcfg = JV.CogVAEConfig(**VAE_KW), TV.CogVAEConfig(**VAE_KW)
    sd = chip_smoke.reference_cog_vae_sd(tcfg, torch.Generator().manual_seed(0))
    tree = JCK.convert_cog_vae({k: v.numpy() for k, v in sd.items()}, jcfg)
    vae = TV.CogVAE(tcfg)
    vae.load_state_dict(TCK.convert_cog_vae(sd, tcfg))
    enc = jax.jit(lambda t, v: JV.vae_encode(t, jcfg, v))
    dec = jax.jit(lambda t, z: JV.vae_decode(t, jcfg, z))
    return jcfg, tree, vae, enc, dec


@pytest.mark.parametrize("frames", [5, 4, 1], ids=["odd", "even", "one"])
def test_encode_matches_jax(vaes, frames):
    """The mean latents of a clip (an odd clip keeps frame 0 alone in the
    temporal means): f32 rel L2 <= 1e-5."""
    jcfg, tree, vae, enc, _ = vaes
    v = np.random.default_rng(1).uniform(-1, 1, (1, 3, frames, 16, 24)).astype(np.float32)
    ref = np.asarray(enc(tree, jnp.asarray(v)))
    out = vae.encode(torch.from_numpy(v)).numpy()
    assert out.shape == ref.shape and rel_err(out, ref) <= 1e-5


@pytest.mark.parametrize("latent_frames", [3, 2, 1], ids=["odd", "even", "one"])
def test_decode_matches_jax(vaes, latent_frames):
    """Scaled latents -> video: the spatial norms (the first latent frame to
    the first frame alone in an odd clip), the upsamples: rel L2 <= 1e-5."""
    jcfg, tree, vae, _, dec = vaes
    z = np.random.default_rng(2).standard_normal((1, 16, latent_frames, 2, 3)).astype(np.float32)
    ref = np.asarray(dec(tree, jnp.asarray(z)))
    out = vae.decode(torch.from_numpy(z)).numpy()
    assert out.shape == ref.shape and rel_err(out, ref) <= 1e-5


def test_tiled_decode_matches_jax(vaes):
    """The CLI's tiled decode (models/common/vae_tiling.py) against JAX's
    vae_decode_tiled: tiles of 4 latents, overlap 2; rel L2 <= 1e-5."""
    jcfg, tree, vae, _, _ = vaes
    z = np.random.default_rng(3).standard_normal((1, 16, 2, 6, 7)).astype(np.float32)
    ref = np.asarray(JV.vae_decode_tiled(tree, jcfg, jnp.asarray(z), tile=4, overlap=2))
    out = spatial_tiled_decode(vae.decode, torch.from_numpy(z), tile=4, overlap=2, scale=8).numpy()
    assert rel_err(out, ref) <= 1e-5


@pytest.mark.parametrize("invert", [True, False], ids=["v1.5", "v1.0"])
def test_scale_latents(invert):
    kw = dict(scaling_factor=0.7 if invert else 1.15258426, invert_scale_latents=invert)
    raw = np.random.default_rng(4).standard_normal((1, 16, 1, 4, 6)).astype(np.float32)
    ref = np.asarray(JV.scale_latents(JV.CogVAEConfig(**kw), jnp.asarray(raw)))
    np.testing.assert_array_equal(TV.scale_latents(TV.CogVAEConfig(**kw), torch.from_numpy(raw)).numpy(), ref)


def test_convert_cog_vae_matches_jax():
    """diffusers' names (tests/test_checkpoint.make_sd_cog_vae): the port's
    convert_cog_vae equals JAX's carried over, bit for bit, and loads."""
    jcfg, tcfg = JV.CogVAEConfig(**VAE_KW), TV.CogVAEConfig(**VAE_KW)
    sd = make_sd_cog_vae(jcfg)
    ref = tree_state_dict(jax.tree.map(np.asarray, JCK.convert_cog_vae(sd, jcfg)))
    ours = TCK.convert_cog_vae({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert torch.equal(ours[k], ref[k]), k
    TV.CogVAE(tcfg).load_state_dict(ours)


def test_cog_configs_read_as_jax_reads_them(tmp_path):
    """cog_vae_config_from_json (invert_scale_latents False when missing, as
    in JAX) and cog_config_from_json on diffusers' names."""
    (tmp_path / "config.json").write_text(json.dumps({"block_out_channels": [8, 16, 16, 32], "layers_per_block": 2,
                                                      "norm_num_groups": 8, "scaling_factor": 1.15258426}))
    assert dataclasses.asdict(TCK.cog_vae_config_from_json(str(tmp_path))) == dataclasses.asdict(
        JCK.cog_vae_config_from_json(str(tmp_path)))
    (tmp_path / "config.json").write_text(json.dumps({"num_attention_heads": 4, "attention_head_dim": 16,
                                                      "num_layers": 3, "max_text_seq_length": 10,
                                                      "in_channels": 32, "ofs_embed_dim": 512, "patch_size_t": None}))
    assert dataclasses.asdict(TCK.cog_config_from_json(str(tmp_path))) == dataclasses.asdict(
        JCK.cog_config_from_json(str(tmp_path)))
    assert TCK.cog_config_from_json(str(tmp_path / "absent")) is None


def test_convert_cog_dit_matches_jax():
    """diffusers' CogVideoXTransformer3DModel names (make_sd_cog): the port's
    convert_cog_dit equals JAX's carried over, bit for bit."""
    kw = dict(num_layers=2, hidden_size=64, heads_num=4, head_dim=16, text_len=10, text_dim=32, time_embed_dim=48,
              in_channels=32, ofs_embed=True)
    jcfg, tcfg = JCM.CogConfig(**kw), TCM.CogConfig(**kw)
    sd = make_sd_cog(jcfg)
    ref = cog_params_from_numpy(jax.tree.map(np.asarray, JCK.convert_cog_dit(sd, jcfg, dtype=jnp.float32)),
                                tcfg).state_dict()
    ours = TCK.convert_cog_dit({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert torch.equal(ours[k].reshape(ref[k].shape), ref[k]), k


@pytest.mark.parametrize("size", [(768, 1360), (240, 416), (300, 500)], ids=["cog_768p", "down_half", "down_odd"])
def test_bilinear_resize_matches_jax(size):
    """examples/1/image.jpg (480x832) to CogVideoX's 768x1360 and down (the
    antialiased triangle): within 1e-5 of jax.image.resize(.., "bilinear")."""
    img = load_image(os.path.join(ROOT, "examples", "1", "image.jpg"))
    ref = np.asarray(jax.image.resize(jnp.asarray(img.numpy()), (1, 3) + size, "bilinear"))
    out = resize_bilinear(img, *size).numpy()
    assert out.shape == ref.shape and np.abs(out - ref).max() <= 1e-5
