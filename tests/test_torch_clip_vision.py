"""The CLIP vision tower (models/common/clip.py), the cubic resize
(models/common/resize.py), convert_clip_vision and CLIPImageEncoder of the
torch port against the JAX package's, on the same numpy weights and inputs;
tolerances are stated per test."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu.io import checkpoint as JCK
from sparse_videogen_tpu.io import encoders as JENC
from sparse_videogen_tpu.models.common import clip as JCLIP
from sparse_videogen_tpu_torch.io import checkpoint as TCK
from sparse_videogen_tpu_torch.io import encoders as TENC
from sparse_videogen_tpu_torch.io.from_jax import clip_vision_params_from_numpy
from sparse_videogen_tpu_torch.io.safetensors import save_file
from sparse_videogen_tpu_torch.models.common import clip as TCLIP
from sparse_videogen_tpu_torch.models.common.resize import resize_cubic

CFG_KW = dict(image_size=28, patch_size=14, dim=32, ffn_dim=64, num_layers=3, num_heads=4)
t = lambda a: torch.from_numpy(np.array(a))


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def hf_vision_sd(cfg_kw, seed=0) -> dict:
    """A CLIPVisionModel state dict in HF's names (vision_model.*), random."""
    rng = np.random.default_rng(seed)
    d, f, ps, n = cfg_kw["dim"], cfg_kw["ffn_dim"], cfg_kw["patch_size"], cfg_kw["num_layers"]
    r = lambda *s, scale=0.1: (scale * rng.standard_normal(s)).astype(np.float32)
    v = "vision_model."
    sd = {f"{v}embeddings.patch_embedding.weight": r(d, 3, ps, ps), f"{v}embeddings.class_embedding": r(d),
          f"{v}embeddings.position_embedding.weight": r(1 + (cfg_kw["image_size"] // ps) ** 2, d)}
    for ln in ("pre_layrnorm", "post_layernorm"):
        sd[f"{v}{ln}.weight"], sd[f"{v}{ln}.bias"] = 1 + r(d), r(d)
    for i in range(n):
        b = f"{v}encoder.layers.{i}"
        for nm in ("q_proj", "k_proj", "v_proj", "out_proj"):
            sd[f"{b}.self_attn.{nm}.weight"], sd[f"{b}.self_attn.{nm}.bias"] = r(d, d, scale=d**-0.5), r(d)
        for ln in ("layer_norm1", "layer_norm2"):
            sd[f"{b}.{ln}.weight"], sd[f"{b}.{ln}.bias"] = 1 + r(d), r(d)
        sd[f"{b}.mlp.fc1.weight"], sd[f"{b}.mlp.fc1.bias"] = r(f, d, scale=d**-0.5), r(f)
        sd[f"{b}.mlp.fc2.weight"], sd[f"{b}.mlp.fc2.bias"] = r(d, f, scale=f**-0.5), r(d)
    return sd


def wan_orig_vision_sd(sd: dict, n_layers: int) -> dict:
    """The same weights in wan_orig's names (visual.*, fused to_qkv)."""
    v = "vision_model."
    out = {"visual.patch_embedding.weight": sd[f"{v}embeddings.patch_embedding.weight"],
           "visual.cls_embedding": sd[f"{v}embeddings.class_embedding"].reshape(1, 1, -1),
           "visual.pos_embedding": sd[f"{v}embeddings.position_embedding.weight"][None]}
    for ours, hf in (("pre_norm", "pre_layrnorm"), ("post_norm", "post_layernorm")):
        out[f"visual.{ours}.weight"], out[f"visual.{ours}.bias"] = sd[f"{v}{hf}.weight"], sd[f"{v}{hf}.bias"]
    for i in range(n_layers):
        b, hb = f"visual.transformer.{i}", f"{v}encoder.layers.{i}"
        for part in ("weight", "bias"):
            out[f"{b}.attn.to_qkv.{part}"] = np.concatenate([sd[f"{hb}.self_attn.{n}_proj.{part}"] for n in "qkv"])
            out[f"{b}.attn.proj.{part}"] = sd[f"{hb}.self_attn.out_proj.{part}"]
            for ours, hf in (("norm1", "layer_norm1"), ("norm2", "layer_norm2")):
                out[f"{b}.{ours}.{part}"] = sd[f"{hb}.{hf}.{part}"]
            out[f"{b}.mlp.0.{part}"], out[f"{b}.mlp.2.{part}"] = sd[f"{hb}.mlp.fc1.{part}"], sd[f"{hb}.mlp.fc2.{part}"]
    return out


@pytest.mark.parametrize("act", ["gelu", "quick_gelu"])
def test_clip_vision_forward_matches_jax(act):
    """Penultimate (the I2V clip_fea) and last hidden states, f32: rel L2
    error <= 1e-5."""
    kw = dict(CFG_KW, hidden_act=act)
    jcfg, tcfg = JCLIP.CLIPVisionConfig(**kw), TCLIP.CLIPVisionConfig(**kw)
    sd = hf_vision_sd(kw)
    tree = jax.tree.map(np.asarray, JCK.convert_clip_vision(sd, jcfg))
    model = TCLIP.CLIPVisionModel(tcfg)
    model.load_state_dict(clip_vision_params_from_numpy(tree, tcfg))
    px = np.random.default_rng(1).standard_normal((2, 3, 28, 28)).astype(np.float32)
    for penultimate in (True, False):
        ref = JCLIP.clip_vision_forward(tree, jcfg, jnp.asarray(px), penultimate=penultimate)
        ours = TCLIP.clip_vision_forward(model, t(px), penultimate=penultimate)
        assert ours.shape == (2, 5, 32)
        assert rel_err(ours.numpy(), ref) <= 1e-5


@pytest.mark.parametrize("src,dst", [((480, 832), (224, 224)), ((480, 832), (720, 1264)), ((37, 53), (37, 53)),
                                     ((37, 53), (21, 90)), ((5, 7), (16, 3)), ((48, 80), (480, 816))])
def test_cubic_resize_matches_jax(src, dst):
    """jax.image.resize(..., "cubic"): down (antialiased), up, the same size
    and odd sizes; the largest difference <= 1e-5 (measured <= 2.1e-6)."""
    x = np.random.default_rng(0).uniform(-1, 1, (1, 3, *src)).astype(np.float32)
    ref = np.asarray(jax.image.resize(jnp.asarray(x), (1, 3, *dst), method="cubic"))
    ours = resize_cubic(t(x), *dst)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == ref.shape
    assert np.abs(ours.numpy() - ref).max() <= 1e-5


def test_convert_clip_vision_both_namings():
    """HF names and wan_orig's (fused to_qkv) give the same state_dict, equal
    to JAX's conversion after the layout change."""
    jcfg, tcfg = JCLIP.CLIPVisionConfig(**CFG_KW), TCLIP.CLIPVisionConfig(**CFG_KW)
    sd = hf_vision_sd(CFG_KW, seed=2)
    ref = clip_vision_params_from_numpy(jax.tree.map(np.asarray, JCK.convert_clip_vision(sd, jcfg)), tcfg)
    hf = TCK.convert_clip_vision({k: t(v) for k, v in sd.items()}, tcfg)
    orig = TCK.convert_clip_vision({k: t(v) for k, v in wan_orig_vision_sd(sd, CFG_KW["num_layers"]).items()}, tcfg)
    assert set(hf) == set(orig) == set(ref) == set(TCLIP.CLIPVisionModel(tcfg).state_dict())
    for k, v in ref.items():
        assert torch.equal(hf[k], v) and torch.equal(orig[k], v), k


def test_clip_image_encoder_matches_jax(tmp_path):
    """CLIPImageEncoder.from_dir on an image_encoder/ dir (HF names, HF's
    config.json with vision_config): pixels in [-1, 1] of a 48x80 image,
    resized to 28x28 and normalised, f32: rel L2 error <= 1e-5; a dir
    without config.json means ViT-H/14."""
    d = tmp_path / "image_encoder"
    d.mkdir()
    sd = hf_vision_sd(CFG_KW, seed=3)
    save_file({k: t(v) for k, v in sd.items()}, str(d / "model.safetensors"))
    with open(d / "config.json", "w") as f:
        json.dump({"vision_config": {"image_size": 28, "patch_size": 14, "hidden_size": 32, "intermediate_size": 64,
                                     "num_hidden_layers": 3, "num_attention_heads": 4, "hidden_act": "gelu"}}, f)
    px = np.random.default_rng(4).uniform(-1, 1, (1, 3, 48, 80)).astype(np.float32)
    jcfg = JCLIP.CLIPVisionConfig(**CFG_KW)
    ref = JENC.CLIPImageEncoder(JCK.convert_clip_vision(sd, jcfg), jcfg)(px)
    enc = TENC.CLIPImageEncoder.from_dir(str(tmp_path))
    ours = enc(t(px))
    assert ours.shape == (1, 5, 32) and enc.model.cfg == TCLIP.CLIPVisionConfig(**CFG_KW)
    assert rel_err(ours.numpy(), ref) <= 1e-5
    os.remove(d / "config.json")
    assert TENC.clip_config_from_json(str(d)) is None
