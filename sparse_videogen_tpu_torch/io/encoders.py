"""Prompt -> text states, and image -> CLIP features, from a local
checkpoint dir (counterpart of sparse_videogen_tpu/io/encoders.py, its UMT5
and CLIP image parts). UMT5Encoder tokenizes with whitespace cleaning, runs
the UMT5 encoder, zeroes every position past each prompt's real length, and
hands the DiT a fixed (B, text_len, dim) tensor. CLIPImageEncoder resizes
pixels in [-1, 1] to 224x224 (the cubic rule of jax.image.resize),
normalises them and returns the penultimate hidden states of the ViT-H/14
vision tower (B, 257, 1280), Wan I2V's clip_fea.

Layout under model_dir: umt5/, text_encoder/ or umt5-xxl/ holds the UMT5
safetensors in the reference's names (io/checkpoint.convert_umt5) and an
optional config.json; tokenizer.json or spiece.model sits in tokenizer/,
google/umt5-xxl/, google/ or model_dir itself (one subdir level searched);
image_encoder/ or clip/ holds the CLIP vision tower in HF's or wan_orig's
names (io/checkpoint.convert_clip_vision) and an optional config.json (HF's
CLIPVisionConfig keys, top level or under vision_config).
"""

from __future__ import annotations

import os

import torch

from sparse_videogen_tpu_torch.io.tokenizer import T5TokenizerLite
from sparse_videogen_tpu_torch.models.common.clip import (CLIP_VIT_H_14, CLIPVisionConfig, CLIPVisionModel,
                                                          clip_preprocess)
from sparse_videogen_tpu_torch.models.common.t5 import UMT5_XXL, T5Config, T5Encoder


def _find_subdir(model_dir: str, names) -> str | None:
    for n in names:
        d = os.path.join(model_dir, n)
        if os.path.isdir(d):
            return d
    return None


class UMT5Encoder:
    """texts -> (B, text_len, dim) encoder states (f32, zero past each
    prompt's tokens)."""

    def __init__(self, model: T5Encoder, tokenizer: T5TokenizerLite, text_len: int = 512):
        self.model = model
        self.tokenizer = tokenizer
        self.text_len = text_len

    @classmethod
    def from_dir(cls, model_dir: str, *, text_len: int = 512, dtype=torch.bfloat16, device="cpu",
                 cfg: T5Config | None = None) -> "UMT5Encoder":
        from sparse_videogen_tpu_torch.io.checkpoint import convert_umt5, dataclass_from_json
        from sparse_videogen_tpu_torch.io.safetensors import load_dir

        enc_dir = _find_subdir(model_dir, ["umt5", "text_encoder", "umt5-xxl"]) or model_dir
        if cfg is None:
            cfg = dataclass_from_json(enc_dir, T5Config) or UMT5_XXL
        model = T5Encoder(cfg, dtype=dtype, device=device)
        model.load_state_dict(convert_umt5(load_dir(enc_dir), cfg))
        tok_dir = _find_subdir(model_dir, ["tokenizer", "google/umt5-xxl", "google"]) or model_dir
        return cls(model, T5TokenizerLite.from_dir(tok_dir), text_len=text_len)

    def __call__(self, texts) -> torch.Tensor:
        ids, mask = self.tokenizer(texts, seq_len=self.text_len)
        ctx = self.model(ids, mask)
        return ctx * torch.as_tensor(mask, device=ctx.device).to(ctx.dtype)[..., None]


def clip_config_from_json(path: str) -> CLIPVisionConfig | None:
    """A CLIPVisionConfig from HF's config.json in dir `path` (None if absent)."""
    import json

    cj = os.path.join(path, "config.json")
    if not os.path.isfile(cj):
        return None
    with open(cj) as f:
        return clip_config_from_hf(json.load(f))


def clip_config_from_hf(c: dict) -> CLIPVisionConfig:
    """HF CLIPVisionConfig keys (at the top level or under vision_config)."""
    c = c.get("vision_config", c)
    return CLIPVisionConfig(image_size=c.get("image_size", 224), patch_size=c.get("patch_size", 14),
                            dim=c.get("hidden_size", 1280), ffn_dim=c.get("intermediate_size", 5120),
                            num_layers=c.get("num_hidden_layers", 32), num_heads=c.get("num_attention_heads", 16),
                            hidden_act=c.get("hidden_act", "gelu"))


class CLIPImageEncoder:
    """pixels (B, 3, H, W) in [-1, 1] -> the penultimate ViT-H/14 hidden
    states (B, 257, 1280), f32."""

    def __init__(self, model: CLIPVisionModel):
        self.model = model

    @classmethod
    def from_dir(cls, model_dir: str, *, dtype=torch.float32, device="cpu") -> "CLIPImageEncoder":
        from sparse_videogen_tpu_torch.io.checkpoint import convert_clip_vision
        from sparse_videogen_tpu_torch.io.safetensors import load_dir

        d = _find_subdir(model_dir, ["image_encoder", "clip"]) or model_dir
        cfg = clip_config_from_json(d) or CLIP_VIT_H_14
        model = CLIPVisionModel(cfg, dtype=dtype, device=device)
        model.load_state_dict(convert_clip_vision(load_dir(d), cfg))
        return cls(model)

    def __call__(self, pixels) -> torch.Tensor:
        x = clip_preprocess(pixels.to(self.model.pos.device), self.model.cfg.image_size)
        return self.model(x, penultimate=True)
