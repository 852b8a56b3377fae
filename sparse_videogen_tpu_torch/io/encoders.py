"""Prompt -> text states from a local checkpoint dir (counterpart of
sparse_videogen_tpu/io/encoders.py, its UMT5 part): tokenize with whitespace
cleaning, run the UMT5 encoder, zero every position past each prompt's real
length, and hand the DiT a fixed (B, text_len, dim) tensor.

Layout under model_dir: umt5/, text_encoder/ or umt5-xxl/ holds the UMT5
safetensors in the reference's names (io/checkpoint.convert_umt5) and an
optional config.json; tokenizer.json or spiece.model sits in tokenizer/,
google/umt5-xxl/, google/ or model_dir itself (one subdir level searched).
"""

from __future__ import annotations

import os

import torch

from sparse_videogen_tpu_torch.io.tokenizer import T5TokenizerLite
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
