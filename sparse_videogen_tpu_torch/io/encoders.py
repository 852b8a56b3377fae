"""Prompt -> text states, and image -> CLIP features, from a local
checkpoint dir (counterpart of sparse_videogen_tpu/io/encoders.py). UMT5Encoder
tokenizes with whitespace cleaning, runs the UMT5 encoder, zeroes every
position past each prompt's real length, and hands the DiT a fixed (B,
text_len, dim) tensor. CLIPImageEncoder resizes pixels in [-1, 1] to
224x224 (the cubic rule of jax.image.resize), normalises them and returns
the penultimate hidden states of the ViT-H/14 vision tower (B, 257, 1280),
Wan I2V's clip_fea. HyVideoTextEncoders (HunyuanVideo T2V) and
LlavaImageTextEncoder (HunyuanVideo I2V with a Llava checkpoint) return
(states (B, text_len, 4096), mask (B, text_len), pooled (B, 768)): LLaMA-3
states of the templated prompt with the instruction prefix cropped, and
CLIP-L's pooled state of the raw prompt.

Layout under model_dir: umt5/, text_encoder/ or umt5-xxl/ holds the UMT5
safetensors in the reference's names (io/checkpoint.convert_umt5) and an
optional config.json; tokenizer.json or spiece.model sits in tokenizer/,
google/umt5-xxl/, google/ or model_dir itself (one subdir level searched);
image_encoder/ or clip/ holds the CLIP vision tower in HF's or wan_orig's
names (io/checkpoint.convert_clip_vision) and an optional config.json (HF's
CLIPVisionConfig keys, top level or under vision_config). HunyuanVideo:
text_encoder/ (or llm/, llava-llama-3-8b/; llava/ for Llava) holds the
LLaMA (or Llava) safetensors in HF's names, its tokenizer.json and
tokenizer_config.json and an optional config.json; text_encoder_2/ (or
clip/, clipL/) the CLIP text tower likewise.
"""

from __future__ import annotations

import os

import torch

import json

import numpy as np

from sparse_videogen_tpu_torch.io.tokenizer import HFTokenizerLite, T5TokenizerLite
from sparse_videogen_tpu_torch.models.common.clip import (CLIP_L_TEXT, CLIP_VIT_H_14, CLIPTextConfig, CLIPTextModel,
                                                          CLIPVisionConfig, CLIPVisionModel, clip_preprocess)
from sparse_videogen_tpu_torch.models.common.llama import LLAMA3_8B, LlamaConfig, LlamaModel
from sparse_videogen_tpu_torch.models.common.llava import LlavaModel, llava_encode
from sparse_videogen_tpu_torch.models.common.t5 import UMT5_XXL, T5Config, T5Encoder

# HF config.json size keys -> the configs' fields
_HF_LLAMA_KEYS = {"vocab_size": "vocab_size", "hidden_size": "dim", "intermediate_size": "ffn_dim",
                  "num_hidden_layers": "num_layers", "num_attention_heads": "num_heads",
                  "num_key_value_heads": "num_kv_heads", "rope_theta": "rope_theta", "rms_norm_eps": "eps"}
_HF_CLIP_TEXT_KEYS = {"vocab_size": "vocab_size", "hidden_size": "dim", "intermediate_size": "ffn_dim",
                      "num_hidden_layers": "num_layers", "num_attention_heads": "num_heads",
                      "max_position_embeddings": "max_positions", "layer_norm_eps": "eps"}


def _config_from_json(path: str, cls, hf_keys: dict):
    """`cls` from config.json in dir `path` (None if absent): the package's
    own names as the JAX package reads them (dataclass_from_json), then HF's
    names (hf_keys) over them where present, so an HF config.json gives its
    sizes instead of leaving the defaults in place."""
    import dataclasses

    from sparse_videogen_tpu_torch.io.checkpoint import dataclass_from_json

    cfg = dataclass_from_json(path, cls)
    if cfg is None:
        return None
    with open(os.path.join(path, "config.json")) as f:
        c = json.load(f)
    return dataclasses.replace(cfg, **{ours: c[theirs] for theirs, ours in hf_keys.items() if theirs in c})


def llama_config_from_json(path: str) -> LlamaConfig | None:
    """A LlamaConfig from config.json in the package's names or HF's
    LlamaConfig names (None if absent)."""
    return _config_from_json(path, LlamaConfig, _HF_LLAMA_KEYS)


def clip_text_config_from_json(path: str) -> CLIPTextConfig | None:
    """A CLIPTextConfig from config.json in the package's names or HF's
    CLIPTextConfig names (None if absent)."""
    return _config_from_json(path, CLIPTextConfig, _HF_CLIP_TEXT_KEYS)


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
        from sparse_videogen_tpu_torch.io.checkpoint import convert_umt5, t5_config_from_json
        from sparse_videogen_tpu_torch.io.safetensors import load_dir

        enc_dir = _find_subdir(model_dir, ["umt5", "text_encoder", "umt5-xxl"]) or model_dir
        if cfg is None:
            cfg = t5_config_from_json(enc_dir) or UMT5_XXL
        model = T5Encoder(cfg, dtype=dtype, device=device)
        model.load_state_dict(convert_umt5(load_dir(enc_dir), cfg))
        tok_dir = _find_subdir(model_dir, ["tokenizer", "google/umt5-xxl", "google"]) or model_dir
        return cls(model, T5TokenizerLite.from_dir(tok_dir), text_len=text_len)

    def __call__(self, texts) -> torch.Tensor:
        ids, mask = self.tokenizer(texts, seq_len=self.text_len)
        ctx = self.model(ids, mask)
        return ctx * torch.as_tensor(mask, device=ctx.device).to(ctx.dtype)[..., None]


class T5TextEncoder:
    """A T5 v1.0 or v1.1 encoder in HF's names: texts -> (B, text_len, dim)
    f32 states. CogVideoX hands the DiT the states as they come (T5 v1.1
    XXL, 226 tokens); Cosmos zeroes every position past each prompt's
    tokens (T5 v1.0 t5-11b, 512 tokens): `mask_output`."""

    def __init__(self, model: T5Encoder, tokenizer: T5TokenizerLite, text_len: int, mask_output: bool):
        self.model, self.tokenizer = model, tokenizer
        self.text_len, self.mask_output = text_len, mask_output

    @classmethod
    def from_dir(cls, model_dir: str, *, text_len: int, default_cfg: T5Config, mask_output: bool,
                 dtype=torch.bfloat16, device="cpu") -> "T5TextEncoder":
        """text_encoder/ under model_dir: HF's safetensors and config.json
        (either naming: io/checkpoint.t5_config_from_json; without it
        default_cfg); the tokenizer (spiece.model or tokenizer.json) in
        model_dir or one subdir below it, as the JAX CLIs search."""
        from sparse_videogen_tpu_torch.io.checkpoint import convert_t5_hf, t5_config_from_json
        from sparse_videogen_tpu_torch.io.safetensors import load_dir

        edir = os.path.join(model_dir, "text_encoder")
        cfg = t5_config_from_json(edir) or default_cfg
        model = T5Encoder(cfg, dtype=dtype, device=device)
        model.load_state_dict(convert_t5_hf(load_dir(edir), cfg))
        return cls(model, T5TokenizerLite.from_dir(model_dir), text_len, mask_output)

    def __call__(self, texts) -> torch.Tensor:
        ids, mask = self.tokenizer(texts, seq_len=self.text_len)
        ctx = self.model(ids, mask)
        if self.mask_output:
            ctx = ctx * torch.as_tensor(mask, device=ctx.device).to(ctx.dtype)[..., None]
        return ctx


def clip_config_from_json(path: str) -> CLIPVisionConfig | None:
    """A CLIPVisionConfig from HF's config.json in dir `path` (None if absent)."""
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


# ---------------------------------------------------------------------------
# HunyuanVideo: LLaMA-3 (template + crop_start) and CLIP-L pooled
# ---------------------------------------------------------------------------

# the reference's dit-llm-encode-video template (hyvideo_orig/constants.py)
PROMPT_TEMPLATE_ENCODE_VIDEO = (
    "<|start_header_id|>system<|end_header_id|>\n\nDescribe the video by detailing the following aspects: "
    "1. The main content and theme of the video."
    "2. The color, shape, size, texture, quantity, text, and spatial relationships of the objects."
    "3. Actions, events, behaviors temporal relationships, physical movement changes of the objects."
    "4. background environment, light, style and atmosphere."
    "5. camera angles, movements, and transitions used in the video:<|eot_id|>"
    "<|start_header_id|>user<|end_header_id|>\n\n{}<|eot_id|>"
)
CROP_START_VIDEO = 95
HYVIDEO_NEGATIVE_PROMPT = (
    "Aerial view, aerial view, overexposed, low quality, deformation, a poor "
    "composition, bad hands, bad teeth, bad eyes, bad limbs, distortion"
)
CLIP_TEXT_LEN = 77


def _clip_text_from_dir(model_dir: str, dtype, device):
    """text_encoder_2/ (or clip/, clipL/): the CLIP text tower and its tokenizer."""
    from sparse_videogen_tpu_torch.io.checkpoint import convert_clip_text
    from sparse_videogen_tpu_torch.io.safetensors import load_dir

    d = _find_subdir(model_dir, ["text_encoder_2", "clip", "clipL"]) or model_dir
    cfg = clip_text_config_from_json(d) or CLIP_L_TEXT
    clip = CLIPTextModel(cfg, dtype=dtype, device=device)
    clip.load_state_dict(convert_clip_text(load_dir(d), cfg))
    return clip, HFTokenizerLite.from_dir(d)


def _pooled(clip: CLIPTextModel, tok: HFTokenizerLite, prompts):
    ids, mask = tok(list(prompts), seq_len=CLIP_TEXT_LEN)
    return clip(ids, mask)[1]


class HyVideoTextEncoders:
    """prompts -> (states (B, text_len, dim), mask (B, text_len), pooled
    (B, 768)), as the reference's hyvideo text encoders:
      1. each prompt in the video template, tokenized to crop_start +
         text_len tokens (LLaMA-3's tokenizer);
      2. the LLaMA's active layers (hidden_states[-(skip + 1)], no final
         norm), the first crop_start instruction positions cropped, the
         states zeroed where the mask is 0;
      3. CLIP-L on the raw prompt (77 tokens), its pooled state."""

    def __init__(self, llama: LlamaModel, llama_tok: HFTokenizerLite, clip: CLIPTextModel,
                 clip_tok: HFTokenizerLite, *, text_len: int = 256, crop_start: int = CROP_START_VIDEO,
                 template: str = PROMPT_TEMPLATE_ENCODE_VIDEO):
        self.llama, self.llama_tok, self.clip, self.clip_tok = llama, llama_tok, clip, clip_tok
        self.text_len, self.crop_start, self.template = text_len, crop_start, template

    @classmethod
    def from_dir(cls, model_dir: str, *, dtype=torch.bfloat16, skip_layers: int = 2, device="cpu",
                 **kw) -> "HyVideoTextEncoders":
        from sparse_videogen_tpu_torch.io.checkpoint import convert_llama
        from sparse_videogen_tpu_torch.io.safetensors import load_dir

        ldir = _find_subdir(model_dir, ["text_encoder", "llm", "llava-llama-3-8b"]) or model_dir
        lcfg = llama_config_from_json(ldir) or LLAMA3_8B
        llama = LlamaModel(lcfg, n_layers=lcfg.num_layers - skip_layers, dtype=dtype, device=device)
        llama.load_state_dict(convert_llama(load_dir(ldir), lcfg, skip_layers=skip_layers))
        clip, ctok = _clip_text_from_dir(model_dir, dtype, device)
        return cls(llama, HFTokenizerLite.from_dir(ldir), clip, ctok, **kw)

    def __call__(self, prompts):
        ids, mask = self.llama_tok([self.template.format(p) for p in prompts], seq_len=self.crop_start + self.text_len)
        states = self.llama(ids, mask)[:, self.crop_start:]
        out_mask = torch.as_tensor(mask[:, self.crop_start:], device=states.device)
        states = states * out_mask[..., None].to(states.dtype)
        return states, out_mask, _pooled(self.clip, self.clip_tok, prompts)


# Llava's vision tower: CLIP ViT-L/14 at 336 pixels (576 patches), quick_gelu
CLIP_VIT_L_14_336 = CLIPVisionConfig(image_size=336, dim=1024, ffn_dim=4096, num_layers=24, num_heads=16,
                                     hidden_act="quick_gelu")


def llava_config_from_json(path: str) -> tuple[LlamaConfig, CLIPVisionConfig]:
    """(LLaMA, vision) configs of a Llava dir, as the JAX package reads them:
    config.json in the LlamaConfig's own names, else LLAMA3_8B; HF's
    text_config and vision_config override (the vision default is CLIP
    ViT-L/14-336 with quick_gelu, 24 layers)."""
    lcfg = llama_config_from_json(path) or LLAMA3_8B
    vcfg = CLIP_VIT_L_14_336
    cj = os.path.join(path, "config.json")
    if os.path.isfile(cj):
        with open(cj) as f:
            c = json.load(f)
        tc, vc = c.get("text_config", {}), c.get("vision_config", {})
        if tc:
            lcfg = LlamaConfig(vocab_size=tc.get("vocab_size", lcfg.vocab_size), dim=tc.get("hidden_size", lcfg.dim),
                               ffn_dim=tc.get("intermediate_size", lcfg.ffn_dim),
                               num_layers=tc.get("num_hidden_layers", lcfg.num_layers),
                               num_heads=tc.get("num_attention_heads", lcfg.num_heads),
                               num_kv_heads=tc.get("num_key_value_heads", lcfg.num_kv_heads),
                               rope_theta=tc.get("rope_theta", lcfg.rope_theta), eps=tc.get("rms_norm_eps", lcfg.eps))
        if vc:
            vcfg = CLIPVisionConfig(image_size=vc.get("image_size", 336), patch_size=vc.get("patch_size", 14),
                                    dim=vc.get("hidden_size", 1024), ffn_dim=vc.get("intermediate_size", 4096),
                                    num_layers=vc.get("num_hidden_layers", 24),
                                    num_heads=vc.get("num_attention_heads", 16),
                                    hidden_act=vc.get("hidden_act", "quick_gelu"))
    return lcfg, vcfg


class LlavaImageTextEncoder:
    """HunyuanVideo-I2V's prompt encoder: Llava (the CLIP vision tower, the
    projector, the LLaMA) with the image spliced into the template at its
    <image> placeholder. The community checkpoint's template and crop live
    in its pipeline config, so they are knobs here, as in the JAX package:
    `template` holds "<image>"; `crop_start` drops that many leading
    positions of the spliced sequence; `interleave` keeps every k-th image
    patch embedding. Returns (states, mask, pooled) as HyVideoTextEncoders.

    The id sequence is sized so that the spliced one is crop_start +
    text_len long: crop_start + text_len - n_img + 1 ids, n_img =
    ceil(grid^2 / interleave). Where that is negative (336 / 14 gives 576
    patches: at crop_start 0, interleave 1 and text_len 256 it is -319) the
    JAX encoder fails in np.zeros; this one raises ValueError naming the
    numbers before any work (ROADMAP.md section 3)."""

    def __init__(self, llava: LlavaModel, llama_tok: HFTokenizerLite, clip: CLIPTextModel,
                 clip_tok: HFTokenizerLite, *, text_len: int = 256, crop_start: int = 0,
                 template: str = "<image>\n{}", interleave: int = 1):
        if "<image>" not in template:
            raise ValueError(f"the Llava template {template!r} has no <image> placeholder")
        self.llava, self.llama_tok, self.clip, self.clip_tok = llava, llama_tok, clip, clip_tok
        self.text_len, self.crop_start, self.template, self.interleave = text_len, crop_start, template, interleave

    @classmethod
    def from_dir(cls, model_dir: str, *, dtype=torch.bfloat16, skip_layers: int = 2, device="cpu",
                 **kw) -> "LlavaImageTextEncoder":
        from sparse_videogen_tpu_torch.io.checkpoint import convert_llava
        from sparse_videogen_tpu_torch.io.safetensors import load_dir

        ldir = _find_subdir(model_dir, ["text_encoder", "llava", "llm"]) or model_dir
        lcfg, vcfg = llava_config_from_json(ldir)
        llava = LlavaModel(lcfg, vcfg, n_layers=lcfg.num_layers - skip_layers, dtype=dtype, device=device)
        llava.load_state_dict(convert_llava(load_dir(ldir), lcfg, vcfg, skip_layers=skip_layers))
        clip, ctok = _clip_text_from_dir(model_dir, dtype, device)
        return cls(llava, HFTokenizerLite.from_dir(ldir), clip, ctok, **kw)

    @property
    def n_image_tokens(self) -> int:
        return -(-self.llava.vision.cfg.grid ** 2 // self.interleave)

    def _tokenize_unpadded(self, text: str, cap: int = 512):
        ids, mask = self.llama_tok([text], seq_len=cap)
        return ids[0, :int(mask[0].sum())]

    def __call__(self, prompts, image):
        """prompts: one prompt; image (1, 3, H, W) in [-1, 1]."""
        if len(prompts) != 1:
            raise ValueError(f"one prompt a call (the image splice is static), got {len(prompts)}")
        n_img = self.n_image_tokens
        n_ids = self.crop_start + self.text_len - n_img + 1
        if n_ids < 0:
            raise ValueError(f"Llava: crop_start {self.crop_start} + text_len {self.text_len} - {n_img} image "
                             f"tokens ({self.llava.vision.cfg.grid}^2 patches / interleave {self.interleave}) + 1 = "
                             f"{n_ids} prompt ids; raise crop_start or interleave")
        pre, post = self.template.split("<image>")
        suffix = post.format(prompts[0]) if "{}" in post else post + prompts[0]
        pre_ids = self._tokenize_unpadded(pre) if pre else np.zeros((0,), np.int32)
        body = np.concatenate([pre_ids, np.zeros((1,), pre_ids.dtype), self._tokenize_unpadded(suffix)])
        n_real = min(len(body), n_ids)
        ids = np.zeros((1, n_ids), np.int32)
        ids[0, :n_real] = body[:n_real]
        mask = np.zeros((1, n_ids), np.int32)
        mask[0, :n_real] = 1
        dev = self.llava.llama.embed.device
        px = clip_preprocess(torch.as_tensor(image).to(dev), self.llava.vision.cfg.image_size)
        hidden, mask2 = llava_encode(self.llava, ids, mask, px, len(pre_ids), interleave=self.interleave)
        crop = slice(self.crop_start, self.crop_start + self.text_len)
        states, out_mask = hidden[:, crop], mask2[:, crop]
        return states * out_mask[..., None].to(states.dtype), out_mask, _pooled(self.clip, self.clip_tok, prompts)
