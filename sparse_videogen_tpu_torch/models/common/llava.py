"""Llava, HunyuanVideo-I2V's prompt encoder (counterpart of
sparse_videogen_tpu/models/common/llava.py): the prompt template holds an
<image> placeholder whose one token is replaced by the projected CLIP
vision-patch embeddings before the LLaMA blocks run.

HF LlavaForConditionalGeneration's pieces:
  - vision tower: CLIPVisionModel, feature layer -2 (the penultimate
    states), the CLS token dropped (select strategy "default"), then every
    `interleave`-th patch kept (diffusers' image_embed_interleave);
  - projector: linear, exact GELU, linear into the LLaMA width, in the
    vision features' dtype (f32) with the weights cast to it;
  - language model: LlamaModel over the spliced embeddings (cast to the
    embedding's dtype).
The image position comes from the template, so the splice is a fixed
concatenation.

Parameter names: vision.*, projector.{fc1, fc2}, llama.* (the sub-models'
own; io/checkpoint.convert_llava maps HF's names onto these).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from sparse_videogen_tpu_torch.models.common import layers as L
from sparse_videogen_tpu_torch.models.common.clip import CLIPVisionConfig, CLIPVisionModel
from sparse_videogen_tpu_torch.models.common.llama import LlamaConfig, LlamaModel


class LlavaModel(nn.Module):
    """The vision tower (f32, as the JAX conversion loads it), the projector
    and the LLaMA (`n_layers` active blocks) in `dtype`; or, given `llama`,
    that LlamaModel (its own dtype and weights, kept by init_random)."""

    def __init__(self, llama_cfg: LlamaConfig, vision_cfg: CLIPVisionConfig, *, n_layers: int | None = None,
                 dtype=torch.bfloat16, device="cpu", llama: LlamaModel | None = None):
        super().__init__()
        self.vision = CLIPVisionModel(vision_cfg, dtype=torch.float32, device=device)
        self.projector = nn.ModuleDict({"fc1": nn.Linear(vision_cfg.dim, llama_cfg.dim, dtype=dtype, device=device),
                                        "fc2": nn.Linear(llama_cfg.dim, llama_cfg.dim, dtype=dtype, device=device)})
        self._own_llama = llama is None
        self.llama = LlamaModel(llama_cfg, n_layers=n_layers, dtype=dtype, device=device) if llama is None else llama
        self.requires_grad_(False)

    @torch.no_grad()
    def init_random(self, generator: torch.Generator):
        """The sub-models' own draws; the projector N(0, 1/d_in), zero biases."""
        self.vision.init_random(generator)
        for fc in self.projector.values():
            fc.weight.copy_(torch.randn(fc.weight.shape, generator=generator, device=fc.weight.device)
                            * fc.in_features**-0.5)
            fc.bias.zero_()
        if self._own_llama:
            self.llama.init_random(generator)
        return self


@torch.no_grad()
def project_image_features(model: LlavaModel, pixel_values, *, interleave: int = 1):
    """CLIP-normalized pixels (B, 3, H, W) -> (B, ceil(n_patches /
    interleave), llama dim) projected patch embeddings (f32)."""
    feats = model.vision(pixel_values.to(model.vision.pos.device).float(), penultimate=True)[:, 1:]
    if interleave > 1:
        feats = feats[:, ::interleave]
    h = F.gelu(L.linear(model.projector["fc1"], feats))
    return L.linear(model.projector["fc2"], h)


@torch.no_grad()
def llava_encode(model: LlavaModel, ids, mask, pixel_values, image_pos: int, *, interleave: int = 1):
    """Encode [ids[:image_pos], <image patches>, ids[image_pos + 1:]]: ids
    and mask (B, L) with ONE placeholder at `image_pos`. Returns (hidden
    states (B, L - 1 + n_img, dim), the spliced mask)."""
    llama = model.llama
    dev = llama.embed.device
    img = project_image_features(model, pixel_values, interleave=interleave)
    ids, mask = torch.as_tensor(ids, device=dev).long(), torch.as_tensor(mask, device=dev)
    tok = llama.embed[ids]
    embeds = torch.cat([tok[:, :image_pos], img.to(tok.dtype), tok[:, image_pos + 1:]], dim=1)
    img_mask = torch.ones(mask.shape[0], img.shape[1], dtype=mask.dtype, device=dev)
    mask2 = torch.cat([mask[:, :image_pos], img_mask, mask[:, image_pos + 1:]], dim=1)
    return llama(None, mask2, inputs_embeds=embeds), mask2
