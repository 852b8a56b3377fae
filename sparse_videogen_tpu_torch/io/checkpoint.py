"""Reference checkpoints -> the port's state_dicts (counterpart of
sparse_videogen_tpu/io/checkpoint.py, Wan, UMT5 and CLIP vision parts).

  - Wan DiT (T2V and I2V): diffusers WanTransformer3DModel names or the
    wan_orig names -> models/wan/model.WanModel;
  - Wan VAE: wan_orig WanVAE_ names, the decoder side and conv2, and on
    request the encoder side and conv1 -> models/wan/vae.WanVAE;
  - UMT5: wan_orig T5Encoder names -> models/common/t5.T5Encoder;
  - CLIP ViT vision tower: HF CLIPVisionModel names (vision_model.*) or
    wan_orig's (visual.*, fused to_qkv) -> models/common/clip.CLIPVisionModel.

Torch keeps the checkpoints' layouts, (out, in) linears and (co, ci, k...)
convolutions, so a conversion renames and reshapes; the JAX package
transposes to channels-last, the port does not. Dtypes are left to the
module: load_state_dict casts into each parameter's dtype (bf16 linears,
f32 norms and time path), as the JAX conversion casts.
"""

from __future__ import annotations

import dataclasses
import json
import os
import re


def dataclass_from_json(path: str, cls):
    """Build `cls` from config.json in dir `path` (None if absent). Unknown
    keys are ignored; list values become tuples."""
    cj = os.path.join(path, "config.json")
    if not os.path.isfile(cj):
        return None
    with open(cj) as f:
        c = json.load(f)
    fields = {f.name for f in dataclasses.fields(cls)}
    return cls(**{k: (tuple(v) if isinstance(v, list) else v) for k, v in c.items() if k in fields})


def wan_config_from_json(path: str):
    """A WanConfig from a checkpoint dir's config.json, in the wan_orig flat
    naming or the diffusers WanTransformer3DModel naming (None if absent)."""
    from sparse_videogen_tpu_torch.models.wan.model import WanConfig

    cj = os.path.join(path, "config.json")
    if not os.path.isfile(cj):
        return None
    with open(cj) as f:
        c = json.load(f)
    if "num_attention_heads" in c:  # diffusers naming
        heads = c["num_attention_heads"]
        dim = heads * c["attention_head_dim"]
        return WanConfig(
            model_type="i2v" if c.get("image_dim") else "t2v",
            patch_size=tuple(c.get("patch_size", (1, 2, 2))),
            text_len=c.get("text_len", 512),
            in_dim=c.get("in_channels", 16),
            dim=dim,
            ffn_dim=c.get("ffn_dim", dim * 4),
            freq_dim=c.get("freq_dim", 256),
            text_dim=c.get("text_dim", 4096),
            out_dim=c.get("out_channels", 16),
            num_heads=heads,
            num_layers=c.get("num_layers", 30),
            eps=c.get("eps", 1e-6),
            image_dim=c.get("image_dim") or 1280,
        )
    return dataclass_from_json(path, WanConfig)


# the DiT's names: port -> (wan_orig, diffusers); "{b}" is blocks.<i>
_WAN_NAMES = {
    "text_embedding.fc1": ("text_embedding.0", "condition_embedder.text_embedder.linear_1"),
    "text_embedding.fc2": ("text_embedding.2", "condition_embedder.text_embedder.linear_2"),
    "time_embedding.fc1": ("time_embedding.0", "condition_embedder.time_embedder.linear_1"),
    "time_embedding.fc2": ("time_embedding.2", "condition_embedder.time_embedder.linear_2"),
    "time_projection": ("time_projection.1", "condition_embedder.time_proj"),
    "head_out": ("head.head", "proj_out"),
    **{f"{{b}}.{att}.{nm}": (f"{{b}}.{att}.{nm}", f"{{b}}.attn{a}.to_{'out.0' if nm == 'o' else nm}")
       for a, att in ((1, "self_attn"), (2, "cross_attn")) for nm in "qkvo"},
    "{b}.ffn.fc1": ("{b}.ffn.0", "{b}.ffn.net.0.proj"),
    "{b}.ffn.fc2": ("{b}.ffn.2", "{b}.ffn.net.2"),
}
_WAN_VECTORS = {
    **{f"{{b}}.{att}.{nm}": (f"{{b}}.{att}.{nm}.weight", f"{{b}}.attn{a}.{nm}.weight")
       for a, att in ((1, "self_attn"), (2, "cross_attn")) for nm in ("norm_q", "norm_k")},
    "{b}.norm3.weight": ("{b}.norm3.weight", "{b}.norm2.weight"),
    "{b}.norm3.bias": ("{b}.norm3.bias", "{b}.norm2.bias"),
}
# I2V: the image branch of each block's cross-attention and the image embedding
_WAN_I2V_NAMES = {
    "{b}.cross_attn.k_img": ("{b}.cross_attn.k_img", "{b}.attn2.add_k_proj"),
    "{b}.cross_attn.v_img": ("{b}.cross_attn.v_img", "{b}.attn2.add_v_proj"),
    "img_emb.norm1": ("img_emb.proj.0", "condition_embedder.image_embedder.norm1"),
    "img_emb.fc1": ("img_emb.proj.1", "condition_embedder.image_embedder.ff.net.0.proj"),
    "img_emb.fc2": ("img_emb.proj.3", "condition_embedder.image_embedder.ff.net.2"),
    "img_emb.norm2": ("img_emb.proj.4", "condition_embedder.image_embedder.norm2"),
}
_WAN_I2V_VECTORS = {"{b}.cross_attn.norm_k_img": ("{b}.cross_attn.norm_k_img.weight", "{b}.attn2.norm_added_k.weight")}


def convert_wan_dit(sd: dict, cfg) -> dict:
    """diffusers or wan_orig Wan state dict (T2V, or I2V with the image
    branch) -> WanModel(cfg).state_dict()."""
    diffusers = any(k.startswith("condition_embedder") for k in sd)
    src = 1 if diffusers else 0
    names, vectors = dict(_WAN_NAMES), dict(_WAN_VECTORS)
    if any(k.startswith(("img_emb.", "condition_embedder.image_embedder.")) for k in sd):
        names.update(_WAN_I2V_NAMES)
        vectors.update(_WAN_I2V_VECTORS)
    out = {}
    pe = sd["patch_embedding.weight"]  # (dim, in, pt, ph, pw): a linear over (in, pt, ph, pw) patches
    out["patch_embedding.weight"] = pe.reshape(pe.shape[0], -1)
    out["patch_embedding.bias"] = sd["patch_embedding.bias"]
    out["head_modulation"] = sd["scale_shift_table" if diffusers else "head.modulation"].reshape(2, -1)
    blocks = [f"blocks.{i}" for i in range(cfg.num_layers)]
    for ours, pair in names.items():
        for b in blocks if "{b}" in ours else [None]:
            theirs = pair[src].format(b=b)
            for part in ("weight", "bias"):
                out[f"{ours.format(b=b)}.{part}"] = sd[f"{theirs}.{part}"]
    for ours, pair in vectors.items():
        for b in blocks:
            out[ours.format(b=b)] = sd[pair[src].format(b=b)]
    for b in blocks:
        out[f"{b}.modulation"] = sd[f"{b}.scale_shift_table" if diffusers else f"{b}.modulation"].reshape(6, -1)
    return out


def _wan_vae_module_names(sd: dict, prefix: str, ours: str, out: dict) -> None:
    """One residual block (norm1/conv1/norm2/conv2/shortcut) or attention
    block (norm/to_qkv/proj) of the reference at `prefix` -> ours."""
    if f"{prefix}.residual.0.gamma" in sd:
        out[f"{ours}.norm1"] = sd[f"{prefix}.residual.0.gamma"].reshape(-1)
        out[f"{ours}.norm2"] = sd[f"{prefix}.residual.3.gamma"].reshape(-1)
        convs = {"conv1": "residual.2", "conv2": "residual.6", "shortcut": "shortcut"}
    else:
        out[f"{ours}.norm"] = sd[f"{prefix}.norm.gamma"].reshape(-1)
        convs = {"to_qkv": "to_qkv", "proj": "proj"}
    for mine, theirs in convs.items():
        if f"{prefix}.{theirs}.weight" in sd:
            out[f"{ours}.{mine}.weight"] = sd[f"{prefix}.{theirs}.weight"]
            out[f"{ours}.{mine}.bias"] = sd[f"{prefix}.{theirs}.bias"]


def _wan_vae_tower(sd: dict, side: str, out: dict) -> None:
    """One side of the VAE: conv1, head, middle and the stages. The
    reference's <side>.downsamples.<i> / upsamples.<i> is one flat list; a
    resample entry ends a stage, as in the JAX conversion."""
    theirs_list, ours_list = ("downsamples", "down") if side == "encoder" else ("upsamples", "up")
    for key in (f"{side}.conv1", f"{side}.head.2"):
        ours = f"{side}.head_conv" if key.endswith("head.2") else key
        out[f"{ours}.weight"], out[f"{ours}.bias"] = sd[f"{key}.weight"], sd[f"{key}.bias"]
    out[f"{side}.head_norm"] = sd[f"{side}.head.0.gamma"].reshape(-1)
    for j in range(3):
        _wan_vae_module_names(sd, f"{side}.middle.{j}", f"{side}.middle.{j}", out)
    idxs = sorted({int(m.group(1)) for k in sd if (m := re.match(rf"{side}\.{theirs_list}\.(\d+)\.", k))})
    stage, block = 0, 0
    for i in idxs:
        kr = f"{side}.{theirs_list}.{i}"
        if f"{kr}.residual.0.gamma" in sd or f"{kr}.norm.gamma" in sd:
            _wan_vae_module_names(sd, kr, f"{side}.{ours_list}.{stage}.blocks.{block}", out)
            block += 1
            continue
        for mine, theirs in (("conv", "resample.1"), ("time_conv", "time_conv")):
            if f"{kr}.{theirs}.weight" in sd:
                out[f"{side}.{ours_list}.{stage}.resample.{mine}.weight"] = sd[f"{kr}.{theirs}.weight"]
                out[f"{side}.{ours_list}.{stage}.resample.{mine}.bias"] = sd[f"{kr}.{theirs}.bias"]
        stage, block = stage + 1, 0


def convert_wan_vae(sd: dict, cfg, encoder: bool = False) -> dict:
    """wan_orig WanVAE_ state dict -> WanVAE(cfg, encoder=encoder).state_dict():
    conv2 and the decoder, and with `encoder` conv1 and the encoder too."""
    out = {"conv2.weight": sd["conv2.weight"], "conv2.bias": sd["conv2.bias"]}
    _wan_vae_tower(sd, "decoder", out)
    if encoder:
        out["conv1.weight"], out["conv1.bias"] = sd["conv1.weight"], sd["conv1.bias"]
        _wan_vae_tower(sd, "encoder", out)
    return out


def convert_clip_vision(sd: dict, cfg) -> dict:
    """A CLIP ViT vision tower -> CLIPVisionModel(cfg).state_dict(), from HF
    CLIPVisionModel names (vision_model.*, the Wan I2V repo's
    image_encoder/) or wan_orig's XLMRobertaCLIP names (visual.*, whose
    fused to_qkv is split into q, k and v)."""
    out = {}

    def lin(ours, theirs):
        out[f"{ours}.weight"], out[f"{ours}.bias"] = sd[f"{theirs}.weight"], sd[f"{theirs}.bias"]

    if any(k.startswith("vision_model.") for k in sd):
        pre = "vision_model."
        pw = sd[f"{pre}embeddings.patch_embedding.weight"]
        out["patch_proj.weight"] = pw.reshape(pw.shape[0], -1)
        out["cls"] = sd[f"{pre}embeddings.class_embedding"].reshape(1, -1)
        out["pos"] = sd[f"{pre}embeddings.position_embedding.weight"]
        lin("pre_ln", f"{pre}pre_layrnorm")  # (sic) HF's attribute name
        lin("post_ln", f"{pre}post_layernorm")
        names = {"ln1": "layer_norm1", "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
                 "o": "self_attn.out_proj", "ln2": "layer_norm2", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
        for i in range(cfg.num_layers):
            for ours, theirs in names.items():
                lin(f"blocks.{i}.{ours}", f"{pre}encoder.layers.{i}.{theirs}")
        return out
    pw = sd["visual.patch_embedding.weight"]
    out["patch_proj.weight"] = pw.reshape(pw.shape[0], -1)
    out["cls"] = sd["visual.cls_embedding"].reshape(1, -1)
    out["pos"] = sd["visual.pos_embedding"].reshape(-1, pw.shape[0])
    lin("pre_ln", "visual.pre_norm")
    lin("post_ln", "visual.post_norm")
    names = {"ln1": "norm1", "ln2": "norm2", "o": "attn.proj", "fc1": "mlp.0", "fc2": "mlp.2"}
    for i in range(cfg.num_layers):
        b = f"visual.transformer.{i}"
        for ours, theirs in names.items():
            lin(f"blocks.{i}.{ours}", f"{b}.{theirs}")
        qkv_w, qkv_b = sd[f"{b}.attn.to_qkv.weight"], sd[f"{b}.attn.to_qkv.bias"]
        d = qkv_w.shape[1]
        for j, nm in enumerate("qkv"):
            out[f"blocks.{i}.{nm}.weight"] = qkv_w[j * d:(j + 1) * d]
            out[f"blocks.{i}.{nm}.bias"] = qkv_b[j * d:(j + 1) * d]
    return out


def convert_umt5(sd: dict, cfg) -> dict:
    """wan_orig T5Encoder (UMT5) state dict -> T5Encoder(cfg).state_dict()."""
    out = {"token_embedding": sd["token_embedding.weight"], "norm": sd["norm.weight"]}
    names = {"norm1": "norm1.weight", "q.weight": "attn.q.weight", "k.weight": "attn.k.weight",
             "v.weight": "attn.v.weight", "o.weight": "attn.o.weight",
             "rel_embedding": "pos_embedding.embedding.weight", "norm2": "norm2.weight",
             "gate.weight": "ffn.gate.0.weight", "fc1.weight": "ffn.fc1.weight", "fc2.weight": "ffn.fc2.weight"}
    for i in range(cfg.num_layers):
        for ours, theirs in names.items():
            out[f"blocks.{i}.{ours}"] = sd[f"blocks.{i}.{theirs}"]
    return out

