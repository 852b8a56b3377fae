"""Reference checkpoints -> the port's state_dicts (counterpart of
sparse_videogen_tpu/io/checkpoint.py: its Wan, UMT5, CLIP and HunyuanVideo
parts).

  - Wan DiT (T2V and I2V): diffusers WanTransformer3DModel names or the
    wan_orig names -> models/wan/model.WanModel;
  - Wan VAE: wan_orig WanVAE_ names, the decoder side and conv2, and on
    request the encoder side and conv1 -> models/wan/vae.WanVAE;
  - UMT5: wan_orig T5Encoder names -> models/common/t5.T5Encoder;
  - CLIP ViT vision tower: HF CLIPVisionModel names (vision_model.*) or
    wan_orig's (visual.*, fused to_qkv) -> models/common/clip.CLIPVisionModel;
  - HunyuanVideo: the DiT in hyvideo_orig names (fused q|k|v) ->
    models/hyvideo/model.HyVideoModel; the causal-3D VAE (CausalConv3d's
    `.conv`, diffusers' attention names) -> models/hyvideo/vae.HyVideoVAE;
    HF LlamaModel (the last skip layers dropped) -> models/common/llama;
    HF CLIPTextModel -> models/common/clip.CLIPTextModel; HF Llava in either
    naming generation -> models/common/llava.LlavaModel;
  - the prompt extender's causal LM: HF Qwen2ForCausalLM / LlamaForCausalLM
    -> models/common/llama.LlamaModel(lm=True) (convert_qwen_lm), and the
    JAX package's converted pytrees on disk (its save_pytree layout,
    params.safetensors and structure.json in one directory: load_pytree).

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



def convert_hyvideo_dit(sd: dict, cfg) -> dict:
    """HYVideoDiffusionTransformer state dict (hyvideo_orig names: double and
    single blocks with fused q|k|v, the token refiner txt_in, the embedders)
    -> HyVideoModel(cfg).state_dict()."""
    out = {}

    def lin(ours, theirs):
        for part in ("weight", "bias"):
            out[f"{ours}.{part}"] = sd[f"{theirs}.{part}"]

    pe = sd["img_in.proj.weight"]  # (hidden, C, pt, ph, pw): a linear over (C, pt, ph, pw) patches
    out["img_in.weight"], out["img_in.bias"] = pe.reshape(pe.shape[0], -1), sd["img_in.proj.bias"]
    mlps = {"time_in": ("time_in.mlp.0", "time_in.mlp.2"), "vector_in": ("vector_in.in_layer", "vector_in.out_layer"),
            "txt_in.t_embedder": ("txt_in.t_embedder.mlp.0", "txt_in.t_embedder.mlp.2"),
            "txt_in.c_embedder": ("txt_in.c_embedder.linear_1", "txt_in.c_embedder.linear_2")}
    if "guidance_in.mlp.0.weight" in sd:
        mlps["guidance_in"] = ("guidance_in.mlp.0", "guidance_in.mlp.2")
    for ours, (fc1, fc2) in mlps.items():
        lin(f"{ours}.fc1", fc1)
        lin(f"{ours}.fc2", fc2)
    lin("txt_in.input_embedder", "txt_in.input_embedder")
    for i in range(cfg.refiner_depth):
        b = f"txt_in.individual_token_refiner.blocks.{i}"
        for ours, theirs in (("norm1", "norm1"), ("qkv", "self_attn_qkv"), ("proj", "self_attn_proj"),
                             ("norm2", "norm2"), ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2"),
                             ("adaln", "adaLN_modulation.1")):
            lin(f"txt_in.blocks.{i}.{ours}", f"{b}.{theirs}")
    for i in range(cfg.mm_double_blocks_depth):
        b = f"double_blocks.{i}"
        for s in ("img", "txt"):
            for ours, theirs in (("mod", "mod.linear"), ("qkv", "attn_qkv"), ("proj", "attn_proj"),
                                 ("mlp.fc1", "mlp.fc1"), ("mlp.fc2", "mlp.fc2")):
                lin(f"{b}.{s}_{ours}", f"{b}.{s}_{theirs}")
            for nm in ("q", "k"):
                out[f"{b}.{s}_{nm}_norm"] = sd[f"{b}.{s}_attn_{nm}_norm.weight"]
    for i in range(cfg.mm_single_blocks_depth):
        b = f"single_blocks.{i}"
        for ours, theirs in (("modulation", "modulation.linear"), ("linear1", "linear1"), ("linear2", "linear2")):
            lin(f"{b}.{ours}", f"{b}.{theirs}")
        for nm in ("q_norm", "k_norm"):
            out[f"{b}.{nm}"] = sd[f"{b}.{nm}.weight"]
    lin("final_adaln", "final_layer.adaLN_modulation.1")
    lin("final_linear", "final_layer.linear")
    return out


def convert_hyvideo_vae(sd: dict, cfg) -> dict:
    """AutoencoderKLCausal3D state dict (hyvideo_orig's vae: a CausalConv3d
    wraps its Conv3d as `.conv`; diffusers' Attention to_q / to_k / to_v /
    to_out.0 / group_norm) -> HyVideoVAE(cfg).state_dict()."""
    out = {}

    def put(ours, theirs):
        for part in ("weight", "bias"):
            out[f"{ours}.{part}"] = sd[f"{theirs}.{part}"]

    def res(ours, theirs):
        for nm in ("norm1", "norm2"):
            put(f"{ours}.{nm}", f"{theirs}.{nm}")
        for nm in ("conv1", "conv2"):
            put(f"{ours}.{nm}", f"{theirs}.{nm}.conv")
        if f"{theirs}.conv_shortcut.conv.weight" in sd:
            put(f"{ours}.shortcut", f"{theirs}.conv_shortcut.conv")

    for side, blocks, sampler, n_res in (("encoder", "down", "downsamplers", cfg.layers_per_block),
                                         ("decoder", "up", "upsamplers", cfg.layers_per_block + 1)):
        put(f"{side}.conv_in", f"{side}.conv_in.conv")
        put(f"{side}.norm_out", f"{side}.conv_norm_out")
        put(f"{side}.conv_out", f"{side}.conv_out.conv")
        mid = f"{side}.mid_block"
        res(f"{side}.mid.res0", f"{mid}.resnets.0")
        res(f"{side}.mid.res1", f"{mid}.resnets.1")
        for ours, theirs in (("norm", "group_norm"), ("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("o", "to_out.0")):
            put(f"{side}.mid.attn.{ours}", f"{mid}.attentions.0.{theirs}")
        resample = "ds" if side == "encoder" else "us"
        for i in range(cfg.num_blocks):
            b = f"{side}.{blocks}_blocks.{i}"
            for j in range(n_res):
                res(f"{side}.{blocks}.{i}.res.{j}", f"{b}.resnets.{j}")
            if f"{b}.{sampler}.0.conv.conv.weight" in sd:
                put(f"{side}.{blocks}.{i}.{resample}", f"{b}.{sampler}.0.conv.conv")
    put("quant_conv", "quant_conv")
    put("post_quant_conv", "post_quant_conv")
    return out


def convert_llama(sd: dict, cfg, *, skip_layers: int = 2) -> dict:
    """HF LlamaModel / LlamaForCausalLM state dict (with or without the
    `model.` prefix) -> LlamaModel(cfg, n_layers=num_layers -
    skip_layers).state_dict(): HunyuanVideo reads hidden_states[-(skip +
    1)], so the last skip_layers layers and the final norm are dropped."""
    pre = "model." if any(k.startswith("model.") for k in sd) else ""
    out = {"embed": sd[f"{pre}embed_tokens.weight"]}
    names = {"ln1": "input_layernorm.weight", "q.weight": "self_attn.q_proj.weight",
             "k.weight": "self_attn.k_proj.weight", "v.weight": "self_attn.v_proj.weight",
             "o.weight": "self_attn.o_proj.weight", "ln2": "post_attention_layernorm.weight",
             "gate.weight": "mlp.gate_proj.weight", "up.weight": "mlp.up_proj.weight",
             "down.weight": "mlp.down_proj.weight"}
    for i in range(cfg.num_layers - skip_layers):
        for ours, theirs in names.items():
            out[f"blocks.{i}.{ours}"] = sd[f"{pre}layers.{i}.{theirs}"]
    return out


def convert_qwen_lm(sd: dict, cfg) -> dict:
    """HF Qwen2ForCausalLM / LlamaForCausalLM state dict (with or without
    the `model.` prefix) -> LlamaModel(cfg, lm=True, qkv_bias=..., tied=...)
    .state_dict(): every layer (convert_llama with none skipped), the q / k
    / v biases where the checkpoint has them (Qwen2's), the final norm, and
    `lm_head` unless the checkpoint has none (tied to the embedding)."""
    out = convert_llama(sd, cfg, skip_layers=0)
    pre = "model." if any(k.startswith("model.") for k in sd) else ""
    for i in range(cfg.num_layers):
        for nm in ("q", "k", "v"):
            key = f"{pre}layers.{i}.self_attn.{nm}_proj.bias"
            if key in sd:
                out[f"blocks.{i}.{nm}.bias"] = sd[key]
    out["final_norm"] = sd[f"{pre}norm.weight"]
    if "lm_head.weight" in sd:
        out["lm_head"] = sd["lm_head.weight"]
    return out


def load_pytree(path: str, device="cpu"):
    """Read the JAX package's save_pytree layout: directory `path` with
    params.safetensors and structure.json -> the pytree (dicts and lists)
    with torch leaves in their stored dtypes. The JAX prompt extender saves
    into, and loads from, a directory named params.safetensors inside its
    model_dir (utils/prompt_extend.py)."""
    from sparse_videogen_tpu_torch.io.safetensors import load_file

    with open(os.path.join(path, "structure.json")) as f:
        structure = json.load(f)
    leaves = load_file(os.path.join(path, "params.safetensors"), device=device)

    def rebuild(node, prefix):
        if node is None:
            return leaves["/".join(prefix)]
        if "d" in node:
            return {k: rebuild(v, prefix + (k,)) for k, v in node["d"].items()}
        return [rebuild(v, prefix + (str(i),)) for i, v in enumerate(node["l"])]

    return rebuild(structure, ())


def convert_clip_text(sd: dict, cfg) -> dict:
    """HF CLIPTextModel state dict (with or without `text_model.`) ->
    CLIPTextModel(cfg).state_dict()."""
    pre = "text_model." if any(k.startswith("text_model.") for k in sd) else ""
    out = {"token_embedding": sd[f"{pre}embeddings.token_embedding.weight"],
           "position_embedding": sd[f"{pre}embeddings.position_embedding.weight"],
           "final_ln.weight": sd[f"{pre}final_layer_norm.weight"], "final_ln.bias": sd[f"{pre}final_layer_norm.bias"]}
    names = {"ln1": "layer_norm1", "q": "self_attn.q_proj", "k": "self_attn.k_proj", "v": "self_attn.v_proj",
             "o": "self_attn.out_proj", "ln2": "layer_norm2", "fc1": "mlp.fc1", "fc2": "mlp.fc2"}
    for i in range(cfg.num_layers):
        for ours, theirs in names.items():
            for part in ("weight", "bias"):
                out[f"blocks.{i}.{ours}.{part}"] = sd[f"{pre}encoder.layers.{i}.{theirs}.{part}"]
    return out


def convert_llava(sd: dict, llama_cfg, vision_cfg, *, skip_layers: int = 2) -> dict:
    """HF LlavaForConditionalGeneration state dict -> LlavaModel(...).state_dict(),
    in either naming generation: model.vision_tower / model.language_model /
    model.multi_modal_projector (transformers >= 4.52), or vision_tower /
    language_model.model / multi_modal_projector."""
    new_style = any(k.startswith("model.vision_tower.") for k in sd)
    vt = "model.vision_tower." if new_style else "vision_tower."
    lm = "model.language_model." if new_style else "language_model.model."
    proj = "model.multi_modal_projector." if new_style else "multi_modal_projector."
    sub = lambda pre: {k[len(pre):]: v for k, v in sd.items() if k.startswith(pre)}
    out = {f"vision.{k}": v for k, v in convert_clip_vision(sub(vt), vision_cfg).items()}
    out.update({f"llama.{k}": v for k, v in convert_llama(sub(lm), llama_cfg, skip_layers=skip_layers).items()})
    for ours, theirs in (("fc1", "linear_1"), ("fc2", "linear_2")):
        for part in ("weight", "bias"):
            out[f"projector.{ours}.{part}"] = sd[f"{proj}{theirs}.{part}"]
    return out


# ---------------------------------------------------------------------------
# T5 (HF names), CogVideoX, Cosmos
# ---------------------------------------------------------------------------


def _read_json(path: str):
    cj = os.path.join(path, "config.json")
    if not os.path.isfile(cj):
        return None
    with open(cj) as f:
        return json.load(f)


def t5_config_from_json(path: str):
    """A T5Config from config.json in dir `path` (None if absent), in the
    package's own names or in HF's T5Config / UMT5Config names
    (models/common/t5.t5_config_from_dict)."""
    from sparse_videogen_tpu_torch.models.common.t5 import t5_config_from_dict

    c = _read_json(path)
    return None if c is None else t5_config_from_dict(c)


def convert_t5_hf(sd: dict, cfg) -> dict:
    """HF T5EncoderModel (or T5ForConditionalGeneration) state dict ->
    T5Encoder(cfg).state_dict(): T5 v1.0 (DenseReluDense.wi) or v1.1 / UMT5
    (wi_0 the gate, wi_1 fc1); with cfg.shared_rel_bias block 0's relative
    bias is the encoder's, otherwise each block's own."""
    pre = "encoder." if any(k.startswith("encoder.") for k in sd) else ""
    embed = "shared.weight" if "shared.weight" in sd else f"{pre}embed_tokens.weight"
    out = {"token_embedding": sd[embed], "norm": sd[f"{pre}final_layer_norm.weight"]}
    rel = "layer.0.SelfAttention.relative_attention_bias.weight"
    if cfg.shared_rel_bias:
        out["rel_embedding"] = sd[f"{pre}block.0.{rel}"]
    for i in range(cfg.num_layers):
        b, o = f"{pre}block.{i}", f"blocks.{i}"
        out[f"{o}.norm1"] = sd[f"{b}.layer.0.layer_norm.weight"]
        out[f"{o}.norm2"] = sd[f"{b}.layer.1.layer_norm.weight"]
        for nm in "qkvo":
            out[f"{o}.{nm}.weight"] = sd[f"{b}.layer.0.SelfAttention.{nm}.weight"]
        ff = f"{b}.layer.1.DenseReluDense"
        out[f"{o}.fc2.weight"] = sd[f"{ff}.wo.weight"]
        if f"{ff}.wi.weight" in sd:
            out[f"{o}.fc1.weight"] = sd[f"{ff}.wi.weight"]
        else:
            out[f"{o}.gate.weight"], out[f"{o}.fc1.weight"] = sd[f"{ff}.wi_0.weight"], sd[f"{ff}.wi_1.weight"]
        if not cfg.shared_rel_bias:
            out[f"{o}.rel_embedding"] = sd[f"{b}.{rel}"]
    return out


def _put(out, sd, ours, theirs, parts=("weight", "bias")):
    for part in parts:
        if f"{theirs}.{part}" in sd:
            out[f"{ours}.{part}"] = sd[f"{theirs}.{part}"]


def cog_config_from_json(path: str):
    """A CogConfig from diffusers' CogVideoXTransformer3DModel config.json
    (None if absent), as the JAX package reads it."""
    from sparse_videogen_tpu_torch.models.cog.model import CogConfig

    c = _read_json(path)
    if c is None:
        return None
    heads, hd = c.get("num_attention_heads", 48), c.get("attention_head_dim", 64)
    return CogConfig(num_layers=c.get("num_layers", 42), hidden_size=heads * hd, heads_num=heads, head_dim=hd,
                     text_len=c.get("max_text_seq_length", 226), text_dim=c.get("text_embed_dim", 4096),
                     in_channels=c.get("in_channels", 16), out_channels=c.get("out_channels", 16),
                     patch_size=c.get("patch_size", 2), patch_size_t=c.get("patch_size_t") or 2,
                     time_embed_dim=c.get("time_embed_dim", 512), ofs_embed=c.get("ofs_embed_dim") is not None,
                     eps=c.get("norm_eps", 1e-5))


def convert_cog_dit(sd: dict, cfg) -> dict:
    """diffusers CogVideoXTransformer3DModel state dict -> CogModel(cfg).
    state_dict(). v1.5's patch_embed.proj is a Linear; v1.0's Conv2d (kernel
    = stride) flattens to the same matmul."""
    out = {}
    for ours, theirs in (("time_emb.fc1", "time_embedding.linear_1"), ("time_emb.fc2", "time_embedding.linear_2"),
                         ("text_proj", "patch_embed.text_proj"), ("norm_final", "norm_final"),
                         ("norm_out", "norm_out.norm"), ("norm_out_lin", "norm_out.linear"), ("proj_out", "proj_out")):
        _put(out, sd, ours, theirs)
    if "ofs_embedding.linear_1.weight" in sd:
        _put(out, sd, "ofs_emb.fc1", "ofs_embedding.linear_1")
        _put(out, sd, "ofs_emb.fc2", "ofs_embedding.linear_2")
    pw = sd["patch_embed.proj.weight"]
    out["patch_proj.weight"], out["patch_proj.bias"] = pw.reshape(pw.shape[0], -1), sd["patch_embed.proj.bias"]
    names = {"norm1.lin": "norm1.linear", "norm1.norm": "norm1.norm", "norm2.lin": "norm2.linear",
             "norm2.norm": "norm2.norm", "attn.q": "attn1.to_q", "attn.k": "attn1.to_k", "attn.v": "attn1.to_v",
             "attn.o": "attn1.to_out.0", "attn.norm_q": "attn1.norm_q", "attn.norm_k": "attn1.norm_k",
             "ffn.fc1": "ff.net.0.proj", "ffn.fc2": "ff.net.2"}
    for i in range(cfg.num_layers):
        for ours, theirs in names.items():
            _put(out, sd, f"blocks.{i}.{ours}", f"transformer_blocks.{i}.{theirs}")
    return out


def cog_vae_config_from_json(path: str):
    """A CogVAEConfig from diffusers' AutoencoderKLCogVideoX config.json
    (None if absent), as the JAX package reads it (invert_scale_latents
    False when the key is missing)."""
    from sparse_videogen_tpu_torch.models.cog.vae import CogVAEConfig

    c = _read_json(path)
    if c is None:
        return None
    return CogVAEConfig(in_channels=c.get("in_channels", 3), out_channels=c.get("out_channels", 3),
                        block_out_channels=tuple(c.get("block_out_channels", (128, 256, 256, 512))),
                        layers_per_block=c.get("layers_per_block", 3), latent_channels=c.get("latent_channels", 16),
                        norm_num_groups=c.get("norm_num_groups", 32), scaling_factor=c.get("scaling_factor", 0.7),
                        invert_scale_latents=c.get("invert_scale_latents", False),
                        temporal_compression=c.get("temporal_compression_ratio", 4))


def convert_cog_vae(sd: dict, cfg) -> dict:
    """diffusers AutoencoderKLCogVideoX state dict -> CogVAE(cfg).state_dict()
    (a CogVideoXCausalConv3d wraps its Conv3d as `.conv`; shortcuts are plain
    1x1x1 Conv3d; decoder norms are CogVideoXSpatialNorm3D: norm_layer and
    the causal conv_y / conv_b; the resamplers per-frame Conv2d)."""
    out = {}

    def norm(ours, theirs, spatial):
        if spatial:
            _put(out, sd, f"{ours}.norm", f"{theirs}.norm_layer")
            _put(out, sd, f"{ours}.conv_y", f"{theirs}.conv_y.conv")
            _put(out, sd, f"{ours}.conv_b", f"{theirs}.conv_b.conv")
        else:
            _put(out, sd, ours, theirs)

    def res(ours, theirs, spatial):
        for nm in ("norm1", "norm2"):
            norm(f"{ours}.{nm}", f"{theirs}.{nm}", spatial)
        for nm in ("conv1", "conv2"):
            _put(out, sd, f"{ours}.{nm}", f"{theirs}.{nm}.conv")
        _put(out, sd, f"{ours}.shortcut", f"{theirs}.conv_shortcut")

    for side, blocks, n_res, spatial in (("encoder", "down", cfg.layers_per_block, False),
                                         ("decoder", "up", cfg.layers_per_block + 1, True)):
        _put(out, sd, f"{side}.conv_in", f"{side}.conv_in.conv")
        _put(out, sd, f"{side}.conv_out", f"{side}.conv_out.conv")
        norm(f"{side}.norm_out", f"{side}.norm_out", spatial)
        for j in range(2):
            res(f"{side}.mid.res.{j}", f"{side}.mid_block.resnets.{j}", spatial)
        sampler, name = ("downsamplers", "ds") if side == "encoder" else ("upsamplers", "us")
        for i in range(cfg.num_blocks):
            b = f"{side}.{blocks}_blocks.{i}"
            for j in range(n_res):
                res(f"{side}.{blocks}.{i}.res.{j}", f"{b}.resnets.{j}", spatial)
            _put(out, sd, f"{side}.{blocks}.{i}.{name}.conv", f"{b}.{sampler}.0.conv")
    return out


def convert_cosmos_dit(sd: dict, cfg) -> dict:
    """diffusers CosmosTransformer3DModel state dict -> CosmosModel(cfg).
    state_dict()."""
    out = {"time_embed.norm": sd["time_embed.norm.weight"]}
    for ours, theirs in (("patch_embed", "patch_embed.proj"), ("time_embed.t_fc1", "time_embed.t_embedder.linear_1"),
                         ("time_embed.t_fc2", "time_embed.t_embedder.linear_2"), ("norm_out.fc1", "norm_out.linear_1"),
                         ("norm_out.fc2", "norm_out.linear_2"), ("proj_out", "proj_out")):
        _put(out, sd, ours, theirs)
    for i in range(cfg.num_layers):
        b, o = f"transformer_blocks.{i}", f"blocks.{i}"
        for nm in ("norm1", "norm2", "norm3"):
            _put(out, sd, f"{o}.{nm}.fc1", f"{b}.{nm}.linear_1")
            _put(out, sd, f"{o}.{nm}.fc2", f"{b}.{nm}.linear_2")
        for a in ("attn1", "attn2"):
            for ours, theirs in (("q", "to_q"), ("k", "to_k"), ("v", "to_v"), ("o", "to_out.0")):
                _put(out, sd, f"{o}.{a}.{ours}", f"{b}.{a}.{theirs}")
            for nm in ("norm_q", "norm_k"):
                out[f"{o}.{a}.{nm}"] = sd[f"{b}.{a}.{nm}.weight"]
        _put(out, sd, f"{o}.ff1", f"{b}.ff.net.0.proj")
        _put(out, sd, f"{o}.ff2", f"{b}.ff.net.2")
    if "learnable_pos_embed.pos_emb_t" in sd:
        for ax in "thw":
            out[f"pos_embed.{ax}"] = sd[f"learnable_pos_embed.pos_emb_{ax}"]
    return out


def convert_cosmos_vae(sd: dict, cfg) -> dict:
    """The Cosmos tokenizer (CV8x8x8) state dict -> CosmosVAE(cfg).state_dict():
    Cosmos-Tokenizer's names (encoder.down.<i>.block.<j>, mid.block_1 /
    attn_1 / attn_2 / block_2, a CausalConv3d's conv as `.conv3d`) or
    diffusers-style spellings, as the JAX package accepts them; a missing
    module raises KeyError naming the candidates and some of the keys."""

    def pick(*cands):
        for c in cands:
            if f"{c}.weight" in sd:
                return c
        raise KeyError(f"cosmos vae: none of {cands} in checkpoint; have e.g. {sorted(sd)[:12]}")

    out = {}

    def conv(ours, *cands):
        _put(out, sd, ours, pick(*[f"{c}{s}" for c in cands for s in (".conv3d", ".conv", "")]))

    def mat(ours, key):
        """A 1x1x1 conv, 1x1 conv or linear -> a Linear (co, ci)."""
        w = sd[f"{key}.weight"]
        out[f"{ours}.weight"], out[f"{ours}.bias"] = w.reshape(w.shape[0], w.shape[1]), sd[f"{key}.bias"]

    def res(ours, p, p_alt):
        for nm in ("norm1", "norm2"):
            _put(out, sd, f"{ours}.{nm}", pick(f"{p}.{nm}", f"{p_alt}.{nm}"))
        for nm in ("conv1", "conv2"):
            conv(f"{ours}.{nm}", f"{p}.{nm}", f"{p_alt}.{nm}")
        for sc in (f"{p}.nin_shortcut", f"{p}.conv_shortcut", f"{p_alt}.conv_shortcut"):
            for suf in (".conv3d", ""):
                if f"{sc}{suf}.weight" in sd:
                    mat(f"{ours}.shortcut", f"{sc}{suf}")
                    return

    def attn(ours, p):
        _put(out, sd, f"{ours}.norm", pick(f"{p}.norm"))
        for mine, cands in (("q", ("q", "to_q")), ("k", ("k", "to_k")), ("v", ("v", "to_v")),
                            ("o", ("proj_out", "to_out.0"))):
            mat(f"{ours}.{mine}", pick(*[f"{p}.{c}" for c in cands]))

    def mid(ours, p):
        tp = next((c for c in (f"{p}.attn_2", f"{p}.temporal_attn_1") if f"{c}.norm.weight" in sd), None)
        if tp is None:
            raise KeyError(f"cosmos vae: no temporal attention under {p} (tried attn_2/temporal_attn_1)")
        res(f"{ours}.res1", f"{p}.block_1", f"{p}.resnets.0")
        attn(f"{ours}.attn_s", f"{p}.attn_1")
        attn(f"{ours}.attn_t", tp)
        res(f"{ours}.res2", f"{p}.block_2", f"{p}.resnets.1")

    n = len(cfg.channels_mult)
    for i in range(n):
        for j in range(cfg.num_res_blocks):
            res(f"encoder.levels.{i}.res.{j}", f"encoder.down.{i}.block.{j}", f"encoder.down_blocks.{i}.resnets.{j}")
        if cfg.downsample(i):
            conv(f"encoder.levels.{i}.down", f"encoder.down.{i}.downsample", f"encoder.down_blocks.{i}.downsamplers.0")
    for d, i in enumerate(reversed(range(n))):
        for j in range(cfg.num_res_blocks + 1):
            res(f"decoder.levels.{d}.res.{j}", f"decoder.up.{i}.block.{j}", f"decoder.up_blocks.{d}.resnets.{j}")
        if cfg.downsample(i):
            conv(f"decoder.levels.{d}.up", f"decoder.up.{i}.upsample", f"decoder.up_blocks.{d}.upsamplers.0")
    for side in ("encoder", "decoder"):
        conv(f"{side}.conv_in", f"{side}.conv_in")
        conv(f"{side}.conv_out", f"{side}.conv_out")
        _put(out, sd, f"{side}.norm_out", pick(f"{side}.norm_out"))
        mid(f"{side}.mid", f"{side}.mid")
    return out
