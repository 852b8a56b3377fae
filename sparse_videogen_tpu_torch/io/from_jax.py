"""JAX package state (as numpy) -> the port's: the Wan parameter pytree (T2V
or I2V) -> WanModel state_dict, the T5 / UMT5 pytree -> T5Encoder's, the Wan VAE
pytree -> WanVAE's, the CLIP vision pytree -> CLIPVisionModel's, the
HunyuanVideo pytree -> a HyVideoModel, the CogVideoX pytree -> a CogModel,
HunyuanVideo's encoders (LLaMA, the CLIP text tower, Llava) and VAE ->
LlamaModel's, CLIPTextModel's, LlavaModel's and HyVideoVAE's state_dicts,
and SAP's k-means carry -> SAPState.

The JAX package stores linears as {"w": (d_in, d_out), "b": (d_out,)},
convolutions channels-last ((kt, kh, kw, ci, co), (kh, kw, ci, co)), and
stacks the blocks on a leading layer axis; nn.Linear wants (d_out, d_in),
convolutions (co, ci, k...), and a ModuleList. Feeding both packages the
same weights and states is what the parity tests rest on.
"""

from __future__ import annotations

import numpy as np
import torch


def _linear(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["w"]).T
    if "b" in p:
        sd[f"{name}.bias"] = np.asarray(p["b"])


def wan_params_from_numpy(tree, cfg) -> dict:
    """tree: init_wan_params(...) output (T2V or I2V) with numpy leaves.
    Returns a state_dict of torch tensors (the leaves' dtypes) for
    WanModel(cfg)."""
    sd = {}
    _linear(sd, "patch_embedding", tree["patch_embedding"])
    for grp in ("text_embedding", "time_embedding"):
        for fc in ("fc1", "fc2"):
            _linear(sd, f"{grp}.{fc}", tree[grp][fc])
    _linear(sd, "time_projection", tree["time_projection"])
    sd["head_modulation"] = np.asarray(tree["head"]["modulation"])
    _linear(sd, "head_out", tree["head"]["out"])
    blocks = tree["blocks"]
    for i in range(cfg.num_layers):
        b = f"blocks.{i}"
        layer = lambda a: np.asarray(a)[i]
        sd[f"{b}.modulation"] = layer(blocks["modulation"])
        for att in ("self_attn", "cross_attn"):
            for nm in ("q", "k", "v", "o"):
                _linear(sd, f"{b}.{att}.{nm}", {k: layer(a) for k, a in blocks[att][nm].items()})
            for nm in ("norm_q", "norm_k"):
                sd[f"{b}.{att}.{nm}"] = layer(blocks[att][nm])
        sd[f"{b}.norm3.weight"] = layer(blocks["norm3"]["w"])
        sd[f"{b}.norm3.bias"] = layer(blocks["norm3"]["b"])
        for fc in ("fc1", "fc2"):
            _linear(sd, f"{b}.ffn.{fc}", {k: layer(a) for k, a in blocks["ffn"][fc].items()})
        if "k_img" in blocks["cross_attn"]:
            for nm in ("k_img", "v_img"):
                _linear(sd, f"{b}.cross_attn.{nm}", {k: layer(a) for k, a in blocks["cross_attn"][nm].items()})
            sd[f"{b}.cross_attn.norm_k_img"] = layer(blocks["cross_attn"]["norm_k_img"])
    if "img_emb" in tree:
        pe = tree["img_emb"]
        for fc in ("fc1", "fc2"):
            _linear(sd, f"img_emb.{fc}", pe[fc])
        for nm in ("norm1", "norm2"):
            sd[f"img_emb.{nm}.weight"], sd[f"img_emb.{nm}.bias"] = pe[nm]["w"], pe[nm]["b"]
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}


def clip_vision_params_from_numpy(tree, cfg) -> dict:
    """tree: init_clip_vision_params(...) or convert_clip_vision(...) with
    numpy leaves (blocks stacked on a leading layer axis). Returns a
    state_dict for CLIPVisionModel(cfg)."""
    sd = {"patch_proj.weight": np.asarray(tree["patch_proj"]["w"]).T, "cls": tree["cls"], "pos": tree["pos"]}
    for nm in ("pre_ln", "post_ln"):
        sd[f"{nm}.weight"], sd[f"{nm}.bias"] = tree[nm]["w"], tree[nm]["b"]
    blocks = tree["blocks"]
    for i in range(cfg.num_layers):
        layer = lambda a: np.asarray(a)[i]
        for nm in ("q", "k", "v", "o", "fc1", "fc2"):
            _linear(sd, f"blocks.{i}.{nm}", {k: layer(a) for k, a in blocks[nm].items()})
        for nm in ("ln1", "ln2"):
            sd[f"blocks.{i}.{nm}.weight"], sd[f"blocks.{i}.{nm}.bias"] = layer(blocks[nm]["w"]), layer(blocks[nm]["b"])
    return {k: _tensor(v, "cpu") for k, v in sd.items()}


def t5_params_from_numpy(tree, cfg) -> dict:
    """tree: init_t5_params(...) or convert_t5_hf(...) (UMT5, T5 v1.0 or
    v1.1) with numpy leaves. Returns a state_dict of torch tensors (the
    leaves' dtypes) for T5Encoder(cfg)."""
    sd = {"token_embedding": tree["token_embedding"], "norm": tree["norm"]}
    if cfg.shared_rel_bias:
        sd["rel_embedding"] = tree["rel_embedding"]
    blocks = tree["blocks"]
    vectors = ("norm1", "norm2") + (() if cfg.shared_rel_bias else ("rel_embedding",))
    linears = ("q", "k", "v", "o", "fc1", "fc2") + (("gate",) if cfg.gated_ffn else ())
    for i in range(cfg.num_layers):
        for nm in vectors:
            sd[f"blocks.{i}.{nm}"] = np.asarray(blocks[nm])[i]
        for nm in linears:
            sd[f"blocks.{i}.{nm}.weight"] = np.asarray(blocks[nm]["w"])[i].T
    return {k: _tensor(v, "cpu") for k, v in sd.items()}


def wan_vae_params_from_numpy(tree, cfg, encoder: bool = False) -> dict:
    """tree: init_wan_vae_params(...) or convert_wan_vae(...) with numpy
    leaves. Returns a state_dict for WanVAE(cfg, encoder=encoder): conv2
    and the decoder, and with `encoder` conv1 and the encoder too. conv3d
    (kt, kh, kw, ci, co) -> (co, ci, kt, kh, kw), conv2d (kh, kw, ci, co) ->
    (co, ci, kh, kw)."""
    sd = {}

    def conv(name, p):
        w = np.asarray(p["w"])
        sd[f"{name}.weight"] = w.transpose(4, 3, 0, 1, 2) if w.ndim == 5 else w.transpose(3, 2, 0, 1)
        sd[f"{name}.bias"] = p["b"]

    def block(name, p):
        for nm, v in p.items():
            if isinstance(v, dict):
                conv(f"{name}.{nm}", v)
            else:
                sd[f"{name}.{nm}"] = v

    def tower(side, stages):
        t = tree[side]
        conv(f"{side}.conv1", t["conv1"])
        conv(f"{side}.head_conv", t["head_conv"])
        sd[f"{side}.head_norm"] = t["head_norm"]
        for j, p in enumerate(t["middle"]):
            block(f"{side}.middle.{j}", p)
        for i, stage in enumerate(t[stages]):
            for j, p in enumerate(stage["blocks"]):
                block(f"{side}.{stages}.{i}.blocks.{j}", p)
            for nm, p in stage.get("resample", {}).items():
                conv(f"{side}.{stages}.{i}.resample.{nm}", p)

    conv("conv2", tree["conv2"])
    tower("decoder", "up")
    if encoder:
        conv("conv1", tree["conv1"])
        tower("encoder", "down")
    return {k: _tensor(v, "cpu") for k, v in sd.items()}


def hyvideo_params_from_numpy(tree, cfg):
    """tree: init_hyvideo_params(...) output with numpy leaves (blocks
    stacked on a leading layer axis, linears {"w": (in, out), "b"}). Returns
    a HyVideoModel(cfg) on the CPU holding those weights, its linears in the
    dtype of the tree's linears."""
    from sparse_videogen_tpu_torch.models.hyvideo.model import HyVideoModel

    sd = {}
    lin = lambda name, p: _linear(sd, name, p)
    lin("img_in", tree["img_in"])
    for grp in ("time_in", "vector_in", "guidance_in"):
        if grp in tree:
            for fc in ("fc1", "fc2"):
                lin(f"{grp}.{fc}", tree[grp][fc])
    ti = tree["txt_in"]
    lin("txt_in.input_embedder", ti["input_embedder"])
    for grp in ("t_embedder", "c_embedder"):
        for fc in ("fc1", "fc2"):
            lin(f"txt_in.{grp}.{fc}", ti[grp][fc])

    def stacked(prefix, blocks, n, linears, mlps, vectors, norms=()):
        for i in range(n):
            layer = lambda a: np.asarray(a)[i]
            for nm in linears:
                lin(f"{prefix}.{i}.{nm}", {k: layer(a) for k, a in blocks[nm].items()})
            for nm in mlps:
                for fc in ("fc1", "fc2"):
                    lin(f"{prefix}.{i}.{nm}.{fc}", {k: layer(a) for k, a in blocks[nm][fc].items()})
            for nm in vectors:
                sd[f"{prefix}.{i}.{nm}"] = layer(blocks[nm])
            for nm in norms:
                sd[f"{prefix}.{i}.{nm}.weight"] = layer(blocks[nm]["w"])
                sd[f"{prefix}.{i}.{nm}.bias"] = layer(blocks[nm]["b"])

    stacked("txt_in.blocks", ti["blocks"], cfg.refiner_depth, ("qkv", "proj", "adaln"), ("mlp",), (),
            ("norm1", "norm2"))
    stacked("double_blocks", tree["double_blocks"], cfg.mm_double_blocks_depth,
            [f"{s}_{nm}" for s in ("img", "txt") for nm in ("mod", "qkv", "proj")], ("img_mlp", "txt_mlp"),
            [f"{s}_{nm}_norm" for s in ("img", "txt") for nm in ("q", "k")])
    stacked("single_blocks", tree["single_blocks"], cfg.mm_single_blocks_depth, ("modulation", "linear1", "linear2"),
            (), ("q_norm", "k_norm"))
    lin("final_adaln", tree["final_adaln"])
    lin("final_linear", tree["final_linear"])
    sd = {k: _tensor(v, "cpu") for k, v in sd.items()}
    model = HyVideoModel(cfg, dtype=sd["img_in.weight"].dtype)
    model.load_state_dict(sd)
    return model


def cog_params_from_numpy(tree, cfg):
    """tree: init_cog_params(...) output with numpy leaves (blocks stacked
    on a leading layer axis, linears {"w": (in, out), "b"}, LayerNorms {"w",
    "b"}). Returns a CogModel(cfg) on the CPU holding those weights, its
    linears in the dtype of the tree's linears."""
    from sparse_videogen_tpu_torch.models.cog.model import CogModel

    sd = {}
    for grp in ("time_emb", "ofs_emb"):
        if grp in tree:
            for fc in ("fc1", "fc2"):
                _linear(sd, f"{grp}.{fc}", tree[grp][fc])
    for nm in ("patch_proj", "text_proj", "norm_out_lin", "proj_out"):
        _linear(sd, nm, tree[nm])
    for nm in ("norm_final", "norm_out"):
        sd[f"{nm}.weight"], sd[f"{nm}.bias"] = tree[nm]["w"], tree[nm]["b"]
    blocks = tree["blocks"]
    for i in range(cfg.num_layers):
        layer = lambda p: {k: np.asarray(a)[i] for k, a in p.items()}
        for nm, sub in (("norm1", blocks["norm1"]), ("norm2", blocks["norm2"])):
            _linear(sd, f"blocks.{i}.{nm}.lin", layer(sub["lin"]))
            ln = layer(sub["norm"])
            sd[f"blocks.{i}.{nm}.norm.weight"], sd[f"blocks.{i}.{nm}.norm.bias"] = ln["w"], ln["b"]
        att = blocks["attn"]
        for nm in ("q", "k", "v", "o"):
            _linear(sd, f"blocks.{i}.attn.{nm}", layer(att[nm]))
        for nm in ("norm_q", "norm_k"):
            ln = layer(att[nm])
            sd[f"blocks.{i}.attn.{nm}.weight"], sd[f"blocks.{i}.attn.{nm}.bias"] = ln["w"], ln["b"]
        for fc in ("fc1", "fc2"):
            _linear(sd, f"blocks.{i}.ffn.{fc}", layer(blocks["ffn"][fc]))
    sd = {k: _tensor(v, "cpu") for k, v in sd.items()}
    model = CogModel(cfg, dtype=sd["patch_proj.weight"].dtype)
    model.load_state_dict(sd)
    return model


def _tensor(a, device):
    """numpy (ml_dtypes bfloat16 included) -> torch tensor of the same dtype."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.astype(np.float32)).to(device=device, dtype=torch.bfloat16)
    return torch.from_numpy(np.array(a)).to(device)


def sap_state_from_numpy(state, device="cpu"):
    """A JAX SAPState with numpy leaves (q_centroids, k_centroids,
    initialized, last_density) -> the port's SAPState. A state stacked over
    layers (the JAX runtime's, centroids (L, BH, C, D)) gives a dict
    layer -> SAPState, the form SAPRuntime.states takes."""
    from sparse_videogen_tpu_torch.sparse.svg2 import SAPState

    q, k, init, dens = (np.asarray(getattr(state, n)) for n in ("q_centroids", "k_centroids", "initialized",
                                                                 "last_density"))

    def one(i=None):
        pick = (lambda a: a) if i is None else (lambda a: a[i])
        return SAPState(_tensor(pick(q), device), _tensor(pick(k), device), bool(pick(init)),
                        _tensor(pick(dens), device).float())

    if q.ndim == 4:
        return {li: one(li) for li in range(q.shape[0])}
    return one()


def _stacked(sd, prefix, blocks, n, linears=(), vectors=(), norms=()):
    """Blocks stacked on a leading layer axis -> <prefix>.<i>.<name> entries:
    linears {"w", "b"?} transposed, vectors as they are, LayerNorms {"w", "b"}."""
    for i in range(n):
        for nm in linears:
            _linear(sd, f"{prefix}.{i}.{nm}", {k: np.asarray(a)[i] for k, a in blocks[nm].items()})
        for nm in vectors:
            sd[f"{prefix}.{i}.{nm}"] = np.asarray(blocks[nm])[i]
        for nm in norms:
            sd[f"{prefix}.{i}.{nm}.weight"] = np.asarray(blocks[nm]["w"])[i]
            sd[f"{prefix}.{i}.{nm}.bias"] = np.asarray(blocks[nm]["b"])[i]


def llama_params_from_numpy(tree, cfg) -> dict:
    """tree: init_llama_params(...) or convert_llama(...) with numpy leaves
    (the active blocks stacked). Returns a state_dict for LlamaModel(cfg,
    n_layers=<the tree's block count>)."""
    sd = {"embed": tree["embed"]}
    blocks = tree["blocks"]
    _stacked(sd, "blocks", blocks, len(np.asarray(blocks["ln1"])), ("q", "k", "v", "o", "gate", "up", "down"),
             ("ln1", "ln2"))
    return {k: _tensor(v, "cpu") for k, v in sd.items()}


def clip_text_params_from_numpy(tree, cfg) -> dict:
    """tree: init_clip_text_params(...) or convert_clip_text(...) with numpy
    leaves. Returns a state_dict for CLIPTextModel(cfg)."""
    sd = {"token_embedding": tree["token_embedding"], "position_embedding": tree["position_embedding"],
          "final_ln.weight": tree["final_ln"]["w"], "final_ln.bias": tree["final_ln"]["b"]}
    _stacked(sd, "blocks", tree["blocks"], cfg.num_layers, ("q", "k", "v", "o", "fc1", "fc2"), (), ("ln1", "ln2"))
    return {k: _tensor(v, "cpu") for k, v in sd.items()}


def llava_params_from_numpy(tree, llama_cfg, vision_cfg) -> dict:
    """tree: convert_llava(...) with numpy leaves ({vision, projector,
    llama}). Returns a state_dict for LlavaModel(llama_cfg, vision_cfg,
    n_layers=<the tree's LLaMA block count>)."""
    sd = {f"vision.{k}": v for k, v in clip_vision_params_from_numpy(tree["vision"], vision_cfg).items()}
    sd.update({f"llama.{k}": v for k, v in llama_params_from_numpy(tree["llama"], llama_cfg).items()})
    proj = {}
    for fc in ("fc1", "fc2"):
        _linear(proj, f"projector.{fc}", tree["projector"][fc])
    sd.update({k: _tensor(v, "cpu") for k, v in proj.items()})
    return sd


def hyvideo_vae_params_from_numpy(tree, cfg) -> dict:
    """tree: init_hyvideo_vae_params(...) or convert_hyvideo_vae(...) with
    numpy leaves. Returns a state_dict for HyVideoVAE(cfg): conv3d (kt, kh,
    kw, ci, co) -> (co, ci, kt, kh, kw), linears transposed, norms {"g", "b"}."""
    sd = {}

    def conv(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = np.asarray(p["w"]).transpose(4, 3, 0, 1, 2), p["b"]

    def norm(name, p):
        sd[f"{name}.weight"], sd[f"{name}.bias"] = p["g"], p["b"]

    def res(name, p):
        norm(f"{name}.norm1", p["norm1"])
        norm(f"{name}.norm2", p["norm2"])
        conv(f"{name}.conv1", p["conv1"])
        conv(f"{name}.conv2", p["conv2"])
        if "shortcut" in p:
            conv(f"{name}.shortcut", p["shortcut"])

    for side, blocks, resample in (("encoder", "down", "ds"), ("decoder", "up", "us")):
        t = tree[side]
        conv(f"{side}.conv_in", t["conv_in"])
        conv(f"{side}.conv_out", t["conv_out"])
        norm(f"{side}.norm_out", t["norm_out"])
        res(f"{side}.mid.res0", t["mid"]["res0"])
        res(f"{side}.mid.res1", t["mid"]["res1"])
        attn = t["mid"]["attn"]
        norm(f"{side}.mid.attn.norm", attn["norm"])
        for nm in ("q", "k", "v", "o"):
            _linear(sd, f"{side}.mid.attn.{nm}", attn[nm])
        for i, blk in enumerate(t[blocks]):
            for j, r in enumerate(blk["res"]):
                res(f"{side}.{blocks}.{i}.res.{j}", r)
            if resample in blk:
                conv(f"{side}.{blocks}.{i}.{resample}", blk[resample])
    conv("quant_conv", tree["quant_conv"])
    conv("post_quant_conv", tree["post_quant_conv"])
    return {k: _tensor(v, "cpu") for k, v in sd.items()}


def tree_state_dict(tree, prefix: str = "") -> dict:
    """A JAX pytree whose paths are the port's parameter names (the
    CogVideoX VAE's and the Cosmos tokenizer's: init_*_vae_params or
    convert_*_vae with numpy leaves) -> a state_dict of torch tensors (the
    leaves' dtypes): {"w", "b"} is a
    linear (w (in, out) transposed) or a convolution (channels-last w moved
    to (co, ci, k...)), {"g", "b"} a norm's weight and bias, a list's items
    are numbered, any other leaf keeps its path."""
    sd = {}

    def walk(node, path):
        name = ".".join(path)
        if isinstance(node, (list, tuple)):
            for i, item in enumerate(node):
                walk(item, path + [str(i)])
        elif isinstance(node, dict) and "w" in node and set(node) <= {"w", "b"}:
            w = np.asarray(node["w"])
            sd[f"{name}.weight"] = w.T if w.ndim == 2 else w.transpose(w.ndim - 1, w.ndim - 2, *range(w.ndim - 2))
            if "b" in node:
                sd[f"{name}.bias"] = np.asarray(node["b"])
        elif isinstance(node, dict) and set(node) == {"g", "b"}:
            sd[f"{name}.weight"], sd[f"{name}.bias"] = np.asarray(node["g"]), np.asarray(node["b"])
        elif isinstance(node, dict):
            for k, v in node.items():
                walk(v, path + [k])
        else:
            sd[name] = np.asarray(node)

    walk(tree, [prefix] if prefix else [])
    return {k: _tensor(v, "cpu") for k, v in sd.items()}


def _unstacked(tree, n: int):
    """Blocks stacked on a leading layer axis -> a list of n block trees."""
    return [_tree_map(lambda a, i=i: np.asarray(a)[i], tree) for i in range(n)]


def _tree_map(fn, tree):
    """fn on every leaf of nested dicts and lists."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_tree_map(fn, v) for v in tree]
    return fn(tree)


def cosmos_params_from_numpy(tree, cfg) -> dict:
    """tree: init_cosmos_params(...) or convert_cosmos_dit(...) with numpy
    leaves (blocks stacked) -> a state_dict for CosmosModel(cfg)."""
    return tree_state_dict(dict(tree, blocks=_unstacked(tree["blocks"], cfg.num_layers)))
