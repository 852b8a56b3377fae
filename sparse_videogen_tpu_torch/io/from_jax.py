"""JAX Wan parameter pytree (as numpy) -> WanModel state_dict.

The JAX package stores linears as {"w": (d_in, d_out), "b": (d_out,)} and
stacks the blocks on a leading layer axis; nn.Linear wants (d_out, d_in) and
a ModuleList. Feeding both packages the same weights is what the parity
tests rest on.
"""

from __future__ import annotations

import numpy as np
import torch


def _linear(sd, name, p):
    sd[f"{name}.weight"] = np.asarray(p["w"]).T
    if "b" in p:
        sd[f"{name}.bias"] = np.asarray(p["b"])


def wan_params_from_numpy(tree, cfg) -> dict:
    """tree: init_wan_params(...) output (T2V) with numpy leaves. Returns a
    state_dict of torch tensors (the leaves' dtypes) for WanModel(cfg)."""
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
    return {k: torch.from_numpy(np.ascontiguousarray(v)) for k, v in sd.items()}
