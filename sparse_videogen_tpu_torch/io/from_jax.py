"""JAX package state (as numpy) -> the port's: the Wan parameter pytree ->
WanModel state_dict, and SAP's k-means carry -> SAPState.

The JAX package stores linears as {"w": (d_in, d_out), "b": (d_out,)} and
stacks the blocks on a leading layer axis; nn.Linear wants (d_out, d_in) and
a ModuleList. Feeding both packages the same weights and states is what the
parity tests rest on.
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
