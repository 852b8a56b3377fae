"""Debug helpers (counterpart of sparse_videogen_tpu/utils/misc.py, after
the reference's svg/utils/misc.py and its per-model qkv dumpers)."""

from __future__ import annotations

import dataclasses
import os

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Color:
    black = "\033[30m"
    red = "\033[31m"
    green = "\033[32m"
    yellow = "\033[33m"
    blue = "\033[34m"
    magenta = "\033[35m"
    cyan = "\033[36m"
    white = "\033[37m"
    reset = "\033[39m"
    orange = "\033[38;2;180;60;0m"


def print_memory_usage(prefix: str = ""):
    """The card's allocated and peak allocated memory in MB
    (torch.cuda.memory_allocated / max_memory_allocated)."""
    if not torch.cuda.is_available():
        print(f"{Color.orange}{prefix} Memory: no CUDA device{Color.reset}")
        return
    used = torch.cuda.memory_allocated() // 1024**2
    peak = torch.cuda.max_memory_allocated() // 1024**2
    print(f"{Color.orange}{prefix} Memory: {used} / {peak} MB{Color.reset}")


def print_args(args):
    print(f"{Color.magenta}Args:{Color.reset}")
    for key, value in vars(args).items():
        print(f"{Color.magenta}{key}: {value}{Color.reset}")


def _numpy(x):
    """A tensor (bf16 as f32, numpy has no bf16) or array -> numpy."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    return np.asarray(x)


def save_qkv(q, k, v, save_dir, layer_idx, timestep, x=None):
    """Dump attention inputs for offline analysis to
    <save_dir>/sparse_qkv[x]_layer<i>_ts<t>.npz; returns its path."""
    os.makedirs(save_dir, exist_ok=True)
    tag = "qkvx" if x is not None else "qkv"
    path = os.path.join(save_dir, f"sparse_{tag}_layer{layer_idx}_ts{timestep}.npz")
    data = {"q": _numpy(q), "k": _numpy(k), "v": _numpy(v), "timestep": timestep, "layer_idx": layer_idx}
    if x is not None:
        data["x"] = _numpy(x)
    np.savez(path, **data)
    return path
