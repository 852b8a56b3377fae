"""True LPIPS (AlexNet) in PyTorch, behind a local weights file (counterpart
of sparse_videogen_tpu/utils/lpips_jax.py; the same weights and forward).

The reference reports LPIPS through the `lpips` package, which downloads
pretrained AlexNet and its calibration weights; nothing is downloaded
here. The weights come from a local file the user supplies:
  1. ``$SVT_LPIPS_WEIGHTS``: a .npz (below) or a directory holding
     ``alexnet*.pth`` (torchvision state dict) and ``alex.pth`` (the lpips
     package's linear calibration weights, lpips/weights/v0.1/alex.pth);
  2. ``<repo>/weights/lpips_alex.npz``.

.npz layout: conv{i}_w, conv{i}_b for i in 0..4 (torchvision AlexNet
``features`` convs, OIHW) and lin{i}_w for i in 0..4 (LPIPS 1x1
calibration, shape (1, C_i, 1, 1)). ``export_npz`` converts the two .pth
files once.

Taps are the five ReLU outputs of torchvision AlexNet's features:
  conv(3->64, k11, s4, p2) relu | maxpool(3, 2)
  conv(64->192, k5, p2)    relu | maxpool(3, 2)
  conv(192->384, k3, p1)   relu
  conv(384->256, k3, p1)   relu
  conv(256->256, k3, p1)   relu
LPIPS: scale the [-1, 1] input, unit-normalise each tap over channels,
square the difference, weight by the non-negative 1x1 linear layer, take
the spatial mean and sum the 5 stages. f32 on the given device, TF32 off.
"""

from __future__ import annotations

import os

import numpy as np

from sparse_videogen_tpu_torch.utils.perceptual import _SCALE, _SHIFT, _unit, exact_f32

# (k, stride, pad, pool_after) per conv stage; channel sizes come from weights
_STAGES = ((11, 4, 2, True), (5, 1, 2, True), (3, 1, 1, False),
           (3, 1, 1, False), (3, 1, 1, False))


def _from_torch_dir(path: str) -> dict:
    import glob

    import torch

    alex_path = None
    lin_path = None
    for f in sorted(glob.glob(os.path.join(path, "*.pth")) + glob.glob(os.path.join(path, "*.pt"))):
        sd = torch.load(f, map_location="cpu", weights_only=True)
        keys = list(sd.keys())
        if any(k.startswith("features.0") for k in keys):
            alex_path = (f, sd)
        elif any("lin0" in k for k in keys):
            lin_path = (f, sd)
    if alex_path is None or lin_path is None:
        raise FileNotFoundError(
            f"{path}: need a torchvision AlexNet state dict (features.*) and "
            f"the lpips alex.pth linear weights (lin*.model.1.weight)")
    out = {}
    conv_ids = [0, 3, 6, 8, 10]  # torchvision AlexNet features module indices
    for i, ci in enumerate(conv_ids):
        out[f"conv{i}_w"] = alex_path[1][f"features.{ci}.weight"].numpy().astype(np.float32)
        out[f"conv{i}_b"] = alex_path[1][f"features.{ci}.bias"].numpy().astype(np.float32)
    for i in range(5):
        for k in (f"lin{i}.model.1.weight", f"lin{i}.weight"):
            if k in lin_path[1]:
                out[f"lin{i}_w"] = lin_path[1][k].numpy().astype(np.float32)
                break
        else:
            raise KeyError(f"lin{i} weight missing in {lin_path[0]}")
    return out


def load_lpips_weights(path: str | None = None) -> dict | None:
    """Resolve + load LPIPS-alex weights; None when nothing is available."""
    candidates = []
    if path:
        candidates.append(path)
    env = os.environ.get("SVT_LPIPS_WEIGHTS")
    if env:
        candidates.append(env)
    here = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    candidates.append(os.path.join(here, "weights", "lpips_alex.npz"))
    for c in candidates:
        if os.path.isdir(c):
            return _from_torch_dir(c)
        if os.path.isfile(c):
            if c.endswith(".npz"):
                with np.load(c) as z:
                    return {k: z[k] for k in z.files}
            raise ValueError(f"{c}: single-file weights must be .npz "
                             f"(use export_npz, or point at the .pth directory)")
    return None


def export_npz(torch_dir: str, out_path: str) -> None:
    """One-time conversion: .pth directory -> portable .npz."""
    np.savez(out_path, **_from_torch_dir(torch_dir))


def _alex_taps(x, w):
    """x: (N, 3, H, W) scaled f32 input tensor -> 5 ReLU tap activations."""
    import torch
    import torch.nn.functional as F

    h = x
    taps = []
    for i, (k, s, p, pool) in enumerate(_STAGES):
        h = F.relu(F.conv2d(h, torch.as_tensor(w[f"conv{i}_w"], device=x.device),
                            torch.as_tensor(w[f"conv{i}_b"], device=x.device), stride=s, padding=p))
        taps.append(h)
        if pool:
            h = F.max_pool2d(h, 3, 2)
    return taps


def lpips_alex(a, b, weights, *, batch: int = 4, device="cpu") -> float:
    """LPIPS(alex) between (T, H, W, 3) numpy videos in [0, 1]. Frame mean."""
    import torch

    assert a.shape == b.shape and a.shape[-1] == 3, (a.shape, b.shape)

    def dist(xa, xb):
        total = 0.0
        for i, (ya, yb) in enumerate(zip(_alex_taps(xa, weights), _alex_taps(xb, weights))):
            lin = torch.as_tensor(weights[f"lin{i}_w"], device=xa.device)[0, :, 0, 0]  # (C,)
            d2 = (_unit(ya) - _unit(yb)) ** 2
            total = total + torch.mean(torch.sum(d2 * lin[None, :, None, None], dim=1), dim=(1, 2))
        return total

    vals = []
    sh = _SHIFT[None, :, None, None]
    sc = _SCALE[None, :, None, None]
    with torch.no_grad(), exact_f32():
        for t0 in range(0, a.shape[0], batch):
            xa = (np.asarray(a[t0:t0 + batch], np.float32).transpose(0, 3, 1, 2) * 2 - 1 - sh) / sc
            xb = (np.asarray(b[t0:t0 + batch], np.float32).transpose(0, 3, 1, 2) * 2 - 1 - sh) / sc
            vals.append(dist(torch.as_tensor(xa, device=device), torch.as_tensor(xb, device=device)).cpu().numpy())
    return float(np.mean(np.concatenate(vals)))
