"""Self-contained perceptual distance, an LPIPS stand-in (counterpart of
sparse_videogen_tpu/utils/perceptual.py).

LPIPS's structure with fixed random features instead of pretrained AlexNet:

    d(a, b) = mean_s mean_hw || phi_s(a)_norm - phi_s(b)_norm ||^2

phi_s are the ReLU activations of a small strided conv stack whose weights
come from a seeded numpy generator (the JAX package's, so both packages
compute the same metric), `_norm` LPIPS's unit normalisation over channels.
Scores correlate with LPIPS but are not comparable with it in absolute
value, hence the name `lpips_rf` (random features). The convolutions run
as `F.conv2d` in f32 on the given device, with TF32 off.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np

# LPIPS input normalization constants (the package's scaling layer)
_SHIFT = np.array([-0.030, -0.088, -0.188], np.float32)
_SCALE = np.array([0.458, 0.448, 0.450], np.float32)

# conv stack: (out_channels, kernel, stride); receptive fields span edges ->
# textures -> parts, mirroring LPIPS's 5 AlexNet stages
_STAGES = ((16, 7, 2), (32, 5, 2), (64, 3, 2), (96, 3, 2), (128, 3, 2))
_SEED = 20260818


@functools.lru_cache(maxsize=1)
def random_feature_params(seed: int = _SEED):
    """Deterministic conv weights (He-scaled) + uniform stage weights."""
    rng = np.random.default_rng(seed)
    params = []
    c_in = 3
    for c_out, k, _ in _STAGES:
        fan_in = c_in * k * k
        w = rng.standard_normal((c_out, c_in, k, k)).astype(np.float32)
        w *= np.sqrt(2.0 / fan_in)
        params.append(w)
        c_in = c_out
    return params


@contextlib.contextmanager
def exact_f32():
    """cuDNN convolutions and matmuls in f32, not TF32, inside the block."""
    import torch

    conv, mm = torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, torch.backends.cuda.matmul.allow_tf32 = conv, mm


def _features(x, params):
    """x: (N, 3, H, W) f32 tensor in [-1, 1] -> list of per-stage activations."""
    import torch
    import torch.nn.functional as F

    shift = torch.as_tensor(_SHIFT, device=x.device)[None, :, None, None]
    scale = torch.as_tensor(_SCALE, device=x.device)[None, :, None, None]
    h = (x - shift) / scale
    feats = []
    for w, (_, k, s) in zip(params, _STAGES):
        h = F.relu(F.conv2d(h, torch.as_tensor(w, device=x.device), stride=s, padding=k // 2))
        feats.append(h)
    return feats


def _unit(y):
    import torch

    return y / torch.sqrt(torch.sum(y * y, dim=1, keepdim=True) + 1e-10)


def lpips_rf(a, b, *, batch: int = 8, device="cpu"):
    """Perceptual distance between (T, H, W, 3) numpy videos in [0, 1]: the
    mean over frames of the LPIPS-structured random-feature distance,
    frames in mini-batches of `batch` on `device`."""
    import torch

    assert a.shape == b.shape and a.shape[-1] == 3, (a.shape, b.shape)
    params = random_feature_params()

    def dist(xa, xb):
        total = 0.0
        fa, fb = _features(xa, params), _features(xb, params)
        for ya, yb in zip(fa, fb):
            total = total + torch.mean(torch.sum((_unit(ya) - _unit(yb)) ** 2, dim=1), dim=(1, 2))
        return total / len(fa)

    vals = []
    with torch.no_grad(), exact_f32():
        for t0 in range(0, a.shape[0], batch):
            xa, xb = (torch.as_tensor(v[t0:t0 + batch].transpose(0, 3, 1, 2) * 2.0 - 1.0, dtype=torch.float32,
                                      device=device) for v in (a, b))
            vals.append(dist(xa, xb).cpu().numpy())
    return float(np.mean(np.concatenate(vals)))
