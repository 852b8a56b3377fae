"""io/image.py's JPEG encoder on the card against the same encoder on the
CPU (whose bytes tests/test_torch_jpeg_encode.py holds to PIL's): every
stage is integer torch ops, so the bytes must be equal on any device. The
`gpu`-marked test needs a CUDA device and skips without one; on the card
(no JAX, no PIL there): python -m pytest tests/test_torch_jpeg_encode_gpu.py
-m gpu --noconftest."""

import numpy as np
import pytest
import torch

from sparse_videogen_tpu_torch.io import image as TIMG


def _frames(h, w, noise, seed, t=3):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 255 // h, xx * 255 // w, (yy + xx) * 255 // (h + w)], -1)
    return np.clip(base[None] + rng.integers(-noise, noise + 1, (t, h, w, 3)), 0, 255).astype(np.uint8)


def _blocks(h, w):
    grid = (np.arange(h)[:, None] // 8 + np.arange(w)[None] // 8) % 2 * 255
    return np.repeat(grid[None, ..., None], 3, axis=-1).astype(np.uint8)


VIDEOS = {
    "noise": lambda: np.random.default_rng(0).integers(0, 256, (2, 40, 56, 3), dtype=np.uint8),
    "gradient": lambda: _frames(48, 64, 6, 1),
    "blocks": lambda: _blocks(32, 48),
    "flat": lambda: np.stack([np.zeros((16, 24, 3), np.uint8), np.full((16, 24, 3), 255, np.uint8)]),
    "1x1": lambda: np.array([[[[200, 30, 90]]]], np.uint8),
    "33x47": lambda: _frames(33, 47, 30, 3),
    "480x832": lambda: _frames(480, 832, 60, 4, t=2),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the encoder's device path")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("quality", [1, 50, 93, 95, 100])
@pytest.mark.parametrize("name", list(VIDEOS))
def test_card_bytes_equal_cpu(cuda, name, quality):
    video = torch.from_numpy(VIDEOS[name]())
    assert TIMG.encode_jpeg_frames(video.to(cuda), quality) == TIMG.encode_jpeg_frames(video, quality)
