"""The Wan VAE's nearest 2x upsample on the card at the decode's real size.

At 480x832x81 the upsample before the last stage writes a (1, 192, 81,
480, 832) tensor, 6.2e9 elements. F.interpolate's CUDA nearest kernel
returned wrong values past 2^31 output elements, so models/wan/vae.py
upsamples with an expand + reshape copy (nearest2x); this holds it to the
same copy made 8 frames at a time (each chunk under 2^31 elements), bit for
bit. The
`gpu`-marked test needs a CUDA device and skips without one; on the card:
`python -m pytest tests/test_torch_vae_card.py -m gpu --noconftest` (this
file imports no JAX)."""

import pytest
import torch

from sparse_videogen_tpu_torch.models.wan import vae as V


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the size that overflows 32-bit indexing fits only the card")
    return torch.device("cuda")


@pytest.mark.gpu
def test_spatial_upsample_past_2_31_elements(cuda):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(1, 192, 81, 240, 416, device=cuda, generator=g)
    whole = V.nearest2x(x)
    assert whole.numel() > 2**31
    for t in range(0, x.shape[2], 8):
        assert torch.equal(whole[:, :, t:t + 8], V.nearest2x(x[:, :, t:t + 8])), t
