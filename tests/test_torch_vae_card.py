"""The Wan VAE's nearest 2x upsample on the card at the decode's real size.

At 480x832x81 the upsample before the last stage writes a (1, 192, 81,
480, 832) tensor, 6.2e9 elements. F.interpolate's CUDA nearest kernel
returned wrong values past 2^31 output elements, so models/wan/vae.py
upsamples with an expand + reshape copy (nearest2x); this holds it to the
same copy made 8 frames at a time (each chunk under 2^31 elements), bit for
bit. The
`gpu`-marked test needs a CUDA device and skips without one; on the card:
`python -m pytest tests/test_torch_vae_card.py -m gpu --noconftest` (this
file imports no JAX).

The CogVideoX and Cosmos VAEs likewise resize, upsample and pad with copies
and normalise with reductions (models/cog/vae.py, models/cosmos/vae.py):
their time-splitting upsamples, the spatial norm's broadcast over the
nearest resize and both group norms are held at sizes past 2^31 elements to
the same op on chunks under it (bit for bit where the op is a copy; the
group norms within 1e-5, against statistics gathered chunk by chunk in f64
or the same op a frame at a time, whose reductions sum in other orders)."""

import pytest
import torch

from sparse_videogen_tpu_torch.models.cog import vae as CV
from sparse_videogen_tpu_torch.models.cosmos import vae as SV
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


@pytest.mark.gpu
def test_cog_upsample_copy_past_2_31_elements(cuda):
    """CogVideoX's nearest 2x of an odd clip (frame 0 in space only, the
    rest in time and space) at (1, 32, 41, 384, 680) -> 81 frames of 768 x
    1360 (2.7e9 elements), against the copy of 8-frame chunks."""
    from sparse_videogen_tpu_torch.models.hyvideo.vae import _repeat

    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(1, 32, 41, 384, 680, device=cuda, generator=g)
    whole = x.new_empty(1, 32, 81, 768, 1360)
    _repeat(x[:, :, :1], 1, 2, 2, whole[:, :, :1])
    _repeat(x[:, :, 1:], 2, 2, 2, whole[:, :, 1:])
    assert whole.numel() > 2**31
    assert torch.equal(whole[:, :, :1], _repeat(x[:, :, :1], 1, 2, 2))
    for t in range(1, 41, 8):
        assert torch.equal(whole[:, :, 1 + 2 * (t - 1):1 + 2 * (t + 7)], _repeat(x[:, :, t:t + 8], 2, 2, 2)), t


@pytest.mark.gpu
def test_cog_spatial_norm_and_group_norm_past_2_31_elements(cuda):
    """The decoder's spatial norm at (1, 32, 81, 768, 1360) (2.7e9 elements
    a tensor) with 21 latent frames of 96 x 170: the group norm's f32
    statistics against chunked f64 ones (1e-5), and the broadcast of
    conv_y / conv_b over the nearest resize against the resized latents
    made by copies, chunk by chunk (bit for bit)."""
    from sparse_videogen_tpu_torch.models.hyvideo.vae import _repeat

    g = torch.Generator(device=cuda).manual_seed(2)
    m = CV.SpatialNorm(32, 16, 4, cuda)
    with torch.no_grad():
        for p in m.parameters():
            p.copy_(torch.randn(p.shape, device=cuda, generator=g) * 0.3)
    f = torch.randn(1, 32, 81, 768, 1360, device=cuda, generator=g)
    z = torch.randn(1, 16, 21, 96, 170, device=cuda, generator=g)
    assert f.numel() > 2**31
    s = torch.zeros(4, dtype=torch.float64, device=cuda)
    ss = torch.zeros_like(s)
    for t in range(0, 81, 8):
        c = f[:, :, t:t + 8].double().reshape(4, 8, -1)
        s += c.sum((1, 2))
        ss += (c * c).sum((1, 2))
    n = f.numel() // 4
    mean, var = s / n, ss / n - (s / n) ** 2
    out = CV.spatial_norm(m, f.clone(), z, 4)
    y, b = CV.plain_conv3d_1x1(m.conv_y, z), CV.plain_conv3d_1x1(m.conv_b, z)
    w, bias = m.norm.weight.view(1, -1, 1, 1, 1), m.norm.bias.view(1, -1, 1, 1, 1)
    for t in range(0, 81, 8):
        fc = f[:, :, t:t + 8].double().reshape(1, 4, 8, -1, 768, 1360)
        ref = ((fc - mean.view(1, 4, 1, 1, 1, 1)) / torch.sqrt(var.view(1, 4, 1, 1, 1, 1) + 1e-6)).reshape(
            1, 32, -1, 768, 1360).float() * w + bias
        # output frame 0 takes latent frame 0, frame k > 0 latent frame 1 + (k - 1) // 4
        idx = torch.tensor([0 if k == 0 else 1 + (k - 1) // 4 for k in range(t, min(t + 8, 81))], device=cuda)
        yy, bb = (_repeat(a.index_select(2, idx), 1, 8, 8) for a in (y, b))
        assert (out[:, :, t:t + 8] - (ref * yy + bb)).abs().max() <= 1e-5 * (1 + (ref * yy + bb).abs().max()), t


@pytest.mark.gpu
def test_cosmos_upsample_and_group_norm_past_2_31_elements(cuda):
    """Cosmos's causal upsample (T -> 2T - 1, space 2x) at (1, 32, 16, 352,
    640) -> (1, 32, 31, 704, 1280) (9.0e8 elements out; 2.9e9 before the
    frame-0 cut) against 4-frame chunks, bit for bit; its per-frame
    GroupNorm(1) at (1, 80, 31, 704, 1280) (2.2e9) against the same op a
    frame at a time, within 1e-5 (the two reductions sum in other orders)."""
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(1, 32, 16, 352, 640, device=cuda, generator=g)
    whole = SV.upsample_causal(x, (2, 2, 2))
    assert whole.shape == (1, 32, 31, 704, 1280)
    for t in range(0, 16, 4):
        chunk = SV.upsample_causal(x[:, :, max(t - 1, 0):t + 4], (2, 2, 2))
        lo = 0 if t == 0 else 2 * t - 1
        assert torch.equal(whole[:, :, lo:2 * t + 7], chunk[:, :, -(2 * t + 7 - lo):]), t
    del x, whole
    m = torch.nn.GroupNorm(1, 80, eps=1e-6, device=cuda)
    with torch.no_grad():
        m.weight.uniform_(0.5, 1.5, generator=g)
        m.bias.uniform_(-0.5, 0.5, generator=g)
    x = torch.randn(1, 80, 31, 704, 1280, device=cuda, generator=g)
    whole = SV.group_norm1(m, x)
    assert whole.numel() > 2**31
    for t in range(31):
        frame = SV.group_norm1(m, x[:, :, t:t + 1])
        assert (whole[:, :, t:t + 1] - frame).abs().max() <= 1e-5 * (1 + frame.abs().max()), t
