"""The fused LayerNorm + modulation (ops/layernorm_mod.py) on the CPU: its
plain version equals, bit for bit, each eager expression the models ran at
their `model.norm` sites before it; the wrapper's counters and argument
checks; one launch a site in a tiny Wan and HunyuanVideo forward. The kernel
itself runs on the card (tests/test_torch_kernels.py, `gpu`)."""

import pytest
import torch

from sparse_videogen_tpu_torch import _kernels
from sparse_videogen_tpu_torch.models.common import layers as L
from sparse_videogen_tpu_torch.models.hyvideo import model as HM
from sparse_videogen_tpu_torch.models.wan import model as WM
from sparse_videogen_tpu_torch.ops.layernorm_mod import kernel_args, layernorm_mod, layernorm_mod_plain

EPS = 1e-6


def _x(shape, seed, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 2 + 0.3).to(dtype)


def _vec(shape, seed, dtype=torch.float32):
    return torch.randn(shape, generator=torch.Generator().manual_seed(seed)).to(dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("B", [1, 2])
def test_wan_modulation_equals_eager(B, dtype):
    """Wan's norm1 / norm2 / head: e (B, 6, d) f32, scale and shift its
    (B, 1, d) slices, (layer_norm_f32(x) (1 + scale) + shift) cast back."""
    x = _x((B, 37, 64), 0, dtype)
    e = _vec((B, 6, 64), 1)
    for scale, shift in ((e[:, 1:2], e[:, 0:1]), (e[:, 4:5], e[:, 3:4])):
        eager = (L.layer_norm_f32(x, EPS) * (1 + scale) + shift).to(x.dtype)
        assert torch.equal(WM._norm_mod(x, EPS, scale, shift), eager)


def test_wan_norm3_affine_equals_eager():
    x = _x((2, 37, 64), 2)
    w, b = _vec(64, 3) + 1, _vec(64, 4)
    eager = L.layer_norm_f32(x, EPS, w, b).to(x.dtype)
    assert torch.equal(L.layer_norm_mod(x, EPS, w, b), eager)


@pytest.mark.parametrize("B", [1, 2])
def test_hyvideo_modulation_equals_eager(B):
    """HunyuanVideo's _modulate: bf16 shift and scale (B, hidden), 1 + scale
    rounded in bf16, the f32 LayerNorm promoting both; and the final layer's
    slice of the [video | text] sequence."""
    xx = _x((B, 45, 64), 5)
    shift, scale = _vec((B, 64), 6, torch.bfloat16), _vec((B, 64), 7, torch.bfloat16)
    for x in (xx, xx[:, :37]):
        eager = (L.layer_norm_f32(x, EPS) * (1 + scale[:, None]) + shift[:, None]).to(x.dtype)
        assert torch.equal(HM._norm_mod(x, EPS, shift, scale), eager)


@pytest.mark.parametrize("shape", [(64,), (3, 64)], ids=["d", "Bd"])
def test_plain_broadcasts_vectors(shape):
    x = _x((3, 11, 64), 8)
    m, a = _vec(shape, 9), _vec(shape, 10)
    ref = (L.layer_norm_f32(x, EPS) * (m if m.dim() == 1 else m[:, None])
           + (a if a.dim() == 1 else a[:, None])).to(x.dtype)
    assert torch.equal(layernorm_mod(x, m, a, EPS), ref)


def test_cpu_tensors_count_plain_calls():
    x = _x((2, 5, 64), 11)
    m, a = _vec(64, 12), _vec(64, 13)
    _kernels.reset_counts()
    layernorm_mod(x, m, a, EPS)
    layernorm_mod_plain(x, m, a, EPS)
    assert _kernels.PLAIN_CALLS["layernorm_mod"] == 2 and _kernels.LAUNCHES["layernorm_mod"] == 0


def test_wrapper_rejects_bad_shapes():
    x = _x((2, 5, 64), 14)
    m = _vec(64, 15)
    with pytest.raises(ValueError):  # x not (B, S, d)
        layernorm_mod(x[0], m, m, EPS)
    with pytest.raises(ValueError):  # a vector of another width
        layernorm_mod(x, m[:32], m, EPS)
    with pytest.raises(ValueError):  # a batch of vectors other than x's
        layernorm_mod(x, _vec((1, 64), 16), m, EPS)


def test_kernel_args_take_slices_and_reject_what_the_kernel_cannot_read():
    """kernel_args (what the CUDA path checks before a launch): the strides
    of a [video | text] slice and of a (B, 6, d) table's rows pass through;
    a d that is not a multiple of 8, a non-unit last stride, rows that are
    not contiguous, f32 x and f64 vectors raise."""
    xx = _x((2, 45, 64), 17)
    e = _vec((2, 6, 64), 18)
    assert kernel_args(xx[:, :37], e[:, 0], e[:, 3]) == (45 * 64, 6 * 64, 6 * 64)
    assert kernel_args(xx[:1], e[0, 0], e[:1, 1]) == (0, 0, 0)
    m = _vec(64, 19)
    with pytest.raises(ValueError, match="d % 8"):
        kernel_args(_x((2, 5, 60), 20), m[:60], m[:60])
    with pytest.raises(ValueError, match="rows of d contiguous"):
        kernel_args(_x((2, 64, 5), 21).transpose(1, 2), m, m)
    with pytest.raises(ValueError, match="rows of d contiguous"):
        kernel_args(_x((2, 5, 128), 22)[:, :, :64], m, m)
    with pytest.raises(ValueError, match="bf16"):
        kernel_args(xx.float(), m, m)
    with pytest.raises(ValueError, match="f32"):
        kernel_args(xx, m.double(), m)
    with pytest.raises(ValueError, match="unit last stride"):
        kernel_args(xx, _vec((64, 2), 23)[:, 0], m)


WAN_KW = dict(dim=128, ffn_dim=256, num_heads=2, num_layers=2, freq_dim=32, text_dim=48, text_len=8)
HY_KW = dict(hidden_size=128, heads_num=2, mm_double_blocks_depth=2, mm_single_blocks_depth=1,
             rope_dim_list=(16, 24, 24), text_states_dim=32, text_states_dim_2=24, text_len=8, mlp_width_ratio=2.0)


def _wan_forward():
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime, wan_layout

    cfg = WM.WanConfig(**WAN_KW)
    model = WM.WanModel(cfg, dtype=torch.bfloat16).init_random(torch.Generator().manual_seed(0))
    lay = wan_layout(cfg, 80, 128, 9)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 16, lay.num_frames, 10, 16, generator=g).to(torch.bfloat16)
    ctx = torch.randn(2, cfg.text_len, cfg.text_dim, generator=g).to(torch.bfloat16)
    rt = make_wan_runtime(lay, device=torch.device("cpu"), pattern="dense")
    _kernels.reset_counts()
    model(x, torch.full((2,), 500.0), ctx, attention=rt)
    return cfg, 3 * cfg.num_layers + 1


def _hy_forward():
    from sparse_videogen_tpu_torch.pipelines.hyvideo import hyvideo_layout, make_hyvideo_runtime

    cfg = HM.HyVideoConfig(**HY_KW)
    model = HM.HyVideoModel(cfg, dtype=torch.bfloat16).init_random(torch.Generator().manual_seed(0))
    lay = hyvideo_layout(cfg, 128, 256, 9)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 16, lay.num_frames, 16, 32, generator=g).to(torch.bfloat16)
    text = torch.randn(1, cfg.text_len, cfg.text_states_dim, generator=g).to(torch.bfloat16)
    mask = (torch.arange(cfg.text_len) < 5).to(torch.int32)[None]
    pooled = torch.randn(1, cfg.text_states_dim_2, generator=g).to(torch.bfloat16)
    rt = make_hyvideo_runtime(lay, device=torch.device("cpu"), prompt_length=5, pattern="dense")
    _kernels.reset_counts()
    model(x, torch.full((1,), 900.0), text, mask, pooled, guidance=torch.full((1,), 6000.0), attention=rt)
    return cfg, 4 * cfg.mm_double_blocks_depth + cfg.mm_single_blocks_depth + 1


@pytest.mark.parametrize("forward", [_wan_forward, _hy_forward], ids=["wan", "hyvideo"])
def test_one_call_a_norm_site(forward):
    """Every `model.norm` site goes through layer_norm_mod once a forward:
    Wan 3 a block + the head, HunyuanVideo 4 a double block, 1 a single
    block + the final layer. On the card each is one launch, and
    chip_smoke.py expects as many (norm_sites)."""
    import chip_smoke

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg, want = forward()
    finally:
        torch.set_num_threads(threads)
    assert _kernels.PLAIN_CALLS["layernorm_mod"] == want and _kernels.LAUNCHES["layernorm_mod"] == 0
    assert chip_smoke.norm_sites(cfg) == want


@pytest.mark.parametrize("pattern,streams", [("SVG", 1), ("dense", 1), ("SAP", 2)])
def test_smoke_expects_the_norm_launches_of_every_forward(pattern, streams):
    """chip_smoke.expected_launches counts norm_sites launches a forward:
    one forward a step (Wan's CFG batch), SAP's streams one each; CogVideoX
    and Cosmos none."""
    import chip_smoke
    from sparse_videogen_tpu_torch.config import SAPConfig, WarmupSchedule
    from sparse_videogen_tpu_torch.presets import COG_768P_SVG, T2V_480P

    cfg = T2V_480P.model
    timesteps = [999.0, 900.0, 500.0]
    warmup = WarmupSchedule.from_fractions(0.0, 0.0, cfg.num_layers, timesteps)
    want, _ = chip_smoke.expected_launches(pattern, cfg.num_layers, warmup, timesteps, ("none", "band_sink"),
                                           sap=SAPConfig(), sap_streams=streams, norms=chip_smoke.norm_sites(cfg))
    assert want["layernorm_mod"] == streams * len(timesteps) * (3 * cfg.num_layers + 1)
    assert chip_smoke.norm_sites(COG_768P_SVG.model) == 0
