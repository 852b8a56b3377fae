"""The fused q/k RMSNorm + RoPE (ops/qk_norm_rope.py) on the CPU: its plain
version equals, bit for bit, each eager chain the models ran at their
`model.qk` sites before it (WanRMSNorm over the token or a head, the head
view, the interleaved rotation, the [video | text] joins), in bf16 and f32;
the wrapper's counters and argument checks; one call a site in tiny Wan
(T2V, I2V) and HunyuanVideo forwards whose outputs equal the old chain's.
The kernel itself runs on the card (tests/test_torch_kernels.py, `gpu`)."""

import pytest
import torch

from sparse_videogen_tpu_torch import _kernels
from sparse_videogen_tpu_torch.models.common import layers as L
from sparse_videogen_tpu_torch.models.common.rope import apply_rope_interleaved, nd_rope_cos_sin
from sparse_videogen_tpu_torch.models.hyvideo import model as HM
from sparse_videogen_tpu_torch.models.wan import model as WM
from sparse_videogen_tpu_torch.ops.qk_norm_rope import kernel_args, qk_norm_rope, qk_norm_rope_plain

EPS = 1e-6
DTYPES = [torch.bfloat16, torch.float32]


def _x(shape, seed, dtype=torch.bfloat16):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(shape, generator=g) * 2 + 0.3).to(dtype)


def _w(n, seed):
    return torch.rand(n, generator=torch.Generator().manual_seed(seed)) + 0.5


def _tables(grid, D):
    return tuple(torch.from_numpy(a) for a in nd_rope_cos_sin(grid, (D - 4 * (D // 6), 2 * (D // 6), 2 * (D // 6))))


def _heads(y, H):
    B, S, d = y.shape
    return y.view(B, S, H, d // H).transpose(1, 2)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("rope", [True, False], ids=["self", "cross"])
def test_wan_token_group_equals_eager(dtype, rope):
    """Wan's _qk: rms_norm over the whole token, the head view, RoPE in
    self-attention (none in cross-attention, whose k has other rows)."""
    cos, sin = _tables((2, 3, 5), 32)
    x, w = _x((2, 30, 128), 0, dtype), _w(128, 1)
    y = _heads(L.rms_norm(x, w, EPS), 4)
    eager = apply_rope_interleaved(y, cos, sin) if rope else y
    got = WM._qk(x, w, EPS, 4, *((cos, sin) if rope else ()))
    assert torch.equal(got, eager) and got.dtype == dtype


@pytest.mark.parametrize("dtype", DTYPES)
def test_hyvideo_head_group_on_a_qkv_view_equals_eager(dtype):
    """HunyuanVideo's double block: the per-head rms_norm of the fused
    projection's q column view (token stride 3h), RoPE on every row."""
    cos, sin = _tables((2, 3, 5), 32)
    qkv = _x((1, 30, 3 * 128), 2, dtype)
    q = qkv.chunk(3, dim=-1)[0]
    w = _w(32, 3)
    eager = apply_rope_interleaved(L.rms_norm(_heads(q, 4), w, EPS), cos, sin)
    assert torch.equal(qk_norm_rope(q, w, EPS, 4, cos, sin), eager)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rope_prefix_shorter_than_the_rows_equals_eager(dtype):
    """HunyuanVideo's single block over [video | text]: the video rows
    roped, the text rows after them normalised only."""
    cos, sin = _tables((2, 3, 5), 32)
    qkv = _x((1, 38, 3 * 128), 4, dtype)
    k = qkv.chunk(3, dim=-1)[1]
    w = _w(32, 5)
    y = L.rms_norm(_heads(k, 4), w, EPS)
    eager = torch.cat([apply_rope_interleaved(y[:, :, :30], cos, sin), y[:, :, 30:]], dim=2)
    assert torch.equal(qk_norm_rope(k, w, EPS, 4, cos, sin), eager)


@pytest.mark.parametrize("dtype", DTYPES)
def test_rows_written_at_an_offset_of_a_joined_buffer_equal_the_cat(dtype):
    """The double block's [video | text] q: each stream written into its
    rows of one buffer equals the old torch.cat of the two, and rows outside
    [r0, r0 + S) stay as they were."""
    cos, sin = _tables((2, 3, 5), 32)
    img, txt = _x((2, 30, 3 * 128), 6, dtype).chunk(3, dim=-1)[0], _x((2, 7, 3 * 128), 7, dtype).chunk(3, dim=-1)[0]
    wi, wt = _w(32, 8), _w(32, 9)
    eager = torch.cat([apply_rope_interleaved(L.rms_norm(_heads(img, 4), wi, EPS), cos, sin),
                       L.rms_norm(_heads(txt, 4), wt, EPS)], dim=2)
    out = torch.full((2, 4, 37, 32), 7.0, dtype=dtype)
    assert qk_norm_rope(img, wi, EPS, 4, cos, sin, out=out) is out
    qk_norm_rope(txt, wt, EPS, 4, out=out, r0=30)
    assert torch.equal(out, eager)
    part = torch.full((2, 4, 40, 32), 7.0, dtype=dtype)
    qk_norm_rope(txt, wt, EPS, 4, out=part, r0=31)
    assert torch.equal(part[:, :, 31:38], eager[:, :, 30:]) and bool((part[:, :, :31] == 7).all()) \
        and bool((part[:, :, 38:] == 7).all())


def test_cpu_tensors_count_plain_calls():
    x, w = _x((1, 5, 64), 10), _w(64, 11)
    _kernels.reset_counts()
    qk_norm_rope(x, w, EPS, 2)
    qk_norm_rope_plain(x, w, EPS, 2)
    assert _kernels.PLAIN_CALLS["qk_norm_rope"] == 2 and not any(_kernels.LAUNCHES.values())
    assert _kernels.PLAIN_CALLS["rope"] == 0  # the rotation inside is not K2's plain call


_BAD = {"x not (B, S, d)": lambda x, w: dict(x=x[0]),
        "d not a multiple of heads": lambda x, w: dict(heads=3),
        "a weight of neither width": lambda x, w: dict(weight=w[:16]),
        "cos without sin": lambda x, w: dict(cos=torch.ones(5, 16)),
        "more table rows than tokens": lambda x, w: dict(cos=torch.ones(6, 16), sin=torch.ones(6, 16)),
        "tables of another head dim": lambda x, w: dict(cos=torch.ones(5, 32), sin=torch.ones(5, 32)),
        "out shorter than the rows": lambda x, w: dict(out=torch.zeros(2, 2, 4, 32, dtype=torch.bfloat16)),
        "rows past out's end": lambda x, w: dict(out=torch.zeros(2, 2, 8, 32, dtype=torch.bfloat16), r0=4),
        "out of another dtype": lambda x, w: dict(out=torch.zeros(2, 2, 5, 32)),
        "an offset without a buffer": lambda x, w: dict(r0=1)}


@pytest.mark.parametrize("case", list(_BAD))
def test_wrapper_rejects_shapes_that_do_not_fit(case):
    x, w = _x((2, 5, 64), 12), _w(64, 13)
    args = dict(x=x, weight=w, heads=2, cos=None, sin=None, out=None, r0=0)
    args.update(_BAD[case](x, w))
    with pytest.raises(ValueError):
        qk_norm_rope(args.pop("x"), args.pop("weight"), EPS, args.pop("heads"), args.pop("cos"), args.pop("sin"),
                     **args)


def test_kernel_args_take_qkv_views_and_reject_what_the_kernel_cannot_read():
    """kernel_args (what the CUDA path checks before a launch): a fused
    qkv's column view passes with its token and batch strides, a table's row
    slice passes; f32 x, a non-unit last stride, a token stride that breaks
    16-byte alignment, a head that does not tile a warp for a per-head norm,
    an f64 weight, tables that are not contiguous and an out that is not
    contiguous raise."""
    qkv = _x((2, 9, 3 * 256), 14)
    q = qkv.chunk(3, dim=-1)[0]
    wh, wt = _w(128, 15), _w(256, 16)
    out = torch.empty(2, 2, 9, 128, dtype=torch.bfloat16)
    tab = torch.ones(20, 64)
    assert kernel_args(q, wh, tab[11:], tab[11:], out) == (9 * 768, 768, 9)
    assert kernel_args(q[:1], wt, None, None, out[:1]) == (0, 768, 0)
    with pytest.raises(ValueError, match="bf16"):
        kernel_args(q.float(), wh, None, None, out)
    with pytest.raises(ValueError, match="unit last stride"):
        kernel_args(_x((2, 256, 9), 17).transpose(1, 2), wh, None, None, out)
    with pytest.raises(ValueError, match="unit last stride"):
        kernel_args(_x((2, 9, 260), 18)[:, :, :256], wh, None, None, out)
    with pytest.raises(ValueError, match="32 % \\(D / 8\\)"):
        kernel_args(_x((2, 9, 96), 19), _w(48, 20), None, None, torch.empty(2, 2, 9, 48, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="weight"):
        kernel_args(q, wh.double(), None, None, out)
    with pytest.raises(ValueError, match="cos"):
        kernel_args(q, wh, torch.ones(9, 128)[:, ::2], tab[:9], out)
    with pytest.raises(ValueError, match="contiguous"):
        kernel_args(q, wh, None, None, torch.empty(2, 2, 128, 9, dtype=torch.bfloat16).transpose(2, 3))


def _old_chain(x, weight, eps, heads, cos=None, sin=None, *, out=None, r0=0):
    """The expressions the models ran at `model.qk` before the fused op:
    Wan's rms_norm then the head view, HunyuanVideo's head view then
    rms_norm, apply_rope_interleaved (on the video rows, then a cat with
    the text rows) and the cat of [video | text]."""
    B, S, d = x.shape
    y = _heads(L.rms_norm(x, weight, eps), heads) if weight.shape[0] == d else L.rms_norm(_heads(x, heads), weight, eps)
    if cos is not None:
        n = cos.shape[0]
        y = apply_rope_interleaved(y, cos, sin) if n == S else torch.cat(
            [apply_rope_interleaved(y[:, :, :n], cos, sin), y[:, :, n:]], dim=2)
    if out is None:
        return y
    out[:, :, r0:r0 + S] = y  # the values of the old torch.cat of [video | text]
    return out


def _wan(model_type, dtype):
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime, wan_layout

    cfg = WM.WanConfig(model_type=model_type, in_dim=16 if model_type == "t2v" else 36, dim=128, ffn_dim=256,
                       num_heads=2, num_layers=2, freq_dim=32, text_dim=48, text_len=8, image_dim=40)
    model = WM.WanModel(cfg, dtype=dtype).init_random(torch.Generator().manual_seed(0))
    lay = wan_layout(cfg, 80, 128, 9)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, cfg.in_dim, lay.num_frames, 10, 16, generator=g).to(dtype)
    ctx = torch.randn(2, cfg.text_len, cfg.text_dim, generator=g).to(dtype)
    clip = torch.randn(2, 257, cfg.image_dim, generator=g) if model_type == "i2v" else None
    rt = make_wan_runtime(lay, device=torch.device("cpu"), pattern="dense")
    return cfg, lambda: model(x, torch.full((2,), 500.0), ctx, attention=rt, clip_fea=clip)


def _hy(dtype):
    from sparse_videogen_tpu_torch.pipelines.hyvideo import hyvideo_layout, make_hyvideo_runtime

    cfg = HM.HyVideoConfig(hidden_size=128, heads_num=2, mm_double_blocks_depth=2, mm_single_blocks_depth=2,
                           rope_dim_list=(16, 24, 24), text_states_dim=32, text_states_dim_2=24, text_len=8,
                           mlp_width_ratio=2.0)
    model = HM.HyVideoModel(cfg, dtype=dtype).init_random(torch.Generator().manual_seed(0))
    lay = hyvideo_layout(cfg, 128, 256, 9)
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, 16, lay.num_frames, 16, 32, generator=g).to(dtype)
    text = torch.randn(1, cfg.text_len, cfg.text_states_dim, generator=g).to(dtype)
    mask = (torch.arange(cfg.text_len) < 5).to(torch.int32)[None]
    pooled = torch.randn(1, cfg.text_states_dim_2, generator=g).to(dtype)
    rt = make_hyvideo_runtime(lay, device=torch.device("cpu"), prompt_length=5, pattern="dense")
    return cfg, lambda: model(x, torch.full((1,), 900.0), text, mask, pooled, guidance=torch.full((1,), 6000.0),
                              attention=rt)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("family", ["wan-t2v", "wan-i2v", "hyvideo"])
def test_one_call_a_qk_site_and_the_old_chains_output(family, dtype, monkeypatch):
    """Every `model.qk` site goes through qk_norm_rope once a forward (Wan 4
    a block, 5 in I2V with k_img; HunyuanVideo 4 a double block, 2 a single
    block; chip_smoke.py expects as many, qk_sites), no K2 plain call, and
    the forward equals, bit for bit, the same forward with the old chain at
    every site."""
    import chip_smoke

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        cfg, forward = _wan(family[4:], dtype) if family.startswith("wan") else _hy(dtype)
        _kernels.reset_counts()
        got = forward()
        calls, rope = _kernels.PLAIN_CALLS["qk_norm_rope"], _kernels.PLAIN_CALLS["rope"]
        monkeypatch.setattr(L, "qk_norm_rope", _old_chain)
        want = forward()
    finally:
        torch.set_num_threads(threads)
    sites = {"wan-t2v": 4 * 2, "wan-i2v": 5 * 2, "hyvideo": 4 * 2 + 2 * 2}[family]
    assert calls == sites == chip_smoke.qk_sites(cfg) and rope == 0
    assert torch.equal(got, want)


@pytest.mark.parametrize("pattern,streams", [("SVG", 1), ("SAP", 2)])
def test_smoke_expects_qk_launches_in_place_of_k2(pattern, streams):
    """chip_smoke.expected_launches with model_sites: Wan and HunyuanVideo
    launch qk_sites a forward and no K2; CogVideoX keeps K2 on q and k a
    layer and launches no fused q/k kernel."""
    import chip_smoke
    from sparse_videogen_tpu_torch.config import SAPConfig, WarmupSchedule
    from sparse_videogen_tpu_torch.presets import COG_768P_SVG, HY_PRESETS, T2V_480P

    timesteps = [999.0, 900.0, 500.0]
    for cfg in (T2V_480P.model, HY_PRESETS["hyvideo-720p-svg"].model):
        n = cfg.num_layers
        warmup = WarmupSchedule.from_fractions(0.0, 0.0, n, timesteps)
        want, _ = chip_smoke.expected_launches(pattern, n, warmup, timesteps, ("none", "band_sink"), sap=SAPConfig(),
                                               sap_streams=streams, **chip_smoke.model_sites(cfg))
        assert want["qk_norm_rope"] == streams * len(timesteps) * chip_smoke.qk_sites(cfg) and want["rope"] == 0
    cog = COG_768P_SVG.model
    warmup = WarmupSchedule.from_fractions(0.0, 0.0, cog.num_layers, timesteps)
    want, _ = chip_smoke.expected_launches("SVG", cog.num_layers, warmup, timesteps, ("none", "cog"),
                                           **chip_smoke.model_sites(cog))
    assert want["rope"] == 2 * cog.num_layers * len(timesteps) and want["qk_norm_rope"] == 0
    assert chip_smoke.qk_sites(T2V_480P.model) == 4 * 30 and chip_smoke.qk_sites(cog) == 0


def test_single_block_refuses_tables_of_another_length():
    cfg = HM.HyVideoConfig(hidden_size=64, heads_num=1, rope_dim_list=(16, 24, 24), text_len=4,
                           mm_double_blocks_depth=0, mm_single_blocks_depth=1, mlp_width_ratio=2.0)
    blk = HM.SingleBlock(cfg, torch.float32, "cpu")
    cos, sin = _tables((1, 2, 3), 64)
    with pytest.raises(ValueError, match="RoPE tables"):
        blk(torch.randn(1, 11, 64), torch.randn(1, 64), cos, sin, 4, 500.0, 0, attention=None)
