"""At tiny sizes on the CPU, the plain reference agrees with the port's CPU
path: the Wan DiT in f32, SVG1's classes and attention, the sampler's first
step. (The test imports both; the reference imports nothing of the port.)"""

import copy

import pytest
import torch

from svgbench import inputs as I
from svgbench.families import wan
from svgbench.reference import attn_judge, svg1 as RS, wan as RW
from svgbench.reference.common import attention
from svgbench.spec import Benchmark

TINY = dict(dim=128, ffn_dim=256, num_heads=2, num_layers=2, text_len=16, text_dim=64, freq_dim=32)
TINY_GEN = dict(height=128, width=256, num_frames=17)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def tiny_cfg():
    cfg = copy.deepcopy(Benchmark().cell("wan1.3b-480p-svg1").config)
    cfg["model"].update(TINY)
    cfg["generation"].update(TINY_GEN)
    return wan.model_cfg(cfg)


def rel(a, b):
    return float((a - b).norm() / b.norm())


def test_wan_forward_matches_the_port_in_f32():
    from sparse_videogen_tpu_torch.models.wan.model import WanConfig, WanModel

    c = tiny_cfg()
    P = I.f32_params(wan.param_spec(c), 5, "cpu")
    keys = ("model_type", "text_len", "in_dim", "dim", "ffn_dim", "freq_dim", "text_dim", "out_dim", "num_heads",
            "num_layers", "eps")
    model = WanModel(WanConfig(patch_size=tuple(c["patch_size"]), **{k: c[k] for k in keys}), dtype=torch.float32)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(P[n])
    g = torch.Generator().manual_seed(1)
    x = torch.randn(1, *wan.latent_shape(c), generator=g)
    ctx = torch.randn(1, c["text_len"], c["text_dim"], generator=g)
    t = RW.timestep0(50, 3.0)
    dense = lambda q, k, v, *a, **kw: torch.stack([attention(q[b], k[b], v[b]) for b in range(q.shape[0])])
    ours = RW.forward(P, c, x[0], t, ctx[0], lambda li, q, k, v: attention(q, k, v))
    port = model(x, torch.full((1,), t), ctx, attention=dense)[0]
    assert rel(ours, port) < 1e-5


def test_svg1_classes_and_attention_match_the_port():
    from sparse_videogen_tpu_torch.config import SVGConfig, WarmupSchedule
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime
    from sparse_videogen_tpu_torch.config import VideoLayout

    nf, fs, H, D = 5, 128, 4, 32
    g = torch.Generator().manual_seed(3)
    # structured inputs: heads that prefer a spatial and heads that prefer a temporal neighbourhood
    base = torch.randn(1, H, nf * fs, D, generator=g)
    frame_code = torch.randn(nf, D, generator=g).repeat_interleave(fs, 0)
    slot_code = torch.randn(fs, D, generator=g).repeat(nf, 1)
    q = base.clone()
    q[:, :2] += 3 * frame_code
    q[:, 2:] += 3 * slot_code
    k = q + 0.1 * torch.randn(q.shape, generator=g)
    v = torch.randn(q.shape, generator=g)
    rows = torch.randint(0, nf * fs, (64,), generator=g)
    rt = make_wan_runtime(VideoLayout(num_frames=nf, frame_size=fs), device="cpu", pattern="SVG",
                          warmup=WarmupSchedule(), svg=SVGConfig(sparsity=0.25, profile_multiplier=2.0))
    port = rt(q, k, v, 500.0, 0, rows=rows)
    lay = RS.Layout(nf=nf, fs=fs)
    ref = attn_judge.Lowp("SVG", lay, RS.band_frames(0.25, lay), 2.0, 0, rows[None], "f32")
    ours = ref(0, q[0], k[0], v[0])
    assert rel(ours, port[0]) < 1e-5
    # the judge reads the port's classes back from its rows and finds nothing to fault
    j = attn_judge.Judge("SVG", lay, RS.band_frames(0.25, lay), 2.0, 0, rows[None], [port[0][:, rows]])
    again = j(0, q[0], k[0], v[0])
    assert rel(again, port[0]) < 1e-5 and j.class_gap == [0.0] and j.rows_rel[0] < 1e-5
    assert j.temporal_heads == 2


def test_unipc_first_step_matches_the_port():
    from sparse_videogen_tpu_torch.schedulers import FlowUniPC

    g = torch.Generator().manual_seed(0)
    x, v = torch.randn(16, 3, 4, 4, generator=g), torch.randn(16, 3, 4, 4, generator=g)
    sch = FlowUniPC(50, shift=3.0)
    port, _ = sch.step(0, x, v, sch.init_state(x))
    assert torch.allclose(RW.unipc_first_step(50, 3.0, x, v), port, rtol=1e-6, atol=1e-6)
    assert RW.timestep0(50, 3.0) == pytest.approx(float(sch.timesteps[0]), rel=1e-12)


def test_weights_are_the_same_for_program_and_reference():
    from sparse_videogen_tpu_torch.models.wan.model import WanConfig, WanModel

    c = tiny_cfg()
    keys = ("model_type", "text_len", "in_dim", "dim", "ffn_dim", "freq_dim", "text_dim", "out_dim", "num_heads",
            "num_layers", "eps")
    model = WanModel(WanConfig(patch_size=tuple(c["patch_size"]), **{k: c[k] for k in keys}), dtype=torch.bfloat16)
    I.load_into(model, wan.param_spec(c), 9)
    P = I.f32_params(wan.param_spec(c), 9, "cpu")
    for n, p in model.named_parameters():
        assert torch.equal(p.float(), P[n]), n
    w = P["blocks.1.ffn.fc1.weight"]
    assert abs(float(w.std()) * c["dim"] ** 0.5 - 1) < 0.05 and float(P["blocks.1.ffn.fc1.bias"].abs().sum()) == 0


HY_TINY = dict(hidden_size=128, heads_num=2, mm_double_blocks_depth=1, mm_single_blocks_depth=2,
               rope_dim_list=[16, 24, 24], text_states_dim=32, text_states_dim_2=16, text_len=16, refiner_depth=2)
HY_GEN = dict(height=128, width=256, num_frames=17, prompt_length=5)


def test_hyvideo_forward_matches_the_port_in_f32():
    from sparse_videogen_tpu_torch.models.hyvideo.model import HyVideoConfig, HyVideoModel
    from svgbench.families import hyvideo
    from svgbench.reference import hyvideo as RH

    cfg = copy.deepcopy(Benchmark().cell("hyvideo-720p-svg1").config)
    cfg["model"].update(HY_TINY)
    cfg["generation"].update(HY_GEN)
    c = hyvideo.model_cfg(cfg)
    P = I.f32_params(hyvideo.param_spec(c), 5, "cpu")
    keys = ("in_channels", "out_channels", "hidden_size", "heads_num", "mlp_width_ratio", "mm_double_blocks_depth",
            "mm_single_blocks_depth", "text_states_dim", "text_states_dim_2", "text_len", "guidance_embed",
            "refiner_depth", "eps")
    model = HyVideoModel(HyVideoConfig(patch_size=tuple(c["patch_size"]), rope_dim_list=tuple(c["rope_dim_list"]),
                                       **{k: c[k] for k in keys}), dtype=torch.float32)
    assert {n for n, _ in model.named_parameters()} == set(P)
    with torch.no_grad():
        for n, p in model.named_parameters():
            p.copy_(P[n])
    inp = hyvideo.make_inputs(c, {"num_sampled_rows": 8}, 3, "cpu")
    x, states, pooled, mask = inp["noise"], inp["states"].float(), inp["pooled"].float(), inp["mask"]
    dense = lambda q, k, v, *a, **kw: torch.stack([attention(q[b], k[b], v[b]) for b in range(q.shape[0])])
    ours = RH.forward(P, c, x[0], 1000.0, states[0], mask[0], pooled[0], 6000.0,
                      lambda li, q, k, v: attention(q, k, v))
    port = model(x, torch.full((1,), 1000.0), states, mask, pooled, guidance=torch.full((1,), 6000.0),
                 attention=dense)[0]
    # the guidance sinusoid's arguments reach 6000: f32 exp of its frequencies differs from f64 by an ulp
    assert rel(ours, port) < 1e-4


def test_euler_first_step_matches_the_port():
    from sparse_videogen_tpu_torch.schedulers import FlowMatchEuler
    from svgbench.reference import hyvideo as RH

    g = torch.Generator().manual_seed(0)
    x, v = torch.randn(16, 3, 4, 4, generator=g), torch.randn(16, 3, 4, 4, generator=g)
    sch = FlowMatchEuler(50, shift=7.0)
    assert torch.allclose(RH.euler_first_step(50, 7.0, x, v), sch.step(0, x, v)[0], rtol=1e-6, atol=1e-6)
    assert RH.timestep0(50, 7.0) == float(sch.timesteps[0])


@pytest.mark.parametrize("layout, width", [
    (RS.Layout(nf=5, fs=128), 0.7), (RS.Layout(nf=4, fs=200), 1.9),
    (RS.Layout(nf=5, fs=128, text=64, prompt=17), 1.3), (RS.Layout(nf=3, fs=300, text=32, prompt=0), 0.9)])
@pytest.mark.parametrize("temporal", [False, True])
def test_banded_attention_equals_the_masked_full_attention(layout, width, temporal):
    g = torch.Generator().manual_seed(7)
    q, k, v = (torch.randn(2, layout.seq, 16, generator=g) for _ in range(3))
    full = attention(q, k, v, RS.exec_allow(layout, width, temporal), block=96)
    torch.testing.assert_close(RS.attend(q, k, v, layout, width, temporal), full, rtol=1e-5, atol=1e-6)
