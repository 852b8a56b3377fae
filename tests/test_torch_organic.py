"""The port's utils/organic.py against the JAX package's: the weight surgery
exactly, whether it runs in JAX (then carried across by io/from_jax.py) or
in the port; smooth_latents to 1e-5 (f32) when both get the same
low-resolution field."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu.models.hyvideo import model as JHM
from sparse_videogen_tpu.models.wan import model as JWM
from sparse_videogen_tpu.utils import organic as JO
from sparse_videogen_tpu_torch.io.from_jax import hyvideo_params_from_numpy, wan_params_from_numpy
from sparse_videogen_tpu_torch.models.hyvideo import model as THM
from sparse_videogen_tpu_torch.models.wan import model as TWM
from sparse_videogen_tpu_torch.utils import organic as TO

WAN_KW = dict(dim=128, ffn_dim=256, num_heads=2, num_layers=2, freq_dim=32, text_dim=48, text_len=8)
HY_KW = dict(hidden_size=128, heads_num=2, mm_double_blocks_depth=2, mm_single_blocks_depth=2,
             rope_dim_list=(16, 24, 24), text_states_dim=32, text_states_dim_2=24, text_len=8, mlp_width_ratio=2.0)


def _perturbed(tree):
    """Every leaf perturbed (f32), so unit norm weights and zero biases
    cannot hide a slip."""
    rng = np.random.default_rng(0)
    return jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree)


def _assert_same_state(got: dict, want: dict):
    assert got.keys() == want.keys()
    for name, t in want.items():
        assert torch.equal(got[name], t.to(got[name].dtype)), name


@pytest.mark.parametrize("gain", [1.0, 3.5])
def test_align_self_attn_qk_matches_jax(gain):
    """Wan: K := Q in every self-attention (never the cross-attention) and
    norm_q x gain, the same bits as JAX's surgery on the same tree."""
    jcfg, tcfg = JWM.WanConfig(**WAN_KW), TWM.WanConfig(**WAN_KW)
    tree = _perturbed(JWM.init_wan_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32))
    want = wan_params_from_numpy(jax.tree.map(np.asarray, JO.align_self_attn_qk(tree, gain=gain)), tcfg)
    model = TWM.WanModel(tcfg, dtype=torch.float32)
    model.load_state_dict(wan_params_from_numpy(tree, tcfg))
    assert TO.align_self_attn_qk(model, gain=gain) is model
    _assert_same_state(model.state_dict(), want)
    for blk in model.blocks:
        assert torch.equal(blk.self_attn.k.weight, blk.self_attn.q.weight)
        assert not torch.equal(blk.cross_attn.k.weight, blk.cross_attn.q.weight)


@pytest.mark.parametrize("gain", [1.0, 3.5])
def test_align_fused_qkv_matches_jax(gain):
    """HunyuanVideo: the k outputs of every fused qkv / linear1 projection
    (the token refiner's, the double blocks' image and text, the single
    blocks') copy the q outputs and every *q_norm weight is scaled by gain,
    the same bits as JAX's surgery."""
    jcfg, tcfg = JHM.HyVideoConfig(**HY_KW), THM.HyVideoConfig(**HY_KW)
    tree = _perturbed(JHM.init_hyvideo_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32))
    h = jcfg.hidden_size
    aligned = JO.align_fused_qkv(jax.tree.map(jnp.asarray, tree), h, gain=gain)
    want = hyvideo_params_from_numpy(jax.tree.map(np.asarray, aligned), tcfg)
    model = hyvideo_params_from_numpy(tree, tcfg)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    assert TO.align_fused_qkv(model, h, gain=gain) is model
    _assert_same_state(model.state_dict(), want.state_dict())
    w = model.single_blocks[0].linear1.weight
    assert torch.equal(w[h:2 * h], w[:h]) and torch.equal(w[2 * h:], before["single_blocks.0.linear1.weight"][2 * h:])
    changed = {k for k, v in model.state_dict().items() if not torch.equal(v, before[k])}
    assert {"txt_in.blocks.0.qkv.weight", "double_blocks.1.img_qkv.bias", "double_blocks.0.txt_qkv.weight"} <= changed
    assert ("double_blocks.0.img_q_norm" in changed) == (gain != 1.0)


@pytest.mark.parametrize("shape", [(2, 3, 5, 12, 18), (1, 2, 1, 7, 10), (1, 4, 21, 30, 52)])
def test_smooth_latents_matches_jax(shape):
    """The same low-resolution field (JAX's own draw) through JAX's
    smooth_latents and the port's smooth_field: jax.image.resize's linear
    kernel renormalises its weights where they reach past the border, and
    when upsampling only one input sample lies inside there, so it holds the
    edge value, as F.interpolate's clamped half-pixel coordinates do. The
    two weigh the samples and sum the variance in other orders (f32; the
    standard deviation over up to 131,040 values): rtol 1e-5, atol 1e-5 on
    unit-variance values (f32 rounding of values near 0). The port's smooth_latents draws its field from
    a torch.Generator: same field, same result; unit variance."""
    factors = (3, 6, 6)
    key = jax.random.PRNGKey(3)
    want = np.asarray(JO.smooth_latents(key, shape, factors, dtype=jnp.float32))
    low_shape = shape[:2] + tuple(max(1, -(-n // f)) for n, f in zip(shape[2:], factors))
    low = torch.from_numpy(np.asarray(jax.random.normal(key, low_shape, jnp.float32)))
    got = TO.smooth_field(low, shape, torch.float32)
    assert got.shape == shape and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    ours = TO.smooth_latents(torch.Generator().manual_seed(1), shape, factors, dtype=torch.float32)
    field = torch.randn(low_shape, generator=torch.Generator().manual_seed(1))
    assert torch.equal(ours, TO.smooth_field(field, shape, torch.float32))
    assert abs(ours.std(correction=0).item() - 1.0) < 1e-5
    assert TO.smooth_latents(torch.Generator().manual_seed(1), shape).dtype == torch.bfloat16


def test_organic_inputs_lower_sap_density():
    """The port's use of the surgery (scripts/profile_wan.py --organic): a
    tiny Wan with K := Q (gain 4) on smooth latents gives SAP a lower
    density than random weights on i.i.d. latents, and sap_run_list_stats
    counts every sparse layer's run lists (live columns <= loaded ones).
    generate_latents takes such latents in place of its noise and refuses
    another shape."""
    import dataclasses

    from sparse_videogen_tpu_torch.config import SAPConfig, SVGConfig, WarmupSchedule
    from sparse_videogen_tpu_torch.models.wan.model import WAN_1_3B, WanModel
    from sparse_videogen_tpu_torch.pipelines import WanPipeline
    from sparse_videogen_tpu_torch.pipelines.wan import make_wan_runtime, wan_layout
    from sparse_videogen_tpu_torch.scripts.profile_wan import sap_run_list_stats

    cfg = dataclasses.replace(WAN_1_3B, dim=256, ffn_dim=512, num_heads=2, num_layers=2)
    H, W, NF = 96, 128, 9
    sap = SAPConfig(num_q_centroids=8, num_k_centroids=24, kmeans_iter_init=4)
    lay = wan_layout(cfg, H, W, NF)
    shape = (cfg.out_dim, lay.num_frames, H // 8, W // 8)
    stats = {}
    for gain in (None, 4.0):
        gen = torch.Generator().manual_seed(0)
        model = WanModel(cfg, dtype=torch.bfloat16).init_random(gen)
        if gain is not None:
            TO.align_self_attn_qk(model, gain=gain)
        x = torch.randn(2, *shape, generator=gen).to(torch.bfloat16) if gain is None else TO.smooth_latents(
            gen, (2, *shape))
        ctx = torch.randn(2, cfg.text_len, cfg.text_dim, generator=gen).to(torch.bfloat16)
        t = torch.full((1,), 500.0)
        rt = make_wan_runtime(lay, device="cpu", pattern="SAP", warmup=WarmupSchedule(0, 1e9), sap=sap)

        def forwards():
            for s in range(2):
                rt.states = {}
                model(x[s:s + 1], t, ctx[s:s + 1], attention=rt, generator=gen)

        stats[gain] = sap_run_list_stats(forwards)
        assert stats[gain]["layers"] == 4
        assert 0 < stats[gain]["live_columns"] <= stats[gain]["loaded_columns"]
    assert stats[4.0]["density_mean"] < 0.5 * stats[None]["density_mean"]
    pipe = WanPipeline(model)
    kw = dict(height=H, width=W, num_frames=NF, num_inference_steps=1, pattern="dense")
    lat = TO.smooth_latents(gen, (1, *shape), dtype=torch.float32)
    want = pipe._denoise(ctx[:1], ctx[1:], lat, guidance_scale=5.0, flow_shift=3.0, first_layers_fp=0.0,
                         first_times_fp=0.0, svg=SVGConfig(), **kw)
    assert torch.equal(pipe.generate_latents(ctx[:1], ctx[1:], latents=lat, **kw), want)
    with pytest.raises(ValueError, match="latents"):
        pipe.generate_latents(ctx[:1], ctx[1:], latents=lat[:, :, :1], **kw)
