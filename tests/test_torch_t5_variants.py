"""T5 v1.0 (Cosmos's t5-11b: ReLU, not gated) and v1.1 (CogVideoX's:
gated tanh-GELU), both with block 0's relative bias shared by every layer,
in the port (models/common/t5.py, io/checkpoint.convert_t5_hf and
t5_config_from_json, io/encoders.T5TextEncoder) against the JAX package on
the same numpy weights, and against transformers.T5EncoderModel on
HF-named configs, where the JAX package's config reader keeps UMT5's
defaults and its converter then fails (ROADMAP.md section 3). Also the
LLaMA and CLIP text config readers on HF's names.

Tolerances: configs and converters exact (bit for bit); f32 encoders rel L2
1e-5 (the residual stream is f32 on both sides; summation order only)."""

import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu.io import checkpoint as JCK
from sparse_videogen_tpu.models.common import t5 as JT5
from sparse_videogen_tpu_torch.io import checkpoint as TCK
from sparse_videogen_tpu_torch.io import encoders as TENC
from sparse_videogen_tpu_torch.io.from_jax import t5_params_from_numpy
from sparse_videogen_tpu_torch.models.common import t5 as TT5

VARIANTS = {
    "v1.0": dict(gated_ffn=False, shared_rel_bias=True, ffn_act="relu"),
    "v1.1": dict(gated_ffn=True, shared_rel_bias=True, ffn_act="gelu_tanh"),
    "umt5": dict(gated_ffn=True, shared_rel_bias=False, ffn_act="gelu_tanh"),
}
SIZES = dict(vocab_size=120, dim=32, dim_attn=32, dim_ffn=48, num_heads=4, num_layers=2, num_buckets=8, max_dist=16)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _inputs(L=20):
    rng = np.random.default_rng(0)
    ids = rng.integers(0, SIZES["vocab_size"], (2, L)).astype(np.int32)
    mask = np.ones((2, L), np.int32)
    mask[0, 12:] = 0
    return ids, mask


def test_presets_are_the_jax_packages():
    assert dataclasses.asdict(TT5.T5_11B) == dataclasses.asdict(JT5.T5_11B)
    assert dataclasses.asdict(TT5.UMT5_XXL) == dataclasses.asdict(JT5.UMT5_XXL)
    v11 = TT5.T5_V1_1_XXL  # google/t5-v1_1-xxl's config.json
    assert (v11.dim, v11.dim_attn, v11.dim_ffn, v11.num_heads, v11.vocab_size) == (4096, 4096, 10240, 64, 32128)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_t5_encode_matches_jax(variant):
    """Every leaf perturbed, a mask with padding; f32: rel L2 <= 1e-5."""
    jcfg = JT5.T5Config(**SIZES, **VARIANTS[variant])
    tcfg = TT5.T5Config(**SIZES, **VARIANTS[variant])
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32),
                        JT5.init_t5_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32))
    ids, mask = _inputs()
    ref = JT5.t5_encode(tree, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    model = TT5.T5Encoder(tcfg, dtype=torch.float32)
    model.load_state_dict(t5_params_from_numpy(tree, tcfg))
    assert (model.rel_embedding is None) == (variant == "umt5")
    assert (model.blocks[0].gate is None) == (variant == "v1.0")
    out = model(ids, mask)
    assert out.dtype == torch.float32 and rel_err(out.numpy(), ref) <= 1e-5


def _hf_model(proj):
    from transformers import T5Config, T5EncoderModel

    torch.manual_seed(0)
    hf_cfg = T5Config(vocab_size=120, d_model=16, d_kv=4, d_ff=40, num_layers=2, num_heads=4,
                      relative_attention_num_buckets=8, relative_attention_max_distance=16, feed_forward_proj=proj,
                      dropout_rate=0.0)
    hf = T5EncoderModel(hf_cfg).eval()
    with torch.no_grad():
        for name, p in hf.named_parameters():
            if "layer_norm" in name:
                p.add_(0.1 * torch.randn(p.shape))
    return hf, hf_cfg


@pytest.mark.parametrize("proj", ["relu", "gated-gelu"])
def test_hf_named_config_matches_transformers(tmp_path, proj):
    """HF's config.json names (d_model 16, 2 layers, 8 buckets) read by
    t5_config_from_json, HF's weights by convert_t5_hf: the states equal
    transformers.T5EncoderModel's within rel L2 1e-5 over every position,
    padding included."""
    hf, hf_cfg = _hf_model(proj)
    (tmp_path / "config.json").write_text(json.dumps(hf_cfg.to_dict()))
    cfg = TCK.t5_config_from_json(str(tmp_path))
    assert (cfg.dim, cfg.dim_attn, cfg.dim_ffn, cfg.num_heads, cfg.num_layers, cfg.num_buckets, cfg.max_dist) == (
        16, 16, 40, 4, 2, 8, 16)
    assert cfg.shared_rel_bias and cfg.gated_ffn == (proj == "gated-gelu")
    assert cfg.ffn_act == ("relu" if proj == "relu" else "gelu_tanh")
    model = TT5.T5Encoder(cfg, dtype=torch.float32)
    model.load_state_dict(TCK.convert_t5_hf(hf.state_dict(), cfg))
    ids, mask = _inputs(11)
    ids = ids % 120
    with torch.no_grad():
        ref = hf(input_ids=torch.as_tensor(ids).long(), attention_mask=torch.as_tensor(mask).long()).last_hidden_state
    assert rel_err(model(ids, mask).numpy(), ref.numpy()) <= 1e-5


def test_hf_config_reader_names():
    base = {"model_type": "t5", "d_model": 64, "d_kv": 16, "num_heads": 8, "d_ff": 96, "num_layers": 3,
            "vocab_size": 500, "relative_attention_num_buckets": 16, "relative_attention_max_distance": 64,
            "layer_norm_epsilon": 1e-5, "feed_forward_proj": "gated-gelu"}
    cfg = TT5.t5_config_from_dict(base)
    assert cfg == TT5.T5Config(vocab_size=500, dim=64, dim_attn=128, dim_ffn=96, num_heads=8, num_layers=3,
                               num_buckets=16, max_dist=64, eps=1e-5, gated_ffn=True, shared_rel_bias=True,
                               ffn_act="gelu_tanh")
    assert not TT5.t5_config_from_dict(dict(base, model_type="umt5")).shared_rel_bias
    assert TT5.t5_config_from_dict(dict(base, feed_forward_proj="relu")).gated_ffn is False
    for bad in ("gelu", "gated-silu"):
        with pytest.raises(ValueError, match=bad):
            TT5.t5_config_from_dict(dict(base, feed_forward_proj=bad))


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_package_names_read_as_jax_reads_them(tmp_path, variant):
    """config.json in the package's own names: the port's reader equals the
    JAX package's dataclass_from_json exactly (other keys ignored)."""
    kw = dict(SIZES, **VARIANTS[variant])
    (tmp_path / "config.json").write_text(json.dumps(dict(kw, comment="ignored")))
    ours = TCK.t5_config_from_json(str(tmp_path))
    ref = JCK.dataclass_from_json(str(tmp_path), JT5.T5Config)
    assert dataclasses.asdict(ours) == dataclasses.asdict(ref)


@pytest.mark.parametrize("proj", ["relu", "gated-gelu"])
def test_convert_t5_hf_matches_jax(proj):
    """The converter bit for bit: JAX's convert_t5_hf carried over by
    t5_params_from_numpy equals the port's convert_t5_hf on the same HF
    state dict (v1.0 wi, v1.1 wi_0 / wi_1, block 0's bias)."""
    hf, hf_cfg = _hf_model(proj)
    cfg_kw = dict(vocab_size=120, dim=16, dim_attn=16, dim_ffn=40, num_heads=4, num_layers=2, num_buckets=8,
                  max_dist=16, gated_ffn=proj != "relu", shared_rel_bias=True,
                  ffn_act="relu" if proj == "relu" else "gelu_tanh")
    sd = {k: v.numpy() for k, v in hf.state_dict().items()}
    jtree = jax.tree.map(np.asarray, JCK.convert_t5_hf(sd, JT5.T5Config(**cfg_kw), dtype=jnp.float32))
    ref = t5_params_from_numpy(jtree, TT5.T5Config(**cfg_kw))
    ours = TCK.convert_t5_hf({k: torch.as_tensor(v) for k, v in sd.items()}, TT5.T5Config(**cfg_kw))
    assert sorted(ours) == sorted(ref)
    for k in ref:
        assert torch.equal(torch.as_tensor(ours[k]).float(), ref[k].float()), k


@pytest.mark.parametrize("mask_output", [False, True], ids=["cog_unmasked", "cosmos_masked"])
def test_text_encoder_matches_the_jax_clis(tmp_path, mask_output):
    """T5TextEncoder on a checkpoint dir (HF weights, spiece.model): the
    states as the JAX CLIs compute them: t5_encode of the tokenizer's ids
    and mask, times the mask for Cosmos, as they are for CogVideoX."""
    import chip_smoke
    from sparse_videogen_tpu.io.tokenizer import T5TokenizerLite as JTok

    prompt = "a cat walks on the grass"
    chip_smoke.write_tiny_cosmos_checkpoint(str(tmp_path), prompt, t5_names="package")
    cfg_kw = {k: v for k, v in json.loads((tmp_path / "text_encoder" / "config.json").read_text()).items()}
    jcfg = JT5.T5Config(**cfg_kw)
    enc = TENC.T5TextEncoder.from_dir(str(tmp_path), text_len=32, default_cfg=TT5.T5_11B, mask_output=mask_output,
                                      dtype=torch.float32)
    out = enc([prompt]).numpy()
    params = JCK.convert_t5_hf(JCK.load_safetensors_dir(str(tmp_path / "text_encoder")), jcfg, dtype=jnp.float32)
    ids, mask = JTok.from_dir(str(tmp_path))([prompt], seq_len=32)
    ref = np.asarray(JT5.t5_encode(params, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    if mask_output:
        ref = ref * mask[..., None]
        assert (out[0, int(mask.sum()):] == 0).all()
    assert rel_err(out, ref) <= 1e-5


def test_llama_and_clip_text_readers_map_hf_names(tmp_path):
    """HF's LlamaConfig / CLIPTextConfig size keys give the sizes (the JAX
    reader would keep the defaults); the package's own names read as JAX
    reads them."""
    from sparse_videogen_tpu.models.common.llama import LlamaConfig as JLlama
    from sparse_videogen_tpu_torch.models.common.clip import CLIPTextConfig
    from sparse_videogen_tpu_torch.models.common.llama import LlamaConfig

    (tmp_path / "config.json").write_text(json.dumps({
        "vocab_size": 1000, "hidden_size": 64, "intermediate_size": 96, "num_hidden_layers": 3,
        "num_attention_heads": 4, "num_key_value_heads": 2, "rope_theta": 10000.0, "rms_norm_eps": 1e-6,
        "max_position_embeddings": 77, "layer_norm_eps": 1e-5}))
    assert TENC.llama_config_from_json(str(tmp_path)) == LlamaConfig(
        vocab_size=1000, dim=64, ffn_dim=96, num_layers=3, num_heads=4, num_kv_heads=2, rope_theta=10000.0, eps=1e-6)
    assert TENC.clip_text_config_from_json(str(tmp_path)) == CLIPTextConfig(
        vocab_size=1000, dim=64, ffn_dim=96, num_layers=3, num_heads=4, max_positions=77, eps=1e-5)
    own = dict(vocab_size=50, dim=32, ffn_dim=48, num_layers=3, num_heads=4, num_kv_heads=2)
    (tmp_path / "config.json").write_text(json.dumps(own))
    assert dataclasses.asdict(TENC.llama_config_from_json(str(tmp_path))) == dataclasses.asdict(
        JCK.dataclass_from_json(str(tmp_path), JLlama))
    assert TENC.llama_config_from_json(str(tmp_path / "absent")) is None
