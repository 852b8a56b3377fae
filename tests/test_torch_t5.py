"""The port's UMT5 encoder (models/common/t5.py, io/encoders.py,
io/checkpoint.convert_umt5) against the JAX package's on the same numpy
weights (io/from_jax.t5_params_from_numpy). Both run the residual stream
in f32 (the norm weights are f32) with each linear's weights cast to f32;
the differences are f32 summation order."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu.io import checkpoint as JCK
from sparse_videogen_tpu.io.encoders import UMT5Encoder as JEncoder
from sparse_videogen_tpu.models.common import t5 as JT5
from sparse_videogen_tpu_torch.io import checkpoint as TCK
from sparse_videogen_tpu_torch.io.encoders import UMT5Encoder as TEncoder
from sparse_videogen_tpu_torch.io.from_jax import t5_params_from_numpy
from sparse_videogen_tpu_torch.io.safetensors import save_file
from sparse_videogen_tpu_torch.models.common import t5 as TT5
from tests.test_prompt_to_video import _make_umt5_sd, _write_spiece

CFG_KW = dict(vocab_size=120, dim=32, dim_attn=32, dim_ffn=48, num_heads=4, num_layers=2, num_buckets=8, max_dist=16)
JCFG, TCFG = JT5.T5Config(**CFG_KW), TT5.T5Config(**CFG_KW)


def rel_err(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


@pytest.mark.parametrize("seq_len,num_buckets,max_dist", [(20, 8, 16), (512, 32, 128), (77, 32, 128)])
def test_bucket_table_exact(seq_len, num_buckets, max_dist):
    ours = TT5.relative_position_buckets(seq_len, num_buckets, max_dist)
    assert ours.dtype == np.int32
    np.testing.assert_array_equal(ours, JT5.relative_position_buckets(seq_len, num_buckets, max_dist))


def _inputs():
    rng = np.random.default_rng(0)
    ids = rng.integers(0, CFG_KW["vocab_size"], (2, 20)).astype(np.int32)
    mask = np.ones((2, 20), np.int32)
    mask[0, 12:] = 0
    return ids, mask


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_umt5_matches_jax(dtype):
    """2 layers, every leaf perturbed (no unit norm or zero bias hides a
    layout slip). f32: rel L2 <= 1e-5 (measured ~3e-7 on the CPU). bf16
    weights (the CLI's): both sides cast the same bf16 values up and run f32,
    so the same tolerance holds."""
    tree = JT5.init_t5_params(jax.random.PRNGKey(0), JCFG, dtype=jnp.float32)
    rng = np.random.default_rng(1)
    tree = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), tree)
    jdt, tdt = (jnp.float32, torch.float32) if dtype == "float32" else (jnp.bfloat16, torch.bfloat16)
    layout = JT5.init_t5_params(jax.random.PRNGKey(0), JCFG, dtype=jdt)
    tree = jax.tree.map(lambda a, ref: np.asarray(a).astype(ref.dtype), tree, layout)
    ids, mask = _inputs()
    ref = JT5.t5_encode(tree, JCFG, jnp.asarray(ids), jnp.asarray(mask))
    model = TT5.T5Encoder(TCFG, dtype=tdt)
    model.load_state_dict(t5_params_from_numpy(tree, TCFG))
    assert model.blocks[0].q.weight.dtype == tdt and model.norm.dtype == torch.float32
    ours = model(ids, mask)
    assert ours.dtype == torch.float32 and tuple(ours.shape) == (2, 20, 32)
    assert rel_err(ours.numpy(), np.asarray(ref, np.float32)) <= 1e-5


def test_convert_umt5_equals_jax_conversion():
    """The reference's names -> the port's state_dict: the same bf16 weights
    as JAX's convert_umt5, after the (in, out) -> (out, in) layout change."""
    cfg_kw = dict(vocab_size=16, dim=16, dim_attn=16, dim_ffn=24, num_heads=2, num_layers=2, num_buckets=8)
    jcfg, tcfg = JT5.T5Config(**cfg_kw), TT5.T5Config(**cfg_kw)
    sd = _make_umt5_sd(jcfg)
    ref = TT5.T5Encoder(tcfg)
    ref.load_state_dict(t5_params_from_numpy(jax.tree.map(np.asarray, JCK.convert_umt5(sd, jcfg)), tcfg))
    ours = TT5.T5Encoder(tcfg)
    ours.load_state_dict(TCK.convert_umt5({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg))
    want = ref.state_dict()
    for name, t in ours.state_dict().items():
        assert t.dtype == want[name].dtype
        assert torch.equal(t, want[name]), name


def test_umt5_encoder_from_dir_zeroes_padding(tmp_path):
    """UMT5Encoder.from_dir on a dir of safetensors (written by the port's
    writer), config.json and spiece.model: the states past each prompt's
    tokens are 0, the rest equal JAX's within rel L2 1e-5."""
    import json

    cfg_kw = dict(vocab_size=16, dim=16, dim_attn=16, dim_ffn=24, num_heads=2, num_layers=2, num_buckets=8)
    (tmp_path / "umt5").mkdir()
    save_file({k: torch.from_numpy(v) for k, v in _make_umt5_sd(JT5.T5Config(**cfg_kw)).items()},
              str(tmp_path / "umt5" / "model.safetensors"))
    (tmp_path / "umt5" / "config.json").write_text(json.dumps(cfg_kw))
    _write_spiece(str(tmp_path))
    texts = ["a cat", "the grass on the grass"]
    ours = TEncoder.from_dir(str(tmp_path), text_len=8)(texts).numpy()
    ref = np.asarray(JEncoder.from_dir(str(tmp_path), text_len=8)(texts), np.float32)
    assert ours.shape == (2, 8, 16) and np.isfinite(ours).all()
    assert np.abs(ours[0, 3:]).max() == 0.0  # "a cat" is 3 tokens with </s>
    assert (np.abs(ours).sum(axis=(1, 2)) > 0).all()
    np.testing.assert_array_equal(ours == 0, ref == 0)
    assert rel_err(ours, ref) <= 1e-5
