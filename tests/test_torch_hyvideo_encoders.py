"""HunyuanVideo's text encoders in the port against the JAX package: LLaMA
(GQA, the skipped last layers, right padding), the CLIP text tower, Llava
(the projected image patches spliced in), HyVideoTextEncoders and
LlavaImageTextEncoder from a checkpoint dir, and the converters.

The converters run on HF-named state dicts built with `transformers` on
this host (LlamaModel, CLIPTextModel, LlavaForConditionalGeneration in both
naming generations; the DiT on chip_smoke.reference_hyvideo_dit_sd's
hyvideo_orig names) and must give what the JAX conversion gives, carried
across by io/from_jax, bit for bit. The modules run in f32 on the same
weights: rel L2 at most 1e-5 (f32 summation order)."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
import sparse_videogen_tpu.io.checkpoint as JCK
from sparse_videogen_tpu.io import encoders as JENC
from sparse_videogen_tpu.models.common import clip as JCLIP
from sparse_videogen_tpu.models.common import llama as JL
from sparse_videogen_tpu.models.common import llava as JLV
from sparse_videogen_tpu.models.hyvideo import model as JHM
from sparse_videogen_tpu_torch.io import checkpoint as TCK
from sparse_videogen_tpu_torch.io import encoders as TENC
from sparse_videogen_tpu_torch.io import from_jax as FJ
from sparse_videogen_tpu_torch.models.common import clip as TCLIP
from sparse_videogen_tpu_torch.models.common import llama as TL
from sparse_videogen_tpu_torch.models.common import llava as TLV
from sparse_videogen_tpu_torch.models.hyvideo import model as THM

LLAMA = dict(vocab_size=64, dim=32, ffn_dim=48, num_layers=4, num_heads=4, num_kv_heads=2)
CLIP = dict(vocab_size=64, dim=24, ffn_dim=48, num_layers=2, num_heads=4, max_positions=77)
VISION = dict(image_size=28, patch_size=14, dim=32, ffn_dim=64, num_layers=3, num_heads=4, hidden_act="quick_gelu")
PROMPT = "a cat walks on the grass"


def rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.linalg.norm(a - b) / np.linalg.norm(b)


def _perturbed(module, seed):
    """An HF module's state dict with every tensor moved by N(0, 0.05^2),
    as numpy (norm weights of one and zero biases would hide a slip)."""
    g = torch.Generator().manual_seed(seed)
    return {k: (v + 0.05 * torch.randn(v.shape, generator=g)).numpy() for k, v in module.state_dict().items()}


def _hf_llama(seed=0):
    from transformers import LlamaConfig, LlamaModel

    torch.manual_seed(seed)
    return LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=48, num_hidden_layers=4,
                       num_attention_heads=4, num_key_value_heads=2, rope_theta=500000.0), LlamaModel


@pytest.fixture(scope="module")
def llama_sd():
    cfg, cls = _hf_llama()
    return _perturbed(cls(cfg), 0)


@pytest.fixture(scope="module")
def clip_sd():
    from transformers import CLIPTextConfig, CLIPTextModel

    torch.manual_seed(1)
    return _perturbed(CLIPTextModel(CLIPTextConfig(vocab_size=64, hidden_size=24, intermediate_size=48,
                                                   num_hidden_layers=2, num_attention_heads=4,
                                                   max_position_embeddings=77, hidden_act="quick_gelu")), 1)


@pytest.fixture(scope="module")
def llava_sd():
    from transformers import CLIPVisionConfig, LlavaConfig, LlavaForConditionalGeneration

    lcfg, _ = _hf_llama()
    vcfg = CLIPVisionConfig(image_size=28, patch_size=14, hidden_size=32, intermediate_size=64, num_hidden_layers=3,
                            num_attention_heads=4, hidden_act="quick_gelu")
    torch.manual_seed(2)
    return _perturbed(LlavaForConditionalGeneration(LlavaConfig(vision_config=vcfg, text_config=lcfg)), 2)


def _legacy(sd):
    """The pre-4.52 Llava names: vision_tower., language_model.model., multi_modal_projector."""
    out = {}
    for k, v in sd.items():
        for new, old in (("model.vision_tower.", "vision_tower."), ("model.language_model.", "language_model.model."),
                         ("model.multi_modal_projector.", "multi_modal_projector.")):
            if k.startswith(new):
                k = old + k[len(new):]
        out[k] = v
    return out


def _equal_state(ours: dict, ref: dict):
    assert set(ours) == set(ref)
    for k in ref:
        a, b = torch.as_tensor(ours[k]), ref[k]
        assert a.shape == b.shape and a.dtype == b.dtype and torch.equal(a, b), k


@pytest.mark.parametrize("skip", [0, 2])
def test_convert_llama_equals_jax(llama_sd, skip):
    """HF names with and without model.; the last `skip` layers dropped."""
    cfg = TL.LlamaConfig(**LLAMA)
    for sd in (llama_sd, {f"model.{k}": v for k, v in llama_sd.items()}):
        ref = FJ.llama_params_from_numpy(JCK.convert_llama(sd, JL.LlamaConfig(**LLAMA), skip_layers=skip,
                                                           dtype=jnp.float32), cfg)
        ours = TCK.convert_llama({k: torch.from_numpy(v) for k, v in sd.items()}, cfg, skip_layers=skip)
        _equal_state(ours, ref)
        assert sum(k.endswith(".ln1") for k in ours) == LLAMA["num_layers"] - skip


def test_convert_clip_text_equals_jax(clip_sd):
    cfg = TCLIP.CLIPTextConfig(**CLIP)
    ref = FJ.clip_text_params_from_numpy(JCK.convert_clip_text(clip_sd, JCLIP.CLIPTextConfig(**CLIP)), cfg)
    _equal_state(TCK.convert_clip_text({k: torch.from_numpy(v) for k, v in clip_sd.items()}, cfg), ref)


@pytest.mark.parametrize("naming", ["new", "legacy"])
def test_convert_llava_equals_jax(llava_sd, naming):
    sd = llava_sd if naming == "new" else _legacy(llava_sd)
    lcfg, vcfg = TL.LlamaConfig(**LLAMA), TCLIP.CLIPVisionConfig(**VISION)
    tree = JCK.convert_llava(sd, JL.LlamaConfig(**LLAMA), JCLIP.CLIPVisionConfig(**VISION), dtype=jnp.float32)
    ref = FJ.llava_params_from_numpy(jax.tree.map(np.asarray, tree), lcfg, vcfg)
    _equal_state(TCK.convert_llava({k: torch.from_numpy(v) for k, v in sd.items()}, lcfg, vcfg), ref)


def test_convert_hyvideo_dit_equals_jax():
    """hyvideo_orig names (chip_smoke.reference_hyvideo_dit_sd), fused q|k|v."""
    kw = dict(chip_smoke.TINY_HY_DIT, mm_double_blocks_depth=2, mm_single_blocks_depth=2)
    tcfg, jcfg = THM.HyVideoConfig(**kw), JHM.HyVideoConfig(**kw)
    sd = chip_smoke.reference_hyvideo_dit_sd(tcfg, torch.Generator().manual_seed(3))
    tree = JCK.convert_hyvideo_dit({k: v.numpy() for k, v in sd.items()}, jcfg, dtype=jnp.float32)
    ref = FJ.hyvideo_params_from_numpy(jax.tree.map(np.asarray, tree), tcfg).state_dict()
    _equal_state(TCK.convert_hyvideo_dit(sd, tcfg), ref)


def test_llama_matches_jax(llama_sd):
    """GQA (4 heads on 2 kv heads), 2 of 4 layers (skip 2), right padding
    (row 0 keeps 7 of 11 tokens): f32, rel L2 <= 1e-5."""
    jcfg, tcfg = JL.LlamaConfig(**LLAMA), TL.LlamaConfig(**LLAMA)
    tree = JCK.convert_llama(llama_sd, jcfg, dtype=jnp.float32)
    model = TL.LlamaModel(tcfg, n_layers=2, dtype=torch.float32)
    model.load_state_dict(TCK.convert_llama({k: torch.from_numpy(v) for k, v in llama_sd.items()}, tcfg))
    rng = np.random.default_rng(0)
    ids = rng.integers(0, LLAMA["vocab_size"], (2, 11)).astype(np.int32)
    mask = np.ones((2, 11), np.int32)
    mask[0, 7:] = 0
    ref = JL.llama_encode(tree, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    ours = TL.llama_encode(model, ids, mask)
    assert ours.shape == (2, 11, LLAMA["dim"]) and rel(ours, ref) <= 1e-5


def test_clip_text_matches_jax(clip_sd):
    """Causal plus padding bias, quick_gelu; the pooled state at the FIRST
    argmax id (the padding repeats the end-of-text id): f32, rel L2 <= 1e-5."""
    jcfg, tcfg = JCLIP.CLIPTextConfig(**CLIP), TCLIP.CLIPTextConfig(**CLIP)
    tree = JCK.convert_clip_text(clip_sd, jcfg)
    model = TCLIP.CLIPTextModel(tcfg)
    model.load_state_dict(TCK.convert_clip_text({k: torch.from_numpy(v) for k, v in clip_sd.items()}, tcfg))
    rng = np.random.default_rng(1)
    ids = rng.integers(0, 62, (2, 77)).astype(np.int32)
    ids[:, 0] = 62
    ids[0, 9:] = 63  # end-of-text, then its padding
    ids[1, 30] = 63
    mask = np.ones((2, 77), np.int32)
    mask[0, 10:] = 0
    hidden, pooled = TCLIP.clip_text_encode(model, ids, mask)
    rh, rp = JCLIP.clip_text_encode(tree, jcfg, jnp.asarray(ids), jnp.asarray(mask))
    assert rel(hidden, rh) <= 1e-5 and rel(pooled, rp) <= 1e-5
    np.testing.assert_allclose(pooled[0].numpy(), hidden[0, 9].numpy())


@pytest.mark.parametrize("interleave", [1, 2])
def test_llava_matches_jax(llava_sd, interleave):
    """The penultimate vision states without CLS (every interleave-th),
    fc1-gelu-fc2, spliced at position 3 of 8 ids: f32, rel L2 <= 1e-5."""
    lcfg, vcfg = TL.LlamaConfig(**LLAMA), TCLIP.CLIPVisionConfig(**VISION)
    tree = JCK.convert_llava(llava_sd, JL.LlamaConfig(**LLAMA), JCLIP.CLIPVisionConfig(**VISION), dtype=jnp.float32)
    model = TLV.LlavaModel(lcfg, vcfg, n_layers=2, dtype=torch.float32)
    model.load_state_dict(TCK.convert_llava({k: torch.from_numpy(v) for k, v in llava_sd.items()}, lcfg, vcfg))
    rng = np.random.default_rng(2)
    ids = rng.integers(0, 64, (1, 8)).astype(np.int32)
    mask = np.ones((1, 8), np.int32)
    mask[0, 6:] = 0
    px = rng.standard_normal((1, 3, 28, 28)).astype(np.float32)
    ref, rmask = JLV.llava_encode(tree, JL.LlamaConfig(**LLAMA), JCLIP.CLIPVisionConfig(**VISION), jnp.asarray(ids),
                                  jnp.asarray(mask), jnp.asarray(px), 3, interleave=interleave)
    ours, omask = TLV.llava_encode(model, ids, mask, torch.from_numpy(px), 3, interleave=interleave)
    assert ours.shape == (1, 7 + -(-4 // interleave), LLAMA["dim"])
    np.testing.assert_array_equal(omask.numpy(), np.asarray(rmask))
    assert rel(ours, ref) <= 1e-5


@pytest.fixture(scope="module")
def ckpt_dirs(tmp_path_factory):
    d = tmp_path_factory.mktemp("hy_enc")
    chip_smoke.write_tiny_hyvideo_checkpoint(str(d / "t2v"), PROMPT)
    chip_smoke.write_tiny_hyvideo_checkpoint(str(d / "i2v"), PROMPT, i2v=True)
    return str(d / "t2v"), str(d / "i2v")


def test_hyvideo_text_encoders_match_jax(ckpt_dirs):
    """from_dir on the tiny checkpoint (tokenizer.json files read by each
    package), f32: the template, crop_start + text_len tokens, the crop and
    the zeroed padding; mask exact, states and pooled rel L2 <= 1e-5."""
    d = ckpt_dirs[0]
    ref = JENC.HyVideoTextEncoders.from_dir(d, dtype=jnp.float32, text_len=12)([PROMPT, "a cat"])
    ours = TENC.HyVideoTextEncoders.from_dir(d, dtype=torch.float32, text_len=12)([PROMPT, "a cat"])
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    assert 0 < int(ours[1][0].sum()) < 12 and ours[0].shape == (2, 12, chip_smoke.TINY_LLAMA["dim"])
    assert rel(ours[0], ref[0]) <= 1e-5 and rel(ours[2], ref[2]) <= 1e-5


def test_llava_image_text_encoder_matches_jax(ckpt_dirs):
    """The Llava checkpoint: the image through CLIP's cubic resize, the
    template's <image> spliced, f32; mask exact, rel L2 <= 1e-5."""
    d = ckpt_dirs[1]
    img = np.random.default_rng(3).uniform(-1, 1, (1, 3, 40, 56)).astype(np.float32)
    ref = JENC.LlavaImageTextEncoder.from_dir(d, dtype=jnp.float32, text_len=12)([PROMPT], jnp.asarray(img))
    ours = TENC.LlavaImageTextEncoder.from_dir(d, dtype=torch.float32, text_len=12)([PROMPT], torch.from_numpy(img))
    np.testing.assert_array_equal(ours[1].numpy(), np.asarray(ref[1]))
    assert rel(ours[0], ref[0]) <= 1e-5 and rel(ours[2], ref[2]) <= 1e-5


def test_llava_refuses_more_image_tokens_than_the_text(ckpt_dirs):
    """At Llava's vision size (336 / 14: 576 patches) and the CLI's defaults
    (crop_start 0, interleave 1, text_len 256) the id count is 0 + 256 - 576
    + 1 = -319: the JAX encoder fails in np.zeros, the port refuses naming
    the numbers before any work; interleave 4 (144 tokens) fits."""
    d = ckpt_dirs[1]
    jtok = JENC.HyVideoTextEncoders.from_dir(ckpt_dirs[0], dtype=jnp.float32, text_len=12).llama_tok
    vcfg = dataclasses.replace(JCLIP.CLIPVisionConfig(**VISION), image_size=336)
    jenc = JENC.LlavaImageTextEncoder(None, JL.LlamaConfig(**LLAMA), vcfg, jtok, None, JCLIP.CLIPTextConfig(**CLIP),
                                      jtok, text_len=256)
    with pytest.raises(ValueError, match="negative"):
        jenc([PROMPT], None)
    enc = TENC.LlavaImageTextEncoder.from_dir(d, dtype=torch.float32, text_len=256)
    enc.llava = TLV.LlavaModel(TL.LlamaConfig(**LLAMA), dataclasses.replace(TCLIP.CLIPVisionConfig(**VISION),
                                                                           image_size=336), dtype=torch.float32)
    with pytest.raises(ValueError, match="-319"):
        enc([PROMPT], torch.zeros(1, 3, 8, 8))
    enc.interleave = 4
    assert enc.n_image_tokens == 144
