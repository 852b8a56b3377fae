"""The prompt extenders of the torch port (utils/prompt_extend.py) and what
they run on: the causal LM of models/common/llama.py (q / k / v biases,
final norm, tied or untied head, greedy decoding), io/checkpoint's
convert_qwen_lm and load_pytree, io/from_jax.llama_lm_params_from_numpy
and HFTokenizerLite.decode, against the JAX package and `tokenizers`.

- The expander: JAX's tiny-Qwen setup (tests/test_utils.py, a WordLevel
  tokenizer.json, an HF-layout Qwen2 state dict, here with non-zero q / k /
  v biases) in one model_dir written by JAX's convert_qwen_lm + save_pytree;
  the port's TorchQwenPromptExpander and JAX's JaxQwenPromptExpander return
  the same PromptOutput.
- Logits: f32, within rel L2 1e-5 of JAX's llama_lm_logits, tied and
  untied heads.
- Greedy ids: equal at every step, and at every step the top-2 logit gap
  is asserted above 1e-3 (a thousand times the logits' agreement), so no
  step is a near-tie.
- decode equals tokenizers' decode (skip_special_tokens True and False) on
  a WordLevel file without a decoder and on ByteLevel-BPE files (one built
  with tokenizers, with a non-special added token, and chip_smoke's
  Qwen2-style file), random ids including specials, unknown ids and byte
  tokens that cut a multi-byte UTF-8 character.
- DashScope: build_request equals JAX's; the retry path runs offline with
  urlopen monkeypatched.
"""

import dataclasses
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from sparse_videogen_tpu.io.checkpoint import convert_qwen_lm as jax_convert_qwen_lm
from sparse_videogen_tpu.io.checkpoint import save_pytree as jax_save_pytree
from sparse_videogen_tpu.models.common import llama as JL
from sparse_videogen_tpu.utils import prompt_extend as JPE
from sparse_videogen_tpu_torch.io.checkpoint import convert_qwen_lm, load_pytree
from sparse_videogen_tpu_torch.io.from_jax import llama_lm_params_from_numpy
from sparse_videogen_tpu_torch.io.tokenizer import HFTokenizerLite
from sparse_videogen_tpu_torch.models.common import llama as TL
from sparse_videogen_tpu_torch.utils import prompt_extend as TPE

WORDS = ["a", "cat", "rides", "bicycle", "the", "sunny", "street", "<|im_start|>", "<|im_end|>", "system", "user",
         "assistant"]


def hf_qwen_sd(cfg, seed=0, tied=False):
    """An HF Qwen2ForCausalLM state dict (numpy f32) with q / k / v biases."""
    g = torch.Generator().manual_seed(seed)
    rnd = lambda *s, scale=0.1: (torch.randn(*s, generator=g) * scale).numpy()  # noqa: E731
    hd, kv = cfg.head_dim, cfg.num_kv_heads
    sd = {"model.embed_tokens.weight": rnd(cfg.vocab_size, cfg.dim, scale=0.2),
          "model.norm.weight": 1 + rnd(cfg.dim)}
    if not tied:
        sd["lm_head.weight"] = rnd(cfg.vocab_size, cfg.dim, scale=0.2)
    for i in range(cfg.num_layers):
        b = f"model.layers.{i}"
        sd[f"{b}.input_layernorm.weight"] = 1 + rnd(cfg.dim)
        sd[f"{b}.post_attention_layernorm.weight"] = 1 + rnd(cfg.dim)
        for nm, out in (("q", cfg.dim), ("k", kv * hd), ("v", kv * hd)):
            sd[f"{b}.self_attn.{nm}_proj.weight"] = rnd(out, cfg.dim)
            sd[f"{b}.self_attn.{nm}_proj.bias"] = rnd(out)
        sd[f"{b}.self_attn.o_proj.weight"] = rnd(cfg.dim, cfg.dim)
        sd[f"{b}.mlp.gate_proj.weight"] = rnd(cfg.ffn_dim, cfg.dim)
        sd[f"{b}.mlp.up_proj.weight"] = rnd(cfg.ffn_dim, cfg.dim)
        sd[f"{b}.mlp.down_proj.weight"] = rnd(cfg.dim, cfg.ffn_dim)
    return sd


def cfg_pair(**kw):
    base = dict(vocab_size=40, dim=32, ffn_dim=64, num_layers=2, num_heads=2, num_kv_heads=1, rope_theta=1e4)
    base.update(kw)
    return JL.LlamaConfig(**base), TL.LlamaConfig(**base)


def port_lm(sd, tcfg):
    out = convert_qwen_lm({k: torch.from_numpy(v) for k, v in sd.items()}, tcfg)
    model = TL.LlamaModel(tcfg, dtype=torch.float32, lm=True, qkv_bias=True, tied="lm_head" not in out)
    model.load_state_dict(out)
    return model


@pytest.fixture(scope="module")
def model_dir(tmp_path_factory):
    """JAX's tiny-Qwen checkpoint directory (tests/test_utils.py's layout)."""
    from tokenizers import Tokenizer, models, pre_tokenizers

    d = str(tmp_path_factory.mktemp("qwen_tiny"))
    vocab = {"<pad>": 0, "<unk>": 1, "<eos>": 2}
    for w in WORDS:
        vocab.setdefault(w, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(os.path.join(d, "tokenizer.json"))
    with open(os.path.join(d, "tokenizer_config.json"), "w") as f:
        json.dump({"pad_token": "<pad>", "eos_token": "<eos>"}, f)
    jcfg, _ = cfg_pair(vocab_size=len(vocab))
    jax_save_pytree(os.path.join(d, "params.safetensors"), jax_convert_qwen_lm(hf_qwen_sd(jcfg), jcfg,
                                                                               dtype=jnp.float32))
    with open(os.path.join(d, "config.json"), "w") as f:
        json.dump({"vocab_size": jcfg.vocab_size, "dim": jcfg.dim, "ffn_dim": jcfg.ffn_dim,
                   "num_layers": jcfg.num_layers, "num_heads": jcfg.num_heads, "num_kv_heads": jcfg.num_kv_heads,
                   "rope_theta": jcfg.rope_theta, "eos_token_id": 2}, f)
    return d


def test_expander_matches_jax(model_dir):
    """The same PromptOutput from both packages' expanders on one JAX
    model_dir (the weights read through load_pytree of the
    params.safetensors directory), 8 greedy tokens."""
    theirs = JPE.JaxQwenPromptExpander(model_dir, max_new_tokens=8)
    ours = TPE.TorchQwenPromptExpander(model_dir, max_new_tokens=8, device="cpu")
    assert ours.cfg.eps == theirs.cfg.eps == 1e-5 and ours.model.blocks[0].q.bias.abs().sum() > 0
    got = ours("a cat rides the bicycle", tar_lang="en", seed=7)
    want = theirs("a cat rides the bicycle", tar_lang="en", seed=7)
    assert got.status and got.prompt, got.message
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert ours("a cat rides the bicycle", tar_lang="en", seed=7) == got


def test_load_pytree(model_dir):
    """load_pytree reads JAX's save_pytree layout, leaf for leaf (dtypes
    and values)."""
    from sparse_videogen_tpu.io.checkpoint import load_pytree as jax_load_pytree

    path = os.path.join(model_dir, "params.safetensors")
    flat = lambda t, p="": ({k: v for key, sub in t.items() for k, v in flat(sub, f"{p}/{key}").items()}  # noqa: E731
                            if isinstance(t, dict) else {p: t})
    ours, theirs = flat(load_pytree(path)), flat(jax_load_pytree(path))
    assert ours.keys() == theirs.keys() and "/blocks/q/b" in ours and "/lm_head" in ours
    for k, v in theirs.items():
        np.testing.assert_array_equal(ours[k].numpy(), np.asarray(v), err_msg=k)


def jax_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@pytest.mark.parametrize("tied", [False, True], ids=["untied", "tied"])
def test_lm_logits_match_jax(tied):
    """llama_lm_logits within rel L2 1e-5 of JAX's (f32; non-zero biases;
    the head lm_head or the embedding), on a padded batch of 2."""
    jcfg, tcfg = cfg_pair(vocab_size=48, num_layers=3, num_heads=4, num_kv_heads=2)
    sd = hf_qwen_sd(jcfg, seed=1, tied=tied)
    params = jax_convert_qwen_lm(sd, jcfg, dtype=jnp.float32)
    assert ("lm_head" in params) != tied
    model = port_lm(sd, tcfg)
    tree_sd = llama_lm_params_from_numpy(jax_to_numpy(params), tcfg)
    assert tree_sd.keys() == model.state_dict().keys()
    for k, v in model.state_dict().items():
        torch.testing.assert_close(tree_sd[k], v, rtol=0, atol=0, msg=k)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, jcfg.vocab_size, (2, 11)).astype(np.int32)
    mask = np.ones_like(ids)
    mask[1, 7:] = 0
    want = np.asarray(JL.llama_lm_logits(params, jcfg, jnp.asarray(ids), jnp.asarray(mask)))
    got = TL.llama_lm_logits(model, torch.from_numpy(ids), torch.from_numpy(mask)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape == (2, 11, jcfg.vocab_size)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) <= 1e-5
    last = TL.llama_lm_logits(model, torch.from_numpy(ids), torch.from_numpy(mask), last_only=True).numpy()
    np.testing.assert_allclose(last[:, 0], got[:, -1], rtol=1e-6, atol=1e-6)


def test_greedy_matches_jax():
    """6 greedy tokens equal JAX's; at every step the top-2 gap of the
    port's logits exceeds 1e-3, so none is a near-tie that rounding could
    flip (the agreement of the logits is ~1e-6)."""
    jcfg, tcfg = cfg_pair(vocab_size=64, num_layers=2, num_heads=2, num_kv_heads=2)
    sd = hf_qwen_sd(jcfg, seed=2)
    params = jax_convert_qwen_lm(sd, jcfg, dtype=jnp.float32)
    model = port_lm(sd, tcfg)
    prompt = [5, 9, 17, 3, 44]
    want = JL.llama_greedy_generate(params, jcfg, prompt, max_new_tokens=6, eos_id=-1)
    got = TL.llama_greedy_generate(model, prompt, max_new_tokens=6, eos_id=-1)
    assert got == want and len(got) == 6
    for step in range(len(got)):
        arr = torch.tensor([prompt + got[:step]])
        top2 = torch.topk(TL.llama_lm_logits(model, arr, torch.ones_like(arr))[0, -1], 2).values
        assert float(top2[0] - top2[1]) > 1e-3, (step, top2)
    eos = got[3]
    assert TL.llama_greedy_generate(model, prompt, max_new_tokens=6, eos_id=eos) == got[:got.index(eos)]


def _decode_cases(vocab_size, specials, rng):
    ids = [list(map(int, rng.integers(0, vocab_size + 5, n))) for n in (1, 3, 8, 20)]
    return ids + [specials + ids[2], ids[1] + specials[:1] + ids[0]]


def _check_decode(path, rng):
    from tokenizers import Tokenizer

    theirs = Tokenizer.from_file(os.path.join(path, "tokenizer.json"))
    ours = HFTokenizerLite.from_dir(path)
    specials = [i for i, t in theirs.get_added_tokens_decoder().items() if t.special]
    n = max(theirs.get_vocab(with_added_tokens=True).values()) + 1
    for ids in _decode_cases(n, specials, rng):
        for skip in (True, False):
            assert ours.decode(ids, skip_special_tokens=skip) == theirs.decode(ids, skip_special_tokens=skip), \
                (ids, skip)
    return ours, theirs


def test_decode_wordlevel(model_dir):
    """No decoder: the tokens joined by spaces; unknown ids dropped."""
    from tokenizers import Tokenizer

    tj = os.path.join(model_dir, "tokenizer.json")
    tok = Tokenizer.from_file(tj)
    tok.add_special_tokens(["<|im_start|>", "<|im_end|>"])
    d = os.path.dirname(tj) + "_specials"
    os.makedirs(d, exist_ok=True)
    tok.save(os.path.join(d, "tokenizer.json"))
    _check_decode(d, np.random.default_rng(3))
    ours = HFTokenizerLite.from_dir(model_dir)
    assert ours.decode(ours.encode("a cat rides the bicycle")) == "a cat rides the bicycle"


def test_decode_byte_level(tmp_path):
    """ByteLevel: a BPE trained by tokenizers with specials and a non-special
    added token (its ' ' is outside the byte map: its own UTF-8), and
    chip_smoke's Qwen2-style file; multi-byte characters, cut or whole."""
    from tokenizers import AddedToken, Tokenizer, decoders, models, pre_tokenizers, trainers

    texts = ["héllo wörld, 世界 and emoji 🙂 here", "a cat rides the bicycle on the sunny street"] * 4
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=False)
    tok.decoder = decoders.ByteLevel()
    tok.train_from_iterator(texts, trainers.BpeTrainer(vocab_size=400, initial_alphabet=pre_tokenizers.ByteLevel
                                                       .alphabet(), special_tokens=["<|im_start|>", "<|im_end|>"]))
    tok.add_tokens([AddedToken("new word", special=False)])
    (tmp_path / "trained").mkdir()
    tok.save(str(tmp_path / "trained" / "tokenizer.json"))
    rng = np.random.default_rng(4)
    ours, theirs = _check_decode(str(tmp_path / "trained"), rng)
    for text in texts[:2] + ["<|im_start|>user\nnew word 🙂<|im_end|>"]:
        ids = theirs.encode(text).ids
        assert ours.encode(text) == ids
        for cut in range(len(ids) + 1):
            assert ours.decode(ids[:cut]) == theirs.decode(ids[:cut]), (text, cut)
    chip_smoke.bpe_tokenizer_files(str(tmp_path / "qwen"), texts + [TPE.LM_EN_SYS_PROMPT], "qwen")
    ours, theirs = _check_decode(str(tmp_path / "qwen"), rng)
    chat = TPE.TorchQwenPromptExpander._TMPL.format(system=TPE.LM_EN_SYS_PROMPT, user=texts[0])
    assert ours.encode(chat) == theirs.encode(chat).ids
    assert ours.decode(ours.encode(chat)) == theirs.decode(theirs.encode(chat).ids)


def test_decode_refuses_other_decoders(model_dir):
    tj = json.load(open(os.path.join(model_dir, "tokenizer.json")))
    tj["decoder"] = {"type": "WordPiece", "prefix": "##", "cleanup": True}
    with pytest.raises(ValueError, match="WordPiece"):
        HFTokenizerLite(tj).decode([3])


def test_prompts_and_local_backend():
    """The system prompts are JAX's; LocalLLMPromptExpander's envelope."""
    for name in ("LM_ZH_SYS_PROMPT", "LM_EN_SYS_PROMPT", "VL_ZH_SYS_PROMPT", "VL_EN_SYS_PROMPT"):
        assert getattr(TPE, name) == getattr(JPE, name)
    calls = []

    def chat(system, user, image=None):
        calls.append((system, user, image))
        return f" rewritten: {user} "

    out = TPE.LocalLLMPromptExpander(chat)("a cat", tar_lang="en", seed=7)
    assert out == TPE.PromptOutput(True, "rewritten: a cat", 7, TPE.LM_EN_SYS_PROMPT, "")
    assert TPE.LocalLLMPromptExpander(chat, is_vl=True)("a dog", tar_lang="zh", image="IMG").status
    assert calls[-1] == (TPE.VL_ZH_SYS_PROMPT, "a dog", "IMG")
    bad = TPE.LocalLLMPromptExpander(lambda s, u: 1 / 0)("a cat", tar_lang="en", seed=1)
    assert not bad.status and bad.prompt == "a cat" and "division" in bad.message


def test_dashscope_offline(monkeypatch):
    """build_request equals JAX's (text and VL); the urllib path with
    urlopen monkeypatched: a failure then an answer (the retry), a VL
    answer in typed parts, and every try failing (the envelope)."""
    import urllib.request

    monkeypatch.delenv("DASHSCOPE_API_KEY", raising=False)
    with pytest.raises(ValueError):
        TPE.DashScopePromptExpander()
    msgs = [{"role": "system", "content": "S"}, {"role": "user", "content": "U"}]
    for vl in (False, True):
        ours = TPE.DashScopePromptExpander(api_key="sk-test", is_vl=vl)
        theirs = JPE.DashScopePromptExpander(api_key="sk-test", is_vl=vl)
        assert ours.build_request(msgs) == theirs.build_request(msgs)
    calls = []

    def urlopen(req, timeout=None):
        calls.append(json.loads(req.data))
        if len(calls) == 1:
            raise OSError("no egress")
        content = [{"text": "a "}, {"text": "dog"}] if "multimodal" in req.full_url else " rewritten "
        return io.BytesIO(json.dumps({"output": {"choices": [{"message": {"content": content}}]}}).encode())

    monkeypatch.setattr(urllib.request, "urlopen", urlopen)
    pe = TPE.DashScopePromptExpander(api_key="sk-test", retry_times=2)
    pe._dashscope = None
    assert pe("a cat", tar_lang="en", seed=3) == TPE.PromptOutput(True, "rewritten", 3, TPE.LM_EN_SYS_PROMPT, "")
    assert len(calls) == 2 and calls[1]["input"]["messages"][1]["content"] == "a cat"
    vl = TPE.DashScopePromptExpander(api_key="sk-test", is_vl=True)
    vl._dashscope = None
    out = vl("a dog", tar_lang="en", image="https://x/img.png", seed=1)
    assert out.prompt == "a dog" and out.status
    assert calls[-1]["input"]["messages"][1]["content"][0] == {"image": "https://x/img.png"}
    calls.clear()
    calls.append(None)  # every later call fails too
    monkeypatch.setattr(urllib.request, "urlopen", lambda req, timeout=None: (_ for _ in ()).throw(OSError("down")))
    bad = pe("a cat", tar_lang="en", seed=2)
    assert not bad.status and bad.prompt == "a cat" and "down" in bad.message
