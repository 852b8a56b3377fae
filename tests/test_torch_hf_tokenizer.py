"""The port's tokenizer.json reader (io/tokenizer.HFTokenizerLite) against
the JAX package's HFTokenizerLite, which wraps the `tokenizers` library
(absent on the card's host). The files are built here with `tokenizers`
in LLaMA-3's structure (a Split by LLaMA-3's pattern, ByteLevel, a BPE with
ignore_merges trained on a small corpus, the template's special tokens, a
TemplateProcessing BOS) and CLIP's (NFC, whitespace runs to " ",
lowercase, a Split keeping CLIP's pattern, ByteLevel, a BPE with the </w>
suffix and an unk token, RobertaProcessing), plus GPT-2's ByteLevel with
its own pattern, the WordLevel + Whitespace files of the JAX package's
tests, and chip_smoke.bpe_tokenizer_files' hand-written LLaMA-3 and CLIP
files. Ids and masks must be equal (tolerance: exact), truncated and
padded to seq_len, and unpadded by encode; a component the port does not
read raises ValueError naming it."""

import json
import os

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import AddedToken, Regex, Tokenizer, models, normalizers, pre_tokenizers, processors, trainers

import chip_smoke
from sparse_videogen_tpu.io.tokenizer import HFTokenizerLite as JTok
from sparse_videogen_tpu_torch.io import tokenizer as TT
from sparse_videogen_tpu_torch.io.encoders import PROMPT_TEMPLATE_ENCODE_VIDEO

CORPUS = ["A cat walks on the grass, realistic. The quick brown fox jumps over 12345 lazy dogs! It's what I'LL do.",
          PROMPT_TEMPLATE_ENCODE_VIDEO.format("a dog runs on the beach at sunset"),
          "日本語のテキスト と 中文 ñandú café naïve Ελληνικά русский 🐱🐈 emoji 😀 tabs\tand\r\nnewlines"] * 8

TEXTS = [
    "", " ", "A cat walks on the grass, realistic",
    "It's IT'S we'RE they'll I'D you'Ve she'M ſ'ſ",  # contractions in either case (and the long s)
    "digits 1234567890 00 1 12345678 3.14159",  # runs longer than 3
    "tabs\tand\r\nnewlines\n\n\n end   spaces    run  ",  # newlines and space runs
    "日本語のテキスト と 中文 ñandú café naïve Ελληνικά русский عربى",  # non-Latin letters
    "emoji 😀🐱 🧑‍🚀 👍🏽 ok",  # multi-byte characters, ZWJ sequences
    "x\x1cy\x1f z w v​q 　wide",  # U+001C-1F are \s to Python, not to tokenizers
    "<|start_header_id|>user<|end_header_id|>\n\nhi<|eot_id|>", "<|startoftext|>hi<|endoftext|> there",
    "ΑΣ ΣΑΣ İstanbul Ⓐⓑ circled", "é and é", "a_b-c 12abc3 4d5",
    PROMPT_TEMPLATE_ENCODE_VIDEO.format("A cat walks on the grass, realistic"),
]


def _llama(d):
    tok = Tokenizer(models.BPE(ignore_merges=True))
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(chip_smoke.LLAMA3_PATTERN), behavior="isolated", invert=False),
        pre_tokenizers.ByteLevel(add_prefix_space=False, trim_offsets=True, use_regex=False)])
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(vocab_size=600, show_progress=False,
                                                        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    tok.add_special_tokens(list(chip_smoke.LLAMA3_SPECIALS))
    bos = tok.token_to_id("<|begin_of_text|>")
    tok.post_processor = processors.Sequence([
        processors.ByteLevel(trim_offsets=False),
        processors.TemplateProcessing(single="<|begin_of_text|> $A", pair="<|begin_of_text|> $A <|begin_of_text|> $B:1",
                                      special_tokens=[("<|begin_of_text|>", bos)])])
    return tok, {"bos_token": "<|begin_of_text|>", "eos_token": "<|end_of_text|>"}


def _clip(d):
    tok = Tokenizer(models.BPE(unk_token="<|endoftext|>", continuing_subword_prefix="", end_of_word_suffix="</w>"))
    tok.normalizer = normalizers.Sequence([normalizers.NFC(), normalizers.Replace(Regex(r"\s+"), " "),
                                           normalizers.Lowercase()])
    tok.pre_tokenizer = pre_tokenizers.Sequence([
        pre_tokenizers.Split(Regex(chip_smoke.CLIP_PATTERN), behavior="removed", invert=True),
        pre_tokenizers.ByteLevel(add_prefix_space=False, use_regex=False)])
    specials = [AddedToken(t, normalized=True, special=True) for t in chip_smoke.CLIP_SPECIALS]
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(vocab_size=600, end_of_word_suffix="</w>",
                                                        initial_alphabet=pre_tokenizers.ByteLevel.alphabet(),
                                                        special_tokens=specials, show_progress=False))
    ids = {t: tok.token_to_id(t) for t in chip_smoke.CLIP_SPECIALS}
    tok.post_processor = processors.RobertaProcessing(sep=("<|endoftext|>", ids["<|endoftext|>"]),
                                                      cls=("<|startoftext|>", ids["<|startoftext|>"]),
                                                      trim_offsets=False, add_prefix_space=False)
    return tok, {"pad_token": {"content": "<|endoftext|>"}}


def _gpt2(d):
    tok = Tokenizer(models.BPE())
    tok.pre_tokenizer = pre_tokenizers.ByteLevel(add_prefix_space=True, use_regex=True)
    tok.train_from_iterator(CORPUS, trainers.BpeTrainer(vocab_size=500, show_progress=False,
                                                        initial_alphabet=pre_tokenizers.ByteLevel.alphabet()))
    return tok, {}


def _word(d):
    vocab = {"<pad>": 0, "<unk>": 1}
    for w in "a cat walks on the grass realistic video of some".split():
        vocab.setdefault(w, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    return tok, {"pad_token": "<pad>"}


TOKENIZER_FILES = {"llama3": _llama, "clip": _clip, "gpt2": _gpt2, "wordlevel": _word}


@pytest.fixture(scope="module", params=list(TOKENIZER_FILES) + ["llama3_by_hand", "clip_by_hand"])
def pair(request, tmp_path_factory):
    """(JAX HFTokenizerLite, the port's) on one tokenizer dir."""
    d = tmp_path_factory.mktemp(request.param)
    if request.param.endswith("_by_hand"):
        chip_smoke.bpe_tokenizer_files(str(d), CORPUS, request.param.split("_")[0].replace("llama3", "llama"))
    else:
        tok, config = TOKENIZER_FILES[request.param](d)
        tok.save(str(d / "tokenizer.json"))
        with open(d / "tokenizer_config.json", "w") as f:
            json.dump(config, f)
    return JTok.from_dir(str(d)), TT.HFTokenizerLite.from_dir(str(d))


@pytest.mark.parametrize("seq_len", [8, 77, 351])
def test_ids_and_masks_equal_jax(pair, seq_len):
    """Padded and truncated batches (truncation keeps room for the
    post-processor's tokens) and the pad id: exact."""
    jtok, ttok = pair
    assert ttok.pad_id == jtok.pad_id
    ref_ids, ref_mask = jtok(TEXTS, seq_len=seq_len)
    ids, mask = ttok(TEXTS, seq_len=seq_len)
    assert ids.dtype == np.int32 and mask.dtype == np.int32
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(mask, ref_mask)


def test_encode_equal_jax(pair):
    """Unpadded ids with the special tokens (Llava's unpadded tokenization
    goes through __call__ at 512): exact."""
    jtok, ttok = pair
    for text in TEXTS:
        assert ttok.encode(text) == jtok.encode(text), repr(text)


ALPHABET = st.sampled_from(list("abcXYZ '\n\t\r1234.,!?-_<|>") + [
    "é", "é", "ß", "ſ", "ǅ", "😀", "‍", "日", "　", "\x1c", "ΐ", "İ", "Σ", "Ⓐ", "٣",
    "<|eot_id|>", "<|endoftext|>", "<|start_header_id|>", "'s", "'LL", " ", "\xa0"])


@settings(max_examples=60, deadline=None, suppress_health_check=list(HealthCheck))
@given(texts=st.lists(st.lists(ALPHABET, max_size=24).map("".join), min_size=1, max_size=3),
       seq_len=st.integers(2, 40))
def test_fuzz_equal_jax(pair, texts, seq_len):
    """Random texts over letters, digits, marks, emoji, whitespace of every
    kind, special-token strings and contractions (bounded: 60 draws of up to
    3 texts per tokenizer), seq_len from 2, the most special tokens a file
    here adds (below that, test_seq_len_below_the_special_tokens): exact."""
    jtok, ttok = pair
    ref_ids, ref_mask = jtok(texts, seq_len=seq_len)
    ids, mask = ttok(texts, seq_len=seq_len)
    np.testing.assert_array_equal(ids, ref_ids)
    np.testing.assert_array_equal(mask, ref_mask)


def test_seq_len_below_the_special_tokens(tmp_path):
    """Where seq_len cannot hold the post-processor's tokens, tokenizers
    skips the truncation and returns rows longer than seq_len (the JAX
    package's arrays then have another width); the port raises instead."""
    chip_smoke.bpe_tokenizer_files(str(tmp_path), CORPUS, "clip")
    ref_ids, _ = JTok.from_dir(str(tmp_path))(["a cat"], seq_len=1)
    assert ref_ids.shape[1] > 1
    with pytest.raises(ValueError, match="special tokens"):
        TT.HFTokenizerLite.from_dir(str(tmp_path))(["a cat"], seq_len=1)


def test_template_special_tokens(tmp_path):
    """The video template's <|start_header_id|>, <|end_header_id|> and
    <|eot_id|> come out as their ids, after the BOS, as in LLaMA-3."""
    ids_of = chip_smoke.bpe_tokenizer_files(str(tmp_path), CORPUS, "llama")
    tok = TT.HFTokenizerLite.from_dir(str(tmp_path))
    ids = tok.encode(PROMPT_TEMPLATE_ENCODE_VIDEO.format("a cat"))
    assert ids[:2] == [ids_of["<|begin_of_text|>"], ids_of["<|start_header_id|>"]]
    assert ids.count(ids_of["<|eot_id|>"]) == 2 and ids[-1] == ids_of["<|eot_id|>"]
    assert ids.count(ids_of["<|end_header_id|>"]) == 2
    assert tok.pad_id == ids_of["<|end_of_text|>"]  # no pad_token: eos_token


@pytest.mark.parametrize("config,want", [
    ({"pad_token": "<pad>", "eos_token": "</s>"}, "<pad>"),
    ({"pad_token": {"content": "<pad>"}}, "<pad>"),
    ({"pad_token": "<nope>", "eos_token": "</s>"}, "</s>"),
    ({"eos_token": {"content": "</s>"}}, "</s>"),
    ({}, None),
    (None, None),
], ids=["pad", "pad_dict", "pad_absent_eos", "eos_dict", "neither", "no_config"])
def test_pad_id_rule(tmp_path, config, want):
    """pad_token, else eos_token (each only if the vocabulary has it), else 0."""
    vocab = {"a": 0, "b": 1, "<pad>": 2, "</s>": 3}
    tok = Tokenizer(models.WordLevel(vocab, unk_token="a"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.save(str(tmp_path / "tokenizer.json"))
    if config is not None:
        with open(tmp_path / "tokenizer_config.json", "w") as f:
            json.dump(config, f)
    ours, ref = TT.HFTokenizerLite.from_dir(str(tmp_path)), JTok.from_dir(str(tmp_path))
    assert ours.pad_id == ref.pad_id == (0 if want is None else vocab[want])


def _refuse(tmp_path, tok, match):
    tok.save(str(tmp_path / "tokenizer.json"))
    with pytest.raises(ValueError, match=match):
        TT.HFTokenizerLite.from_dir(str(tmp_path))


@pytest.mark.parametrize("case", ["normalizer", "pre_tokenizer", "model", "pattern", "added_token", "byte_fallback",
                                  "behavior", "post_processor"])
def test_unread_components_raise(tmp_path, case):
    """Each component the port does not read raises ValueError naming it."""
    tok = Tokenizer(models.BPE(vocab={"a": 0, "b": 1, "ab": 2}, merges=[("a", "b")],
                               byte_fallback=case == "byte_fallback"))
    match = {"byte_fallback": "byte_fallback"}.get(case)
    if case == "normalizer":
        tok.normalizer, match = normalizers.Strip(), "Strip"
    elif case == "pre_tokenizer":
        tok.pre_tokenizer, match = pre_tokenizers.Digits(), "Digits"
    elif case == "model":
        tok = Tokenizer(models.WordPiece({"a": 0, "[UNK]": 1}, unk_token="[UNK]"))
        match = "WordPiece"
    elif case == "pattern":
        tok.pre_tokenizer, match = pre_tokenizers.Split(Regex(r"\p{Lu}+"), behavior="isolated"), "Lu"
    elif case == "added_token":
        tok.add_special_tokens([AddedToken("<x>", lstrip=True)])
        match = "lstrip"
    elif case == "behavior":
        tok.pre_tokenizer, match = pre_tokenizers.Split(Regex("a"), behavior="contiguous"), "Contiguous"
    elif case == "post_processor":
        tok.post_processor, match = processors.TemplateProcessing(single="$A $B:1", pair="$A $B:1"), "template"
    _refuse(tmp_path, tok, match)


def test_onig_classes():
    """\\p{L} and \\p{N} follow Unicode 16.0 as tokenizers' Oniguruma does
    (U+1C89 and U+10D40 are new there); \\s is White_Space (not U+001C)."""
    letters, numbers = TT.onig_regex(r"\p{L}"), TT.onig_regex(r"\p{N}")
    assert letters.fullmatch("Ᲊ") and letters.fullmatch("ñ") and not letters.fullmatch("1")
    assert numbers.fullmatch("\U00010d40") and numbers.fullmatch("٣") and not numbers.fullmatch("a")
    ws = TT.onig_regex(r"\s")
    assert ws.fullmatch("　") and ws.fullmatch("\x85") and not ws.fullmatch("\x1c")
    for bad in (r"\w+", r"^a", r"\p{Lu}", r"[\S]"):
        with pytest.raises(ValueError):
            TT.onig_regex(bad)
