"""The port's T5/UMT5 tokenizer (io/tokenizer.py: a protobuf reader and a
Unigram Viterbi in the standard library) against the JAX package's
T5TokenizerLite (a `tokenizers.Unigram` built through transformers'
protobuf schema) on the synthetic spiece.model of
tests/test_prompt_to_video.py, and on a tokenizer.json saved from it. Ids
and masks must be equal."""

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st

from sparse_videogen_tpu.io.tokenizer import T5TokenizerLite as JTok
from sparse_videogen_tpu_torch.io import tokenizer as TT
from tests.test_prompt_to_video import _write_spiece

PROMPTS = [
    "a cat on the grass.",
    "xyz é cat",  # characters no piece covers: one fused unk a run
    "a cat\tthe   grass",  # runs of spaces and other whitespace
    "cat &amp;amp; the &lt;grass&gt;",  # html entities, unescaped twice
    "",
    "   ",
    "the " * 20,  # longer than seq_len: truncated, </s> kept
    "▁▁a▁cat </s> <unk>",  # the Metaspace character and the special pieces as text
    "catcatcat.the.grass",
]


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """(spiece dir, tokenizer.json dir) and the JAX tokenizer of each."""
    sp = tmp_path_factory.mktemp("spiece")
    _write_spiece(str(sp))
    tj = tmp_path_factory.mktemp("tokjson")
    JTok.from_dir(str(sp)).tok.save(str(tj / "tokenizer.json"))
    return [(JTok.from_dir(str(d)), TT.T5TokenizerLite.from_dir(str(d))) for d in (sp, tj)]


def _check(pair, texts, seq_len, clean="whitespace"):
    jtok, ttok = pair
    ids, mask = ttok(texts, seq_len=seq_len, clean=clean)
    jids, jmask = jtok(texts, seq_len=seq_len, clean=clean)
    assert ids.dtype == np.int32 and mask.dtype == np.int32
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)


@pytest.mark.parametrize("source", ["spiece", "tokenizer_json"])
@pytest.mark.parametrize("clean", ["whitespace", None])
def test_ids_and_masks_equal_jax(sources, source, clean):
    pair = sources[0 if source == "spiece" else 1]
    for seq_len in (8, 32):
        _check(pair, PROMPTS, seq_len, clean)
    _check(pair, "a cat", 1)  # seq_len 1 keeps </s> alone


@settings(max_examples=200, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.lists(st.text(alphabet="acts.▁ <>/&;éx\t", max_size=24), min_size=1, max_size=3))
def test_random_strings_over_the_pieces_alphabet_equal_jax(sources, texts):
    for pair in sources:
        _check(pair, texts, 12)
        _check(pair, texts, 12, clean=None)


def test_spiece_fields(tmp_path):
    _write_spiece(str(tmp_path))
    pieces, unk_id, charsmap = TT.read_spiece(str(tmp_path / "spiece.model"))
    assert unk_id == 2 and charsmap == b""
    assert pieces[:3] == [("<pad>", 0.0), ("</s>", 0.0), ("<unk>", 0.0)]
    assert pieces[4][0] == "▁cat" and pieces[4][1] == np.float32(-1.0 - 0.01 * 4)


def test_precompiled_charsmap_raises(tmp_path):
    """A malformed precompiled_charsmap (3 bytes: not even the trie's size)
    is refused by both packages: tokenizers' Precompiled raises, the port's
    ValueError. Valid charsmaps are tests/test_torch_charsmap.py's."""
    try:
        from transformers.utils import sentencepiece_model_pb2_new as pb2
    except ImportError:
        from transformers.utils import sentencepiece_model_pb2 as pb2

    _write_spiece(str(tmp_path))
    m = pb2.ModelProto()
    m.ParseFromString((tmp_path / "spiece.model").read_bytes())
    m.normalizer_spec.precompiled_charsmap = b"\x01\x02\x03"
    (tmp_path / "spiece.model").write_bytes(m.SerializeToString())
    with pytest.raises(Exception, match="precompiled_charsmap"):
        JTok.from_dir(str(tmp_path))
    with pytest.raises(ValueError, match="precompiled_charsmap"):
        TT.T5TokenizerLite.from_dir(str(tmp_path))
