"""The port's precompiled charsmap (io/tokenizer.Precompiled) and grapheme
segmenter (io/grapheme.py) against `tokenizers`, which the JAX package's
T5TokenizerLite goes through.

No real UMT5 charsmap is in the repository, so the test builds its own: a
darts-clone double-array trie written here (`build_double_array`) over
keys of each kind real charsmaps hold (full-width Latin to ASCII,
ligatures, a base letter with a combining mark to its precomposed form,
a key that is a prefix of another, a mapping to the empty string, other
spaces to " "). The same blob goes into a spiece.model and, through
tokenizers' own serializer, a tokenizer.json; ids and masks must equal the
JAX package's on fixed prompts and on hypothesis strings, and the
normalized text must equal tokenizers' Precompiled's exactly.
"""

import base64
import collections
import json
import struct

import numpy as np
import pytest
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from tokenizers import normalizers

from sparse_videogen_tpu.io.tokenizer import T5TokenizerLite as JTok
from sparse_videogen_tpu_torch.io import grapheme as G
from sparse_videogen_tpu_torch.io import tokenizer as TT


def build_double_array(keys: dict) -> list:
    """A darts-clone double array of `keys` (bytes -> value < 2^31), as
    sentencepiece stores it: unit = label (bits 0-7) | has_leaf (bit 8) |
    offset << 10; a node's children sit at (its position ^ offset) ^ label;
    a key's value is the leaf unit (bit 31 set) at label 0. Bases are unique,
    so no byte can land on another node's child with the same label, and
    the array is whole 256-unit blocks, so every lookup stays inside it."""
    root = {}
    for key, val in keys.items():
        assert key and b"\0" not in key
        node = root
        for c in key:
            node = node.setdefault(c, {})
        node[0] = val
    units, used, bases = [0] * 256, bytearray(256), set()
    used[0] = 1
    first_free = 1
    queue = collections.deque([(root, 0)])
    while queue:
        node, pos = queue.popleft()
        labels = sorted(node)
        p = first_free
        while True:
            b = p ^ labels[0]
            top = (max(b, p) | 0xFF) + 1
            if top > len(used):
                used.extend(bytes(top - len(used)))
                units.extend([0] * (top - len(units)))
            if not used[p] and b not in bases and all(not used[b ^ c] for c in labels):
                break
            p += 1
        bases.add(b)
        assert pos ^ b < 1 << 21
        units[pos] |= ((pos ^ b) << 10) | ((1 << 8) if 0 in node else 0)
        for c in labels:
            used[b ^ c] = 1
            if c == 0:
                units[b] = node[0] | (1 << 31)
            else:
                units[b ^ c] = c
                queue.append((node[c], b ^ c))
        while first_free < len(used) and used[first_free]:
            first_free += 1
    return units


def make_charsmap(mapping: dict) -> bytes:
    """sentencepiece's blob: uint32 LE trie size in bytes, the units, then
    the NUL-terminated replacements (a key's value is its offset)."""
    strings, keys = b"", {}
    for k, v in mapping.items():
        keys[k.encode()] = len(strings)
        strings += v.encode() + b"\0"
    units = build_double_array(keys)
    return struct.pack("<I", 4 * len(units)) + struct.pack(f"<{len(units)}I", *units) + strings


MAPPING = {
    **{chr(0xFF41 + i): chr(0x61 + i) for i in range(26)},  # full-width a-z
    **{chr(0xFF21 + i): chr(0x41 + i) for i in range(26)},  # full-width A-Z
    **{chr(0xFF10 + i): chr(0x30 + i) for i in range(10)},  # full-width digits
    "\ufb01": "fi", "\ufb02": "fl", "\ufb00": "ff", "\ufb03": "ffi",  # ligatures
    "e\u0301": "\u00e9", "a\u0300": "\u00e0",  # base + combining mark -> precomposed
    "x": "ks", "x\u0302": "Q",  # "x" is a prefix of "x^": the shorter key wins
    "\u00ad": "", "\u200b": "",  # soft hyphen, zero-width space -> nothing
    "\u3000": " ", "\u00a0": " ", "\u2009": " ",  # other spaces -> " "
    "\u00a9": "(c)", "\u2764": "<3",  # Extended_Pictographic
    "\u0600": "#",  # a Prepend character
}
BLOB = make_charsmap(MAPPING)
VOCAB = ["▁a", "▁cat", "▁the", "▁on", "▁grass", "▁", "a", "c", "t", "s", ".", "fi",
         "▁fi", "ks", "\u00e9", "\u00e0", "(c)", "<3", "f", "i", "e", "x", "#", "1", "2"]
# every kind of key above, and a character of each grapheme class
ALPHABET = ("act sx.eE\t\r\n\u3000\u00a0\u00ad\u200b\ufb01\ufb00\uff41\uff23\uff11\u0301\u0300\u0302\u0308"
            "\u200d\u200c\u00a9\u2764\ufe0f\U0001F600\U0001F3FB\U0001F1E6\U0001F1E8\u0600\u0903\u0e33\u1100"
            "\u1161\u11a8\uac00\uac01\u0085\u000b\u1f60")
PROMPTS = [
    "\uff41 \uff43\uff41\uff54 \uff4f\uff4e \uff54\uff48\uff45 \uff47\uff52\uff41\uff53\uff53.",
    "\ufb01sh \ufb00 \ufb03x",
    "cafe\u0301 a\u0300 e\u0301\u0301 x\u0302 x\u0302\u0301",
    "a\u00adcat\u200b on\u3000the\u00a0\u2009grass",
    "\u00a9 2024 \u2764\ufe0f \u2764\u200d\u2764 \u00a9\u200d\u00a9",
    "\u0600a \u0600\u0301 \U0001F1E6\U0001F1E8\U0001F1E6 \u1100\u1161\u11a8 \uac01",
    "a\r\ncat\u0085\u0301 \uff58 ks",
    "",
]


def _write_spiece(path, charsmap: bytes):
    try:
        from transformers.utils import sentencepiece_model_pb2_new as pb2
    except ImportError:
        from transformers.utils import sentencepiece_model_pb2 as pb2

    m = pb2.ModelProto()
    for piece, typ in [("<pad>", 3), ("</s>", 3), ("<unk>", 2)]:
        p = m.pieces.add()
        p.piece, p.score, p.type = piece, 0.0, typ
    for w in VOCAB:
        p = m.pieces.add()
        p.piece, p.score, p.type = w, -1.0 - 0.01 * len(w), 1
    m.trainer_spec.unk_id = 2
    m.normalizer_spec.precompiled_charsmap = charsmap
    (path / "spiece.model").write_bytes(m.SerializeToString())


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    """(JAX tokenizer, port tokenizer) from a spiece.model and from the
    tokenizer.json tokenizers saves of it."""
    sp = tmp_path_factory.mktemp("spiece_charsmap")
    _write_spiece(sp, BLOB)
    tj = tmp_path_factory.mktemp("tokjson_charsmap")
    JTok.from_dir(str(sp)).tok.save(str(tj / "tokenizer.json"))
    return [(JTok.from_dir(str(d)), TT.T5TokenizerLite.from_dir(str(d))) for d in (sp, tj)]


def _check(pair, texts, seq_len, clean="whitespace"):
    jtok, ttok = pair
    ids, mask = ttok(texts, seq_len=seq_len, clean=clean)
    jids, jmask = jtok(texts, seq_len=seq_len, clean=clean)
    np.testing.assert_array_equal(ids, jids)
    np.testing.assert_array_equal(mask, jmask)


def test_tokenizer_json_carries_the_charsmap(pairs, tmp_path):
    """tokenizers writes the normalizers as Sequence[Precompiled (base64),
    Replace]; the port reads both, in that order."""
    sp = tmp_path / "sp"
    sp.mkdir()
    _write_spiece(sp, BLOB)
    JTok.from_dir(str(sp)).tok.save(str(tmp_path / "tokenizer.json"))
    norm = json.loads((tmp_path / "tokenizer.json").read_text())["normalizer"]
    assert [n["type"] for n in norm["normalizers"]] == ["Precompiled", "Replace"]
    assert base64.b64decode(norm["normalizers"][0]["precompiled_charsmap"]) == BLOB
    tok = TT.T5TokenizerLite.from_dir(str(tmp_path))
    assert isinstance(tok.normalizers[0], TT.Precompiled) and tok.normalizers[1] is TT.collapse_spaces


@pytest.mark.parametrize("source", ["spiece", "tokenizer_json"])
@pytest.mark.parametrize("clean", ["whitespace", None])
def test_ids_and_masks_equal_jax(pairs, source, clean):
    pair = pairs[0 if source == "spiece" else 1]
    for seq_len in (8, 48):
        _check(pair, PROMPTS, seq_len, clean)


@settings(max_examples=300, deadline=None, suppress_health_check=[HealthCheck.function_scoped_fixture])
@given(st.lists(st.text(alphabet=ALPHABET, max_size=20), min_size=1, max_size=3))
def test_random_strings_equal_jax(pairs, texts):
    """Ids and masks over the keys' characters and a character of every
    grapheme class, and the normalized text itself, exactly."""
    ours, ref = TT.Precompiled(BLOB), normalizers.Precompiled(BLOB)
    for t in texts:
        assert ours(t) == ref.normalize_str(t), (t, ours(t), ref.normalize_str(t))
    for pair in pairs:
        _check(pair, texts, 16)
        _check(pair, texts, 16, clean=None)


def test_lookup_rules_match_tokenizers():
    """The rules the port follows, each confirmed on tokenizers' Precompiled:
    a cluster under 6 bytes is looked up whole and replaced whole by the
    shortest key that is a prefix of it (the marks after "x", and the
    second accent after "e" + U+0301, vanish); a longer cluster goes a
    character at a time; keys never span two clusters."""
    ours, ref = TT.Precompiled(BLOB), normalizers.Precompiled(BLOB)
    cases = {"x\u0302": "ks", "x\u0302\u0301": "ks", "x\u0302\u0301\u0301": "ks\u0302\u0301\u0301",
             "e\u0301": "\u00e9", "e\u0301\u0301": "\u00e9", "\u00a9\u200d": "(c)",
             "\u00a9\u200d\u00a9": "(c)\u200d(c)", "\u0600a": "#", "\u00ad": "", "\ufb03": "ffi",
             "\uff41\uff42": "ab", "\u0085\u0301": "\u0085\u0301"}
    for text, want in cases.items():
        assert ref.normalize_str(text) == want, text
        assert ours(text) == want, text


# a few code points of each Grapheme_Cluster_Break class (and
# Extended_Pictographic) from the module's tables: the ends of ranges
CLASS_SAMPLES = {
    "Extend": [0x300, 0x36F, 0x483, 0x591, 0x93C, 0x94D, 0x200C, 0xFE0F, 0xFE20, 0x1F3FB, 0x1D167, 0xE0020, 0xE01EF],
    "SpacingMark": [0x903, 0x93E, 0x940, 0xE33, 0xEB3, 0x1B3B, 0xABE3, 0x11000, 0x1D166],
    "Prepend": [0x600, 0x605, 0x6DD, 0x70F, 0x890, 0x8E2, 0xD4E, 0x110BD, 0x111C2, 0x11A3A, 0x11A84],
    "Control": [0x1, 0x9, 0x1F, 0x7F, 0x85, 0x9F, 0xAD, 0x61C, 0x180E, 0x200B, 0x200E, 0x2028, 0x2060, 0xFEFF,
                0xFFF0, 0x13430, 0xE0001],
    "ZWJ": [0x200D],
    "ExtPict": [0xA9, 0xAE, 0x203C, 0x2122, 0x2194, 0x231A, 0x2600, 0x2605, 0x2764, 0x1F000, 0x1F600, 0x1FFFD],
    "Other": [0x61, 0x20, 0x3042, 0x4E00, 0x1F1E6, 0x1100, 0x1161, 0x11A8, 0xAC00, 0xAC01, 0x915, 0x10000, 0x1ACF],
}


@pytest.mark.parametrize("cls", sorted(CLASS_SAMPLES))
def test_segmenter_classes_match_tokenizers(cls):
    """Where a break is visible in the normalized text, held to tokenizers
    class by class: "a" + c joins (a lookup of "a" replaces the whole
    cluster) iff c is Extend, ZWJ or SpacingMark; c + "b" joins iff c is
    Prepend; c + U+0301 joins unless c is a control (BMP c: the cluster
    must stay under 6 bytes); "(c)" ZWJ c stays one cluster iff c is
    Extended_Pictographic (or joins anyway)."""
    cps = CLASS_SAMPLES[cls]
    keys = {"a": "A", "©": "C"}
    keys.update({chr(c): "Q" for c in cps if c not in (0x61, 0x62, 0xA9)})
    ref = normalizers.Precompiled(make_charsmap(keys))
    ours = TT.Precompiled(make_charsmap(keys))
    for c in cps:
        ch = chr(c)
        probes = ["a" + ch, "©‍" + ch] + ([ch + "b"] if c not in (0x61, 0x62, 0xA9) else [])
        if c < 0x10000 and c not in (0x61, 0xA9):
            probes.append(ch + "́")
        for s in probes:
            assert ours(s) == ref.normalize_str(s), (hex(c), s)
    joins = [len(G.graphemes("a" + chr(c))) == 1 for c in cps]
    assert all(joins) if cls in ("Extend", "SpacingMark", "ZWJ") else not any(joins)


def test_segmenter_against_regex():
    """The cluster boundaries themselves (Hangul syllable sequences and
    regional indicator pairs, whose clusters the normalizer cannot show,
    included) against the `regex` module's \\X, on strings without Indic
    conjuncts (GB9c is not applied: io/grapheme.py)."""
    import random

    import regex

    rng = random.Random(0)
    pool = [chr(c) for c in (0x61, 0x0D, 0x0A, 0x85, 0x300, 0x200D, 0x200C, 0x903, 0x600, 0x1100, 0x1161, 0x11A8,
                             0xAC00, 0xAC01, 0xD7B0, 0xD7CB, 0xA960, 0x1F1E6, 0x1F1E7, 0x1F1E8, 0xA9, 0x1F600,
                             0x1F3FB, 0xFE0F, 0x2764, 0xE33, 0x200B)]
    for _ in range(3000):
        s = "".join(rng.choice(pool) for _ in range(rng.randint(0, 10)))
        assert G.graphemes(s) == regex.findall(r"\X", s), [hex(ord(c)) for c in s]


def test_break_classes():
    assert G.break_class(0xAC00) == G.LV and G.break_class(0xAC01) == G.LVT and G.break_class(0xAC1C) == G.LV
    assert G.break_class(0x1100) == G.L and G.break_class(0x1161) == G.V and G.break_class(0x11A8) == G.T
    assert G.break_class(0x0D) == G.C_CR and G.break_class(0x0A) == G.C_LF and G.break_class(0x200D) == G.C_ZWJ
    assert G.break_class(0x1F1FF) == G.RI and G.break_class(0x61) == G.OTHER
    assert G.extended_pictographic(0x1F600) and not G.extended_pictographic(0x61)
    assert G.graphemes("") == [] and G.graphemes("a\r\nb") == ["a", "\r\n", "b"]


@pytest.mark.parametrize("blob", [b"", b"\x01\x02\x03", struct.pack("<I", 8) + b"\0" * 4, struct.pack("<I", 0) + b"x",
                                  struct.pack("<I", 4) + struct.pack("<I", 5 << 10)])
def test_malformed_charsmaps_raise(blob):
    """Too short for the trie size, a trie past the blob's end, no trie, and
    a trie whose walk leaves the array (tokenizers refuses the first two and
    panics on the others at their first lookup): ValueError."""
    with pytest.raises(ValueError, match="precompiled_charsmap"):
        TT.Precompiled(blob)("ab")


def test_tokenizer_json_bad_base64_raises(tmp_path):
    tj = {"model": {"type": "Unigram", "unk_id": 0, "vocab": [["<unk>", 0.0], ["▁a", -1.0]]},
          "pre_tokenizer": {"type": "Metaspace", "replacement": "▁", "prepend_scheme": "always"},
          "normalizer": {"type": "Sequence", "normalizers": [{"type": "Precompiled", "precompiled_charsmap": "%%"}]}}
    (tmp_path / "tokenizer.json").write_text(json.dumps(tj))
    with pytest.raises(ValueError, match="base64"):
        TT.T5TokenizerLite.from_dir(str(tmp_path))
