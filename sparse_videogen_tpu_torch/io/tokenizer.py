"""T5/UMT5 prompt tokenizer in the standard library and numpy (counterpart of
sparse_videogen_tpu/io/tokenizer.py, which builds a `tokenizers.Unigram`
through transformers' protobuf schema; the card's host has neither).

It reproduces what that builds from a `spiece.model` (the transformers
T5Converter recipe) or reads from a `tokenizer.json`:
  - normalizers, in the file's order: sentencepiece's
    `precompiled_charsmap` where one is given (real UMT5 tokenizers carry
    one: `Precompiled`, tokenizers' reading of it), then `" {2,}" -> " "`;
  - pre-tokenizer: Metaspace, " " -> "▁", "▁" prepended unless the text
    starts with it, split before every "▁";
  - model: Unigram Viterbi over the pieces' scores (f64), the first of equal
    scores kept; a character no piece covers scores the lowest piece score
    minus 10 and takes the unk id, and neighbouring unk pieces fuse into one
    token (tokenizers' fuse_unk); no byte fallback;
  - post-processor: `</s>` appended, truncation to seq_len (room kept for
    `</s>`), padding to seq_len with id 0; (ids, mask) as int32.
"""

from __future__ import annotations

import base64
import binascii
import functools
import heapq
import html
import json
import os
import re
import struct
import unicodedata

import numpy as np

from sparse_videogen_tpu_torch.io.grapheme import graphemes

EOS = "</s>"
PAD_ID = 0
EOS_ID = 1
SPACE = "▁"
UNK_PENALTY = 10.0


def whitespace_clean(text: str) -> str:
    try:
        import ftfy

        text = ftfy.fix_text(text)
    except ImportError:
        pass
    text = html.unescape(html.unescape(text))
    text = re.sub(r"\s+", " ", text)
    return text.strip()


# -- the protobuf wire format, as far as sentencepiece's ModelProto needs it --

def _varint(buf: bytes, i: int) -> tuple[int, int]:
    shift = value = 0
    while True:
        b = buf[i]
        i += 1
        value |= (b & 0x7F) << shift
        if b < 0x80:
            return value, i
        shift += 7


def _fields(buf: bytes):
    """(field number, wire type, value) of a message: ints for varints,
    bytes for length-delimited and fixed-width fields."""
    i = 0
    while i < len(buf):
        key, i = _varint(buf, i)
        num, wire = key >> 3, key & 7
        if wire == 0:
            value, i = _varint(buf, i)
        elif wire == 1:
            value, i = buf[i:i + 8], i + 8
        elif wire == 2:
            n, i = _varint(buf, i)
            value, i = buf[i:i + n], i + n
        elif wire == 5:
            value, i = buf[i:i + 4], i + 4
        else:
            raise ValueError(f"protobuf wire type {wire} (field {num}) is not supported")
        yield num, wire, value


def _int32(v: int) -> int:
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= 1 << 63 else v


def read_spiece(path: str) -> tuple[list[tuple[str, float]], int, bytes]:
    """spiece.model -> (pieces [(piece, score)], trainer_spec.unk_id,
    normalizer_spec.precompiled_charsmap). ModelProto: pieces = 1
    (SentencePiece: piece = 1, score = 2 float), trainer_spec = 2 (unk_id =
    40, default 0), normalizer_spec = 3 (precompiled_charsmap = 2)."""
    with open(path, "rb") as f:
        buf = f.read()
    pieces, unk_id, charsmap = [], 0, b""
    for num, wire, value in _fields(buf):
        if num == 1 and wire == 2:
            piece, score = "", 0.0
            for n, w, v in _fields(value):
                if n == 1 and w == 2:
                    piece = v.decode("utf-8")
                elif n == 2 and w == 5:
                    score = struct.unpack("<f", v)[0]
            pieces.append((piece, score))
        elif num == 2 and wire == 2:
            for n, w, v in _fields(value):
                if n == 40 and w == 0:
                    unk_id = _int32(v)
        elif num == 3 and wire == 2:
            for n, w, v in _fields(value):
                if n == 2 and w == 2:
                    charsmap = v
    return pieces, unk_id, charsmap


class Unigram:
    """tokenizers' Unigram model (encode_optimized): Viterbi over the
    character positions of a pre-token (tokenizers walks its bytes: the same
    lattice), candidates visited by start, then by length."""

    def __init__(self, vocab: list[tuple[str, float]], unk_id: int):
        self.vocab = vocab
        self.unk_id = unk_id
        self.ids = {}
        for i, (piece, _) in enumerate(vocab):
            self.ids[piece] = i  # a repeated piece maps to its last id, as in tokenizers
        self.max_len = max((len(p) for p, _ in vocab), default=1)
        self.unk_score = min(s for _, s in vocab) - UNK_PENALTY

    def tokenize(self, text: str) -> list[int]:
        n = len(text)
        if n == 0:
            return []
        # best[e] = (score, start, id) of the best path ending at character e
        best: list[tuple[float, int, int] | None] = [None] * (n + 1)
        best[0] = (0.0, 0, -1)
        for s in range(n):
            base = best[s][0]
            single = False
            for e in range(s + 1, min(n, s + self.max_len) + 1):
                pid = self.ids.get(text[s:e])
                if pid is None:
                    continue
                cand = self.vocab[pid][1] + base
                if best[e] is None or cand > best[e][0]:
                    best[e] = (cand, s, pid)
                single = single or e == s + 1
            if not single:
                cand = self.unk_score + base
                if best[s + 1] is None or cand > best[s + 1][0]:
                    best[s + 1] = (cand, s, self.unk_id)
        pieces, unk_run, e = [], [], n
        while e > 0:
            _, s, pid = best[e]
            if pid == self.unk_id:
                unk_run.append(text[s:e])
            else:
                if unk_run:
                    pieces.append("".join(reversed(unk_run)))
                    unk_run = []
                pieces.append(text[s:e])
            e = s
        if unk_run:
            pieces.append("".join(reversed(unk_run)))
        return [self.ids.get(p, self.unk_id) for p in reversed(pieces)]


class Precompiled:
    """sentencepiece's precompiled charsmap as `tokenizers` applies it (its
    Precompiled normalizer, the spm_precompiled crate).

    The blob is a uint32 LE byte size of the trie, the trie's darts-clone
    double-array units (uint32 LE), then the NUL-terminated replacement
    strings; a key's value is its replacement's byte offset. The text is
    walked by extended grapheme clusters (io/grapheme.py): a cluster under 6
    bytes is looked up whole, and replaced whole when a key is a prefix of
    it; otherwise, or when nothing matched, each character is looked up on
    its own. A lookup takes the first result of the common-prefix search,
    the shortest key that is a prefix of the bytes. A malformed blob raises
    ValueError."""

    def __init__(self, blob: bytes):
        blob = bytes(blob)
        if len(blob) < 4:
            raise ValueError(f"precompiled_charsmap of {len(blob)} bytes: no trie size")
        n_units = struct.unpack_from("<I", blob)[0] // 4
        if n_units == 0 or 4 + 4 * n_units > len(blob):
            raise ValueError(f"precompiled_charsmap: a trie of {n_units} units does not fit its {len(blob)} bytes")
        self.units = struct.unpack_from(f"<{n_units}I", blob, 4)
        self.normalized = blob[4 + 4 * n_units:]

    def _at(self, pos: int) -> int:
        if pos >= len(self.units):
            raise ValueError(f"precompiled_charsmap: trie unit {pos} past its {len(self.units)} units")
        return self.units[pos]

    def lookup(self, key: bytes) -> str | None:
        """The replacement of the shortest key that is a prefix of `key`."""
        unit = self._at(0)
        pos = (unit >> 10) << ((unit & 0x200) >> 6)
        for c in key:
            if c == 0:
                break
            pos ^= c
            unit = self._at(pos)
            if unit & 0x800000FF != c:  # the label (a leaf's bit 31 never matches)
                break
            pos ^= (unit >> 10) << ((unit & 0x200) >> 6)
            if unit & 0x100:  # a key ends here: its value is the leaf below
                start = self._at(pos) & 0x7FFFFFFF
                if start > len(self.normalized):
                    raise ValueError(f"precompiled_charsmap: replacement offset {start} past the strings")
                end = self.normalized.find(b"\0", start)
                try:
                    return self.normalized[start:end if end >= 0 else None].decode("utf-8")
                except UnicodeDecodeError as e:
                    raise ValueError(f"precompiled_charsmap: replacement at {start} is not UTF-8") from e
        return None

    def __call__(self, text: str) -> str:
        out = []
        for g in graphemes(text):
            gb = g.encode("utf-8")
            if len(gb) < 6:
                norm = self.lookup(gb)
                if norm is not None:
                    out.append(norm)
                    continue
            for ch in g:
                norm = self.lookup(ch.encode("utf-8"))
                out.append(ch if norm is None else norm)
        return "".join(out)


def collapse_spaces(text: str) -> str:
    return re.sub(" {2,}", " ", text)


def _from_tokenizer_json(path: str) -> tuple[list[tuple[str, float]], int, int, list]:
    """tokenizer.json -> (vocab, unk_id, eos_id, normalizers) for the T5
    recipe; a model or normalizer outside it raises NotImplementedError, a
    malformed charsmap ValueError."""
    with open(path, encoding="utf-8") as f:
        tj = json.load(f)
    model = tj.get("model") or {}
    if model.get("type") != "Unigram" or model.get("byte_fallback"):
        raise NotImplementedError(f"{path}: only a Unigram model without byte fallback is ported")
    pre = tj.get("pre_tokenizer") or {}
    if pre.get("type") != "Metaspace" or pre.get("replacement") != SPACE or pre.get(
            "prepend_scheme", "always" if pre.get("add_prefix_space", True) else "never") != "always":
        raise NotImplementedError(f"{path}: pre-tokenizer {pre} is not ported (Metaspace, prepend always)")
    if model.get("unk_id") is None:
        raise NotImplementedError(f"{path}: a Unigram model without an unk id is not ported")
    norm = tj.get("normalizer") or {}
    norms = []
    for nm in norm.get("normalizers", [norm] if norm else []):
        if nm.get("type") == "Precompiled":
            try:
                blob = base64.b64decode(nm.get("precompiled_charsmap") or "", validate=True)
            except binascii.Error as e:
                raise ValueError(f"{path}: precompiled_charsmap is not base64") from e
            norms.append(Precompiled(blob))
        elif nm.get("type") == "Replace" and nm.get("pattern", {}).get("Regex") == " {2,}" and nm.get("content") == " ":
            norms.append(collapse_spaces)
        else:
            raise NotImplementedError(f"{path}: normalizer {nm} is not ported")
    vocab = [(p, float(s)) for p, s in model["vocab"]]
    special = (tj.get("post_processor") or {}).get("special_tokens", {})
    eos_id = special[EOS]["ids"][0] if EOS in special else next(
        (i for i, (p, _) in enumerate(vocab) if p == EOS), EOS_ID)
    return vocab, model["unk_id"], eos_id, norms


class T5TokenizerLite:
    """texts -> (ids, mask) padded to seq_len (the JAX package's
    T5TokenizerLite: the reference's tokenizer(texts, return_mask=True,
    add_special_tokens=True) with padding="max_length", truncation=True)."""

    def __init__(self, model: Unigram, eos_id: int, normalizers, pad_id: int = PAD_ID):
        self.model = model
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.normalizers = list(normalizers)

    @classmethod
    def from_spiece(cls, path: str) -> "T5TokenizerLite":
        pieces, unk_id, charsmap = read_spiece(path)
        eos_id = next((i for i, (p, _) in enumerate(pieces) if p == EOS), EOS_ID)
        # the JAX package's order: Precompiled (a non-empty charsmap), then the collapse
        norms = ([Precompiled(charsmap)] if charsmap else []) + [collapse_spaces]
        return cls(Unigram(pieces, unk_id), eos_id, norms)

    @classmethod
    def from_dir(cls, path: str) -> "T5TokenizerLite":
        """From a dir holding tokenizer.json (first) or spiece.model, searched
        in `path` and one level of subdirs, as the JAX package searches."""
        candidates = [path] + [os.path.join(path, d) for d in sorted(os.listdir(path))
                               if os.path.isdir(os.path.join(path, d))]
        for d in candidates:
            tj = os.path.join(d, "tokenizer.json")
            if os.path.isfile(tj):
                vocab, unk_id, eos_id, norms = _from_tokenizer_json(tj)
                return cls(Unigram(vocab, unk_id), eos_id, norms)
        for d in candidates:
            sp = os.path.join(d, "spiece.model")
            if os.path.isfile(sp):
                return cls.from_spiece(sp)
        raise FileNotFoundError(f"no tokenizer.json or spiece.model under {path}")

    def encode(self, text: str) -> list[int]:
        """Ids of one text without </s>: normalizers, Metaspace, Unigram."""
        for norm in self.normalizers:
            text = norm(text)
        text = text.replace(" ", SPACE)
        if text and not text.startswith(SPACE):
            text = SPACE + text
        ids = []
        for word in re.split(f"(?={SPACE})", text):
            ids += self.model.tokenize(word)
        return ids

    def __call__(self, texts, seq_len: int = 512, clean: str | None = "whitespace"):
        if isinstance(texts, str):
            texts = [texts]
        ids = np.full((len(texts), seq_len), self.pad_id, np.int32)
        mask = np.zeros((len(texts), seq_len), np.int32)
        for row, text in enumerate(texts):
            if clean == "whitespace":
                text = whitespace_clean(text)
            seq = self.encode(text)[:max(seq_len - 1, 0)] + [self.eos_id]
            seq = seq[:seq_len]
            ids[row, :len(seq)] = seq
            mask[row, :len(seq)] = 1
        return ids, mask


# ---------------------------------------------------------------------------
# tokenizer.json (HF fast format) with a BPE or WordLevel model: LLaMA-3's and
# CLIP's tokenizers, HunyuanVideo's two text encoders
# ---------------------------------------------------------------------------

# Unicode's White_Space property: what `\s` means in tokenizers' regex engines
# (Oniguruma for Split / Replace patterns, the regex crate for Whitespace);
# Python's `\s` adds U+001C-U+001F
_WHITE_SPACE = ((0x09, 0x0D), (0x20, 0x20), (0x85, 0x85), (0xA0, 0xA0), (0x1680, 0x1680), (0x2000, 0x200A),
                (0x2028, 0x2029), (0x202F, 0x202F), (0x205F, 0x205F), (0x3000, 0x3000))
# letters and numbers new in Unicode 16.0, which tokenizers 0.22's Oniguruma
# knows and the unicodedata of Python 3.12 (Unicode 15.0) does not
_LETTERS_16 = ((0x1C89, 0x1C8A), (0xA7CB, 0xA7CD), (0xA7DA, 0xA7DC), (0x105C0, 0x105F3), (0x10D4A, 0x10D65),
               (0x10D6F, 0x10D85), (0x10EC2, 0x10EC4), (0x11380, 0x11389), (0x1138B, 0x1138B), (0x1138E, 0x1138E),
               (0x11390, 0x113B5), (0x113B7, 0x113B7), (0x113D1, 0x113D1), (0x113D3, 0x113D3), (0x11BC0, 0x11BE0),
               (0x13460, 0x143FA), (0x16100, 0x1611D), (0x16D40, 0x16D6C), (0x18CFF, 0x18CFF), (0x1E5D0, 0x1E5ED),
               (0x1E5F0, 0x1E5F0), (0x2EBF0, 0x2EE5D))
_NUMBERS_16 = ((0x10D40, 0x10D49), (0x116D0, 0x116E3), (0x11BF0, 0x11BF9), (0x16130, 0x16139), (0x16D70, 0x16D79),
               (0x1CCF0, 0x1CCF9), (0x1E5F1, 0x1E5FA))
# Other_Alphabetic symbols (category So), part of the regex crate's `\w`
_ALPHABETIC_SYMBOLS = ((0x24B6, 0x24E9), (0x1F130, 0x1F149), (0x1F150, 0x1F169), (0x1F170, 0x1F189))


def _class_body(ranges) -> str:
    esc = lambda c: f"\\U{c:08x}"
    return "".join(esc(a) if a == b else f"{esc(a)}-{esc(b)}" for a, b in ranges)


def _merge_ranges(points, extra=()) -> list:
    out = []
    for a, b in sorted([(p, p) for p in points] + list(extra)):
        if out and a <= out[-1][1] + 1:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


@functools.lru_cache(maxsize=None)
def _category_class(prefixes: str) -> str:
    """The body of a character class ([...] without the brackets) of every
    code point whose general category starts with one of `prefixes` ("L",
    "N", or "LMN" for the regex crate's word characters), with Unicode
    16.0's additions."""
    points = [c for c in range(0x110000) if unicodedata.category(chr(c))[0] in prefixes]
    extra = (_LETTERS_16 if "L" in prefixes else ()) + (_NUMBERS_16 if "N" in prefixes else ())
    if prefixes == "LMN":  # \w: Alphabetic, marks, Nd, Nl, Pc (connector), Join_Control
        points = [c for c in points if unicodedata.category(chr(c)) != "No"]
        points += [c for c in range(0x110000) if unicodedata.category(chr(c)) == "Pc"] + [0x200C, 0x200D]
        extra += _ALPHABETIC_SYMBOLS
    return _class_body(_merge_ranges(points, extra))


_UNSUPPORTED_ESCAPES = set("wWdDbBAzZGhHkgpPx0123456789")


@functools.lru_cache(maxsize=None)
def onig_regex(pattern: str) -> re.Pattern:
    """An Oniguruma pattern of a tokenizer.json (a Split pre-tokenizer's, a
    Replace normalizer's) as a Python `re` pattern with the same matches.
    Both engines backtrack with leftmost-first alternation; `\\p{L}` and
    `\\p{N}` become classes of unicodedata categories (plus Unicode 16.0's
    additions), and `\\s` / `\\S` Unicode's White_Space. Any other `\\p{..}`,
    an escape whose meaning differs between the engines (`\\w`, `\\d`, `\\b`,
    ...), `^` / `$`, or what `re` cannot compile raises ValueError."""
    ws = _class_body(_WHITE_SPACE)
    out, i, in_class = [], 0, False
    while i < len(pattern):
        c = pattern[i]
        if c == "\\" and i + 1 < len(pattern):
            n = pattern[i + 1]
            if n == "p" and pattern.startswith("{", i + 2):
                end = pattern.index("}", i)
                name = pattern[i + 3:end]
                if name not in ("L", "N"):
                    raise ValueError(f"regex {pattern!r}: \\p{{{name}}} is not supported (only \\p{{L}}, \\p{{N}})")
                body = _category_class(name)
                out.append(body if in_class else f"[{body}]")
                i = end + 1
                continue
            if n in "sS":
                if in_class and n == "S":
                    raise ValueError(f"regex {pattern!r}: \\S inside a character class is not supported")
                out.append(ws if in_class else (f"[{ws}]" if n == "s" else f"[^{ws}]"))
            elif n in _UNSUPPORTED_ESCAPES:
                raise ValueError(f"regex {pattern!r}: the escape \\{n} is not supported")
            else:
                out.append(c + n)
            i += 2
            continue
        if c == "[" and not in_class:
            in_class = True
            out.append(c)
            if pattern.startswith("^", i + 1):
                out.append("^")
                i += 1
            if pattern.startswith("]", i + 1):  # a leading ] is a literal
                out.append("\\]")
                i += 1
        elif c == "]" and in_class:
            in_class = False
            out.append(c)
        elif c in "^$" and not in_class:
            raise ValueError(f"regex {pattern!r}: anchors are not supported")
        elif c == "[" and in_class:
            raise ValueError(f"regex {pattern!r}: nested character classes are not supported")
        else:
            out.append(c)
        i += 1
    try:
        return re.compile("".join(out))
    except re.error as e:
        raise ValueError(f"regex {pattern!r}: {e}") from e


def _pattern(spec: dict) -> re.Pattern:
    """A tokenizer.json pattern, {"String": s} or {"Regex": r}."""
    if "String" in spec:
        return re.compile(re.escape(spec["String"]))
    if "Regex" in spec:
        return onig_regex(spec["Regex"])
    raise ValueError(f"pattern {spec} is neither String nor Regex")


def _segments(rx: re.Pattern, text: str):
    """[(start, end, is_match)] covering text in order: the matches and the
    gaps between them (tokenizers' find_matches; empty matches dropped)."""
    out, prev = [], 0
    for m in rx.finditer(text):
        if m.start() == m.end():
            continue
        if m.start() > prev:
            out.append((prev, m.start(), False))
        out.append((m.start(), m.end(), True))
        prev = m.end()
    if prev < len(text):
        out.append((prev, len(text), False))
    return out


SPLIT_BEHAVIORS = ("Removed", "Isolated")


def split_pieces(rx: re.Pattern, text: str, behavior: str, invert: bool = False) -> list:
    """tokenizers' Split of one piece: the matches (of the inverted pattern,
    with invert) are removed, or isolated as pieces of their own."""
    if behavior not in SPLIT_BEHAVIORS:
        raise ValueError(f"Split behavior {behavior!r} is not supported")
    segs = [(a, b, hit != invert) for a, b, hit in _segments(rx, text)]
    return [text[a:b] for a, b, hit in segs if behavior == "Isolated" or not hit]


@functools.lru_cache(maxsize=None)
def byte_to_unicode() -> dict:
    """GPT-2's map of the 256 byte values to printable characters."""
    bs = list(range(ord("!"), ord("~") + 1)) + list(range(ord("¡"), ord("¬") + 1)) + list(range(ord("®"), ord("ÿ") + 1))
    cs, n = bs[:], 0
    for b in range(256):
        if b not in bs:
            bs.append(b)
            cs.append(256 + n)
            n += 1
    return dict(zip(bs, map(chr, cs)))


GPT2_PATTERN = r"'s|'t|'re|'ve|'m|'ll|'d| ?\p{L}+| ?\p{N}+| ?[^\s\p{L}\p{N}]+|\s+(?!\S)|\s+"


def make_normalizer(spec):
    """A tokenizer.json normalizer -> str -> str."""
    if spec is None:
        return lambda s: s
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [make_normalizer(n) for n in spec["normalizers"]]

        def seq(s):
            for f in steps:
                s = f(s)
            return s
        return seq
    if kind == "NFC":
        return lambda s: unicodedata.normalize("NFC", s)
    if kind == "Lowercase":  # char by char, as Rust's char::to_lowercase (no final-sigma rule)
        return lambda s: "".join(c.lower() for c in s)
    if kind == "Replace":
        rx, content = _pattern(spec["pattern"]), spec["content"]
        return lambda s: rx.sub(lambda m: content, s)
    raise ValueError(f"normalizer type {kind!r} is not supported")


def make_pre_tokenizer(spec):
    """A tokenizer.json pre-tokenizer -> (list of pieces -> list of pieces)."""
    if spec is None:
        return lambda pieces: pieces
    kind = spec.get("type")
    if kind == "Sequence":
        steps = [make_pre_tokenizer(p) for p in spec["pretokenizers"]]

        def seq(pieces):
            for f in steps:
                pieces = f(pieces)
            return pieces
        return seq
    if kind == "Split":
        rx, behavior, invert = _pattern(spec["pattern"]), spec["behavior"], bool(spec.get("invert", False))
        if behavior not in SPLIT_BEHAVIORS:
            raise ValueError(f"Split behavior {behavior!r} is not supported")
        return lambda pieces: [q for p in pieces for q in split_pieces(rx, p, behavior, invert)]
    if kind == "ByteLevel":
        prefix, use_regex = spec.get("add_prefix_space", True), spec.get("use_regex", True)
        rx, table = onig_regex(GPT2_PATTERN) if use_regex else None, byte_to_unicode()

        def byte_level(pieces):
            out = []
            for p in pieces:
                if prefix and not p.startswith(" "):
                    p = " " + p
                for q in split_pieces(rx, p, "Isolated") if use_regex else [p]:
                    out.append("".join(table[b] for b in q.encode("utf-8")))
            return out
        return byte_level
    if kind == "Whitespace":  # the regex crate's \w+|[^\w\s]+
        word, ws = _category_class("LMN"), _class_body(_WHITE_SPACE)
        rx = re.compile(f"[{word}]+|[^{word}{ws}]+")
        return lambda pieces: [m.group() for p in pieces for m in rx.finditer(p)]
    raise ValueError(f"pre-tokenizer type {kind!r} is not supported")


class BPE:
    """tokenizers' BPE model: each character of a pre-token is a symbol
    (the continuing-subword prefix on all but the first, the end-of-word
    suffix on the last; a symbol out of the vocabulary becomes unk, or is
    dropped without an unk token), then merges are applied from a min-heap
    on (rank, position), as Word::merge_all does; with ignore_merges a
    pre-token in the vocabulary is one token."""

    def __init__(self, spec: dict):
        for key in ("dropout",):
            if spec.get(key) not in (None, 0, 0.0):
                raise ValueError(f"BPE {key}={spec[key]} is not supported")
        if spec.get("byte_fallback"):
            raise ValueError("BPE byte_fallback is not supported")
        self.vocab = dict(spec["vocab"])
        self.prefix = spec.get("continuing_subword_prefix") or ""
        self.suffix = spec.get("end_of_word_suffix") or ""
        self.unk = spec.get("unk_token")
        self.fuse_unk = bool(spec.get("fuse_unk", False))
        self.ignore_merges = bool(spec.get("ignore_merges", False))
        if self.unk is not None and self.unk not in self.vocab:
            raise ValueError(f"BPE unk_token {self.unk!r} is not in the vocabulary")
        plen = len(self.prefix.encode("utf-8"))
        self.merges = {}
        for rank, m in enumerate(spec["merges"]):
            a, b = m.split(" ") if isinstance(m, str) else m
            new = a + b.encode("utf-8")[plen:].decode("utf-8")
            for t in (a, b, new):
                if t not in self.vocab:
                    raise ValueError(f"BPE merge {m!r}: {t!r} is not in the vocabulary")
            self.merges[(self.vocab[a], self.vocab[b])] = (rank, self.vocab[new])

    def tokenize(self, word: str) -> list[int]:
        if not word:
            return []
        if self.ignore_merges and word in self.vocab:
            return [self.vocab[word]]
        syms, unk = [], None
        for i, ch in enumerate(word):
            s = (self.prefix if i else "") + ch + (self.suffix if i == len(word) - 1 else "")
            if s in self.vocab:
                if unk is not None:
                    syms.append(unk)
                    unk = None
                syms.append(self.vocab[s])
            elif self.unk is not None:
                if unk is not None and not self.fuse_unk:
                    syms.append(unk)
                unk = self.vocab[self.unk]
        if unk is not None:
            syms.append(unk)
        return self._merge(syms)

    def _merge(self, ids: list[int]) -> list[int]:
        n = len(ids)
        c, nxt, prv, alive = list(ids), list(range(1, n + 1)), list(range(-1, n - 1)), [True] * n
        heap = [(self.merges[(c[i], c[i + 1])][0], i, self.merges[(c[i], c[i + 1])][1]) for i in range(n - 1)
                if (c[i], c[i + 1]) in self.merges]
        heapq.heapify(heap)
        while heap:
            rank, pos, new = heapq.heappop(heap)
            if not alive[pos] or nxt[pos] >= n:
                continue
            right = nxt[pos]
            m = self.merges.get((c[pos], c[right]))
            if m is None or m[1] != new:
                continue
            c[pos], alive[right] = new, False
            nxt[pos] = nxt[right]
            if nxt[pos] < n:
                prv[nxt[pos]] = pos
            if prv[pos] >= 0:
                m = self.merges.get((c[prv[pos]], c[pos]))
                if m is not None:
                    heapq.heappush(heap, (m[0], prv[pos], m[1]))
            if nxt[pos] < n:
                m = self.merges.get((c[pos], c[nxt[pos]]))
                if m is not None:
                    heapq.heappush(heap, (m[0], pos, m[1]))
        return [c[i] for i in range(n) if alive[i]]


class WordLevel:
    """tokenizers' WordLevel model: a pre-token's id, else the unk token's."""

    def __init__(self, spec: dict):
        self.vocab = dict(spec["vocab"])
        self.unk = spec.get("unk_token")

    def tokenize(self, word: str) -> list[int]:
        if word in self.vocab:
            return [self.vocab[word]]
        if self.unk in self.vocab:
            return [self.vocab[self.unk]]
        raise ValueError(f"WordLevel: {word!r} is not in the vocabulary and there is no unk token")


def _post_processor(spec):
    """A tokenizer.json post-processor -> (prefix ids, suffix ids) of a single sequence."""
    if spec is None:
        return [], []
    kind = spec.get("type")
    if kind == "Sequence":
        pre, post = [], []
        for p in spec["processors"]:
            a, b = _post_processor(p)
            pre, post = a + pre, post + b
        return pre, post
    if kind == "ByteLevel":  # offsets only
        return [], []
    if kind == "RobertaProcessing":
        return [spec["cls"][1]], [spec["sep"][1]]
    if kind == "TemplateProcessing":
        pre, post, seen = [], [], False
        for item in spec["single"]:
            if "Sequence" in item:
                if item["Sequence"]["id"] != "A" or seen:
                    raise ValueError(f"TemplateProcessing single template {spec['single']} is not supported")
                seen = True
            else:
                (pre if not seen else post).extend(spec["special_tokens"][item["SpecialToken"]["id"]]["ids"])
        return pre, post
    raise ValueError(f"post-processor type {kind!r} is not supported")


class HFTokenizerLite:
    """A tokenizer.json read by hand, as `tokenizers` encodes with it
    (counterpart of the JAX package's HFTokenizerLite, which wraps that
    library): texts -> (ids, mask) truncated and padded to seq_len.

    Per text: the added tokens that are not normalized are cut out of the
    raw text (leftmost-longest), the rest normalized piece by piece, the
    normalized added tokens cut out of that, the remaining pieces
    pre-tokenized and run through the model (BPE or WordLevel); truncation
    keeps room for the post-processor's special tokens, which are then
    added; padding on the right with the pad id. The pad id is
    tokenizer_config.json's pad_token, else its eos_token, else 0 (the JAX
    package's rule). What it reads:
      - models: BPE (byte-level or not, ignore_merges, unk_token, fuse_unk,
        continuing_subword_prefix, end_of_word_suffix), WordLevel;
      - normalizers: Sequence, NFC, Lowercase, Replace;
      - pre-tokenizers: Sequence, Split (Removed or Isolated, invert),
        ByteLevel (add_prefix_space, use_regex: GPT-2's pattern),
        Whitespace;
      - post-processors: Sequence, ByteLevel, TemplateProcessing,
        RobertaProcessing.
    Patterns go through onig_regex. Any other component, a BPE dropout or
    byte fallback, and an added token with lstrip, rstrip or single_word
    raise ValueError naming it. `decode` reads the decoders ByteLevel and
    none (tokens joined by spaces); it raises ValueError naming any other."""

    def __init__(self, tj: dict, pad_id: int = 0):
        kinds = {"BPE": BPE, "WordLevel": WordLevel}
        model = tj.get("model") or {}
        if model.get("type") not in kinds:
            raise ValueError(f"model type {model.get('type')!r} is not supported (BPE, WordLevel)")
        self.model = kinds[model["type"]](model)
        self.normalize = make_normalizer(tj.get("normalizer"))
        self.pre_tokenize = make_pre_tokenizer(tj.get("pre_tokenizer"))
        self.prefix_ids, self.suffix_ids = _post_processor(tj.get("post_processor"))
        self.added, self.added_normalized = {}, {}
        self.special = set()
        for t in tj.get("added_tokens") or []:
            for key in ("lstrip", "rstrip", "single_word"):
                if t.get(key):
                    raise ValueError(f"added token {t['content']!r} with {key} is not supported")
            (self.added_normalized if t.get("normalized", not t.get("special")) else self.added)[t["content"]] = t["id"]
            if t.get("special"):
                self.special.add(t["content"])
        self.decoder = tj.get("decoder")
        self.pad_id = pad_id

    @classmethod
    def from_dir(cls, path: str) -> "HFTokenizerLite":
        tj = os.path.join(path, "tokenizer.json")
        if not os.path.isfile(tj):
            raise FileNotFoundError(f"no tokenizer.json under {path}")
        with open(tj, encoding="utf-8") as f:
            self = cls(json.load(f))
        cfg = os.path.join(path, "tokenizer_config.json")
        if os.path.isfile(cfg):
            with open(cfg) as f:
                c = json.load(f)
            for key in ("pad_token", "eos_token"):
                t = c.get(key)
                if isinstance(t, dict):
                    t = t.get("content")
                if t is not None and self.token_to_id(t) is not None:
                    self.pad_id = self.token_to_id(t)
                    break
        return self

    def token_to_id(self, token: str) -> int | None:
        for table in (self.added, self.added_normalized, self.model.vocab):
            if token in table:
                return table[token]
        return None

    @staticmethod
    def _cut(pieces, table):
        """Cut the tokens of `table` out of the free pieces, leftmost-longest:
        [(text, None) | (token, id)]."""
        if not table:
            return pieces
        longest = max(map(len, table))
        out = []
        for text, tid in pieces:
            if tid is not None:
                out.append((text, tid))
                continue
            start = i = 0
            while i < len(text):
                hit = next((text[i:i + n] for n in range(min(longest, len(text) - i), 0, -1)
                            if text[i:i + n] in table), None)
                if hit is None:
                    i += 1
                    continue
                if i > start:
                    out.append((text[start:i], None))
                out.append((hit, table[hit]))
                i = start = i + len(hit)
            if start < len(text):
                out.append((text[start:], None))
        return out

    def _ids(self, text: str) -> list[int]:
        """The model's ids of one text, added tokens included, no specials."""
        pieces = self._cut([(text, None)], self.added)
        pieces = self._cut([(t, i) if i is not None else (self.normalize(t), None) for t, i in pieces],
                           self.added_normalized)
        ids = []
        for text, tid in pieces:
            if tid is not None:
                ids.append(tid)
            elif text:
                for word in self.pre_tokenize([text]):
                    ids += self.model.tokenize(word)
        return ids

    def encode(self, text: str) -> list[int]:
        """Unpadded, untruncated ids with the special tokens (the JAX
        package's encode: tokenizers' encode with add_special_tokens)."""
        return self.prefix_ids + self._ids(text) + self.suffix_ids

    @functools.cached_property
    def _id_tokens(self) -> dict:
        """id -> token: the model's vocabulary, the added tokens over it."""
        out = {i: t for t, i in self.model.vocab.items()}
        for table in (self.added_normalized, self.added):
            out.update((i, t) for t, i in table.items())
        return out

    def decode(self, ids, skip_special_tokens: bool = True) -> str:
        """tokenizers' decode: each id's token (an added token's before the
        model's; an unknown id dropped, a special token dropped with
        skip_special_tokens), then the decoder: none joins the tokens with
        spaces; ByteLevel maps each token's characters back through GPT-2's
        byte map (a token with a character outside it gives its own UTF-8)
        and decodes the bytes, an invalid sequence as U+FFFD."""
        kind = None if self.decoder is None else self.decoder.get("type")
        if kind not in (None, "ByteLevel"):
            raise ValueError(f"decoder type {kind!r} is not supported (ByteLevel, or none)")
        tokens = [t for t in map(self._id_tokens.get, map(int, ids))
                  if t is not None and not (skip_special_tokens and t in self.special)]
        if kind is None:
            return " ".join(tokens)
        to_byte = {c: b for b, c in byte_to_unicode().items()}
        out = bytearray()
        for tok in tokens:
            bs = [to_byte.get(c) for c in tok]
            out += tok.encode("utf-8") if None in bs else bytes(bs)
        return out.decode("utf-8", errors="replace")

    def __call__(self, texts, seq_len: int):
        if isinstance(texts, str):
            texts = [texts]
        n_special = len(self.prefix_ids) + len(self.suffix_ids)
        if seq_len < n_special:  # tokenizers then skips truncation and returns rows longer than seq_len
            raise ValueError(f"seq_len {seq_len} leaves no room for the post-processor's {n_special} special tokens")
        ids = np.full((len(texts), seq_len), self.pad_id, np.int32)
        mask = np.zeros((len(texts), seq_len), np.int32)
        for row, text in enumerate(texts):
            seq = self.prefix_ids + self._ids(text)[:seq_len - n_special] + self.suffix_ids
            ids[row, :len(seq)] = seq
            mask[row, :len(seq)] = 1
        return ids, mask
