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
import html
import json
import os
import re
import struct

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
