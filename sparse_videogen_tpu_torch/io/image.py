"""Image files -> pixels without PIL (the JAX package's I2V CLI reads its
image with PIL, which the card's host lacks).

`load_image(path)` returns (1, 3, H, W) f32 in [-1, 1], as the JAX CLI's
_load_image: an `.npy` is np.load(path) as f32 (a (3, H, W) array in [-1,
1]); any other file is decoded to 8-bit RGB and mapped by x / 127.5 - 1.

Decoded here:
  - baseline JPEG (SOF0; SOF1 with 8-bit samples and Huffman coding alike):
    1 or 3 components (gray, or JFIF YCbCr), sampling 4:4:4, 4:2:2 (h2v1)
    or 4:2:0 (h2v2), interleaved or one scan per component, restart
    intervals (DRI, RSTn). To give libjpeg-turbo's pixels (what PIL
    returns), it follows libjpeg: the integer "islow" IDCT (jidctint.c)
    with its range-limit table, "fancy" triangle upsampling of the chroma
    with its rounding biases (jdsample.c; edge samples replicated, as
    jdmainct.c's context rows do), and the fixed-point YCbCr -> RGB tables
    (jdcolor.c). Gray gives R = G = B, as PIL's convert("RGB").
  - 8-bit non-interlaced PNG: gray, RGB or RGBA (alpha dropped, as PIL's
    convert("RGB")); zlib and the five row filters.
Progressive or arithmetic-coded JPEG, 12-bit samples, CMYK or Adobe RGB
JPEG, other PNGs and any other format raise ValueError naming `.npy`.

Encoded here (`encode_jpeg`, `encode_jpeg_frames`): baseline JPEG of RGB
frames, the bytes libjpeg-turbo writes when PIL saves with
`quality=q, subsampling=0` (JFIF 1.01, YCbCr 4:4:4, the Annex K tables
scaled by jpeg_quality_scaling, the standard Huffman tables, no restart
interval). The arithmetic is libjpeg's integer path: jccolor.c's
fixed-point YCbCr, edge samples replicated to whole blocks, jfdctint.c's
islow forward DCT (the decoder's constants), and jcdctmgr.c's quantiser,
whose reciprocal multiply equals a division by 8 q rounded half away from
zero. Those stages and the entropy coder (every token's code and length,
their bit offsets, 32-bit words, 0xFF stuffing) are integer torch ops on
the frames' own device; the host only copies the finished bytes and adds
the headers.
"""

from __future__ import annotations

import struct
import time
import zlib

import numpy as np
import torch

# coefficient k of a block's zigzag scan -> its natural (row-major) index
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63], np.int64)
ZIGZAG_LIST = ZIGZAG.tolist()

# jidctint.c: CONST_BITS 13, PASS1_BITS 2, FIX(x) = round(x * 2^13)
CONST_BITS, PASS1_BITS = 13, 2
FIX_0_298631336, FIX_0_390180644, FIX_0_541196100, FIX_0_765366865 = 2446, 3196, 4433, 6270
FIX_0_899976223, FIX_1_175875602, FIX_1_501321110, FIX_1_847759065 = 7373, 9633, 12299, 15137
FIX_1_961570560, FIX_2_053119869, FIX_2_562915447, FIX_3_072711026 = 16069, 16819, 20995, 25172

_UNSUPPORTED = "save the image as a (3, H, W) .npy array in [-1, 1] instead"


def _unsupported(what: str) -> ValueError:
    return ValueError(f"{what}: not decoded by io/image.py; {_UNSUPPORTED}")


# -- JPEG --

def _huffman_lut(counts, symbols) -> list:
    """A 65,536-entry table: the next 16 bits -> (code length << 8) | symbol
    (0: no code starts with those bits)."""
    lut = [0] * 65536
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            start, n = code << (16 - length), 1 << (16 - length)
            lut[start:start + n] = [(length << 8) | symbols[k]] * n
            code += 1
            k += 1
        code <<= 1
    return lut


def _segments(data: bytes, pos: int):
    """The entropy-coded data from `pos`: its restart intervals, each with
    the stuffed zero bytes removed, and the position of the marker that
    ends the scan."""
    out, start, buf = [], pos, bytearray()
    while True:
        i = data.find(b"\xff", pos)
        if i < 0 or i + 1 >= len(data):
            raise ValueError("JPEG: the scan data runs past the end of the file")
        nxt = data[i + 1]
        if nxt == 0x00:  # a stuffed 0xFF
            buf += data[start:i + 1]
            pos = start = i + 2
        elif nxt == 0xFF:  # fill bytes before a marker
            buf += data[start:i]
            pos = start = i + 1
        elif 0xD0 <= nxt <= 0xD7:  # RSTn: the interval ends
            buf += data[start:i]
            out.append(bytes(buf))
            buf = bytearray()
            pos = start = i + 2
        else:
            buf += data[start:i]
            out.append(bytes(buf))
            return out, i


def _windows(seg: bytes) -> list:
    """32-bit big-endian windows at each byte offset of `seg` (zeros past
    its end, as libjpeg reads after a marker)."""
    b = np.frombuffer(seg + b"\0" * 8, np.uint8).astype(np.int64)
    return ((b[:-3] << 24) | (b[1:-2] << 16) | (b[2:-1] << 8) | b[3:]).tolist()


def _decode_block(win, p, dc_lut, ac_lut, pred, out_idx, out_pos, out_val, b):
    """Huffman-decode block b of one component from bit p; appends its
    nonzero coefficients (block index, natural position, value); returns
    (the new bit position, the DC predictor)."""
    zz = ZIGZAG_LIST
    w = win[p >> 3]
    e = dc_lut[(w >> (16 - (p & 7))) & 0xFFFF]
    if not e:
        raise ValueError("JPEG: a bad Huffman code in the scan data")
    p += e >> 8
    s = e & 0xFF
    if s:
        w = win[p >> 3]
        v = (w >> (32 - (p & 7) - s)) & ((1 << s) - 1)
        p += s
        if v < (1 << (s - 1)):
            v -= (1 << s) - 1
        pred += v
    if pred:
        out_idx.append(b)
        out_pos.append(0)
        out_val.append(pred)
    k = 1
    while k < 64:
        w = win[p >> 3]
        e = ac_lut[(w >> (16 - (p & 7))) & 0xFFFF]
        if not e:
            raise ValueError("JPEG: a bad Huffman code in the scan data")
        p += e >> 8
        rs = e & 0xFF
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            if k > 63:
                raise ValueError("JPEG: a coefficient past the end of its block")
            w = win[p >> 3]
            v = (w >> (32 - (p & 7) - s)) & ((1 << s) - 1)
            p += s
            if v < (1 << (s - 1)):
                v -= (1 << s) - 1
            out_idx.append(b)
            out_pos.append(zz[k])
            out_val.append(v)
            k += 1
        elif r == 15:
            k += 16
        else:
            break
    return p, pred


def _descale(x, n):
    return (x + (1 << (n - 1))) >> n


def _idct_1d(x):
    """jpeg_idct_islow's butterfly on 8 int64 arrays (inputs 0..7); returns
    the 8 outputs before their descale."""
    z2, z3 = x[2], x[6]
    z1 = (z2 + z3) * FIX_0_541196100
    tmp2 = z1 + z3 * -FIX_1_847759065
    tmp3 = z1 + z2 * FIX_0_765366865
    tmp0 = (x[0] + x[4]) << CONST_BITS
    tmp1 = (x[0] - x[4]) << CONST_BITS
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    t0, t1, t2, t3 = x[7], x[5], x[3], x[1]
    z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
    z5 = (z3 + z4) * FIX_1_175875602
    t0, t1 = t0 * FIX_0_298631336, t1 * FIX_2_053119869
    t2, t3 = t2 * FIX_3_072711026, t3 * FIX_1_501321110
    z1, z2 = z1 * -FIX_0_899976223, z2 * -FIX_2_562915447
    z3, z4 = z3 * -FIX_1_961570560 + z5, z4 * -FIX_0_390180644 + z5
    t0, t1, t2, t3 = t0 + z1 + z3, t1 + z2 + z4, t2 + z2 + z3, t3 + z1 + z4
    return [tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0, tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3]


def _range_limit_table() -> np.ndarray:
    """libjpeg's post-IDCT table, indexed by the descaled value & 1023."""
    i = np.arange(1024)
    return np.where(i < 128, i + 128, np.where(i < 512, 255, np.where(i < 896, 0, i - 896))).astype(np.uint8)


IDCT_LIMIT = _range_limit_table()


def idct_islow(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """(N, 8, 8) coefficients in natural order and an (8, 8) quantisation
    table -> (N, 8, 8) uint8 samples, as jpeg_idct_islow computes them."""
    c = coef.astype(np.int64) * quant.astype(np.int64)
    cols = _idct_1d([c[:, k, :] for k in range(8)])  # pass 1: down the columns
    ws = np.stack([_descale(v, CONST_BITS - PASS1_BITS) for v in cols], axis=1)
    rows = _idct_1d([ws[:, :, k] for k in range(8)])  # pass 2: along the rows
    out = np.stack([_descale(v, CONST_BITS + PASS1_BITS + 3) for v in rows], axis=2)
    return IDCT_LIMIT[out & 1023]


def _upsample_h2v1(x: np.ndarray) -> np.ndarray:
    """jdsample.c h2v1_fancy_upsample on (h, w) samples -> (h, 2 w)."""
    x = x.astype(np.int32)
    left = np.concatenate([x[:, :1], x[:, :-1]], axis=1)
    right = np.concatenate([x[:, 1:], x[:, -1:]], axis=1)
    out = np.empty((x.shape[0], 2 * x.shape[1]), np.int32)
    out[:, 0::2] = (3 * x + left + 1) >> 2
    out[:, 1::2] = (3 * x + right + 2) >> 2
    return out.astype(np.uint8)


def _upsample_h2v2(x: np.ndarray) -> np.ndarray:
    """jdsample.c h2v2_fancy_upsample on (h, w) samples -> (2 h, 2 w); the
    rows above the first and below the last repeat them."""
    x = x.astype(np.int32)
    above = np.concatenate([x[:1], x[:-1]], axis=0)
    below = np.concatenate([x[1:], x[-1:]], axis=0)
    out = np.empty((2 * x.shape[0], 2 * x.shape[1]), np.int32)
    for v, far in ((0, above), (1, below)):
        c = 3 * x + far  # column sums
        left = np.concatenate([c[:, :1], c[:, :-1]], axis=1)
        right = np.concatenate([c[:, 1:], c[:, -1:]], axis=1)
        out[v::2, 0::2] = (3 * c + left + 8) >> 4
        out[v::2, 1::2] = (3 * c + right + 7) >> 4
    return out.astype(np.uint8)


def _fix16(x: float) -> int:
    return int(x * 65536 + 0.5)


def ycc_to_rgb(y: np.ndarray, cb: np.ndarray, cr: np.ndarray) -> np.ndarray:
    """jdcolor.c ycc_rgb_convert: its 16-bit fixed-point tables -> (h, w, 3) uint8."""
    x = np.arange(256, dtype=np.int64) - 128
    cr_r = (_fix16(1.40200) * x + (1 << 15)) >> 16
    cb_b = (_fix16(1.77200) * x + (1 << 15)) >> 16
    cr_g = -_fix16(0.71414) * x
    cb_g = -_fix16(0.34414) * x + (1 << 15)
    y = y.astype(np.int64)
    r = y + cr_r[cr]
    g = y + ((cb_g[cb] + cr_g[cr]) >> 16)
    b = y + cb_b[cb]
    return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def decode_jpeg(data: bytes) -> np.ndarray:
    """A baseline JPEG's bytes -> (H, W, 3) uint8 RGB."""
    if data[:2] != b"\xff\xd8":
        raise _unsupported("not a JPEG")
    quant, dc_tabs, ac_tabs = {}, {}, {}
    frame, restart, pos = None, 0, 2
    coefs = None
    while True:
        while pos < len(data) and data[pos] == 0xFF and pos + 1 < len(data) and data[pos + 1] == 0xFF:
            pos += 1  # fill bytes
        if pos + 2 > len(data) or data[pos] != 0xFF:
            raise ValueError("JPEG: expected a marker")
        marker = data[pos + 1]
        if marker == 0xD9:  # EOI
            break
        if pos + 4 > len(data):
            raise ValueError("JPEG: a marker segment past the end of the file")
        length = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        seg = data[pos + 4:pos + 2 + length]
        pos += 2 + length
        if marker in (0xC0, 0xC1):  # SOF0 baseline, SOF1 extended sequential (Huffman)
            precision, height, width, nc = struct.unpack(">BHHB", seg[:6])
            if precision != 8:
                raise _unsupported(f"a {precision}-bit JPEG")
            if nc not in (1, 3):
                raise _unsupported(f"a JPEG with {nc} components")
            comps = []
            for i in range(nc):
                cid, hv, tq = seg[6 + 3 * i:9 + 3 * i]
                comps.append({"id": cid, "h": hv >> 4, "v": hv & 15, "tq": tq})
            if height == 0:
                raise _unsupported("a JPEG whose height comes in a DNL marker")
            frame = (height, width, comps)
            hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
            mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
            for c in comps:
                c["bw"], c["bh"] = mcux * c["h"], mcuy * c["v"]
                c["w"], c["hgt"] = -(-width * c["h"] // hmax), -(-height * c["v"] // vmax)
            coefs = [([], [], []) for _ in comps]
        elif 0xC2 <= marker <= 0xCF and marker not in (0xC4, 0xC8, 0xCC):
            raise _unsupported("a progressive, lossless or arithmetic-coded JPEG (SOF%d)" % (marker - 0xC0))
        elif marker == 0xCC:
            raise _unsupported("an arithmetic-coded JPEG (DAC)")
        elif marker == 0xDB:  # DQT
            i = 0
            while i < len(seg):
                pq, tq = seg[i] >> 4, seg[i] & 15
                n = 128 if pq else 64
                vals = np.frombuffer(seg[i + 1:i + 1 + n], ">u2" if pq else np.uint8).astype(np.int64)
                q = np.zeros(64, np.int64)
                q[ZIGZAG] = vals
                quant[tq] = q.reshape(8, 8)
                i += 1 + n
        elif marker == 0xC4:  # DHT
            i = 0
            while i < len(seg):
                tc, th = seg[i] >> 4, seg[i] & 15
                counts = list(seg[i + 1:i + 17])
                n = sum(counts)
                lut = _huffman_lut(counts, list(seg[i + 17:i + 17 + n]))
                (ac_tabs if tc else dc_tabs)[th] = lut
                i += 17 + n
        elif marker == 0xDD:  # DRI
            restart = struct.unpack(">H", seg[:2])[0]
        elif marker == 0xEE and seg[:5] == b"Adobe" and len(seg) >= 12 and seg[11] == 0 and frame and \
                len(frame[2]) == 3:
            raise _unsupported("an Adobe RGB JPEG (no YCbCr transform)")
        elif marker == 0xDA:  # SOS
            if frame is None:
                raise ValueError("JPEG: a scan before the frame header")
            ns = seg[0]
            sel = []
            for i in range(ns):
                cid, td_ta = seg[1 + 2 * i], seg[2 + 2 * i]
                ci = next(j for j, c in enumerate(frame[2]) if c["id"] == cid)
                sel.append((ci, td_ta >> 4, td_ta & 15))
            ss, se, ahal = seg[1 + 2 * ns:4 + 2 * ns]
            if ss != 0 or se != 63 or ahal != 0:
                raise _unsupported("a progressive JPEG scan")
            intervals, pos = _segments(data, pos)
            _decode_scan(frame, sel, intervals, restart, dc_tabs, ac_tabs, coefs)
        elif marker == 0xDC:
            raise _unsupported("a JPEG with a DNL marker")
        # APPn, COM and the rest carry nothing the pixels need
    if frame is None:
        raise ValueError("JPEG: no frame header")
    height, width, comps = frame
    planes = []
    for c, (idx, zpos, val) in zip(comps, coefs):
        coef = np.zeros((c["bh"] * c["bw"], 64), np.int64)
        coef[np.asarray(idx, np.int64), np.asarray(zpos, np.int64)] = np.asarray(val, np.int64)
        blocks = idct_islow(coef.reshape(-1, 8, 8), quant[c["tq"]])
        plane = blocks.reshape(c["bh"], c["bw"], 8, 8).transpose(0, 2, 1, 3).reshape(8 * c["bh"], 8 * c["bw"])
        planes.append(plane[:c["hgt"], :c["w"]])
    if len(comps) == 1:
        return np.repeat(planes[0][:, :, None], 3, axis=2)
    hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
    full = []
    for c, plane in zip(comps, planes):
        ratio = (hmax // c["h"], vmax // c["v"])
        if hmax % c["h"] or vmax % c["v"] or ratio not in ((1, 1), (2, 1), (2, 2)):
            raise _unsupported(f"a JPEG sampled {c['h']}x{c['v']} against {hmax}x{vmax}")
        up = plane if ratio == (1, 1) else _upsample_h2v1(plane) if ratio == (2, 1) else _upsample_h2v2(plane)
        full.append(up[:height, :width])
    return ycc_to_rgb(*full)


def _decode_scan(frame, sel, intervals, restart, dc_tabs, ac_tabs, coefs):
    """One sequential scan (interleaved if it holds several components)."""
    height, width, comps = frame
    if len(sel) == 1:  # non-interleaved: the component's own blocks, row by row
        ci = sel[0][0]
        c = comps[ci]
        bw, bh = -(-c["w"] // 8), -(-c["hgt"] // 8)
        units = [[(ci, by * c["bw"] + bx)] for by in range(bh) for bx in range(bw)]
    else:
        hmax, vmax = max(c["h"] for c in comps), max(c["v"] for c in comps)
        mcux, mcuy = -(-width // (8 * hmax)), -(-height // (8 * vmax))
        units = []
        for my in range(mcuy):
            for mx in range(mcux):
                unit = []
                for ci, _, _ in sel:
                    c = comps[ci]
                    for v in range(c["v"]):
                        for h in range(c["h"]):
                            unit.append((ci, (my * c["v"] + v) * c["bw"] + mx * c["h"] + h))
                units.append(unit)
    tabs = {ci: (dc_tabs[td], ac_tabs[ta]) for ci, td, ta in sel}
    per = restart or len(units)
    if len(intervals) < -(-len(units) // per):
        raise ValueError("JPEG: fewer restart intervals than the scan needs")
    for n, seg_start in enumerate(range(0, len(units), per)):
        win, p = _windows(intervals[n]), 0
        pred = {ci: 0 for ci, _, _ in sel}
        for unit in units[seg_start:seg_start + per]:
            for ci, b in unit:
                dc, ac = tabs[ci]
                p, pred[ci] = _decode_block(win, p, dc, ac, pred[ci], *coefs[ci], b)
                if (p >> 3) >= len(win):
                    raise ValueError("JPEG: the scan data ends early")


# -- JPEG encoding --

# Annex K.1 (jcparam.c's std_luminance_quant_tbl, std_chrominance_quant_tbl), natural order
STD_QUANT = np.array([
    [16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
     14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
     18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
     49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    [17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
     24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99] + [99] * 32], np.int64)

# Annex K.3-K.6 (jstdhuff.c): (class << 4 | table) -> (the counts of codes of
# 1..16 bits, the symbols), in the order of the DHT markers: DC 0, AC 0, DC 1, AC 1
STD_HUFFMAN = {
    0x00: (bytes.fromhex("00010501010101010100000000000000"), bytes.fromhex("000102030405060708090a0b")),
    0x10: (bytes.fromhex("0002010303020403050504040000017d"), bytes.fromhex(
        "01020300041105122131410613516107227114328191a1082342b1c11552d1f02433627282090a161718191a25262728292a"
        "3435363738393a434445464748494a535455565758595a636465666768696a737475767778797a838485868788898a9293"
        "9495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2e3e4e5e6"
        "e7e8e9eaf1f2f3f4f5f6f7f8f9fa")),
    0x01: (bytes.fromhex("00030101010101010101010000000000"), bytes.fromhex("000102030405060708090a0b")),
    0x11: (bytes.fromhex("00020102040403040705040400010277"), bytes.fromhex(
        "000102031104052131061241510761711322328108144291a1b1c109233352f0156272d10a162434e125f11718191a2627"
        "28292a35363738393a434445464748494a535455565758595a636465666768696a737475767778797a8283848586878889"
        "8a92939495969798999aa2a3a4a5a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae2e3e4"
        "e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa")),
}

# jccolor.c: 16 fraction bits, Y rounded by ONE_HALF, Cb and Cr by ONE_HALF - 1
SCALEBITS, ONE_HALF = 16, 1 << 15
CBCR_OFFSET = 128 << SCALEBITS

# the token slots (65 a block) that one pass of the encoder holds: its int64
# temporaries stay near a GiB whatever the video's length
MAX_SLOTS = 1 << 24


def quant_tables(quality: int) -> np.ndarray:
    """jcparam.c's jpeg_set_quality(quality, force_baseline=TRUE): the
    luminance and chrominance tables, (2, 64) in natural order."""
    if not 1 <= quality <= 100:
        raise ValueError(f"JPEG quality {quality}: must be 1..100")
    scale = 5000 // quality if quality < 50 else 200 - 2 * quality
    return np.clip((STD_QUANT * scale + 50) // 100, 1, 255)


def _huffman_codes(counts: bytes, symbols: bytes) -> tuple[list, list]:
    """jchuff.c's jpeg_make_c_derived_tbl: symbol -> code and its length
    (256 entries each; length 0 where the symbol has no code)."""
    code_of, size_of = [0] * 256, [0] * 256
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(counts[length - 1]):
            code_of[symbols[k]], size_of[symbols[k]] = code, length
            code += 1
            k += 1
        code <<= 1
    return code_of, size_of


def jpeg_header(height: int, width: int, quality: int) -> bytes:
    """SOI, APP0 (JFIF 1.01, no density unit, 1x1), DQT 0 and 1 (8-bit,
    zigzag), SOF0 (components 1-3 sampled 1x1, tables 0/1/1), DHT DC 0, AC 0,
    DC 1, AC 1, SOS (Ss 0, Se 63, Ah/Al 0): what libjpeg writes before the
    scan data."""
    if not (0 < height < 65536 and 0 < width < 65536):
        raise ValueError(f"a JPEG of {height}x{width}")

    def seg(marker: int, body: bytes) -> bytes:
        return struct.pack(">BBH", 0xFF, marker, len(body) + 2) + body

    out = b"\xff\xd8" + seg(0xE0, b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    for i, table in enumerate(quant_tables(quality)):
        out += seg(0xDB, bytes([i]) + bytes(table[ZIGZAG].tolist()))
    out += seg(0xC0, struct.pack(">BHHB", 8, height, width, 3) + bytes([1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1]))
    for key, (counts, symbols) in STD_HUFFMAN.items():
        out += seg(0xC4, bytes([key]) + counts + symbols)
    return out + seg(0xDA, bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0]))


class _CoderTables:
    """The entropy coder's lookup tables on one device (int64): the bit
    length of |v| (jchuff.c's category), the DC and AC codes and lengths of
    tables 0 and 1, a run of 0..3 ZRL codes as one token, the masks 0..32."""

    def __init__(self, device):
        def t(x):
            return torch.tensor(x, dtype=torch.int64, device=device)

        dc = [_huffman_codes(*STD_HUFFMAN[0x00 | i]) for i in (0, 1)]
        ac = [_huffman_codes(*STD_HUFFMAN[0x10 | i]) for i in (0, 1)]
        self.nbits = t([v.bit_length() for v in range(2048)])
        self.dc_code, self.dc_size = t([c[0][:12] for c in dc]), t([c[1][:12] for c in dc])
        self.ac_code, self.ac_size = t([c[0] for c in ac]), t([c[1] for c in ac])
        zrl = [(c[0][0xF0], c[1][0xF0]) for c in ac]
        self.zrl_code = t([[sum(code << (size * i) for i in range(n)) for n in range(4)] for code, size in zrl])
        self.zrl_size = t([[size * n for n in range(4)] for _, size in zrl])
        self.mask = t([(1 << n) - 1 for n in range(33)])
        self.table = t([0, 1, 1])  # component -> table


def _fdct_1d(d, first: bool):
    """jpeg_fdct_islow's butterfly on 8 int32 tensors: pass 1 (rows) keeps
    PASS1_BITS more bits, pass 2 (columns) removes them."""
    tmp0, tmp7, tmp1, tmp6 = d[0] + d[7], d[0] - d[7], d[1] + d[6], d[1] - d[6]
    tmp2, tmp5, tmp3, tmp4 = d[2] + d[5], d[2] - d[5], d[3] + d[4], d[3] - d[4]
    tmp10, tmp13, tmp11, tmp12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    n = CONST_BITS - PASS1_BITS if first else CONST_BITS + PASS1_BITS
    out = [None] * 8
    if first:
        out[0], out[4] = (tmp10 + tmp11) * (1 << PASS1_BITS), (tmp10 - tmp11) * (1 << PASS1_BITS)
    else:
        out[0], out[4] = _descale(tmp10 + tmp11, PASS1_BITS), _descale(tmp10 - tmp11, PASS1_BITS)
    z1 = (tmp12 + tmp13) * FIX_0_541196100
    out[2] = _descale(z1 + tmp13 * FIX_0_765366865, n)
    out[6] = _descale(z1 - tmp12 * FIX_1_847759065, n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * FIX_1_175875602
    tmp4, tmp5 = tmp4 * FIX_0_298631336, tmp5 * FIX_2_053119869
    tmp6, tmp7 = tmp6 * FIX_3_072711026, tmp7 * FIX_1_501321110
    z1, z2 = z1 * -FIX_0_899976223, z2 * -FIX_2_562915447
    z3, z4 = z3 * -FIX_1_961570560 + z5, z4 * -FIX_0_390180644 + z5
    out[7], out[5] = _descale(tmp4 + z1 + z3, n), _descale(tmp5 + z2 + z4, n)
    out[3], out[1] = _descale(tmp6 + z2 + z3, n), _descale(tmp7 + z1 + z4, n)
    return out


def jpeg_coefficients(frames: torch.Tensor, quality: int) -> torch.Tensor:
    """(T, H, W, 3) uint8 RGB -> (T, N, 3, 64) int32 quantised coefficients
    in zigzag order: N blocks row-major, each with its Y, Cb and Cr block
    (the interleaved 4:4:4 MCU order)."""
    T, H, W, _ = frames.shape
    dev = frames.device
    x = frames.to(torch.int32)
    r, g, b = x[..., 0], x[..., 1], x[..., 2]
    y = (_fix16(0.29900) * r + _fix16(0.58700) * g + _fix16(0.11400) * b + ONE_HALF) >> SCALEBITS
    cb = (-_fix16(0.16874) * r - _fix16(0.33126) * g + _fix16(0.5) * b + CBCR_OFFSET + ONE_HALF - 1) >> SCALEBITS
    cr = (_fix16(0.5) * r - _fix16(0.41869) * g - _fix16(0.08131) * b + CBCR_OFFSET + ONE_HALF - 1) >> SCALEBITS
    ycc = torch.stack([y, cb, cr], dim=1) - 128  # level shift
    H8, W8 = -(-H // 8) * 8, -(-W // 8) * 8
    rows = torch.arange(H8, device=dev).clamp_(max=H - 1)  # the last row and column repeated
    cols = torch.arange(W8, device=dev).clamp_(max=W - 1)
    ycc = ycc.index_select(2, rows).index_select(3, cols)
    blocks = ycc.reshape(T, 3, H8 // 8, 8, W8 // 8, 8).permute(0, 2, 4, 1, 3, 5)  # (T, by, bx, c, row, col)
    ws = torch.stack(_fdct_1d(blocks.unbind(-1), True), dim=-1)  # pass 1: along each row
    coef = torch.stack(_fdct_1d(ws.unbind(-2), False), dim=-2)  # pass 2: down each column
    coef = coef.reshape(T, -1, 3, 64)
    div = torch.from_numpy(8 * quant_tables(quality)[[0, 1, 1]]).to(device=dev, dtype=torch.int32)
    mag = torch.div(coef.abs() + div // 2, div, rounding_mode="floor")  # jcdctmgr.c's reciprocal quantize
    zz = torch.from_numpy(ZIGZAG).to(dev)
    return torch.where(coef < 0, -mag, mag).index_select(-1, zz)


def _tokens(zz: torch.Tensor, tabs: _CoderTables):
    """(T, N, 3, 64) zigzag coefficients -> each frame's tokens as (code
    bits, bit length) int64 pairs, (T, N * 3 * 65 + 1): a block's DC token,
    one slot per AC coefficient (its ZRLs, its run/size code and its bits;
    length 0 where it is zero), its EOB (where coefficient 63 is zero), and
    per frame the 1-bits that pad it to a whole byte."""
    T, N = zz.shape[:2]
    dev = zz.device
    z = zz.to(torch.int64)

    def bits(v, s):  # jchuff.c: a negative value sends the low bits of v - 1
        return torch.where(v < 0, v - 1, v) & tabs.mask[s]

    tab = tabs.table.view(1, 1, 3)
    dc = z[..., 0]
    diff = dc - torch.cat([torch.zeros_like(dc[:, :1]), dc[:, :-1]], dim=1)  # per component, within the frame
    s = tabs.nbits[diff.abs()]
    dc_val = (tabs.dc_code[tab, s] << s) | bits(diff, s)
    dc_len = tabs.dc_size[tab, s] + s

    ac = z[..., 1:]
    nz = ac != 0
    k = torch.arange(1, 64, device=dev)
    last = torch.where(nz, k, 0).cummax(dim=-1).values  # the last nonzero index up to k (0: none)
    run = k - torch.cat([torch.zeros_like(last[..., :1]), last[..., :-1]], dim=-1) - 1
    s = tabs.nbits[ac.abs()]
    tab4, zrl = tab[..., None], run >> 4
    sym = ((run & 15) << 4) | s
    size = tabs.ac_size[tab4, sym]
    val = ((((tabs.zrl_code[tab4, zrl] << size) | tabs.ac_code[tab4, sym]) << s) | bits(ac, s))
    ac_val = torch.where(nz, val, 0)
    ac_len = torch.where(nz, tabs.zrl_size[tab4, zrl] + size + s, 0)

    eob = ~nz[..., -1]
    eob_val = torch.where(eob, tabs.ac_code[tab, 0], 0)
    eob_len = torch.where(eob, tabs.ac_size[tab, 0], 0)

    vals = torch.cat([dc_val[..., None], ac_val, eob_val[..., None]], dim=-1).reshape(T, -1)
    lens = torch.cat([dc_len[..., None], ac_len, eob_len[..., None]], dim=-1).reshape(T, -1)
    pad = (-lens.sum(dim=-1, keepdim=True)) % 8
    return torch.cat([vals, tabs.mask[pad]], dim=-1), torch.cat([lens, pad], dim=-1)


def _pack(vals: torch.Tensor, lens: torch.Tensor, tabs: _CoderTables):
    """Tokens (T, S) -> the frames' stuffed scan data, one uint8 tensor, and
    the T + 1 byte offsets that cut it into frames. Each token goes into
    the (at most 3) 32-bit big-endian words its bits fall in; the tokens'
    bits never overlap, so adding them is OR-ing them."""
    frame_bytes = lens.sum(dim=-1) // 8
    keep = lens.reshape(-1) > 0
    v, n_bits = vals.reshape(-1)[keep], lens.reshape(-1)[keep]
    end = n_bits.cumsum(0)
    start = end - n_bits
    n_bytes = int(frame_bytes.sum())
    words = torch.zeros(-(-n_bytes // 4) + 3, dtype=torch.int64, device=vals.device)
    for i in range(3):
        w = (start >> 5) + i
        lo, hi = torch.maximum(start, w * 32), torch.minimum(end, w * 32 + 32)
        part = (v >> (end - hi)) & tabs.mask[(hi - lo).clamp_(min=0)]
        words.index_add_(0, w, part << (w * 32 + 32 - hi).clamp_(0, 32))
    data = torch.stack([(words >> 24) & 255, (words >> 16) & 255, (words >> 8) & 255, words & 255], dim=-1)
    data = data.reshape(-1)[:n_bytes].to(torch.uint8)
    ff = (data == 255).to(torch.int64)  # each 0xFF byte is followed by a stuffed 0x00
    ff_before = torch.cat([torch.zeros_like(ff[:1]), ff.cumsum(0)])
    out = torch.zeros(n_bytes + int(ff_before[-1]), dtype=torch.uint8, device=vals.device)
    out[torch.arange(n_bytes, device=vals.device) + ff_before[:-1]] = data
    cuts = torch.cat([torch.zeros_like(frame_bytes[:1]), frame_bytes.cumsum(0)])
    return out, cuts + ff_before[cuts]


def encode_jpeg_frames(frames, quality: int = 95, stages: dict | None = None) -> list[bytes]:
    """(T, H, W, 3) uint8 RGB, a numpy array or a torch tensor on any device
    -> T baseline JPEG files, the bytes of PIL's Image.save(f, "JPEG",
    quality=quality, subsampling=0) with libjpeg-turbo. The coefficients
    and the entropy coder run on the frames' device, MAX_SLOTS tokens at a
    time; `stages` (a dict) gets the seconds of each stage, the device
    waited for at each stage's end."""
    x = torch.from_numpy(np.ascontiguousarray(frames)) if isinstance(frames, np.ndarray) else frames
    if x.dim() != 4 or x.shape[-1] != 3 or x.dtype != torch.uint8:
        raise ValueError(f"encode_jpeg_frames needs (T, H, W, 3) uint8 frames, got {tuple(x.shape)} {x.dtype}")
    T, H, W, _ = x.shape
    header = jpeg_header(H, W, quality)
    tabs = _CoderTables(x.device)
    per_frame = -(-H // 8) * -(-W // 8) * 3 * 65 + 1
    step = max(1, MAX_SLOTS // per_frame)
    times = dict.fromkeys(("coefficients", "entropy coder", "copy to the host", "headers"), 0.0)

    def mark(name, t0):
        if stages is not None and x.device.type == "cuda":
            torch.cuda.synchronize(x.device)
        now = time.perf_counter()
        times[name] += now - t0
        return now

    out = []
    for f0 in range(0, T, step):
        t0 = time.perf_counter()
        zz = jpeg_coefficients(x[f0:f0 + step], quality)
        t0 = mark("coefficients", t0)
        data, cuts = _pack(*_tokens(zz, tabs), tabs)
        t0 = mark("entropy coder", t0)
        data, cuts = data.cpu().numpy().tobytes(), cuts.tolist()
        t0 = mark("copy to the host", t0)
        out += [header + data[a:b] + b"\xff\xd9" for a, b in zip(cuts[:-1], cuts[1:])]
        mark("headers", t0)
    if stages is not None:
        stages.update(times)
    return out


def encode_jpeg(rgb, quality: int = 95) -> bytes:
    """(H, W, 3) uint8 RGB -> one baseline JPEG (encode_jpeg_frames)."""
    return encode_jpeg_frames(rgb[None], quality)[0]


# -- PNG --

def decode_png(data: bytes) -> np.ndarray:
    """An 8-bit non-interlaced PNG (gray, RGB or RGBA) -> (H, W, 3) uint8."""
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise _unsupported("not a PNG")
    pos, idat, hdr = 8, [], None
    while pos < len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if hdr is None:
        raise ValueError("PNG: no IHDR chunk")
    width, height, depth, ctype, _, _, interlace = hdr
    channels = {0: 1, 2: 3, 6: 4}.get(ctype)
    if depth != 8 or channels is None or interlace:
        raise _unsupported(f"a PNG of bit depth {depth}, colour type {ctype}, interlace {interlace}")
    raw = zlib.decompress(b"".join(idat))
    stride = width * channels
    if len(raw) != height * (stride + 1):
        raise ValueError("PNG: the image data has the wrong length")
    rows = np.frombuffer(raw, np.uint8).reshape(height, stride + 1)
    out = np.zeros((height, stride), np.uint8)
    prior = np.zeros(stride, np.uint8)
    for y in range(height):
        f, line = rows[y, 0], rows[y, 1:]
        if f == 0:
            cur = line.copy()
        elif f == 1:  # Sub: a running sum per channel
            cur = np.cumsum(line.reshape(width, channels).astype(np.int64), axis=0).astype(np.uint8).reshape(-1)
        elif f == 2:  # Up
            cur = line + prior
        elif f in (3, 4):  # Average, Paeth: each byte needs the one to its left
            cur = bytearray(stride)
            lb, pb = line.tolist(), prior.tolist()
            for i in range(stride):
                a = cur[i - channels] if i >= channels else 0
                b = pb[i]
                if f == 3:
                    cur[i] = (lb[i] + ((a + b) >> 1)) & 0xFF
                else:
                    c = pb[i - channels] if i >= channels else 0
                    pa, pb_, pc = abs(b - c), abs(a - c), abs(a + b - 2 * c)
                    pred = a if pa <= pb_ and pa <= pc else b if pb_ <= pc else c
                    cur[i] = (lb[i] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"PNG: unknown filter type {f}")
        out[y] = cur
        prior = out[y]
    img = out.reshape(height, width, channels)
    return np.repeat(img, 3, axis=2) if channels == 1 else img[:, :, :3].copy()


# -- entry points --

def read_image(path: str) -> np.ndarray:
    """A JPEG or PNG file -> (H, W, 3) uint8 RGB (by its first bytes)."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:2] == b"\xff\xd8":
        return decode_jpeg(data)
    if data[:8] == b"\x89PNG\r\n\x1a\n":
        return decode_png(data)
    raise _unsupported(f"{path}: neither a JPEG nor a PNG")


def load_image(path: str) -> torch.Tensor:
    """-> (1, 3, H, W) f32 in [-1, 1] on the CPU (an .npy: np.load as f32)."""
    if path.endswith(".npy"):
        arr = np.load(path).astype(np.float32)
    else:
        arr = read_image(path).astype(np.float32).transpose(2, 0, 1) / 127.5 - 1.0
    return torch.from_numpy(np.ascontiguousarray(arr[None]))
