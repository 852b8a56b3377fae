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
The quantisation tables, the zigzag order and the DCT constants here are
the ones a baseline JPEG encoder needs as well.
"""

from __future__ import annotations

import struct
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
