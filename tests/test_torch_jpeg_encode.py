"""io/image.py's baseline JPEG encoder against PIL (12.1 with libjpeg-turbo
on this host) and io/mp4.py against the JAX package's writer and reader,
which go through PIL. The port runs with PIL blocked (sys.modules["PIL"]
None), as on the card's host. Bytes must be equal: every marker, table and
scan byte, over noise, smooth gradients, blocks of 0 and 255 (DC category
11, the largest AC categories), flat frames, sizes that are not multiples
of 8 (edge replication), a whole 480x832 frame and the example image, at
qualities around the points where the quantisation tables change (q = 1
entries first appear at quality 93)."""

import io
import os
import struct
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from sparse_videogen_tpu.io import mp4 as JMP4
from sparse_videogen_tpu_torch.io import image as TIMG
from sparse_videogen_tpu_torch.io import mp4 as TMP4

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
QUALITIES = [1, 50, 75, 92, 93, 95, 100]


def pil_jpeg(img: np.ndarray, quality: int) -> bytes:
    buf = io.BytesIO()
    Image.fromarray(img, "RGB").save(buf, "JPEG", quality=quality, subsampling=0)
    return buf.getvalue()


def _gradient(h, w, noise, seed):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([yy * 255 // h, xx * 255 // w, (yy + xx) * 255 // (h + w)], -1)
    return np.clip(base + rng.integers(-noise, noise + 1, (h, w, 3)), 0, 255).astype(np.uint8)


def _blocks(h, w):
    grid = (np.arange(h)[:, None] // 8 + np.arange(w)[None] // 8) % 2 * 255
    return np.repeat(grid[..., None], 3, axis=-1).astype(np.uint8)


IMAGES = {
    "noise": lambda: np.random.default_rng(0).integers(0, 256, (40, 56, 3), dtype=np.uint8),
    "gradient": lambda: _gradient(48, 64, 6, 1),
    "blocks": lambda: _blocks(32, 48),
    "zeros": lambda: np.zeros((16, 24, 3), np.uint8),
    "full": lambda: np.full((16, 24, 3), 255, np.uint8),
    "1x1": lambda: np.array([[[200, 30, 90]]], np.uint8),
    "7x9": lambda: np.random.default_rng(2).integers(0, 256, (7, 9, 3), dtype=np.uint8),
    "33x47": lambda: _gradient(33, 47, 30, 3),
    "480x832": lambda: _gradient(480, 832, 12, 4),
    "example": lambda: TIMG.read_image(os.path.join(ROOT, "examples", "1", "image.jpg")),
}


def _port_encode(monkeypatch, fn, *args, **kw):
    with monkeypatch.context() as m:
        m.setitem(sys.modules, "PIL", None)
        return fn(*args, **kw)


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("name", list(IMAGES))
def test_encode_jpeg_bytes_equal_pil(monkeypatch, name, quality):
    img = IMAGES[name]()
    assert _port_encode(monkeypatch, TIMG.encode_jpeg, img, quality) == pil_jpeg(img, quality)


def _markers(data: bytes):
    """(marker, segment body) up to the scan, then the scan data and EOI."""
    out, pos = [], 2
    while data[pos + 1] != 0xDA:
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        out.append((data[pos + 1], data[pos + 4:pos + 2 + n]))
        pos += 2 + n
    n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
    out.append((0xDA, data[pos + 4:pos + 2 + n]))
    return data[:2], out, data[pos + 2 + n:-2], data[-2:]


@pytest.mark.parametrize("quality", [50, 95])
def test_stream_layout_field_by_field(monkeypatch, quality):
    """Each field of the stream against PIL's: SOI; APP0 JFIF 1.01, units 0,
    density 1x1, no thumbnail; DQT 0 then 1, 8-bit, zigzag; SOF0 8-bit,
    components 1-3 at 0x11 with tables 0/1/1; DHT DC 0, AC 0, DC 1, AC 1 (the
    standard tables); SOS 1:0x00 2:0x11 3:0x11, Ss 0, Se 63, Ah/Al 0; the scan
    data (0xFF always followed by a stuffed 0x00) and EOI."""
    img = _gradient(37, 45, 40, 5)
    ours, ref = _port_encode(monkeypatch, TIMG.encode_jpeg, img, quality), pil_jpeg(img, quality)
    soi, segs, scan, eoi = _markers(ours)
    r_soi, r_segs, r_scan, r_eoi = _markers(ref)
    assert soi == r_soi == b"\xff\xd8" and eoi == r_eoi == b"\xff\xd9"
    assert [m for m, _ in segs] == [m for m, _ in r_segs] == [0xE0, 0xDB, 0xDB, 0xC0, 0xC4, 0xC4, 0xC4, 0xC4, 0xDA]
    for (m, body), (_, r_body) in zip(segs, r_segs):
        assert body == r_body, hex(m)
    assert segs[0][1] == b"JFIF\0\x01\x01\x00\x00\x01\x00\x01\x00\x00"
    tables = TIMG.quant_tables(quality)
    for i in (0, 1):
        assert segs[1 + i][1] == bytes([i]) + bytes(tables[i][TIMG.ZIGZAG].tolist())
    assert segs[3][1] == struct.pack(">BHHB", 8, 37, 45, 3) + bytes([1, 0x11, 0, 2, 0x11, 1, 3, 0x11, 1])
    assert [body[0] for _, body in segs[4:8]] == [0x00, 0x10, 0x01, 0x11]
    assert segs[8][1] == bytes([3, 1, 0x00, 2, 0x11, 3, 0x11, 0, 63, 0])
    assert scan == r_scan
    ff = np.flatnonzero(np.frombuffer(scan, np.uint8) == 0xFF)
    assert len(ff) and all(scan[i + 1] == 0 for i in ff)


def test_quant_tables_equal_pil_at_every_quality():
    """jpeg_quality_scaling and force_baseline at qualities 1..100: the DQT
    tables PIL writes, and q = 1 entries from quality 93 up."""
    img = np.zeros((8, 8, 3), np.uint8)
    for quality in range(1, 101):
        _, segs, _, _ = _markers(pil_jpeg(img, quality))
        want = np.zeros((2, 64), np.int64)
        for i in (0, 1):
            want[i, TIMG.ZIGZAG] = np.frombuffer(segs[1 + i][1][1:], np.uint8)
        np.testing.assert_array_equal(TIMG.quant_tables(quality), want)
        assert (TIMG.quant_tables(quality) == 1).any() == (quality >= 93)
    for bad in (0, 101):
        with pytest.raises(ValueError):
            TIMG.quant_tables(bad)


def test_quantiser_equals_libjpeg_turbo_reciprocal():
    """jcdctmgr.c's compute_reciprocal / quantize at divisors 8 q (q =
    1..255) over every |coefficient| < 2^15 equals the division rounded
    half away from zero that jpeg_coefficients computes."""
    t = np.arange(1 << 15, dtype=np.int64)
    for q in range(1, 256):
        d = 8 * q
        r = 16 + d.bit_length() - 1
        fq, fr = divmod(1 << r, d)
        c = d // 2
        if fr == 0:
            fq, r = fq >> 1, r - 1
        elif fr <= d // 2:
            c += 1
        else:
            fq += 1
        np.testing.assert_array_equal(((t + c) * fq) >> r, (t + d // 2) // d)


def test_frames_same_bytes_every_input_form_and_chunking(monkeypatch):
    """The batched encoder: a numpy video, a torch tensor, a non-contiguous
    view and a pass of one frame at a time (MAX_SLOTS cut to one frame's
    tokens) all give the frames' own single-image bytes."""
    video = np.stack([_gradient(24, 40, n, n) for n in (0, 9, 60)])
    want = [pil_jpeg(f, 95) for f in video]
    assert TIMG.encode_jpeg_frames(video, 95) == want
    assert TIMG.encode_jpeg_frames(torch.from_numpy(video), 95) == want
    wide = torch.from_numpy(np.ascontiguousarray(video.transpose(0, 2, 1, 3))).transpose(1, 2)
    assert not wide.is_contiguous() and TIMG.encode_jpeg_frames(wide, 95) == want
    monkeypatch.setattr(TIMG, "MAX_SLOTS", 1)
    stages = {}
    assert TIMG.encode_jpeg_frames(video, 95, stages=stages) == want
    assert set(stages) == {"coefficients", "entropy coder", "copy to the host", "headers"}
    with pytest.raises(ValueError):
        TIMG.encode_jpeg_frames(video.astype(np.int16), 95)


@pytest.mark.parametrize("quality", [50, 95])
def test_write_mp4_without_pil_equals_jax(tmp_path, monkeypatch, quality):
    """The whole file: the port's write_mp4 with PIL blocked against JAX's
    write_mp4 (PIL), at odd sizes too."""
    for i, video in enumerate((np.stack([_gradient(48, 64, 20, s) for s in range(3)]),
                               np.stack([_gradient(17, 30, 50, s) for s in range(2)]))):
        JMP4.write_mp4(str(tmp_path / f"j{i}.mp4"), video, fps=16, quality=quality)
        _port_encode(monkeypatch, TMP4.write_mp4, str(tmp_path / f"t{i}.mp4"), video, fps=16, quality=quality)
        assert (tmp_path / f"t{i}.mp4").read_bytes() == (tmp_path / f"j{i}.mp4").read_bytes()


@pytest.mark.parametrize("workers", [1, 2])
def test_read_mp4_without_pil_equals_jax(tmp_path, monkeypatch, workers):
    """read_mp4_mjpeg with PIL blocked (io/image.decode_jpeg, in one process
    or two) returns JAX's reader's frames and fps."""
    video = np.stack([_gradient(40, 56, 25, s) for s in range(3)])
    path = str(tmp_path / "v.mp4")
    JMP4.write_mp4(path, video, fps=12)
    ref, ref_fps = JMP4.read_mp4_mjpeg(path)
    frames, fps = _port_encode(monkeypatch, TMP4.read_mp4_mjpeg, path, workers=workers)
    assert fps == ref_fps == 12 and frames.shape == video.shape
    np.testing.assert_array_equal(frames, ref)
