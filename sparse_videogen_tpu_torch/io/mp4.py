"""Minimal MP4 (ISO BMFF) muxer with Motion-JPEG samples in an `mp4v` track
(counterpart of sparse_videogen_tpu/io/mp4.py; same bytes).

Each frame is a baseline JPEG (PIL, quality 95, 4:4:4) and the track's ESDS
declares MPEG-4 ObjectTypeIndication 0x6C (JPEG): a standard ISO/IEC
14496-14 stream that ffmpeg and VLC decode as mjpeg. PIL is imported only
here, when a frame is encoded or decoded: a host without it cannot write
.mp4 and is told to write the lossless .y4m (io/native.py) instead.

Layout: [ftyp][mdat: jpeg*][moov: mvhd trak(tkhd mdia(mdhd hdlr minf(vmhd
dinf stbl(stsd(mp4v esds) stts stsc stsz stco)))]. Single chunk; one stts
run; 90 kHz timescale.
"""

from __future__ import annotations

import io
import struct

import numpy as np

TIMESCALE = 90000


def _box(tag: bytes, payload: bytes) -> bytes:
    return struct.pack(">I", 8 + len(payload)) + tag + payload


def _full(tag: bytes, version: int, flags: int, payload: bytes) -> bytes:
    return _box(tag, struct.pack(">I", (version << 24) | flags) + payload)


def _desc(tag: int, payload: bytes) -> bytes:
    """MPEG-4 descriptor with expandable length (here always < 2^21)."""
    n = len(payload)
    size = b""
    for shift in (14, 7):
        if n >= (1 << shift):
            size += bytes([0x80 | ((n >> shift) & 0x7F)])
    size += bytes([n & 0x7F])
    return bytes([tag]) + size + payload


def _esds() -> bytes:
    dec_cfg = _desc(
        0x04,
        bytes([0x6C, (0x04 << 2) | 1])  # OTI 0x6C = JPEG, streamType visual
        + b"\x00\x00\x00"  # bufferSizeDB
        + struct.pack(">II", 0, 0),  # max/avg bitrate (unknown)
    )
    sl = _desc(0x06, b"\x02")
    es = _desc(0x03, struct.pack(">HB", 1, 0) + dec_cfg + sl)
    return _full(b"esds", 0, 0, es)


def _sample_entry(width: int, height: int) -> bytes:
    name = b"\x0bMotion-JPEG" + b"\x00" * 20  # 32-byte pascal compressorname
    payload = (
        b"\x00" * 6
        + struct.pack(">H", 1)  # data_reference_index
        + b"\x00" * 16  # pre_defined / reserved
        + struct.pack(">HH", width, height)
        + struct.pack(">II", 0x00480000, 0x00480000)  # 72 dpi
        + b"\x00" * 4
        + struct.pack(">H", 1)  # frame_count
        + name
        + struct.pack(">Hh", 24, -1)  # depth, pre_defined
        + _esds()
    )
    return _box(b"mp4v", payload)


def _matrix() -> bytes:
    return struct.pack(">9i", 0x10000, 0, 0, 0, 0x10000, 0, 0, 0, 0x40000000)


def _pil_image():
    try:
        from PIL import Image
    except ImportError as e:
        raise ImportError(".mp4 needs PIL (Pillow) to encode its JPEG frames, and this host has none: "
                          "write a .y4m instead (io/native.write_y4m; --output_file out.y4m)") from e
    return Image


def encode_frames_jpeg(frames: np.ndarray, quality: int = 95) -> list[bytes]:
    Image = _pil_image()

    out = []
    for f in frames:
        buf = io.BytesIO()
        Image.fromarray(f, "RGB").save(buf, "JPEG", quality=quality, subsampling=0)
        out.append(buf.getvalue())
    return out


def write_mp4(path: str, video: np.ndarray, fps: int = 16, quality: int = 95) -> None:
    """video: (T, H, W, 3) uint8 RGB -> .mp4 (MJPEG track)."""
    if video.ndim != 4 or video.shape[-1] != 3 or video.dtype != np.uint8:
        raise ValueError(f"write_mp4 needs a (T, H, W, 3) uint8 video, got {video.shape} {video.dtype}")
    n, height, width = video.shape[0], video.shape[1], video.shape[2]
    samples = encode_frames_jpeg(video, quality=quality)
    delta = round(TIMESCALE / fps)
    duration = n * delta

    ftyp = _box(b"ftyp", b"isom" + struct.pack(">I", 0x200) + b"isomiso2mp41")
    mdat_payload = b"".join(samples)
    first_sample_off = len(ftyp) + 8  # mdat header

    stsd = _full(b"stsd", 0, 0, struct.pack(">I", 1) + _sample_entry(width, height))
    stts = _full(b"stts", 0, 0, struct.pack(">III", 1, n, delta))
    stsc = _full(b"stsc", 0, 0, struct.pack(">IIII", 1, 1, n, 1))
    stsz = _full(b"stsz", 0, 0, struct.pack(">II", 0, n) + b"".join(struct.pack(">I", len(s)) for s in samples))
    stco = _full(b"stco", 0, 0, struct.pack(">II", 1, first_sample_off))
    stbl = _box(b"stbl", stsd + stts + stsc + stsz + stco)
    url = _full(b"url ", 0, 1, b"")
    dref = _full(b"dref", 0, 0, struct.pack(">I", 1) + url)
    dinf = _box(b"dinf", dref)
    vmhd = _full(b"vmhd", 0, 1, struct.pack(">HHHH", 0, 0, 0, 0))
    minf = _box(b"minf", vmhd + dinf + stbl)
    hdlr = _full(b"hdlr", 0, 0, struct.pack(">I", 0) + b"vide" + b"\x00" * 12 + b"VideoHandler\x00")
    mdhd = _full(b"mdhd", 0, 0, struct.pack(">IIIIHH", 0, 0, TIMESCALE, duration, 0x55C4, 0))
    mdia = _box(b"mdia", mdhd + hdlr + minf)
    tkhd = _full(
        b"tkhd", 0, 3,
        struct.pack(">IIIII", 0, 0, 1, 0, duration)
        + b"\x00" * 8
        + struct.pack(">hhhh", 0, 0, 0, 0)
        + _matrix()
        + struct.pack(">II", width << 16, height << 16),
    )
    trak = _box(b"trak", tkhd + mdia)
    mvhd = _full(
        b"mvhd", 0, 0,
        struct.pack(">IIII", 0, 0, TIMESCALE, duration)
        + struct.pack(">IH", 0x00010000, 0x0100)  # rate, volume
        + b"\x00" * 10
        + _matrix()
        + b"\x00" * 24
        + struct.pack(">I", 2),  # next_track_id
    )
    moov = _box(b"moov", mvhd + trak)

    with open(path, "wb") as f:
        f.write(ftyp)
        f.write(_box(b"mdat", mdat_payload))
        f.write(moov)


def read_mp4_mjpeg(path: str) -> tuple[np.ndarray, int]:
    """Inverse of write_mp4 for round-trip tests: ((T,H,W,3) uint8, fps).

    Parses only files written by write_mp4 (single mjpeg track, one chunk).
    """
    Image = _pil_image()
    with open(path, "rb") as f:
        data = f.read()

    def boxes(buf, off=0, end=None):
        end = len(buf) if end is None else end
        while off + 8 <= end:
            size, tag = struct.unpack(">I4s", buf[off : off + 8])
            yield tag, off + 8, off + size
            off += size

    top = {t: (a, b) for t, a, b in boxes(data)}
    a, b = top[b"moov"]
    moov = {t: (x, y) for t, x, y in boxes(data, a, b)}
    a, b = moov[b"trak"]
    trak = {t: (x, y) for t, x, y in boxes(data, a, b)}
    a, b = trak[b"mdia"]
    mdia = {t: (x, y) for t, x, y in boxes(data, a, b)}
    mh_a, _ = mdia[b"mdhd"]
    timescale = struct.unpack(">I", data[mh_a + 12 : mh_a + 16])[0]
    a, b = mdia[b"minf"]
    minf = {t: (x, y) for t, x, y in boxes(data, a, b)}
    a, b = minf[b"stbl"]
    stbl = {t: (x, y) for t, x, y in boxes(data, a, b)}
    st_a, _ = stbl[b"stts"]
    _, delta = struct.unpack(">II", data[st_a + 8 : st_a + 16])
    sz_a, _ = stbl[b"stsz"]
    _, count = struct.unpack(">II", data[sz_a + 4 : sz_a + 12])
    sizes = struct.unpack(f">{count}I", data[sz_a + 12 : sz_a + 12 + 4 * count])
    co_a, _ = stbl[b"stco"]
    off = struct.unpack(">I", data[co_a + 8 : co_a + 12])[0]
    frames = []
    for s in sizes:
        frames.append(np.asarray(Image.open(io.BytesIO(data[off : off + s])).convert("RGB")))
        off += s
    return np.stack(frames), round(timescale / delta)
