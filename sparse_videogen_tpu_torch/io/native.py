"""Raw video files in numpy (counterpart of sparse_videogen_tpu/io/native.py,
its pure-Python branch: the port loads no native library).

.y4m is YUV4MPEG2 with C420jpeg chroma (2x2 means), BT.601 full range;
ffmpeg and mpv play it.
"""

from __future__ import annotations

import numpy as np


def write_y4m(path: str, video: np.ndarray, fps: int = 16) -> None:
    """video: (T, H, W, 3) uint8 RGB, H and W even -> .y4m."""
    video = np.ascontiguousarray(video, np.uint8)
    T, H, W, C = video.shape
    if C != 3 or H % 2 or W % 2:
        raise ValueError(f"write_y4m needs (T, H, W, 3) with even H and W, got {video.shape}")
    with open(path, "wb") as f:
        f.write(f"YUV4MPEG2 W{W} H{H} F{fps}:1 Ip A1:1 C420jpeg\n".encode())
        rgb = video.astype(np.float32)
        y = 0.299 * rgb[..., 0] + 0.587 * rgb[..., 1] + 0.114 * rgb[..., 2]
        blk = rgb.reshape(T, H // 2, 2, W // 2, 2, 3).mean(axis=(2, 4))
        u = -0.168736 * blk[..., 0] - 0.331264 * blk[..., 1] + 0.5 * blk[..., 2] + 128
        v = 0.5 * blk[..., 0] - 0.418688 * blk[..., 1] - 0.081312 * blk[..., 2] + 128
        for t in range(T):
            f.write(b"FRAME\n")
            f.write(np.clip(y[t], 0, 255).astype(np.uint8).tobytes())
            f.write(np.clip(u[t], 0, 255).astype(np.uint8).tobytes())
            f.write(np.clip(v[t], 0, 255).astype(np.uint8).tobytes())


def read_y4m(path: str) -> tuple[np.ndarray, int]:
    """.y4m -> ((T, H, W, 3) uint8 RGB, fps): write_y4m's C420jpeg layout back
    (nearest-upsampled chroma)."""
    with open(path, "rb") as f:
        header = f.readline().decode()
        if not header.startswith("YUV4MPEG2"):
            raise ValueError(f"{path}: not a YUV4MPEG2 file ({header[:20]!r})")
        W = H = fps = 0
        for tok in header.split()[1:]:
            if tok[0] == "W":
                W = int(tok[1:])
            elif tok[0] == "H":
                H = int(tok[1:])
            elif tok[0] == "F":
                fps = int(tok[1:].split(":")[0])
        frames = []
        ysz, csz = H * W, (H // 2) * (W // 2)
        while True:
            line = f.readline()
            if not line:
                break
            if not line.startswith(b"FRAME"):
                raise ValueError(f"{path}: expected a FRAME marker, got {line[:20]!r}")
            y = np.frombuffer(f.read(ysz), np.uint8).reshape(H, W).astype(np.float32)
            u = np.frombuffer(f.read(csz), np.uint8).reshape(H // 2, W // 2).astype(np.float32)
            v = np.frombuffer(f.read(csz), np.uint8).reshape(H // 2, W // 2).astype(np.float32)
            u = np.repeat(np.repeat(u, 2, 0), 2, 1) - 128.0
            v = np.repeat(np.repeat(v, 2, 0), 2, 1) - 128.0
            r = y + 1.402 * v
            g = y - 0.344136 * u - 0.714136 * v
            b = y + 1.772 * u
            frames.append(np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8))
    return np.stack(frames), fps


def load_video(path: str) -> np.ndarray:
    """.y4m or .npz/.npy -> (T, H, W, 3) float32 in [0, 1]."""
    if path.endswith(".y4m"):
        return read_y4m(path)[0].astype(np.float32) / 255.0
    arr = np.load(path)
    if hasattr(arr, "files"):
        arr = arr[arr.files[0]]
    arr = np.asarray(arr, np.float32)
    if arr.ndim == 5:
        arr = arr[0]
    if arr.shape[0] == 3 and arr.shape[-1] != 3:  # (3, T, H, W) -> (T, H, W, 3)
        arr = np.transpose(arr, (1, 2, 3, 0))
    if arr.min() < -0.01:  # [-1, 1] -> [0, 1]
        arr = (arr + 1.0) / 2.0
    return np.clip(arr, 0.0, 1.0)
