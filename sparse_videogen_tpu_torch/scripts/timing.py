"""Device timing helpers shared by the probe scripts."""

from __future__ import annotations

import subprocess

import torch


def cuda_ms(fn, iters: int, warmup: int) -> float:
    """Mean milliseconds of fn() over `iters` runs after `warmup` runs, by CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_line(script: str) -> str:
    """The card's name and power limit as nvidia-smi gives them; raises without a card."""
    if not torch.cuda.is_available():
        raise RuntimeError(f"{script} needs a CUDA device")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    return f"[device] {smi}; torch {torch.__version__} cuda {torch.version.cuda}"
