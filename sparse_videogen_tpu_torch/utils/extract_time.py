"""Denoise wall-clock extraction from generation logs.

A copy of sparse_videogen_tpu/utils/extract_time.py, after the reference's
svg/utils/extract_time.py: scans a log for completed
tqdm progress lines `100%|...| N/N [mm:ss<` and averages the elapsed times.
Also understands this package's own logger lines `denoise done in S.SSs`.
"""

from __future__ import annotations

import re
import statistics


def analyze_log(file_path: str, target_number: int):
    """(count, "mm:ss" average) of completed N/N tqdm runs in the log."""
    with open(file_path, encoding="utf-8", errors="ignore") as f:
        content = f.read()
    pattern = re.compile(
        rf"100%\|[^|]*\| {target_number}/{target_number} \[(\d{{1,2}}):(\d{{2}})<"
    )
    secs = [int(m) * 60 + int(s) for m, s in pattern.findall(content)]
    secs += [float(s) for s in re.findall(r"denoise done in ([0-9.]+)s", content)]
    if not secs:
        return 0, "00:00"
    avg = statistics.mean(secs)
    return len(secs), f"{int(avg // 60):02d}:{int(avg % 60):02d}"


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("extract_time")
    p.add_argument("--file", required=True)
    p.add_argument("--steps", type=int, default=50)
    args = p.parse_args(argv)
    n, avg = analyze_log(args.file, args.steps)
    print(f"{n} runs, average denoise time {avg}")


if __name__ == "__main__":
    main()
