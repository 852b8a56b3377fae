"""VBench result collection (a copy of sparse_videogen_tpu/utils/vbench.py,
after the reference's svg/utils/vbench.py).

Finds *eval_results.json files under a directory, extracts the first element
of each metric's list (VBench stores [score, per-video details]), and
aggregates means across files.
"""

from __future__ import annotations

import glob
import json
import os


def find_eval_results_files(directory: str) -> list:
    return sorted(glob.glob(os.path.join(directory, "**", "*eval_results.json"), recursive=True))


def extract_scores(json_data: dict) -> dict:
    """First element of each list value (the VBench score); scalars pass."""
    return {
        k: (v[0] if isinstance(v, list) and v else v) for k, v in json_data.items()
    }


def collect(directory: str) -> dict:
    """{file -> {metric -> score}} for every eval_results.json under dir."""
    out = {}
    for f in find_eval_results_files(directory):
        try:
            with open(f) as fh:
                data = json.load(fh)
            if isinstance(data, dict):
                out[f] = extract_scores(data)
        except (json.JSONDecodeError, OSError):
            continue
    return out


def mean_scores(directory: str) -> dict:
    """Per-metric mean over all collected files."""
    per_file = collect(directory)
    sums, counts = {}, {}
    for scores in per_file.values():
        for k, v in scores.items():
            if isinstance(v, (int, float)):
                sums[k] = sums.get(k, 0.0) + v
                counts[k] = counts.get(k, 0) + 1
    return {k: sums[k] / counts[k] for k in sums}


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser("vbench collect")
    p.add_argument("--directory", "-d", required=True)
    p.add_argument("--output", "-o", default=None)
    args = p.parse_args(argv)
    result = {"files": collect(args.directory), "mean": mean_scores(args.directory)}
    text = json.dumps(result, indent=2)
    if args.output:
        with open(args.output, "w") as f:
            f.write(text)
    else:
        print(text)


if __name__ == "__main__":
    main()
