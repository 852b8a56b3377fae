"""The traced window's longest idle stretches on the device, each named by
what was open on the host meanwhile: the program's own regions
("svt.<label>", sparse_videogen_tpu_torch/utils/timer.py), the benchmark's
spans ("svgbench.<layer>") and the host's other operations.

    python3 -m svgbench.gaps --workload <name> --seed <n> --seconds <s> [--gaps 3] [--out file.json]

From the root of a checkout, on the card: the cell's set-up and warm step
as svgbench/run.py makes them, then the window under the timer's
`profiler_trace`, whose Chrome trace (build/gaps_trace/) is reduced here and
removed. Prints one JSON line (and writes it to --out): the gaps, longest
first, and the program's regions of the window by label.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import sys

from svgbench.run import ROOT, cache_dirs, family
from svgbench.spec import Benchmark

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def _overlaps(events, a: float, b: float, n: int) -> list:
    """[name, ms] of the n events overlapping [a, b] (us) the longest."""
    out = {}
    for e in events:
        o = min(b, e["ts"] + e["dur"]) - max(a, e["ts"])
        if o > 0:
            out[e["name"]] = max(out.get(e["name"], 0.0), o)
    return [[k, v / 1e3] for k, v in sorted(out.items(), key=lambda kv: -kv[1])[:n]]


def reduce_trace(trace: dict, n_gaps: int) -> list:
    """The n longest stretches between device operations of a Chrome trace,
    each with the device operations it follows and that end it, and the
    host's ranges that overlapped it, longest overlap first."""
    xs = [e for e in trace["traceEvents"] if e.get("ph") == "X" and "dur" in e]
    dev = sorted((e for e in xs if e.get("cat") in DEVICE_CATS), key=lambda e: e["ts"])
    program = [e for e in xs if e.get("cat") == "cpu_op" and e["name"].startswith("svt.")]
    bench = [e for e in xs if e.get("cat") == "user_annotation" and e["name"].startswith("svgbench.")]
    host = [e for e in xs if e.get("cat") in ("cpu_op", "cuda_runtime") and not e["name"].startswith("svt.")]
    gaps, end, last = [], None, None
    for e in dev:
        if end is not None and e["ts"] > end:
            gaps.append((e["ts"] - end, end, e["ts"], last["name"], e["name"]))
        if end is None or e["ts"] + e["dur"] > end:
            end, last = e["ts"] + e["dur"], e
    gaps.sort(key=lambda g: -g[0])
    return [{"ms": us / 1e3, "follows": follows[:100], "ended_by": ended_by[:100],
             "program": _overlaps(program, a, b, 4), "benchmark": _overlaps(bench, a, b, 3),
             "host": _overlaps(host, a, b, 5)}
            for us, a, b, follows, ended_by in gaps[:n_gaps]]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--gaps", type=int, default=3)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    cache_dirs()
    import torch

    from sparse_videogen_tpu_torch.utils import timer

    if not torch.cuda.is_available():
        print("svgbench.gaps: needs a CUDA device", file=sys.stderr)
        return 2
    cell = Benchmark(ROOT).cell(args.workload)
    run = family(cell.config["family"]).Run(cell, args.seed, torch.device("cuda", 0), True)
    run.setup()
    run.warm()
    logdir = os.path.join(ROOT, "build", "gaps_trace")
    with timer.profiler_trace(logdir):
        win = run.window(args.seconds)
    secs, counts = timer.profiled_log()
    path = os.path.join(logdir, "trace.json")
    with open(path) as f:
        gaps = reduce_trace(json.load(f), args.gaps)
    shutil.rmtree(logdir)
    out = {"workload": cell.name, "seed": args.seed, "steps": win["steps"], "window_s": win["seconds"],
           "gaps": gaps, "regions_ms_a_step": {k: 1e3 * s / win["steps"] for k, s in sorted(secs.items())},
           "regions_a_step": {k: n / win["steps"] for k, n in sorted(counts.items())}}
    line = json.dumps(out)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "w") as f:
            f.write(line + "\n")
    print(line, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
