"""The control of a cell's comparison: the reference itself, computed in the
precision below the configuration's (bf16 -> float8 e4m3 operands in every
matrix product), put in the program's place and judged by the f32
reference like the program. Its readings set the upper end of each limit;
a sound comparison reads it as not correct. The benchmark's runs never run
it.

    python3 -m svgbench.control --workload <name> --seeds 11,12,13 [--prec fp8]

Prints one JSON line a seed: the numbers, and whether the cell's limits
pass them (they must not).
"""

from __future__ import annotations

import argparse
import json
import sys
import time

from svgbench.run import cache_dirs, card_line, family
from svgbench.spec import ROOT, Benchmark


def readings(bench, cell, seed: int, device, prec: str = "fp8") -> dict:
    fam = family(cell.config["family"])
    captured = fam.control_capture(cell, seed, device, prec)
    numbers = fam.judge(cell, seed, device, captured)
    limits = cell.cell["limits"]
    return {"seed": seed, "prec": prec, "numbers": numbers,
            "passes_limits": all(numbers[k] <= v for k, v in limits.items())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--prec", default="fp8")
    args = ap.parse_args(argv)
    cache_dirs()
    import torch

    if not torch.cuda.is_available():
        print("svgbench.control: needs a CUDA device", file=sys.stderr)
        return 2
    bench = Benchmark(ROOT)
    cell = bench.cell(args.workload)
    print(f"[control] {card_line()}", file=sys.stderr, flush=True)
    for s in args.seeds.split(","):
        t0 = time.perf_counter()
        r = readings(bench, cell, int(s), torch.device("cuda", 0), args.prec)
        r["seconds"] = time.perf_counter() - t0
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
