"""Compare the SASS of the attention kernels between this tree and another
checkout of the repository (for example the parent commit, unpacked with
`git archive`), to show that a change to the shared CTA body left the
instances it does not mean to touch as they were.

    python -m sparse_videogen_tpu_torch.scripts.compare_sass --other build/parent [--out sass.json]

Builds both kernel libraries (each tree's own `_kernels.build()`, run in a
subprocess from that tree's root), disassembles each with `cuobjdump -sass`,
splits the listing into functions, strips the per-file anonymous-namespace
tag (`_GLOBAL__N__<hash>`) from the names and compares every function whose
name holds `bsa_kernel`, `bsa_stats_kernel`, `runs_kernel`,
`runs_stats_kernel` or `dense_kernel` instruction by instruction (the lines
that carry an address; addresses and encodings dropped). Prints one
line a function (equal, differing, or present on one side only), and for a
differing one the count of differing positions, whether the two sides hold
the same instructions in another order (`same multiset`) and the first
--show differing pairs; exits non-zero if a function present on both sides
differs.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
TRACKED = ("bsa_kernel", "bsa_stats_kernel", "runs_kernel", "runs_stats_kernel", "dense_kernel")
_FUNC = re.compile(r"^\s*Function : (\S+)")
_ANON = re.compile(r"_GLOBAL__N__[0-9a-fA-F_]+")
# an instruction line: its address, the instruction, its encoding
_INS = re.compile(r"^\s*/\*[0-9a-f]{4,}\*/\s*(.*?)\s*;?\s*/\*\s*0x[0-9a-f]+\s*\*/\s*$")


def build_lib(tree: str) -> str:
    """Path of `tree`'s kernel library, built by that tree's own code."""
    code = "from sparse_videogen_tpu_torch import _kernels; print(_kernels.build())"
    res = subprocess.run([sys.executable, "-c", code], cwd=tree, capture_output=True, text=True, check=True,
                         env={**os.environ, "PYTHONPATH": tree})
    return res.stdout.strip().splitlines()[-1]


def cuobjdump() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = os.path.join(CUDA_HOME or "/usr/local/cuda", "bin", "cuobjdump")
    return cand if os.path.isfile(cand) else "cuobjdump"


def functions(lib: str) -> dict[str, list[str]]:
    """{normalised function name: its SASS instructions} of the tracked kernels."""
    text = subprocess.run([cuobjdump(), "-sass", lib], capture_output=True, text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        m = _FUNC.match(line)
        if m is not None:
            raw = _ANON.sub("", m.group(1))
            name = raw if any(t in raw for t in TRACKED) else None
            if name is not None:
                out[name] = []
            continue
        if name is None:
            continue
        m = _INS.match(line)
        if m is not None:
            out[name].append(" ".join(m.group(1).split()))
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__, formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--other", required=True, help="root of the other checkout")
    p.add_argument("--out", default=None, help="write the per-function verdicts as JSON")
    p.add_argument("--show", type=int, default=8, help="differing instruction pairs to print a function")
    args = p.parse_args(argv)
    here, other = functions(build_lib(ROOT)), functions(build_lib(os.path.abspath(args.other)))
    rows, bad = [], 0
    for name in sorted(set(here) | set(other)):
        if name not in other or name not in here:
            verdict = "only here" if name in here else "only in the other tree"
        else:
            same = here[name] == other[name]
            verdict = "equal" if same else "DIFFERS"
            bad += not same
        n_here, n_other = len(here.get(name, [])), len(other.get(name, []))
        row = {"function": name, "verdict": verdict, "instructions": [n_here, n_other]}
        print(f"[sass] {name}: {verdict} ({n_here} instructions here, {n_other} in the other tree)", flush=True)
        if verdict == "DIFFERS":
            a, b = here[name], other[name]
            pairs = [(i, x, y) for i, (x, y) in enumerate(zip(a, b)) if x != y]
            row["differing_positions"] = len(pairs) + abs(len(a) - len(b))
            row["same_multiset"] = sorted(a) == sorted(b)
            print(f"[sass]   {row['differing_positions']} differing positions, same multiset of instructions: "
                  f"{row['same_multiset']}", flush=True)
            for i, x, y in pairs[:args.show]:
                print(f"[sass]   #{i}: here '{x}' | other '{y}'", flush=True)
        rows.append(row)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    if bad:
        raise SystemExit(f"{bad} function(s) present in both trees differ")


if __name__ == "__main__":
    main()
