"""Faults planted in the program's timed path: the tests see `correct` come
out false under each, and their readings on the card set the upper end of
a limit. The benchmark's own runs never plant one.

    python3 -m svgbench.faults --fault <name> --workload <cell> --seed <n> --seconds <s> [--trace 0]

runs the cell as `svgbench.run` does, with the fault planted. Each fault
takes `set_attr` (setattr, or a test's monkeypatch.setattr).
"""

from __future__ import annotations

import argparse
import sys

import torch


def state_unchanged(set_attr=setattr) -> None:
    """The sampler's step returns the latents it was given."""
    from sparse_videogen_tpu_torch.schedulers import FlowMatchEuler, FlowUniPC

    set_attr(FlowUniPC, "step", lambda self, i, x, v, state: (x, state))
    set_attr(FlowMatchEuler, "step", lambda self, i, x, v, state=(): (x, state))


def half_batch(set_attr=setattr) -> None:
    """Wan's CFG pair: the second half is not computed, the first half's
    output stands in for it."""
    from sparse_videogen_tpu_torch.models.wan.model import WanModel

    fwd = WanModel.forward

    def half(self, x, t, context, **kw):
        v = fwd(self, x[:1], t[:1], context[:1], **kw)
        return torch.cat([v] * x.shape[0])

    set_attr(WanModel, "forward", half)


def attention_altered(set_attr=setattr) -> None:
    """One head's attention output of every layer is off, as if a kernel
    wrote a wrong tile."""
    from sparse_videogen_tpu_torch.sparse import runtimes

    for fn in ("svg1_sparse_impl", "dense_impl"):
        orig = getattr(runtimes, fn)

        def altered(*a, _orig=orig, **kw):
            o = _orig(*a, **kw).clone()
            o[:, 0] = o[:, 0].flip(1)
            return o

        set_attr(runtimes, fn, altered)


def invert_class(set_attr=setattr) -> None:
    """SVG1's profiler gives every head the class with the LARGER profiling
    error: the spatial and the temporal mask swapped."""
    from sparse_videogen_tpu_torch.sparse import svg1

    pick = svg1.best_mask_idx
    set_attr(svg1, "best_mask_idx", lambda mses: 1 - pick(mses))


FAULTS = {f.__name__: f for f in (state_unchanged, half_batch, attention_altered, invert_class)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    args, rest = ap.parse_known_args(argv)
    from svgbench import run

    FAULTS[args.fault]()
    return run.main(rest)


if __name__ == "__main__":
    sys.exit(main())
