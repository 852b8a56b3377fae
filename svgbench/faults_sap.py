"""Faults planted in SAP's timed path (svgbench/faults.py's form, for the
SAP cells): the tests see `correct` come out false under each, and their
readings on the card inform the SAP limits. The benchmark's own runs never
plant one.

    python3 -m svgbench.faults_sap --fault <name> --workload <cell> --seed <n> --seconds <s> [--trace 0]

runs the cell as `svgbench.run` does, with the fault planted. Each fault
takes `set_attr` (setattr, or a test's monkeypatch.setattr).
"""

from __future__ import annotations

import argparse
import sys

import torch


def labels_shuffled(set_attr=setattr) -> None:
    """Every head's q and k labels, as k-means hands them on, permuted over
    the tokens at random (the cluster sizes stay right)."""
    from sparse_videogen_tpu_torch.sparse import svg2

    cluster = svg2.sap_cluster

    def shuffled(*a, **kw):
        (qlab, qc, qsz), (klab, kc, ksz), state = cluster(*a, **kw)
        g = torch.Generator(device=qlab.device).manual_seed(7)
        mix = lambda lab: lab.gather(1, torch.argsort(torch.rand(lab.shape, generator=g, device=lab.device), dim=1))
        return (mix(qlab), qc, qsz), (mix(klab), kc, ksz), state

    set_attr(svg2, "sap_cluster", shuffled)


def map_floor(set_attr=setattr) -> None:
    """SAP's map cut to its min_kc_ratio floor: top_p 0, so every query
    cluster keeps only its most likely entry and the forced prefix."""
    from sparse_videogen_tpu_torch.sparse import svg2

    pick = svg2.identify_dynamic_map
    set_attr(svg2, "identify_dynamic_map", lambda qc, kc, qs, ks, top_p, min_kc_ratio=0.0: pick(
        qc, kc, qs, ks, 0.0, min_kc_ratio))


def uncond_reuses_cond(set_attr=setattr) -> None:
    """The unconditional stream is not computed: the conditional stream's
    output stands in for it (faults.half_batch's counterpart for SAP, whose
    streams are two batch-1 forwards)."""
    from sparse_videogen_tpu_torch.pipelines.wan import WanPipeline

    fwd = WanPipeline._sap_forward
    last = {}

    def reuse(self, runtime, stream_states, s, *a, **kw):
        if s == 0:
            last["v"] = fwd(self, runtime, stream_states, s, *a, **kw)
        return last["v"]

    set_attr(WanPipeline, "_sap_forward", reuse)


FAULTS = {f.__name__: f for f in (labels_shuffled, map_floor, uncond_reuses_cond)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--fault", required=True, choices=sorted(FAULTS))
    args, rest = ap.parse_known_args(argv)
    from svgbench import run

    FAULTS[args.fault]()
    return run.main(rest)


if __name__ == "__main__":
    sys.exit(main())
