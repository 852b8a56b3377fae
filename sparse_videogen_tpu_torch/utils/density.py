"""SAP density telemetry: one JSONL line per (timestep, layer) of a sparse
step (counterpart of sparse_videogen_tpu/utils/density.py's DensityLogger
and log_sap_states; the reference's --logging_file)."""

from __future__ import annotations

import json
import os

import numpy as np


class DensityLogger:
    def __init__(self, path: str | None):
        self.path = path
        if path:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
            open(path, "w").close()

    def log(self, timestep, layer: int, densities):
        if not self.path:
            return
        d = np.asarray(densities, np.float64).ravel()
        entry = {
            "timestep": float(timestep),
            "layer": int(layer),
            "avg_density": float(d.mean()),
            "density": d.tolist(),
        }
        with open(self.path, "a") as f:
            f.write(json.dumps(entry) + "\n")


def log_sap_states(dlog: DensityLogger, timestep, states) -> None:
    """Log per-layer SAP densities: `states` maps a layer to its SAPState,
    whose last_density is (B*H,); dense/warm-up layers leave zeros and are
    skipped (the reference logs sparse steps only)."""
    if dlog.path is None:
        return
    for li in sorted(states):
        dens = states[li].last_density.cpu().numpy()
        if dens.any():
            dlog.log(timestep, li, dens)
