"""The program's own timed regions (sparse_videogen_tpu_torch/utils/timer.py),
read in the benchmark's process after the traced window: each region that
ran while the window's profiler ran holds its device seconds in the timer's
profiled log. A program without that log (one that predates the regions)
reads as nothing, never as an error."""

from __future__ import annotations


def region_ms(t, label: str):
    """Device ms a step of the program's regions named `label` in the traced
    window `t`; None with no step, no device operation (the CPU) or no such
    region."""
    if t.steps == 0 or not t.ops:
        return None
    from sparse_videogen_tpu_torch.utils import timer

    log = getattr(timer, "profiled_log", None)
    if log is None:
        return None
    secs, counts = log()
    if not counts.get(label):
        return None
    return 1e3 * secs[label] / t.steps
