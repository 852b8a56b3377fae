"""Labelled region timer (counterpart of sparse_videogen_tpu/utils/timer.py,
after the reference's svg/timer.py).

TIME_BENCH=1 accumulates the time of every `time_logging(label)` region
across calls; TIME_BENCH=2 also clears the log when it is printed; unset
or 0, the regions cost nothing. On a CUDA device a region records a CUDA
event at each end, without a synchronize, and the elapsed times are read
after a synchronize when the log is read or printed (the reference's own
design); without a card it reads time.perf_counter. `profiler_trace` captures
a torch.profiler trace in Chrome's format and `named_scope` names a range
in it.
"""

from __future__ import annotations

import functools
import os
import tempfile
import time
from collections import defaultdict
from contextlib import contextmanager

import torch

_LOG = defaultdict(float)  # label -> seconds
_COUNT = defaultdict(int)
_PENDING = []  # (label, start event, end event) not read yet


def enabled() -> bool:
    return os.environ.get("TIME_BENCH", "0") != "0"


@contextmanager
def time_logging(label: str):
    """Time the region under `label`: with CUDA events where there is a
    card, else on the host's clock."""
    if not enabled():
        yield
        return
    if torch.cuda.is_available():
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        yield
        end.record()
        _PENDING.append((label, start, end))
        _COUNT[label] += 1
        return
    t0 = time.perf_counter()
    yield
    _LOG[label] += time.perf_counter() - t0
    _COUNT[label] += 1


def time_logging_decorator(label: str):
    def deco(fn):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            with time_logging(label):
                return fn(*a, **k)

        return wrapped

    return deco


def _settle() -> None:
    """Fold the recorded CUDA event pairs into the log (after a synchronize)."""
    if _PENDING:
        torch.cuda.synchronize()
        for label, start, end in _PENDING:
            _LOG[label] += start.elapsed_time(end) / 1e3
        _PENDING.clear()


def get_log():
    """({label: seconds}, {label: count})."""
    _settle()
    return dict(_LOG), dict(_COUNT)


def print_operator_log_data(clear: bool | None = None):
    """Print each label's accumulated time and count; clear the log when
    `clear` (by default: TIME_BENCH=2)."""
    if clear is None:
        clear = os.environ.get("TIME_BENCH", "0") == "2"
    _settle()
    for label in sorted(_LOG):
        print(f"{label}: {_LOG[label] * 1e3:10.2f} ms  (x{_COUNT[label]})")
    if clear:
        _LOG.clear()
        _COUNT.clear()


@contextmanager
def profiler_trace(logdir: str | None = None):
    """torch.profiler over the region (the CPU, and CUDA when there is a
    card), written as a Chrome trace to <logdir>/trace.json (default: a
    svt_trace directory under the temporary directory). Yields logdir."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "svt_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))


def named_scope(name: str):
    """A named range in profiler traces (torch.profiler.record_function)."""
    return torch.profiler.record_function(name)
