"""Labelled regions: the port's one tracing module (counterpart of
sparse_videogen_tpu/utils/timer.py, after the reference's svg/timer.py).

`time_logging(label)` records in two cases: while TIME_BENCH is set (the
operator's switch: 1 accumulates across calls, 2 also clears the log when it
is printed) and while a torch profiler runs. Otherwise it costs one check of
each and returns a shared no-op context. A recording region

- records a CUDA event at each end on the current stream, where there is a
  card, else reads the host's clock (`host=True`: always the host's clock,
  for host work such as building a plan);
- opens a host range named "svt.<label>" (`_RecordFunctionFast`: not a user
  annotation, so the profiler draws it on the host's timeline only, on the
  clock of the device operations);
- never synchronizes: the events are read when a log is read, and past
  _SETTLE_AT waiting pairs those the device has passed are read and their
  events reused, so that a long window reads a few hundred pairs at a time
  (thousands at once stalled the host for 50-70 ms, long enough to idle the
  card) and keeps few Python objects alive.

Figures recorded while a profiler runs go to a log of their own
(`profiled_log`), so that a traced run reads its own window whatever
TIME_BENCH says; `get_log` and `print_operator_log_data` read TIME_BENCH's.

The regions and the metrics that read them (svgbench/metrics/):
  svg1.profile    sample_mse and best_mask_idx          svg1_profile_ms
  svg1.place      place_heads of q, k, v, o; dual_rows  svg1_place_ms
  attn.pad        _run_kernel's padding and copies      attn_pad_ms
  model.norm      f32 LayerNorm, AdaLN, the cast back   norm_mod_ms
  model.qk        q/k RMSNorm, RoPE, [video | text]     qk_ms
  model.residual  gated residual adds and their casts   residual_ms
  video.plan      make_*_runtime (host clock)
  sap.kmeans      SAP's k-means, q and k sides          sap_kmeans_ms
  sap.map         SAP's dynamic map and its density     sap_map_ms
  sap.permute     SAP's permutations and their inverse  sap_permute_ms
`profiler_trace` captures a torch.profiler trace in Chrome's format.

Counters (`count(label, value)`) record under the same two conditions,
beside the regions: an int adds on the host, a tensor (a count the device
computed) adds on the device, and nothing is read until a log is read
(`counted_log`, `get_counts`), so a step never waits for them. Compute a
counter's tensor only where `counting()` is true: off, it costs nothing.
  sap.pairs       real (query, key) pairs SAP's maps allow  svgbench's SAP counts
  sap.q_rows      q rows in the q blocks the run-list kernel computes (each
                  cluster's rows padded to block_q)         sap_q_pad
  sap.q_real      real q rows (heads x tokens)              sap_q_pad
  sap.kv_rows     K rows K3 stages (its packed 128-row stages
                  x 128), over the q blocks it walks        sap_kv_pad
  sap.kv_live     live keys of the same q blocks' run lists sap_kv_pad
  sap.lloyd.<K>   Lloyd passes of a K-centroid k-means call kmeans_roofline
"""

from __future__ import annotations

import contextlib
import os
import tempfile
import threading
import time
from collections import defaultdict

import torch
from torch._C._profiler import _RecordFunctionFast
from torch.autograd import _profiler_enabled

_LOG = defaultdict(float)  # TIME_BENCH's: label -> seconds
_COUNT = defaultdict(int)
_PROF_LOG = defaultdict(float)  # recorded while a profiler ran
_PROF_COUNT = defaultdict(int)
_PENDING = []  # (label, start event, end event, to TIME_BENCH's log, to the profiled log), not read yet
_POOL = []  # read CUDA events, free to record again
_SETTLE_AT = 256
_LOCK = threading.Lock()
_OFF = contextlib.nullcontext()
_CTR = {}  # TIME_BENCH's counters: label -> int or device tensor
_PROF_CTR = {}  # counted while a profiler ran


def enabled() -> bool:
    return os.environ.get("TIME_BENCH", "0") != "0"


def _add(label: str, seconds: float, bench: bool, prof: bool) -> None:
    if bench:
        _LOG[label] += seconds
        _COUNT[label] += 1
    if prof:
        _PROF_LOG[label] += seconds
        _PROF_COUNT[label] += 1


@contextlib.contextmanager
def _region(label: str, host: bool, bench: bool, prof: bool):
    with _RecordFunctionFast("svt." + label):
        if host or not torch.cuda.is_available():
            t0 = time.perf_counter()
            yield
            _add(label, time.perf_counter() - t0, bench, prof)
        else:
            start, end = _event(), _event()
            start.record()
            yield
            end.record()
            _PENDING.append((label, start, end, bench, prof))
            if len(_PENDING) > _SETTLE_AT:
                _settle(wait=False)


def _event():
    try:
        return _POOL.pop()
    except IndexError:
        return torch.cuda.Event(enable_timing=True)


def time_logging(label: str, *, host: bool = False):
    """The region `label`: device time between CUDA events where there is a
    card (host=True, or no card: the host's clock), recorded under TIME_BENCH
    or a running profiler, else a shared no-op context."""
    prof = _profiler_enabled()
    bench = enabled()
    if not (prof or bench):
        return _OFF
    return _region(label, host, bench, prof)


def counting() -> bool:
    """Whether a counter records now (TIME_BENCH, or a running profiler)."""
    return _profiler_enabled() or enabled()


def count(label: str, value) -> None:
    """Add `value` (an int, or a tensor on any device) to the counter
    `label` of each log that records now; a tensor adds on its device, with
    no synchronize."""
    for on, log in ((enabled(), _CTR), (_profiler_enabled(), _PROF_CTR)):
        if on:
            log[label] = log[label] + value if label in log else value


def _read_counts(log: dict, clear: bool) -> dict:
    out = {k: float(v) for k, v in log.items()}
    if clear:
        log.clear()
    return out


def get_counts(clear: bool = False) -> dict:
    """TIME_BENCH's counters, {label: value}."""
    return _read_counts(_CTR, clear)


def counted_log(clear: bool = False) -> dict:
    """The counters recorded while a profiler ran, {label: value}; `clear`
    empties them after reading."""
    return _read_counts(_PROF_CTR, clear)


def _settle(wait: bool = True) -> None:
    """Fold the recorded CUDA event pairs into the logs: every pair, after a
    synchronize, or (wait=False) those whose end the device has passed, in
    order. Their events go back to the pool."""
    with _LOCK:
        if not _PENDING:
            return
        if wait:
            torch.cuda.synchronize()
        n = 0
        for label, start, end, bench, prof in _PENDING:
            if not wait and not end.query():
                break
            _add(label, start.elapsed_time(end) / 1e3, bench, prof)
            _POOL.extend((start, end))
            n += 1
        del _PENDING[:n]


def get_log():
    """TIME_BENCH's ({label: seconds}, {label: count})."""
    _settle()
    return dict(_LOG), dict(_COUNT)


def profiled_log(clear: bool = False):
    """({label: seconds}, {label: count}) of the regions recorded while a
    profiler ran (device seconds, or host seconds for host regions); `clear`
    empties it after reading."""
    _settle()
    out = dict(_PROF_LOG), dict(_PROF_COUNT)
    if clear:
        _PROF_LOG.clear()
        _PROF_COUNT.clear()
    return out


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


@contextlib.contextmanager
def profiler_trace(logdir: str | None = None):
    """torch.profiler over the region (the CPU, and CUDA when there is a
    card), written as a Chrome trace to <logdir>/trace.json (default: a
    svt_trace directory under the temporary directory), with every region's
    "svt.<label>" range; `profiled_log` then holds this trace's regions.
    Yields logdir."""
    from torch.profiler import ProfilerActivity, profile

    logdir = logdir or os.path.join(tempfile.gettempdir(), "svt_trace")
    os.makedirs(logdir, exist_ok=True)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    profiled_log(clear=True)
    counted_log(clear=True)
    with profile(activities=acts) as prof:
        yield logdir
    prof.export_chrome_trace(os.path.join(logdir, "trace.json"))
