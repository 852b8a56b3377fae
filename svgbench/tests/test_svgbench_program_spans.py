"""The readers of the program's own regions (svgbench/program_spans.py and
the six metrics on it): device ms a step of their label from the timer's
profiled log; nothing from an empty trace, a window with no device
operation, an absent label, or a program without the log."""

import pytest

from svgbench.spec import Benchmark
from svgbench.trace import Op, TraceView
from sparse_videogen_tpu_torch.utils import timer

LABELS = {"svg1_profile_ms": "svg1.profile", "svg1_place_ms": "svg1.place", "attn_pad_ms": "attn.pad",
          "norm_mod_ms": "model.norm", "qk_ms": "model.qk", "residual_ms": "model.residual"}
# a planted profiled log: seconds and counts by label, over 4 steps
SECS = {"svg1.profile": 0.4, "svg1.place": 0.2, "attn.pad": 0.12, "model.norm": 1.0, "model.qk": 0.6,
        "model.residual": 0.8, "video.plan": 3.0}
COUNTS = {label: 7 for label in SECS}


def view(steps=4, ops=True):
    b = Benchmark()
    return TraceView(ops=[Op("k", 0, 10, "forward")] if ops else [], steps=steps, step_s=1.0, counts={},
                     kernel_map=b.kernel_map(), peaks={})


def reader(name):
    b = Benchmark()
    return b.reader(next(m for m in b.per_layer if m.name == name))


@pytest.fixture
def planted(monkeypatch):
    monkeypatch.setattr(timer, "profiled_log", lambda clear=False: (dict(SECS), dict(COUNTS)))


@pytest.mark.parametrize("name", sorted(LABELS))
def test_reader_gives_ms_a_step_of_its_label(planted, name):
    assert reader(name)(view()) == pytest.approx(1e3 * SECS[LABELS[name]] / 4)


@pytest.mark.parametrize("name", sorted(LABELS))
def test_reader_reads_nothing_from_an_empty_trace(planted, name):
    assert reader(name)(TraceView(ops=[], steps=0, step_s=0.0, counts={}, kernel_map={}, peaks={})) is None


@pytest.mark.parametrize("name", sorted(LABELS))
def test_reader_reads_nothing_without_device_operations(planted, name):
    assert reader(name)(view(ops=False)) is None


@pytest.mark.parametrize("name", sorted(LABELS))
def test_reader_reads_nothing_for_an_absent_label(monkeypatch, name):
    monkeypatch.setattr(timer, "profiled_log", lambda clear=False: ({"video.plan": 1.0}, {"video.plan": 1}))
    assert reader(name)(view()) is None


@pytest.mark.parametrize("name", sorted(LABELS))
def test_reader_reads_nothing_from_a_program_without_the_log(monkeypatch, name):
    monkeypatch.delattr(timer, "profiled_log")
    assert reader(name)(view()) is None


def test_metrics_are_declared_as_program_spans():
    b = Benchmark()
    by_name = {m.name: m for m in b.per_layer}
    for name in LABELS:
        m = by_name[name]
        assert (m.source, m.unit, m.better, m.moves) == ("program_span", "ms", "lower", "step_s")
    cells = {m["name"]: m["workloads"] for m in b.data["per_layer"] if m["name"] in LABELS}
    assert cells["svg1_profile_ms"] == cells["svg1_place_ms"] == ["wan1.3b-480p-svg1", "hyvideo-720p-svg1"]
    assert all(set(cells[n]) == set(b.workloads) for n in LABELS if not n.startswith("svg1_"))


def test_gaps_are_named_by_the_ranges_open_on_the_host():
    from svgbench.gaps import reduce_trace

    X = lambda name, cat, ts, dur: {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    trace = {"traceEvents": [
        X("k0", "kernel", 0, 10), X("k1", "kernel", 12, 10), X("Memcpy HtoD", "gpu_memcpy", 60, 5),
        X("k2", "kernel", 66, 4), X("svt.video.plan", "cpu_op", 20, 38), X("svt.model.qk", "cpu_op", 0, 11),
        X("svgbench.forward", "user_annotation", 0, 100), X("cudaMemcpyAsync", "cuda_runtime", 50, 10),
        X("svgbench.forward", "gpu_user_annotation", 0, 100)]}
    gaps = reduce_trace(trace, 2)
    assert [g["ms"] for g in gaps] == [0.038, 0.002]
    assert gaps[0]["follows"] == "k1" and gaps[0]["ended_by"] == "Memcpy HtoD"
    assert gaps[0]["program"] == [["svt.video.plan", 0.036]]
    assert gaps[0]["benchmark"] == [["svgbench.forward", 0.038]] and gaps[0]["host"] == [["cudaMemcpyAsync", 0.01]]
    assert gaps[1]["program"] == [["svt.model.qk", 0.001]] and gaps[1]["follows"] == "k0"
