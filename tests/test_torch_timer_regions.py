"""The port's labelled regions (utils/timer.py) where each layer's work
happens: off, they record nothing and open no range; under torch.profiler a
tiny Wan and HunyuanVideo step, SVG1 and dense, records every label as often
as its layers run it, as host ranges that are no user annotations;
profiler_trace's Chrome trace holds them; TIME_BENCH=1 prints every label
with its count, and so do the CLIs at exit."""

import json
import os

import numpy as np
import pytest
import torch

from sparse_videogen_tpu_torch.cli import wan_t2v
from sparse_videogen_tpu_torch.config import SVGConfig
from sparse_videogen_tpu_torch.models.hyvideo import model as HM
from sparse_videogen_tpu_torch.models.wan import model as WM
from sparse_videogen_tpu_torch.pipelines.hyvideo import HyVideoPipeline
from sparse_videogen_tpu_torch.pipelines.wan import WanPipeline
from sparse_videogen_tpu_torch.utils import timer as T

# Wan: token grid (3, 5, 8), S = 120; HunyuanVideo: (3, 8, 16) video + 8 text tokens
WAN_KW = dict(dim=128, ffn_dim=256, num_heads=2, num_layers=2, freq_dim=32, text_dim=48, text_len=8)
HY_KW = dict(hidden_size=128, heads_num=2, mm_double_blocks_depth=2, mm_single_blocks_depth=2,
             rope_dim_list=(16, 24, 24), text_states_dim=32, text_states_dim_2=24, text_len=8, mlp_width_ratio=2.0)
MODEL_LABELS = ("model.norm", "model.qk", "model.residual")
SVG1_LABELS = ("svg1.profile", "svg1.place")


def _wan_step(pattern):
    cfg = WM.WanConfig(**WAN_KW)
    model = WM.WanModel(cfg, dtype=torch.float32).init_random(torch.Generator().manual_seed(0))
    ctx = torch.randn(1, cfg.text_len, cfg.text_dim, generator=torch.Generator().manual_seed(1))
    WanPipeline(model).generate_latents(ctx, torch.zeros_like(ctx), height=80, width=128, num_frames=9,
                                        num_inference_steps=1, pattern=pattern,
                                        svg=SVGConfig(sparsity=0.25, num_sampled_rows=32))


def _hy_step(pattern):
    cfg = HM.HyVideoConfig(**HY_KW)
    model = HM.HyVideoModel(cfg, dtype=torch.float32).init_random(torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    text = torch.randn(1, cfg.text_len, cfg.text_states_dim, generator=g)
    mask = (torch.arange(cfg.text_len) < 5).to(torch.int32)[None]
    pooled = torch.randn(1, cfg.text_states_dim_2, generator=g)
    HyVideoPipeline(model).generate_latents(text, mask, pooled, prompt_length=5, height=128, width=256, num_frames=9,
                                            num_inference_steps=1, pattern=pattern, first_layers_fp=0.0,
                                            first_times_fp=0.0,
                                            svg=SVGConfig(sparsity=0.6, num_sampled_rows=32, profile_multiplier=1.5))


STEPS = {"wan": _wan_step, "hyvideo": _hy_step}
CASES = [("wan", "SVG"), ("wan", "dense"), ("hyvideo", "SVG"), ("hyvideo", "dense")]


def expected_counts(family, pattern):
    """Each label's regions in one step (one forward) of the tiny models."""
    if family == "wan":
        L = WAN_KW["num_layers"]
        counts = {"model.norm": 3 * L + 1, "model.qk": 4 * L, "model.residual": 3 * L}
    else:
        D, S = HY_KW["mm_double_blocks_depth"], HY_KW["mm_single_blocks_depth"]
        L = D + S
        # model.qk: one region a double block (both streams' q and k into the joined buffers, v's join) and one a
        # single block
        counts = {"model.norm": 4 * D + S + 1, "model.qk": D + S, "model.residual": 4 * D + S}
    counts.update({"attn.pad": 2 * L, "video.plan": 1})
    if pattern == "SVG":
        counts.update({"svg1.profile": L, "svg1.place": 4 * L})
    return counts


@pytest.fixture(autouse=True)
def _clean(monkeypatch):
    monkeypatch.delenv("TIME_BENCH", raising=False)
    torch.set_num_threads(1)
    T.print_operator_log_data(clear=True)
    T.profiled_log(clear=True)
    yield
    T.print_operator_log_data(clear=True)
    T.profiled_log(clear=True)


@pytest.fixture(scope="module", params=CASES, ids=[f"{f}-{p}" for f, p in CASES])
def profiled_step(request):
    """(case, the profiled log, the names and user-annotation flags of the
    trace's svt. events) of one profiled step."""
    family, pattern = request.param
    T.profiled_log(clear=True)
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        STEPS[family](pattern)
    secs, counts = T.profiled_log(clear=True)
    events = [(e.name(), e.is_user_annotation()) for e in prof.profiler.kineto_results.events()
              if e.name().startswith("svt.")]
    return (family, pattern), (secs, counts), events


def test_regions_off_record_nothing_and_open_no_range(monkeypatch):
    opened = []
    monkeypatch.setattr(T, "_RecordFunctionFast", lambda name: opened.append(name))
    assert T.time_logging("a") is T.time_logging("b", host=True)  # the shared no-op
    _wan_step("SVG")
    assert opened == []
    assert T.get_log() == ({}, {}) and T.profiled_log() == ({}, {})


def test_profiled_step_records_every_region(profiled_step):
    (family, pattern), (secs, counts), _ = profiled_step
    assert counts == expected_counts(family, pattern)
    assert all(s >= 0 for s in secs.values()) and secs["model.norm"] > 0


def test_profiled_ranges_are_no_user_annotations(profiled_step):
    (family, pattern), (_, counts), events = profiled_step
    assert events and not any(user for _, user in events)
    seen = {}
    for name, _ in events:
        seen[name[len("svt."):]] = seen.get(name[len("svt."):], 0) + 1
    assert seen == counts


def test_profiler_trace_holds_the_ranges(tmp_path):
    with T.profiler_trace(str(tmp_path)) as logdir:
        _wan_step("SVG")
    trace = json.load(open(os.path.join(logdir, "trace.json")))
    names = {}
    for ev in trace["traceEvents"]:
        if str(ev.get("name", "")).startswith("svt."):
            names[ev["name"][len("svt."):]] = ev.get("cat")
    assert set(names) == set(expected_counts("wan", "SVG"))
    assert set(names.values()) == {"cpu_op"}  # not "user_annotation": off the device's timeline
    assert T.profiled_log()[1] == expected_counts("wan", "SVG")


def test_time_bench_prints_every_label_with_its_count(monkeypatch, capsys):
    monkeypatch.setenv("TIME_BENCH", "1")
    _wan_step("SVG")
    T.print_operator_log_data()
    out = capsys.readouterr().out
    for label, n in expected_counts("wan", "SVG").items():
        assert any(line.startswith(f"{label}:") and line.endswith(f"(x{n})") for line in out.splitlines()), label
    assert T.profiled_log() == ({}, {})  # no profiler ran: TIME_BENCH's figures stay in its own log


def test_cli_prints_the_log_at_exit(monkeypatch, capsys, tmp_path):
    monkeypatch.setenv("TIME_BENCH", "1")
    out = str(tmp_path / "x.npz")
    wan_t2v.main(["--smoke", "--pattern", "SVG", "--device", "cpu", "--num_inference_steps", "1", "--output_file",
                  out])
    printed = capsys.readouterr().out
    assert np.load(out)["latents"].shape[0] == 1
    for label in (*MODEL_LABELS, *SVG1_LABELS, "attn.pad", "video.plan"):
        assert f"{label}:" in printed, label


class FakeEvent:
    """A CUDA event on a clock of ticks; `passed` says whether the device has
    reached events recorded so far."""
    made, tick, passed = 0, 0, True

    def __init__(self, enable_timing=True):
        FakeEvent.made += 1
        self.t, self.done = None, True

    def record(self):
        FakeEvent.tick += 1
        self.t, self.done = FakeEvent.tick, FakeEvent.passed

    def query(self):
        return self.done

    def elapsed_time(self, end):
        return float(end.t - self.t)


def test_waiting_event_pairs_are_folded_and_reused(monkeypatch):
    monkeypatch.setenv("TIME_BENCH", "1")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "Event", FakeEvent)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    monkeypatch.setattr(T, "_SETTLE_AT", 4)
    monkeypatch.setattr(T, "_POOL", [])
    FakeEvent.made, FakeEvent.passed = 0, True
    for _ in range(10):
        with T.time_logging("a"):
            pass
    assert len(T._PENDING) <= 4 and FakeEvent.made < 20  # passed pairs were read and their events reused
    FakeEvent.passed = False  # the device lags: nothing more can be read without waiting
    for _ in range(6):
        with T.time_logging("b"):
            pass
    assert [p[0] for p in T._PENDING][-6:] == ["b"] * 6
    secs, counts = T.get_log()  # waits, then reads every pair
    assert counts == {"a": 10, "b": 6} and secs == {"a": pytest.approx(10e-3), "b": pytest.approx(6e-3)}
    assert T._PENDING == []
