"""The benchmark's data, found by name: BENCHMARK.json at the root of the
checkout, and under svgbench/ one file per configuration (configs/), traffic
mix (traffic/), cell (workloads/), per-layer metric (metrics/<name>.py) and
attention-kernel family (kernels/). A later cell, configuration or metric is
a new file and a new entry in BENCHMARK.json; no file here changes.
"""

from __future__ import annotations

import dataclasses
import importlib.util
import json
import os
import re

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = ("device_trace", "program_span", "program_counter", "host_clock")


class SpecError(ValueError):
    pass


def check_name(what: str, name) -> str:
    if not isinstance(name, str) or not NAME.match(name):
        raise SpecError(f"{what} {name!r}: a name is 1-64 of A-Z a-z 0-9 _ . - and starts with a letter, digit or _")
    return name


def check_unit(what: str, unit) -> str:
    if not isinstance(unit, str) or not UNIT.match(unit):
        raise SpecError(f"{what} unit {unit!r}: 1-16 of A-Z a-z 0-9 _ / % . -")
    return unit


def _load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


@dataclasses.dataclass(frozen=True)
class Metric:
    name: str
    unit: str
    better: str
    source: str
    kind: str  # "end_to_end" | "per_layer"
    layer: str | None = None
    moves: str | None = None
    bound: float | None = None


@dataclasses.dataclass(frozen=True)
class Cell:
    """One entry of `workloads` with its configuration, traffic and cell files."""
    name: str
    chips: int
    config: dict  # configs/<config>.json
    traffic: dict  # traffic/<traffic>.json
    cell: dict  # workloads/<name>.json: the limits of the comparison


def _metric(entry: dict, kind: str) -> Metric:
    name = check_name("metric", entry.get("name"))
    check_unit(name, entry.get("unit"))
    if entry.get("better") not in ("lower", "higher"):
        raise SpecError(f"metric {name}: better is lower or higher")
    if entry.get("source") not in SOURCES:
        raise SpecError(f"metric {name}: source is one of {SOURCES}")
    return Metric(name=name, unit=entry["unit"], better=entry["better"], source=entry["source"], kind=kind,
                  layer=entry.get("layer"), moves=entry.get("moves"), bound=entry.get("bound"))


class Benchmark:
    """BENCHMARK.json and the files it names, read from `root`."""

    def __init__(self, root: str = ROOT):
        self.root = root
        path = os.path.join(root, "BENCHMARK.json")
        if not os.path.exists(path):
            raise SpecError(f"no BENCHMARK.json at {root}")
        self.data = _load_json(path)
        self.end_to_end = [_metric(m, "end_to_end") for m in self.data["end_to_end"]]
        self.per_layer = [_metric(m, "per_layer") for m in self.data["per_layer"]]
        self.configs = {check_name("config", c["name"]): c for c in self.data["configs"]}
        self.workloads = {check_name("workload", w["name"]): w for w in self.data["workloads"]}
        names = [m.name for m in self.end_to_end + self.per_layer]
        if len(set(names)) != len(names):
            raise SpecError("two metrics share a name")

    def bench_file(self, *parts: str) -> str:
        """A file of the benchmark's own folder."""
        return os.path.join(self.root, "svgbench", *parts)

    def cell(self, name: str) -> Cell:
        if name not in self.workloads:
            raise SpecError(f"no workload {name!r} in BENCHMARK.json (have {sorted(self.workloads)})")
        w = self.workloads[name]
        cfg_entry = self.configs[check_name("config", w["config"])]
        config = _load_json(os.path.join(self.root, cfg_entry["file"]))
        traffic = _load_json(self.bench_file("traffic", check_name("traffic", w["traffic"]) + ".json"))
        cell = _load_json(self.bench_file("workloads", name + ".json"))
        return Cell(name=name, chips=int(w["chips"]), config=config, traffic=traffic, cell=cell)

    def metrics_for(self, trace: bool) -> list[Metric]:
        """The per-layer metrics of a traced run, else the end-to-end ones; a
        cell reports those that have something to read in it."""
        return self.per_layer if trace else self.end_to_end

    def reader(self, metric: Metric):
        """metrics/<name>.py's `read(t)`: a number or None (nothing to read)."""
        path = self.bench_file("metrics", metric.name + ".py")
        spec = importlib.util.spec_from_file_location(f"svgbench_metric_{metric.name.replace('.', '_')}", path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        return mod.read

    def kernel_map(self) -> dict[str, dict[str, tuple[str, ...]]]:
        """kernels/<family>.json: role ("attention" or "gemm") -> family ->
        substrings of its kernels' names."""
        out: dict = {}
        d = self.bench_file("kernels")
        for fn in sorted(os.listdir(d)):
            if fn.endswith(".json"):
                k = _load_json(os.path.join(d, fn))
                if k.get("role") not in ("attention", "gemm"):
                    raise SpecError(f"kernels/{fn}: role is attention or gemm")
                out.setdefault(k["role"], {})[check_name("kernel family", k["family"])] = tuple(k["names"])
        return out
