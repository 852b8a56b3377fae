"""The harness finds every configuration, traffic mix, cell, metric reader and
kernel map by name, and refuses malformed names and units."""

import json
import os
import shutil

import pytest

from svgbench import spec
from svgbench.spec import Benchmark, SpecError
from svgbench.trace import TraceView


def test_every_cell_resolves():
    b = Benchmark()
    assert b.workloads
    for name, w in b.workloads.items():
        cell = b.cell(name)
        assert cell.config["family"]
        assert cell.traffic["pattern"] in ("dense", "SVG", "SAP")
        assert set(cell.cell["limits"]) and all(v > 0 for v in cell.cell["limits"].values())
        assert w["chips"] in (1, 4)
        assert os.path.exists(os.path.join(spec.ROOT, "svgbench", "families", cell.config["family"] + ".py"))


def test_every_config_file_is_named_and_used():
    b = Benchmark()
    used = {w["config"] for w in b.workloads.values()}
    assert used == set(b.configs)
    files = [c["file"] for c in b.configs.values()]
    assert len(set(files)) == len(files)
    for c in b.configs.values():
        assert c["file"].startswith("svgbench/configs/")
        data = json.load(open(os.path.join(spec.ROOT, c["file"])))
        assert data["source"] == c["source"]
        assert data["reduced"] == c["reduced"]


def test_every_metric_has_a_reader_that_reads_nothing_from_an_empty_trace():
    b = Benchmark()
    empty = TraceView(ops=[], steps=0, step_s=0.0, counts={}, kernel_map=b.kernel_map(), peaks={})
    for m in b.per_layer:
        assert m.moves in {e.name for e in b.end_to_end}
        assert b.reader(m)(empty) is None, m.name
    assert {"step_s", "setup_s", "peak_mem_gib"} <= {m.name for m in b.end_to_end}


def test_every_folder_file_is_read():
    b = Benchmark()
    km = b.kernel_map()
    assert set(km) == {"attention", "gemm"} and {"K1", "K3K4", "K7"} <= set(km["attention"])
    d = os.path.join(spec.ROOT, "svgbench")
    traffic = {w["traffic"] for w in b.workloads.values()}
    assert {f[:-5] for f in os.listdir(os.path.join(d, "traffic"))} >= traffic
    assert {f[:-5] for f in os.listdir(os.path.join(d, "workloads"))} == set(b.workloads)
    assert {f[:-3] for f in os.listdir(os.path.join(d, "metrics")) if f.endswith(".py")} == {
        m.name for m in b.per_layer}


@pytest.mark.parametrize("name", ["a b", "x/y", "", "-lead", "é", "a" * 65, "a,b"])
def test_bad_names_refused(name):
    with pytest.raises(SpecError):
        spec.check_name("workload", name)


@pytest.mark.parametrize("unit", ["tokens per second", "", "µs", "a" * 17])
def test_bad_units_refused(unit):
    with pytest.raises(SpecError):
        spec.check_unit("m", unit)


@pytest.mark.parametrize("field, value", [("name", "bad name"), ("unit", "per second"), ("better", "up"),
                                          ("source", "guess")])
def test_malformed_benchmark_refused(tmp_path, field, value):
    data = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    data["per_layer"][0][field] = value
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(data))
    shutil.copytree(os.path.join(spec.ROOT, "svgbench"), tmp_path / "svgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    with pytest.raises(SpecError):
        Benchmark(str(tmp_path))


def test_kernel_map_refuses_unknown_role(tmp_path):
    shutil.copytree(os.path.join(spec.ROOT, "svgbench"), tmp_path / "svgbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path / "BENCHMARK.json")
    (tmp_path / "svgbench" / "kernels" / "X.json").write_text(json.dumps({"family": "X", "role": "misc",
                                                                           "names": ["x"]}))
    with pytest.raises(SpecError):
        Benchmark(str(tmp_path)).kernel_map()


def test_benchmark_json_keeps_to_the_contract():
    data = json.load(open(os.path.join(spec.ROOT, "BENCHMARK.json")))
    assert set(data) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert data["paths"] == ["svgbench"] and 1 <= data["run_seconds"] <= 51
    assert all(w and len(w) <= 200 and "\t" not in w and "\n" not in w for w in data["command"])
    one_line = lambda s: isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s
    for c in data["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"} and one_line(c["why"]) and one_line(c["source"])
        assert len(c["reduced"]) <= 16 and all(spec.NAME.match(k) for k in c["reduced"])
    for w in data["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and one_line(w["why"]) and w["chips"] == 1
        assert spec.NAME.match(w["traffic"])
    assert len({(w["config"], w["traffic"]) for w in data["workloads"]}) == len(data["workloads"])
    for m in data["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in data["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"} and one_line(m["layer"])
    assert len(json.dumps(data)) < 64 * 1024
