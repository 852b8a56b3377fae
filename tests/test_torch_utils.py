"""The torch port's utilities against the JAX package's: utils/timer.py
(TIME_BENCH 1 and 2, a host-clock region, the profiler trace), visualize.py
(the same string on the same metadata), misc.save_qkv, seed.py, logging.py,
and the copies vbench.py and extract_time.py on the JAX tests' inputs."""

import argparse
import json
import os
import random

import numpy as np
import pytest
import torch

from sparse_videogen_tpu.ops import metadata as JMD
from sparse_videogen_tpu.utils import extract_time as JET
from sparse_videogen_tpu.utils import vbench as JVB
from sparse_videogen_tpu.utils.visualize import visualize_meta as jax_visualize_meta
from sparse_videogen_tpu_torch.ops import metadata as TMD
from sparse_videogen_tpu_torch.utils import extract_time as TET
from sparse_videogen_tpu_torch.utils import timer as T
from sparse_videogen_tpu_torch.utils import vbench as TVB
from sparse_videogen_tpu_torch.utils.misc import print_args, print_memory_usage, save_qkv
from sparse_videogen_tpu_torch.utils.seed import seed_everything
from sparse_videogen_tpu_torch.utils.visualize import visualize_meta


@pytest.fixture(autouse=True)
def _clean_log():
    T.print_operator_log_data(clear=True)
    yield
    T.print_operator_log_data(clear=True)


def test_timer_accumulates_at_level_1(monkeypatch, capsys):
    monkeypatch.setenv("TIME_BENCH", "1")
    for _ in range(3):
        with T.time_logging("unit - sum"):
            sum(range(1000))
    with T.time_logging("unit - fn", host=True):
        assert sum(range(10)) == 45
    T.print_operator_log_data()
    out = capsys.readouterr().out
    assert "unit - sum" in out and "(x3)" in out and "unit - fn" in out and "(x1)" in out
    secs, counts = T.get_log()
    assert counts == {"unit - sum": 3, "unit - fn": 1} and all(s > 0 for s in secs.values())


def test_timer_prints_and_clears_at_level_2(monkeypatch, capsys):
    monkeypatch.setenv("TIME_BENCH", "2")
    with T.time_logging("unit - sleepless"):
        sum(range(1000))
    T.print_operator_log_data()
    assert "unit - sleepless" in capsys.readouterr().out
    assert not T.get_log()[0]
    monkeypatch.setenv("TIME_BENCH", "0")
    with T.time_logging("off"):
        pass
    assert not T.get_log()[1]


def test_profiler_trace(tmp_path, monkeypatch):
    monkeypatch.delenv("TIME_BENCH", raising=False)
    with T.profiler_trace(str(tmp_path)) as logdir:
        with T.time_logging("probe"):
            torch.ones(8, 8).sum()
    trace = json.load(open(os.path.join(logdir, "trace.json")))
    assert any(ev.get("name") == "svt.probe" for ev in trace["traceEvents"])
    assert T.profiled_log(clear=True)[1] == {"probe": 1} and not T.get_log()[1]


def test_visualize_meta_matches_jax():
    bm = np.zeros((1, 4, 8), bool)
    bm[0, range(4), range(4)] = True
    bm[0, 2, 5:] = True
    counts = np.full((1, 8), 128, np.int32)
    meta = TMD.chunk_meta_np(bm, counts, block_kv=128)
    np.testing.assert_array_equal(meta, JMD.chunk_meta_np(bm, counts, block_kv=128))
    ours = visualize_meta(meta, block_kv=128, seq_kv=1024)
    assert ours == jax_visualize_meta(meta, block_kv=128, seq_kv=1024)
    assert "density" in ours and "#" in ours
    assert visualize_meta(torch.from_numpy(meta), block_kv=128, seq_kv=1024, max_cells=2) == \
        jax_visualize_meta(meta, block_kv=128, seq_kv=1024, max_cells=2)


def test_save_qkv_and_prints(tmp_path, capsys):
    q = torch.ones(1, 2, 4, 8, dtype=torch.bfloat16)
    path = save_qkv(q, q * 2, q * 3, str(tmp_path), layer_idx=3, timestep=900, x=torch.zeros(2))
    data = np.load(path)
    assert os.path.basename(path) == "sparse_qkvx_layer3_ts900.npz"
    assert data["k"].dtype == np.float32 and data["k"].max() == 2.0 and int(data["layer_idx"]) == 3
    print_args(argparse.Namespace(seed=1))
    print_memory_usage("probe")
    out = capsys.readouterr().out
    assert "seed: 1" in out and "probe Memory" in out


def test_seed_everything():
    draw = lambda: (random.random(), np.random.rand(), torch.rand(1).item())  # noqa: E731
    assert seed_everything(5) == 5
    a = draw()
    seed_everything(5)
    assert draw() == a


def test_logger():
    from sparse_videogen_tpu_torch.utils.logging import logger

    assert logger.name == "sparse_videogen_tpu_torch" and logger.handlers


def test_vbench_and_extract_time(tmp_path):
    """The copies give the JAX functions' results on the JAX tests' inputs."""
    d1 = tmp_path / "a"
    d1.mkdir()
    (d1 / "x_eval_results.json").write_text(json.dumps(
        {"subject_consistency": [0.9, ["..."]], "motion_smoothness": [0.7, []]}))
    (tmp_path / "y_eval_results.json").write_text(json.dumps({"subject_consistency": [0.5, []]}))
    (tmp_path / "z_eval_results.json").write_text("{broken")
    m = TVB.mean_scores(str(tmp_path))
    assert m == JVB.mean_scores(str(tmp_path)) and TVB.collect(str(tmp_path)) == JVB.collect(str(tmp_path))
    assert abs(m["subject_consistency"] - 0.7) < 1e-9 and abs(m["motion_smoothness"] - 0.7) < 1e-9
    log = tmp_path / "run.log"
    log.write_text("100%|██████████| 50/50 [02:00<00:00]\n100%|██████████| 50/50 [04:00<00:00]\n"
                   "denoise done in 30.5s\njunk\n")
    assert TET.analyze_log(str(log), 50) == JET.analyze_log(str(log), 50) == (3, "02:10")
    assert TET.analyze_log(str(log), 4) == JET.analyze_log(str(log), 4)
