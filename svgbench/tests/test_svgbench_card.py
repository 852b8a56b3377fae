"""On the card (marked gpu; skipped without one, decided inside the fixture):
each cell at its real size, one short window, comes out correct, and the
traced run attributes its device operations to the benchmark's spans."""

import time

import pytest

from svgbench import run as R
from svgbench.spec import Benchmark


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    R.cache_dirs()
    return torch.device("cuda", 0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", sorted(Benchmark().workloads))
def test_cell_on_the_card(card, name):
    b = Benchmark()
    out = R.run_cell(b, b.cell(name), seed=2**31 + 101, seconds=3.0, trace=True, device=card,
                     t_start=time.perf_counter())
    assert out["correct"], out["checks"]
    assert out["device"]["busy_s"] > 0 and out["device"]["platform"] == "gpu"
    for m in ("step_mfu", "attn_roofline", "idle_share"):
        assert 0 < out["metrics"][m]["value"] <= 100, (m, out["metrics"])
