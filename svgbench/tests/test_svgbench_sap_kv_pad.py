"""sap_kv_pad reads the program's sap.kv_rows / sap.kv_live counters, and
nothing where the program has none (a parent without them)."""

from svgbench.spec import Benchmark
from svgbench.trace import Op, TraceView


def read(counted):
    from sparse_videogen_tpu_torch.utils import timer

    b = Benchmark()
    m = next(m for m in b.per_layer if m.name == "sap_kv_pad")
    entry = next(e for e in b.data["per_layer"] if e["name"] == "sap_kv_pad")
    assert entry["workloads"] == ["wan14b-720p-sap"] and m.layer == "kernels (ops/, csrc/)"
    t = TraceView(ops=[Op("k", 0, 10, "runtime")], steps=2, step_s=1.0, counts={}, kernel_map=b.kernel_map(),
                  peaks={"bf16_flops": 1e12, "hbm_bytes_s": 1e11})
    orig = timer.counted_log
    try:
        if counted is None:
            del timer.counted_log
        else:
            timer.counted_log = lambda clear=False: counted
        return b.reader(m)(t)
    finally:
        timer.counted_log = orig


def test_sap_kv_pad_reads_the_counters():
    assert read({"sap.kv_rows": 1280.0, "sap.kv_live": 1000.0}) == 1.28
    assert read({"sap.q_rows": 300.0, "sap.q_real": 200.0}) is None
    assert read({}) is None
    assert read(None) is None
