"""sap_kv_pad (x): the K rows the run-list attention (K3) stages over the live
keys of its run lists, from the program's counters recorded while the
window's profiler ran (utils/timer.py): "sap.kv_rows", K3's packed 128-row
stages x 128 over the q blocks it walks, over "sap.kv_live", the tokens of
those blocks' runs. 1 is no staged key masked; a program without the
counters reads nothing."""


def read(t):
    if t.steps == 0 or not t.ops:
        return None
    from sparse_videogen_tpu_torch.utils import timer

    log = getattr(timer, "counted_log", None)
    c = {} if log is None else log()
    if not c.get("sap.kv_live"):
        return None
    return c["sap.kv_rows"] / c["sap.kv_live"]
