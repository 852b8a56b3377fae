"""sap_q_pad (x): the q rows the run-list attention computes over the real
ones, from the program's counters recorded while the window's profiler ran
(utils/timer.py): "sap.q_rows", each query cluster's rows padded to
block_q, over "sap.q_real", heads x tokens. 1 is no padding."""


def read(t):
    if t.steps == 0 or not t.ops:
        return None
    from sparse_videogen_tpu_torch.utils import timer

    log = getattr(timer, "counted_log", None)
    c = {} if log is None else log()
    if not c.get("sap.q_real"):
        return None
    return c["sap.q_rows"] / c["sap.q_real"]
