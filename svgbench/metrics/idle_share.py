"""idle_share (%): the share of the traced window in which nothing ran on
the device: 1 - (union of the device operations' intervals) / (first
operation's start to last operation's end)."""


def read(t):
    if not t.ops:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
