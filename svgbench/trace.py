"""The reduction of a torch.profiler trace of the window to what the metric
readers take (`TraceView`).

Each device operation is attributed to the benchmark's innermost span
(torch.profiler.record_function ranges named "svgbench.<layer>", opened by
the benchmark around its calls into the program) that was open on the host
when the operation was launched: the launch is the CUDA API call with the
operation's correlation id. Operations launched outside every span (the
sampler's update, the pipeline's own tensors) belong to "step".
"""

from __future__ import annotations

import bisect
import dataclasses
import re

SPAN_PREFIX = "svgbench."
_API = re.compile(r"^cu[A-Z]|^cuda[A-Z]")


@dataclasses.dataclass
class Op:
    name: str
    start: int  # ns, device
    end: int
    span: str  # innermost benchmark span at the launch, or "step"

    @property
    def seconds(self) -> float:
        return (self.end - self.start) / 1e9


@dataclasses.dataclass
class TraceView:
    """The traced window. Readers (svgbench/metrics/<name>.py) take this."""
    ops: list  # [Op] in device order
    steps: int  # completed denoising steps in the window
    step_s: float  # host seconds per step of the traced window (ends in a synchronize)
    counts: dict  # the step's work by the benchmark's count (svgbench/flops.py)
    kernel_map: dict  # role -> family -> name substrings (svgbench/kernels/*.json)
    peaks: dict  # the card's published peaks

    def matches(self, op: Op, role: str) -> bool:
        return any(s in op.name for fam in self.kernel_map.get(role, {}).values() for s in fam)

    def in_span(self, span: str):
        return [o for o in self.ops if o.span == span]

    @property
    def busy_s(self) -> float:
        """Seconds in which some operation ran on the device (the union)."""
        busy, cur_s, cur_e = 0, None, None
        for o in self.ops:
            if cur_e is None or o.start > cur_e:
                busy += 0 if cur_e is None else cur_e - cur_s
                cur_s, cur_e = o.start, o.end
            else:
                cur_e = max(cur_e, o.end)
        busy += 0 if cur_e is None else cur_e - cur_s
        return busy / 1e9

    @property
    def window_s(self) -> float:
        """First operation's start to last operation's end."""
        if not self.ops:
            return 0.0
        return (max(o.end for o in self.ops) - self.ops[0].start) / 1e9

    def idle_gaps(self, n: int = 10) -> list:
        """The n longest stretches with nothing on the device, named by the
        span and the operation that ended them."""
        gaps, cur_e = [], None
        for o in self.ops:
            if cur_e is not None and o.start > cur_e:
                gaps.append(((o.start - cur_e) / 1e9, f"{o.span} before {o.name[:80]}"))
            cur_e = o.end if cur_e is None else max(cur_e, o.end)
        gaps.sort(key=lambda g: -g[0])
        return [[name, s] for s, name in gaps[:n]]

    def top_ops(self, n: int = 10) -> list:
        tot: dict[str, float] = {}
        for o in self.ops:
            tot[o.name[:120]] = tot.get(o.name[:120], 0.0) + o.seconds
        return [[k, v] for k, v in sorted(tot.items(), key=lambda kv: -kv[1])[:n]]


def _device_type_cuda():
    import torch

    return torch.autograd.DeviceType.CUDA


def attribute(events) -> tuple[list, int, int]:
    """kineto events -> ([Op] sorted by device start, number not attributed,
    number whose launch reads later than its start: a wrong match)."""
    cuda = _device_type_cuda()
    spans, launches, dev = [], {}, []
    for e in events:
        name = e.name()
        if name.startswith(SPAN_PREFIX):
            # the profiler also draws each span on the device's timeline: those are no operations
            if e.device_type() != cuda:
                spans.append((e.start_ns(), e.end_ns(), name[len(SPAN_PREFIX):]))
        elif e.device_type() == cuda:
            dev.append(e)
        elif _API.match(name):
            launches[e.correlation_id()] = e.start_ns()
    # spans nest: each span's parent is the innermost span open at its start
    spans.sort(key=lambda s: (s[0], -s[1]))
    starts = [s[0] for s in spans]
    parent, stack = [], []
    for j, (s0, s1, _) in enumerate(spans):
        while stack and spans[stack[-1]][1] < s0:
            stack.pop()
        parent.append(stack[-1] if stack else -1)
        stack.append(j)
    ops, missing, late = [], 0, 0
    for e in dev:
        t = launches.get(e.correlation_id())
        span = "step"
        if t is None:
            missing += 1
            span = "unknown"
        else:
            late += t > e.start_ns()
            # the latest span started by t, or the nearest of its ancestors still open at t
            j = bisect.bisect_right(starts, t) - 1
            while j >= 0 and spans[j][1] < t:
                j = parent[j]
            if j >= 0:
                span = spans[j][2]
        ops.append(Op(e.name(), e.start_ns(), e.end_ns(), span))
    ops.sort(key=lambda o: o.start)
    return ops, missing, late
