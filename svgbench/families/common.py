"""What every model family's run shares: the benchmark's spans, the probes
around the model and its attention runtime, the untimed warm step and the
timed window."""

from __future__ import annotations

import contextlib
import gc
import sys
import time

import torch

from svgbench import inputs as I

# Every video a run makes starts sparse: first_times_fp 0 skips a sparse
# pattern's dense warm-up steps (the configuration's first_times_fp), so
# every timed step is a warm sparse step; a dense pattern has none to skip.
FIRST_TIMES_FP = 0.0


def svg_config(c: dict, traffic: dict):
    """The port's SVGConfig of a cell: the traffic's sparsity and sampled
    rows, the configuration's profiling band."""
    from sparse_videogen_tpu_torch.config import SVGConfig

    return SVGConfig(sparsity=traffic.get("sparsity", 0.25), num_sampled_rows=traffic.get("num_sampled_rows", 64),
                     sample_mse_max_row=traffic.get("sample_mse_max_row", 10000),
                     profile_multiplier=c["svg_profile_multiplier"])


def rows_bound(layout, traffic: dict) -> int:
    """Sampled rows are drawn from [0, this): the profiler's own range."""
    return min(traffic.get("sample_mse_max_row", 10000), layout.seq)


def sampled_rows(layout, traffic: dict, layers: int, seed: int, device) -> torch.Tensor:
    """(layers, R) rows of the compared forward, R = the profiler's count."""
    n = min(traffic.get("num_sampled_rows", 64), layout.seq)
    return torch.randint(0, rows_bound(layout, traffic), (layers, n),
                         generator=I.generator(seed, I.STREAM_ROWS, device), device=device)


def attn_args(c: dict, traffic: dict, layout, dense_layers: int) -> dict:
    """The judged pattern's arguments (svgbench/reference/attn_judge.py)."""
    from svgbench.reference import svg1

    width = svg1.band_frames(traffic.get("sparsity", 0.25), layout)
    return dict(pattern=traffic["pattern"], layout=layout, width=width, multiplier=c["svg_profile_multiplier"],
                dense_layers=dense_layers)


def item(rows: torch.Tensor, b: int) -> torch.Tensor:
    """Batch item b of the program's kept rows; NaN where the program
    produced no such item (it then compares as wrong, never as right)."""
    return rows[b] if rows.shape[0] > b else torch.full_like(rows[0], float("nan"))


class WindowClosed(Exception):
    """Raised from the step callback once the window's seconds have passed."""


class AttentionProbe:
    """The attention runtime as the model sees it: the runtime's call inside
    the "runtime" span; at the compared forward, its output on the sampled
    rows is kept (in the "capture" span)."""

    def __init__(self, runtime, run, rows):
        self._rt, self._run, self._rows = runtime, run, rows

    def __getattr__(self, name):
        return getattr(self._rt, name)

    def __call__(self, q, k, v, t, layer_idx, rows=None, generator=None):
        run = self._run
        with run.span("runtime"):
            o = self._rt(q, k, v, t, layer_idx, rows=rows, generator=generator)
        if run.capturing:
            with run.span("capture"):
                r = o[:, :, self._rows[layer_idx]].clone()
                prev = run.captured_rows.get(layer_idx)
                run.captured_rows[layer_idx] = r if prev is None else torch.cat([prev, r])
        return o


class ModelProbe:
    """The model as the pipeline sees it: each forward inside the "forward"
    span, with the benchmark's sampled rows as `profile_rows` and the
    runtime behind an AttentionProbe."""

    def __init__(self, model, run):
        self._model, self._run = model, run

    def __getattr__(self, name):
        return getattr(self.__dict__["_model"], name)

    def __call__(self, *args, attention, profile_rows=None, **kw):
        run = self._run
        run.on_forward()
        rows = run.next_rows()
        with run.span("forward"):
            return self._model(*args, attention=AttentionProbe(attention, run, rows), profile_rows=rows, **kw)


class RunBase:
    """A family's Run, defined in its module beside model_cfg, layout,
    latent_shape, counts and judge (`family`), gives setup(), which builds
    `model` and `pipe` and sets `inputs` ({"noise", "rows", ...}), and
    generate(latents, steps, callback)."""

    def __init__(self, cell, seed: int, device, trace: bool):
        self.family = sys.modules[type(self).__module__]
        self.cell, self.seed, self.device, self.trace = cell, seed, torch.device(device), trace
        self.c = self.family.model_cfg(cell.config)
        self.capturing = False
        self.in_window = False
        self.captured_rows: dict = {}
        self.captured_latents = None
        self.t_first = None
        self.rows_gen = None

    def span(self, name: str):
        return torch.profiler.record_function("svgbench." + name) if self.trace else contextlib.nullcontext()

    def sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def next_rows(self):
        """The sampled rows of a forward: the compared forward's are the
        inputs' (the reference gets the same), the others are drawn alike."""
        rows = self.inputs["rows"]
        if self.capturing:
            return rows
        hi = rows_bound(self.family.layout(self.c), self.cell.traffic)
        return torch.randint(0, hi, rows.shape, generator=self.rows_gen, device=self.device)

    def on_forward(self):
        if self.in_window and self.t_first is None:
            self.sync()
            self.t_first = time.perf_counter()
            self._events = [self._event()]

    def _event(self):
        if self.device.type != "cuda":
            return time.perf_counter()
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def warm(self):
        """One untimed step of a video of its own: it loads the kernels and
        warms every shape of the window's steps."""
        self.rows_gen = I.generator(self.seed, I.STREAM_WARM, self.device)
        self.generate(self.fresh_noise(self.rows_gen), 1, None)
        self.sync()

    def window(self, seconds: float) -> dict:
        """Whole steps of one video (a new one, from fresh noise, if the
        schedule ends) until `seconds` have passed since the first step
        started. The first step is the compared one."""
        self.in_window = True
        self.capturing = True
        steps = 0

        def on_step(i, lat):
            nonlocal steps
            if self.capturing:
                self.captured_latents = lat.clone()
                self.capturing = False
            steps += 1
            self._events.append(self._event())
            if time.perf_counter() - self.t_first >= seconds:
                raise WindowClosed

        noise = self.inputs["noise"]
        try:
            while True:
                self.generate(noise, None, on_step)
                noise = self.fresh_noise(self.rows_gen)
        except WindowClosed:
            pass
        self.sync()
        t_end = time.perf_counter()
        self.in_window = False
        ev = self._events
        if self.device.type == "cuda":
            per_step = [ev[i - 1].elapsed_time(ev[i]) / 1e3 for i in range(1, len(ev))]
        else:
            per_step = [ev[i] - ev[i - 1] for i in range(1, len(ev))]
        return {"steps": steps, "seconds": t_end - self.t_first, "t_first": self.t_first, "per_step_s": per_step}

    def captured(self) -> dict:
        L = len(self.captured_rows)
        return {"latents": self.captured_latents, "rows": [self.captured_rows[i] for i in range(L)]}

    def fresh_noise(self, gen):
        return torch.randn((1, *self.family.latent_shape(self.c)), generator=gen, device=self.device)

    def counts(self) -> dict:
        return self.family.counts(self.c, self.cell.traffic)

    def judge(self, captured) -> dict:
        return self.family.judge(self.cell, self.seed, self.device, captured)

    def free_program(self):
        """Drop the program's model, pipeline and inputs before the reference runs."""
        del self.pipe, self.model, self.inputs
        gc.collect()
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
