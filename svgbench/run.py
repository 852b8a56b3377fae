"""Run one cell of the benchmark once.

    python3 -m svgbench.run --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. Builds the cell's model on the card with
weights and inputs drawn from --seed, runs one untimed step, then times
whole denoising steps through the port's pipeline for --seconds; with
--trace 1 the window runs under torch.profiler and the per-layer metrics
are read from it instead of the end-to-end ones. After the window the f32
reference judges the first timed step. The last line of stdout is the
result (JSON); the last lines of stderr are the compared numbers and their
limits. Exits non-zero without printing a result when there is no card,
too few cards, or when JAX or the JAX package got loaded.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

from svgbench.spec import ROOT, Benchmark  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "sparse_videogen_tpu")
# published dense peaks of one H100 SXM (NVIDIA's data sheet): bf16 tensor cores, HBM3
PEAKS = {"bf16_flops": 989e12, "hbm_bytes_s": 3.35e12}


def forbidden_modules(names=None) -> list[str]:
    """Loaded modules (or `names`) whose top-level name is JAX's, Flax's or
    the JAX package's, compared whole."""
    return sorted({m.split(".")[0] for m in (sys.modules if names is None else names)} & set(FORBIDDEN))


def cache_dirs() -> None:
    """Fixed cache directories inside the checkout: Triton's; the port's
    kernel library builds into build/kernels/<hash>/ there by itself."""
    os.environ["TRITON_CACHE_DIR"] = os.path.join(ROOT, "build", "triton")


def card_line() -> str:
    import torch

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=False).stdout.strip().splitlines()
    return (f"card {smi[0] if smi else torch.cuda.get_device_name(0)}; {torch.cuda.device_count()} device(s); "
            f"torch {torch.__version__} cuda {torch.version.cuda}")


def built_files() -> set[str]:
    """Every file under the checkout's build/ (the kernel library, Triton's
    cache): a run whose set-up adds one has built or compiled."""
    out = set()
    for d, _, files in os.walk(os.path.join(ROOT, "build")):
        out.update(os.path.join(d, f) for f in files)
    return out


def family(name: str):
    return importlib.import_module(f"svgbench.families.{name}")


def run_cell(bench: Benchmark, cell, *, seed: int, seconds: float, trace: bool, device, t_start: float) -> dict:
    """One run of `cell` on `device` (the card; the CPU only in tests). Returns
    the result object (without the no-JAX check)."""
    import torch

    from sparse_videogen_tpu_torch import _kernels

    log = lambda s: print(f"[svgbench] {s}", file=sys.stderr, flush=True)
    files = built_files()
    t_entry = time.perf_counter()
    torch.empty(1, device=device).fill_(0)  # the device's context
    t_ctx = time.perf_counter()
    fam = family(cell.config["family"])
    run = fam.Run(cell, seed, device, trace)
    run.setup()
    run.sync()
    t_setup = time.perf_counter()
    run.warm()
    t_warm = time.perf_counter()
    built = built_files() != files
    plain_before = sum(_kernels.PLAIN_CALLS.values())
    prof = None
    if trace:
        act = [torch.profiler.ProfilerActivity.CPU]
        if run.device.type == "cuda":
            act.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=act)
        prof.__enter__()
    try:
        win = run.window(seconds)
    finally:
        if prof is not None:
            prof.__exit__(None, None, None)
    setup_s = win["t_first"] - t_start
    log(f"set-up {setup_s} s: imports {t_entry - t_start} s, device context {t_ctx - t_entry} s, model, weights "
        f"and inputs {t_setup - t_ctx} s, warm step {t_warm - t_setup} s, to the first step "
        f"{win['t_first'] - t_warm} s; built {built}")
    cuda = run.device.type == "cuda"
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    plain = sum(_kernels.PLAIN_CALLS.values()) - plain_before
    steps = win["steps"]
    ps = sorted(win["per_step_s"])
    log(f"window: {steps} steps in {win['seconds']} s; step s median {statistics.median(ps)} "
        f"p90 {ps[min(len(ps) - 1, int(0.9 * len(ps)))]} min {ps[0]} max {ps[-1]}; setup {setup_s} s; "
        f"peak {peak} B; plain calls {plain}; launches {dict(_kernels.LAUNCHES)}")
    counts = run.counts()
    view = None
    if trace:
        from svgbench import trace as T

        t0 = time.perf_counter()
        ops, missing, late = T.attribute(prof.profiler.kineto_results.events())
        prof = None
        view = T.TraceView(ops=ops, steps=steps, step_s=win["seconds"] / steps, counts=counts,
                           kernel_map=bench.kernel_map(), peaks=PEAKS)
        spans = {}
        for o in ops:
            spans[o.span] = spans.get(o.span, 0.0) + o.seconds
        log(f"trace: {len(ops)} device ops, {missing} not attributed, {late} launched after they started, "
            f"device s by span {spans}; reduced in {time.perf_counter() - t0} s")
    captured = run.captured()
    run.free_program()
    t0 = time.perf_counter()
    numbers = run.judge(captured)
    log(f"reference: {time.perf_counter() - t0} s; {numbers}")
    limits = cell.cell["limits"]
    checks = {k: {"value": numbers[k], "limit": lim} for k, lim in limits.items()}
    correct = all(c["value"] <= c["limit"] for c in checks.values()) and (plain == 0 or not cuda) and steps > 0
    if plain and cuda:
        log(f"FAILED: {plain} calls fell back to a plain PyTorch version on the card")
    metrics = {}
    for m in bench.metrics_for(trace):
        if trace:
            v = bench.reader(m)(view)
        else:
            v = {"step_s": win["seconds"] / steps, "peak_mem_gib": peak / 2**30, "setup_s": setup_s}.get(m.name)
        if v is not None:
            metrics[m.name] = {"value": v, "unit": m.unit}
    dev = {"platform": "gpu" if cuda else "cpu", "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu",
           "count": cell.chips, "memory_peak_bytes": peak}
    out = {"correct": bool(correct), "attempted": steps, "failed": 0 if correct else steps, "metrics": metrics,
           "device": dev}
    if view is not None:
        dev["busy_s"], dev["window_s"] = view.busy_s, view.window_s
        out["breakdown"] = {"device_ops": view.top_ops(), "idle_gaps": view.idle_gaps()}
    out["setup_built"] = built  # this run's set-up built or compiled: its setup_s stands apart
    out["numbers"] = {k: v for k, v in numbers.items() if k not in checks}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cache_dirs()
    bench = Benchmark(ROOT)
    cell = bench.cell(args.workload)
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"svgbench: needs {cell.chips} CUDA device(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}, device_count = {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    print(f"[svgbench] workload {cell.name} seed {args.seed} seconds {args.seconds} trace {args.trace}",
          file=sys.stderr, flush=True)
    out = run_cell(bench, cell, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
                   device=torch.device("cuda", 0), t_start=T_START)
    print(f"[svgbench] {card_line()}", file=sys.stderr, flush=True)  # after the run: nvidia-smi is no set-up
    bad = forbidden_modules()
    if bad:
        print(f"svgbench: the run loaded {bad}; the port and the benchmark run without JAX", file=sys.stderr)
        return 3
    for k, c in out["checks"].items():
        print(f"check {k} = {c['value']} (limit {c['limit']})", file=sys.stderr)
    print(f"check correct = {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
