"""Nothing the benchmark runs imports JAX, jaxlib, Flax or the JAX package
(top-level module names compared whole: the port's name begins with the JAX
package's), and the reference imports nothing of the port."""

import ast
import os
import subprocess
import sys

import pytest

from svgbench.spec import ROOT

BENCH = os.path.join(ROOT, "svgbench")
FORBIDDEN = {"jax", "jaxlib", "flax", "sparse_videogen_tpu"}


def sources(sub=""):
    for d, _, files in os.walk(os.path.join(BENCH, sub)):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported_tops(path):
    tree = ast.parse(open(path).read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and node.level == 0:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_top_level_names_compare_whole():
    from svgbench.run import forbidden_modules

    assert forbidden_modules(["sparse_videogen_tpu_torch", "sparse_videogen_tpu_torch.ops", "jaxtyping"]) == []
    assert forbidden_modules(["sparse_videogen_tpu.ops.attention", "jax._src", "flax"]) == [
        "flax", "jax", "sparse_videogen_tpu"]


@pytest.mark.parametrize("path", [p for p in sources() if "/tests/" not in p], ids=os.path.basename)
def test_no_jax_import_in_sources(path):
    assert not set(imported_tops(path)) & FORBIDDEN


@pytest.mark.parametrize("path", list(sources("reference")), ids=os.path.basename)
def test_reference_imports_nothing_of_the_port(path):
    assert "sparse_videogen_tpu_torch" not in set(imported_tops(path))


def test_a_run_loads_no_jax():
    """Import everything the harness runs, build a tiny cell's run on the CPU,
    and look at sys.modules in that process."""
    code = (
        "import sys, copy, torch; torch.set_num_threads(1)\n"
        "from svgbench import run, control, trace, flops, inputs\n"
        "from svgbench.spec import Benchmark, Cell\n"
        "import svgbench.families.wan as fam\n"
        "b = Benchmark()\n"
        "for m in b.per_layer: b.reader(m)\n"
        "c = b.cell('wan1.3b-480p-svg1'); cfg = copy.deepcopy(c.config)\n"
        "cfg['model'].update(dim=64, ffn_dim=64, num_heads=1, num_layers=1, text_len=4, text_dim=16, freq_dim=16)\n"
        "cfg['generation'].update(height=32, width=32, num_frames=5)\n"
        "cell = Cell(c.name, 1, cfg, c.traffic, c.cell)\n"
        "r = fam.Run(cell, 1, 'cpu', False); r.setup(); r.warm()\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode == 0, out.stderr[-2000:]
    tops = set(eval(out.stdout.strip().splitlines()[-1]))
    assert "sparse_videogen_tpu_torch" in tops
    assert not tops & FORBIDDEN


def test_reference_runs_without_the_port():
    code = ("import sys; import svgbench.reference.wan, svgbench.reference.svg1, svgbench.reference.attn_judge\n"
            "import svgbench.inputs, svgbench.flops\n"
            "print([m for m in sys.modules if m.split('.')[0].startswith('sparse_videogen')])\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"
