"""The torch port must run where JAX is not installed and keeps its own copy
of what it needs: importing every module of sparse_videogen_tpu_torch, and
chip_smoke.py, pulls in no jax and no module of the JAX package
(sparse_videogen_tpu or sparse_videogen_tpu.*). The card's host also lacks
tokenizers, transformers, safetensors, PIL and regex, so no import pulls
those in either (io/grapheme.py keeps its own Unicode tables; io/image.py
encodes and decodes the .mp4 writer's JPEGs). A static scan of every
source file of the port and of chip_smoke.py finds no import of PIL, JAX
or the JAX package anywhere, lazy imports inside functions included."""

import ast
import os
import pathlib
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import importlib, pkgutil, sys
import sparse_videogen_tpu_torch as pkg
names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + ".")]
for name in names:
    importlib.import_module(name)
import chip_smoke
absent = ("jax", "jaxlib", "sparse_videogen_tpu", "tokenizers", "transformers", "safetensors", "PIL", "regex")
leaked = sorted(m for m in sys.modules if m.split(".")[0] in absent)
print(len(names), leaked)
assert not leaked, leaked
assert len(names) >= 20, names
for mod in ("models.cog.model", "pipelines.cog", "schedulers.ddim_cog", "cli.cog_i2v", "scripts.profile_cog",
            "io.safetensors", "io.tokenizer", "io.encoders", "io.checkpoint", "io.native", "io.mp4",
            "models.common.t5", "models.wan.vae", "models.common.vae_tiling", "utils.dataloader", "io.grapheme",
            "utils.metric", "utils.perceptual", "utils.lpips_alex", "scripts.quality", "cli.wan_i2v", "io.image",
            "models.common.clip", "models.common.resize", "models.common.llama", "models.common.llava",
            "models.hyvideo.vae", "cli.hyvideo_i2v", "cli.hyvideo_t2v", "scripts.hyvideo_stages",
            "models.cog.vae", "models.cosmos.model", "models.cosmos.vae", "pipelines.cosmos",
            "schedulers.edm_euler", "cli.cosmos_t2v", "core.attention_ref", "schedulers.fm_dpm", "utils.quant",
            "parallel.ulysses", "parallel.mesh", "parallel.ring_runtime", "cli._parallel", "parallel.sharding",
            "utils.prompt_extend", "utils.timer", "utils.misc", "utils.visualize", "utils.seed", "utils.logging",
            "utils.vbench", "utils.extract_time"):
    assert pkg.__name__ + "." + mod in names, mod
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr


STATIC_ABSENT = ("PIL", "jax", "jaxlib", "sparse_videogen_tpu")


def _imports(tree):
    """Every module an `import`, a `from ... import` or a literal
    importlib.import_module / __import__ call names, with its line."""
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from ((a.name, node.lineno) for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module, node.lineno
        elif isinstance(node, ast.Call) and node.args and isinstance(node.args[0], ast.Constant) and \
                getattr(node.func, "attr", getattr(node.func, "id", None)) in ("import_module", "__import__"):
            yield str(node.args[0].value), node.lineno


def test_port_sources_import_no_pil_or_jax_even_lazily():
    files = sorted(pathlib.Path(ROOT, "sparse_videogen_tpu_torch").rglob("*.py"))
    files.append(pathlib.Path(ROOT, "chip_smoke.py"))
    assert len(files) > 100
    found = [f"{f.relative_to(ROOT)}:{line} {mod}" for f in files
             for mod, line in _imports(ast.parse(f.read_text(), str(f))) if mod.split(".")[0] in STATIC_ABSENT]
    assert not found, found
    probe = ast.parse("def f():\n    from PIL import Image\n    import jax.numpy\n"
                      "    importlib.import_module('sparse_videogen_tpu.io')\n")
    assert [m for m, _ in _imports(probe)] == ["PIL", "jax.numpy", "sparse_videogen_tpu.io"]
