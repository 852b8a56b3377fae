"""The torch port must run where JAX is not installed and keeps its own copy
of what it needs: importing every module of sparse_videogen_tpu_torch, and
chip_smoke.py, pulls in no jax and no module of the JAX package
(sparse_videogen_tpu or sparse_videogen_tpu.*). The card's host also lacks
tokenizers, transformers, safetensors, PIL and regex, so no import pulls
those in either (the .mp4 writer imports PIL only when it encodes a frame;
io/grapheme.py keeps its own Unicode tables)."""

import os
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
            "parallel.ulysses", "parallel.mesh", "parallel.ring_runtime", "cli._parallel"):
    assert pkg.__name__ + "." + mod in names, mod
"""


def test_port_imports_no_jax():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
