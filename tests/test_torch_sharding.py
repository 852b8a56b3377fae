"""FSDP weight sharding of the torch port (parallel/sharding.py, the dp axis
of parallel/{comm,mesh}.py, cli/_parallel.py) against the JAX package's
parallel/sharding.py.

- param_spec: for every leaf of the Wan (14B, 1.3B), HunyuanVideo,
  CogVideoX 1.5 I2V and Cosmos 7B trees at their published widths and
  depths (jax.eval_shape: shapes only), the leaves that shard and their
  axes equal JAX's `param_spec` on conftest's CPU devices (meshes of 2, 4
  and 8 devices, and dp 2 x sp 2), mapped to the torch tensors. The map
  from a torch tensor to its JAX leaf comes from io/from_jax's converters,
  run on a tiny tree of the same structure whose leaves carry their index:
  exact.
- The sharded model: a tiny Wan through WanPipeline.generate_latents on
  thread-rank grids dp 2 and dp 2 x sp 2 (bf16 and int8 W8A8) gives latents
  equal to the unsharded model's bit for bit (an all-gather is exact), and
  each rank keeps 1/parts of every sharded tensor.
- The CLI under torchrun (gloo, 2 processes) with --dp 2 and with
  --dit_fsdp writes the latents of the single-process run, bit for bit.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from sparse_videogen_tpu.models.cog import model as JCOG
from sparse_videogen_tpu.models.cosmos import model as JCOS
from sparse_videogen_tpu.models.hyvideo import model as JHY
from sparse_videogen_tpu.models.wan import model as JWAN
from sparse_videogen_tpu.parallel import make_mesh
from sparse_videogen_tpu.parallel.sharding import param_spec as jax_param_spec
from sparse_videogen_tpu_torch.io import from_jax as FJ
from sparse_videogen_tpu_torch.models.cog import model as TCOG
from sparse_videogen_tpu_torch.models.cosmos import model as TCOS
from sparse_videogen_tpu_torch.models.hyvideo import model as THY
from sparse_videogen_tpu_torch.models.wan import model as TWAN
from sparse_videogen_tpu_torch.parallel.comm import ThreadRanks
from sparse_videogen_tpu_torch.parallel.sharding import param_spec, plan_bytes, shard_params, shard_plan

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# family -> (JAX config, its init, the converter, the torch model class, tiny widths of the same structure)
FAMILIES = {
    "wan14b": (JWAN.WAN_14B, JWAN.init_wan_params, FJ.wan_params_from_numpy, TWAN.WanConfig, TWAN.WanModel,
               dict(dim=64, ffn_dim=96, num_heads=2, num_layers=2, freq_dim=32, text_dim=48)),
    "wan1.3b": (JWAN.WAN_1_3B, JWAN.init_wan_params, FJ.wan_params_from_numpy, TWAN.WanConfig, TWAN.WanModel,
                dict(dim=64, ffn_dim=96, num_heads=2, num_layers=2, freq_dim=32, text_dim=48)),
    "hyvideo": (JHY.HYVIDEO_T2, JHY.init_hyvideo_params, FJ.hyvideo_params_from_numpy, THY.HyVideoConfig,
                THY.HyVideoModel, dict(hidden_size=64, heads_num=2, mm_double_blocks_depth=2,
                                       mm_single_blocks_depth=2, rope_dim_list=(8, 12, 12), text_states_dim=48,
                                       text_states_dim_2=24)),
    "cog1.5-i2v": (JCOG.COG_1_5_5B_I2V, JCOG.init_cog_params, FJ.cog_params_from_numpy, TCOG.CogConfig,
                   TCOG.CogModel, dict(num_layers=2, hidden_size=64, heads_num=2, head_dim=32, text_dim=48,
                                       time_embed_dim=40)),
    "cosmos7b": (JCOS.COSMOS_7B, JCOS.init_cosmos_params, FJ.cosmos_params_from_numpy, TCOS.CosmosConfig,
                 TCOS.CosmosModel, dict(num_attention_heads=2, attention_head_dim=32, num_layers=2,
                                        text_embed_dim=48, adaln_lora_dim=16, max_size=(8, 16, 16))),
}
GRIDS = {"n2": (1, 1, 2), "n4": (1, 1, 4), "n8": (1, 1, 8), "dp2xsp2": (2, 1, 2)}


def _port_cfg(cls, jcfg):
    return cls(**{f.name: getattr(jcfg, f.name) for f in dataclasses.fields(cls)})


def _leaves(tree):
    """{JAX path string: leaf} of a pytree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {jax.tree_util.keystr(p): leaf for p, leaf in flat}


def _layer_free(name):
    """A torch name with its layer index replaced (every layer of a stack
    maps to the same JAX leaf)."""
    return ".".join("#" if part.isdigit() else part for part in name.split("."))


@pytest.fixture(scope="module")
def leaf_map():
    """family -> {layer-free torch name: JAX path} from the converter on a
    tiny tree whose every leaf holds its own index; also holds
    io/from_jax.jax_layout's shape and axes to what the converter did to
    each leaf (a second tree with distinct values per element)."""
    out = {}
    for fam, (jcfg, init, convert, tcls, tmodel, tiny) in FAMILIES.items():
        jtiny = dataclasses.replace(jcfg, **tiny)
        abstract = jax.eval_shape(lambda c=jtiny, f=init: f(jax.random.PRNGKey(0), c))
        flat = jax.tree_util.tree_flatten_with_path(abstract)[0]
        treedef = jax.tree_util.tree_structure(abstract)
        paths, shapes = [jax.tree_util.keystr(p) for p, _ in flat], [tuple(leaf.shape) for _, leaf in flat]
        vals = [np.arange(int(np.prod(s)), dtype=np.float32).reshape(s) for s in shapes]
        tcfg = _port_cfg(tcls, jtiny)

        def conv(leaves):
            sd = convert(jax.tree_util.tree_unflatten(treedef, leaves), tcfg)
            return sd.state_dict() if isinstance(sd, torch.nn.Module) else sd

        sd_ids = conv([np.full(s, k, np.float32) for k, s in enumerate(shapes)])
        sd_vals = conv(vals)
        layout = FJ.jax_layout(tmodel(tcfg, dtype=torch.float32, device="meta"))
        assert set(layout) == set(sd_ids), (fam, set(layout) ^ set(sd_ids))
        fam_map = {}
        for name, t in sd_ids.items():
            idx = set(t.flatten().tolist())
            assert len(idx) == 1, (fam, name)
            k = int(idx.pop())
            jshape, axes = layout[name]
            assert jshape == shapes[k], (fam, name, jshape, shapes[k])
            leaf, axes = vals[k], list(axes)
            while axes and axes[0] is None:  # one layer of a stacked leaf
                leaf, axes = leaf[next(int(p) for p in name.split(".") if p.isdigit())], axes[1:]
            moved = np.transpose(leaf, [axes.index(a) for a in range(len(axes))])
            np.testing.assert_array_equal(sd_vals[name].numpy(), moved, err_msg=f"{fam} {name}")
            assert fam_map.setdefault(_layer_free(name), paths[k]) == paths[k], (fam, name)
        out[fam] = fam_map
    return out


def _published_shapes(fam):
    """{JAX path: shape} of the family's tree at its published config.
    init_cosmos_params draws from 16 keys and runs out at 10 or more layers
    (StopIteration; Cosmos 7B has 28), so Cosmos is traced at 2 layers and
    its stacked leaves take the published depth."""
    jcfg, init = FAMILIES[fam][:2]
    if fam != "cosmos7b":
        shapes = _leaves(jax.eval_shape(lambda: init(jax.random.PRNGKey(0), jcfg)))
        return {p: tuple(x.shape) for p, x in shapes.items()}
    short = _leaves(jax.eval_shape(lambda: init(jax.random.PRNGKey(0), dataclasses.replace(jcfg, num_layers=2))))
    return {p: (jcfg.num_layers,) + tuple(x.shape[1:]) if p.startswith("['blocks']") else tuple(x.shape)
            for p, x in short.items()}


@pytest.mark.parametrize("grid", list(GRIDS), ids=list(GRIDS))
@pytest.mark.parametrize("fam", list(FAMILIES), ids=list(FAMILIES))
def test_param_spec_matches_jax(leaf_map, fam, grid):
    """Leaf by leaf, at the published widths and depth: the port decides on
    jax_layout's JAX shape and shards the same leaves on the same axes
    (and over the same mesh axes) as JAX's param_spec."""
    jcfg, _, _, tcls, tmodel, _ = FAMILIES[fam]
    dp, rp, sp = GRIDS[grid]
    mesh = make_mesh(dp * rp * sp, dp=dp, rp=rp, sp=sp)
    jax_shapes = _published_shapes(fam)
    layout = FJ.jax_layout(tmodel(_port_cfg(tcls, jcfg), dtype=torch.bfloat16, device="meta"))
    names = {0: "dp", 1: "rp", 2: "sp"}
    covered = set()
    for name, (jshape, axes) in layout.items():
        path = leaf_map[fam][_layer_free(name)]
        covered.add(path)
        assert jshape == jax_shapes[path], (name, jshape, jax_shapes[path])
        want = tuple(jax_param_spec(jshape, mesh))
        ours = param_spec(jshape, (dp, rp, sp))
        if ours is None:
            assert all(e is None for e in want), (name, jshape, want)
            continue
        axis, over = ours
        spec = [None] * len(jshape)
        spec[axis] = tuple(names[a] for a in over) if len(over) > 1 else names[over[0]]
        assert tuple(spec) == want, (name, jshape, spec, want)
        assert axes[axis] is not None, name
    assert covered == set(jax_shapes), set(jax_shapes) - covered
    plan = shard_plan(tmodel(_port_cfg(tcls, jcfg), dtype=torch.bfloat16, device="meta"), (dp, rp, sp))
    assert plan and all(parts in (2, 4, 8) for _, _, parts in plan.values())


SMOKE = dict(dim=256, ffn_dim=512, num_heads=4, num_layers=4, freq_dim=64, text_dim=64, text_len=16)  # the CLI smoke


def _wan(quant):
    from sparse_videogen_tpu_torch.utils.quant import quantize_linears_int8

    model = TWAN.WanModel(TWAN.WanConfig(**SMOKE), dtype=torch.bfloat16).init_random(torch.Generator().manual_seed(0))
    if quant:
        quantize_linears_int8(model.blocks)
    return model


@pytest.mark.parametrize("grid,quant", [((2, 1, 1), False), ((2, 1, 2), False), ((2, 1, 2), True)],
                         ids=["dp2", "dp2xsp2", "dp2xsp2_int8"])
def test_sharded_wan_equals_unsharded(grid, quant):
    """Latents of 2 SVG1 steps (CFG batch 2; Ulysses over sp) through the
    sharded model equal the unsharded model's on one device, bit for bit;
    rank g keeps 1/parts of each sharded tensor and every replicated one."""
    from sparse_videogen_tpu_torch.pipelines import WanPipeline

    torch.set_num_threads(2)
    rng = np.random.default_rng(0)
    ctx = torch.as_tensor(rng.standard_normal((1, 16, 64)), dtype=torch.bfloat16)
    kw = dict(height=96, width=128, num_frames=9, num_inference_steps=2, pattern="SVG", seed=0)
    ref = WanPipeline(_wan(quant)).generate_latents(ctx, torch.zeros_like(ctx), **kw)
    dp, rp, sp = grid
    mesh = ThreadRanks(rp, sp, dp=dp)
    whole = _wan(quant)
    sizes = {n: t.numel() * t.element_size() for n, t in list(whole.named_parameters()) + list(whole.named_buffers())}
    bytes_plan = plan_bytes(whole, grid)
    model = shard_params(whole, mesh)
    assert len(model.plan) >= 20 and (not quant or any(n.endswith("wi8") for n in model.plan))
    for g in mesh.local_ranks:
        assert {n: t.numel() * t.element_size() for n, t in model.shards[g].items()} == \
            {n: sizes[n] // parts for n, (_, _, parts) in model.plan.items()}
        assert model.resident_bytes(g) == bytes_plan["per_rank"]
    out = WanPipeline(model).generate_latents(ctx, torch.zeros_like(ctx), mesh=mesh, **kw)
    assert torch.equal(out, ref), (out.float() - ref.float()).abs().max()


def test_shard_over_one_grid_axis():
    """A leaf none of whose axes divides by all 4 ranks of dp 2 x sp 2 (JAX
    (1030, 1026): both axes even, neither a multiple of 4) splits over dp
    alone (JAX's fallback): each rank keeps half, the sp ranks alike, and
    the gathered forward equals the whole module's bit for bit."""

    class Block(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.lin = torch.nn.Linear(1030, 1026)

        def forward(self, x):
            return torch.nn.functional.pad(self.lin(x), (0, 4))

    class Net(torch.nn.Module):
        def __init__(self):
            super().__init__()
            self.blocks = torch.nn.ModuleList([Block(), Block()])
            self.out = torch.nn.Linear(1030, 1026)

        def forward(self, x):
            for blk in self.blocks:
                x = blk(x)
            return self.out(x)

    torch.manual_seed(0)
    net, x = Net(), torch.randn(3, 1030)
    want = net(x)
    assert param_spec((2, 1030, 1026), (2, 1, 2)) == (1, (0,))
    mesh = ThreadRanks(1, 2, dp=2)
    sharded = shard_params(net, mesh)
    assert {n: (axis, over, parts) for n, (axis, over, parts) in sharded.plan.items()} == {
        "blocks.0.lin.weight": (1, (0,), 2), "blocks.1.lin.weight": (1, (0,), 2), "out.weight": (1, (0,), 2)}
    assert [tuple(sharded.shards[g]["out.weight"].shape) for g in range(4)] == [(1026, 515)] * 4
    assert torch.equal(sharded.shards[0]["out.weight"], sharded.shards[1]["out.weight"])
    assert torch.equal(sharded(x), want)


class _Ranks(ThreadRanks):
    rank = 0  # the rank whose results run() hands back first, as a CLI reads it


# cli -> its steps flag and output flag
CLIS = {"wan_t2v": ("--num_inference_steps", "--output_file"), "wan_i2v": ("--num_inference_steps", "--output_file"),
        "hyvideo_t2v": ("--num_inference_steps", "--output_file"),
        "hyvideo_i2v": ("--num_inference_steps", "--output_file"), "cog_i2v": ("--num_step", "--output_path"),
        "cosmos_t2v": ("--num_inference_steps", "--output_file")}


@pytest.mark.parametrize("cli", list(CLIS))
def test_cli_fsdp_on_thread_ranks(cli, tmp_path, monkeypatch):
    """Every CLI's --smoke through cli/_parallel.shard_cli_model over 2 thread
    ranks on dp (the minimum size lowered to 1 << 10, so that nearly every
    tensor shards, HunyuanVideo's token refiner, whose blocks are read and
    not called, included) writes the unsharded run's latents, bit for bit."""
    import importlib

    from sparse_videogen_tpu_torch.parallel import sharding

    torch.set_num_threads(2)
    mod = importlib.import_module(f"sparse_videogen_tpu_torch.cli.{cli}")
    steps, out = CLIS[cli]
    argv = ["--smoke", "--device", "cpu", steps, "1", out]
    mod.main(argv + [str(tmp_path / "one.npz")])
    monkeypatch.setattr(sharding, "MIN_SIZE", 1 << 10)
    monkeypatch.setattr(mod, "make_cli_mesh", lambda args, device: (_Ranks(dp=2), device))
    monkeypatch.setattr(mod, "close_mesh", lambda mesh: 0)
    seen = []
    shard = mod.shard_cli_model
    monkeypatch.setattr(mod, "shard_cli_model", lambda mesh, model: seen.append(shard(mesh, model)) or seen[-1])
    mod.main(argv + [str(tmp_path / "two.npz")])
    assert isinstance(seen[0], sharding.ShardedModel) and len(seen[0].plan) >= 8
    if cli.startswith("hyvideo"):
        assert any(n.startswith("txt_in.blocks.") for n in seen[0].units[""])
    np.testing.assert_array_equal(np.load(tmp_path / "two.npz")["latents"], np.load(tmp_path / "one.npz")["latents"])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_cli_fsdp_under_torchrun(tmp_path):
    """wan_t2v --smoke under torchrun, gloo, 2 processes: --dp 2 and then
    --dit_fsdp (every rank on dp) write the single-process latents."""
    from sparse_videogen_tpu_torch.cli import wan_t2v

    common = ["--smoke", "--pattern", "SVG", "--device", "cpu", "--num_inference_steps", "2"]
    wan_t2v.main(common + ["--output_file", str(tmp_path / "one.npz")])
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=ROOT)
    for flag in (["--dp", "2"], ["--dit_fsdp"]):
        out = tmp_path / f"{flag[0][2:]}.npz"
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node", "2",
               "--master_addr", "127.0.0.1", "--master_port", str(_free_port()),
               "-m", "sparse_videogen_tpu_torch.cli.wan_t2v", *common, *flag, "--output_file", str(out)]
        res = subprocess.run(cmd, cwd=ROOT, env=env, capture_output=True, text=True, timeout=240)
        assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
        assert "FSDP-sharded over 2 ranks" in res.stderr, res.stderr[-2000:]
        np.testing.assert_array_equal(np.load(out)["latents"], np.load(tmp_path / "one.npz")["latents"])
