"""Ring (context-parallel) attention of the torch port against the JAX
package's shard_map ring, and against the port's single-device paths.

The port's per-rank code runs under two communicators (parallel/comm.py):
n ranks as threads of this process (ThreadRanks), and torch.distributed's
gloo with one process a rank (torch.multiprocessing; the CLI under
torchrun). The JAX ring runs on conftest's virtual CPU devices, its Pallas
kernels in interpret mode. f32 throughout: outputs differ by the order of
f32 sums only (atol 1e-5 on outputs of size ~1).

k-means labels must be equal. The data has no near-ties: q and k are
mixtures of as many well-separated anchors (distance ~11) as there are
centroids, with noise of norm ~1.2, and the warm centroids sit near the
anchors, so every token's nearest centroid wins by a wide margin.
"""

import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.multiprocessing as mp
from jax.sharding import PartitionSpec as P

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.core import kmeans as JKM
from sparse_videogen_tpu.ops.mask_spec import MaskSpec as JMaskSpec
from sparse_videogen_tpu.parallel import make_mesh
from sparse_videogen_tpu.parallel.ring import ring_attention as jax_ring_attention
from sparse_videogen_tpu.parallel.ring import ring_meta as jax_ring_meta
from sparse_videogen_tpu.parallel.ring_sap import sap_ring_attention as jax_sap_ring
from sparse_videogen_tpu.sparse.svg2 import SAPState as JSAPState
from sparse_videogen_tpu_torch import config as TC
from sparse_videogen_tpu_torch.core import kmeans as TKM
from sparse_videogen_tpu_torch.core import masks as TM
from sparse_videogen_tpu_torch.ops import metadata as MD
from sparse_videogen_tpu_torch.ops.mask_spec import MaskSpec
from sparse_videogen_tpu_torch.parallel import ring as TR
from sparse_videogen_tpu_torch.parallel.comm import DistComm, ThreadRanks
from sparse_videogen_tpu_torch.parallel.ring_runtime import RingDenseRuntime
from sparse_videogen_tpu_torch.parallel.ring_sap import sap_ring_attention
from sparse_videogen_tpu_torch.sparse.runtimes import DenseRuntime
from sparse_videogen_tpu_torch.sparse.svg1 import make_svg1_plan
from sparse_videogen_tpu_torch.sparse.svg2 import SAPState, sap_sparse_attention

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ATOL = 1e-5
B, H, D = 1, 2, 64
LAY = TC.VideoLayout(num_frames=8, frame_size=128)  # S = 1024
S = LAY.seq_len
BQ, BKV = 128, 128
SPECS = {"dense": MaskSpec(), "band_sink": MaskSpec(kind="band_sink", band_width=257, sink_size=128)}


def _shard(x, r, n):
    Sl = x.shape[2] // n
    return x[:, :, r * Sl:(r + 1) * Sl]


def _ring_inputs(seed, spec_name, n):
    rng = np.random.default_rng(seed)
    q, k, v = (rng.standard_normal((B, H, S, D)).astype(np.float32) for _ in range(3))
    if spec_name == "dense":
        bm = np.ones((S // BQ, S // 128), bool)
    else:
        bm = TM.execution_mask_block(LAY, 1.0, block_q=BQ, block_kv=128)
    meta = TR.ring_meta(bm, MD.kv_counts_for_seq(S - 60, S)[0], n, block_kv=BKV)
    return q, k, v, meta


def _jax_ring(q, k, v, meta, spec, n):
    return np.asarray(jax_ring_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), make_mesh(n, sp=n),
                                         jnp.asarray(meta), axis="sp", mask_spec=JMaskSpec(**vars(spec)),
                                         block_q=BQ, block_kv=BKV, interpret=True))


@pytest.mark.parametrize("n,spec_name", [(2, "dense"), (4, "band_sink")])
def test_ring_attention_threads_match_jax(n, spec_name):
    """Thread communicator, n ranks: ring_meta equals JAX's; the ring output
    equals JAX's shard_map ring and the port's single-device K1 on the same
    global block mask (the kv tail past S - 60 is padding)."""
    q, k, v, meta = _ring_inputs(n, spec_name, n)
    spec = SPECS[spec_name]
    bm = np.ones((S // BQ, S // 128), bool) if spec_name == "dense" else \
        TM.execution_mask_block(LAY, 1.0, block_q=BQ, block_kv=128)
    np.testing.assert_array_equal(meta, jax_ring_meta(bm, MD.kv_counts_for_seq(S - 60, S)[0], n, block_kv=BKV))
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    outs = ThreadRanks(n).run(lambda c: TR.ring_attention(
        _shard(tq, c.rank, n), _shard(tk, c.rank, n), _shard(tv, c.rank, n), c, torch.from_numpy(meta),
        mask_spec=spec, block_q=BQ, block_kv=BKV))
    ours = torch.cat(outs, dim=2).numpy()
    np.testing.assert_allclose(ours, _jax_ring(q, k, v, meta, spec, n), atol=ATOL, rtol=0)
    from sparse_videogen_tpu_torch.ops.attention import block_sparse_attention_kv

    single = block_sparse_attention_kv(
        tq.reshape(B * H, S, D), tk.reshape(B * H, S, D), tv.reshape(B * H, S, D),
        torch.as_tensor(MD.chunk_meta_np(bm[None], MD.kv_counts_for_seq(S - 60, S), block_kv=BKV)),
        block_q=BQ, block_kv=BKV, mask_spec=spec).reshape(B, H, S, D)
    np.testing.assert_allclose(ours, single.numpy(), atol=ATOL, rtol=0)


def _gloo_rank(rank, n, port, path):
    import torch.distributed as dist

    torch.set_num_threads(1)  # two ranks beside the other test workers
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=n)
    try:
        q, k, v, meta = _ring_inputs(7, "band_sink", n)
        comm = DistComm()
        out = TR.ring_attention(*(_shard(torch.from_numpy(x), rank, n) for x in (q, k, v)), comm,
                                torch.from_numpy(meta), mask_spec=SPECS["band_sink"], block_q=BQ, block_kv=BKV)
        full = torch.cat(comm.all_gather(out), dim=2)
        assert torch.equal(comm.all_reduce_sum(torch.tensor([rank + 1])), torch.tensor([n * (n + 1) // 2]))
        if rank == 0:
            np.save(path, full.numpy())
    finally:
        dist.destroy_process_group()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def test_ring_attention_gloo_matches_jax(tmp_path):
    """torch.distributed (gloo), 2 processes: the same per-rank code as the
    thread communicator, against JAX's shard_map ring."""
    n, path = 2, str(tmp_path / "out.npy")
    mp.spawn(_gloo_rank, args=(n, _free_port(), path), nprocs=n, join=True)
    q, k, v, meta = _ring_inputs(7, "band_sink", n)
    np.testing.assert_allclose(np.load(path), _jax_ring(q, k, v, meta, SPECS["band_sink"], n), atol=ATOL, rtol=0)


def test_ring_dense_runtime_matches_single_device():
    """RingDenseRuntime pads S to n * block_q (S = 1000 -> 1024) and
    all-gathers the output: equal to DenseRuntime's."""
    lay = TC.VideoLayout(num_frames=8, frame_size=125)
    plan = make_svg1_plan(lay, block_q=128, block_kv=256)
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.standard_normal((2, H, lay.seq_len, D)).astype(np.float32)) for _ in range(3))
    ours = RingDenseRuntime(plan, ThreadRanks(4), device="cpu")(q, k, v, 900.0, 0)
    ref = DenseRuntime(plan, device="cpu")(q, k, v, 900.0, 0)
    np.testing.assert_allclose(ours.numpy(), ref.numpy(), atol=ATOL, rtol=0)


QC, KC = 6, 10
SAP_KW = dict(num_q_centroids=QC, num_k_centroids=KC, top_p_kmeans=0.8, min_kc_ratio=0.0, kmeans_iter_step=2,
              block_q=128, block_kv=128)


S_SAP = 512  # 8 frames of 64 tokens


def _sap_data(seed=0):
    """q (k) from QC (KC) anchors, warm centroids near the anchors."""
    S = S_SAP
    rng = np.random.default_rng(seed)
    qa, ka = (rng.standard_normal((n, D)).astype(np.float32) for n in (QC, KC))
    noise = lambda *s: 0.15 * rng.standard_normal(s).astype(np.float32)
    q = qa[rng.integers(0, QC, (B, H, S))] + noise(B, H, S, D)
    k = ka[rng.integers(0, KC, (B, H, S))] + noise(B, H, S, D)
    v = rng.standard_normal((B, H, S, D)).astype(np.float32)
    qc = np.broadcast_to(qa, (B * H, QC, D)) + noise(B * H, QC, D)
    kc = np.broadcast_to(ka, (B * H, KC, D)) + noise(B * H, KC, D)
    return q, k, v, qc.astype(np.float32), kc.astype(np.float32)


@pytest.mark.parametrize("n", [2, 4])
def test_sap_ring_matches_jax_and_single_device(n):
    """Thread communicator: the distributed k-means labels equal JAX's
    shard_map Lloyd and the port's single-device labels exactly, its global
    sizes too; the SAP ring output equals JAX's sap_ring_attention and the
    port's single-device SAP (atol 1e-5), the new centroids to 1e-5."""
    q, k, v, qc, kc = _sap_data(n)
    S = S_SAP
    tq, tk, tv = (torch.from_numpy(x) for x in (q, k, v))
    kf = tk.reshape(B * H, S, D)
    ranks = ThreadRanks(n)
    res = ranks.run(lambda c: TKM.batch_kmeans(_shard(tk, c.rank, n).reshape(B * H, -1, D), KC, 2,
                                               torch.from_numpy(kc), comm=c))
    labels = torch.cat([r[0] for r in res], dim=1)
    single = TKM.batch_kmeans(kf, KC, 2, torch.from_numpy(kc))
    mesh = make_mesh(n, sp=n)
    jfn = jax.shard_map(lambda x, c: JKM.batch_kmeans(x, KC, 2, c, axis_name="sp"), mesh=mesh,
                        in_specs=(P(None, "sp", None), P()), out_specs=(P(None, "sp"), P(), P()), check_vma=False)
    jl, jc, js = jfn(jnp.asarray(k.reshape(B * H, S, D)), jnp.asarray(kc))
    np.testing.assert_array_equal(labels.numpy(), np.asarray(jl))
    np.testing.assert_array_equal(labels.numpy(), single[0].numpy())
    np.testing.assert_array_equal(res[0][2].numpy(), np.asarray(js))
    np.testing.assert_allclose(res[0][1].numpy(), np.asarray(jc), atol=ATOL, rtol=0)

    lay, cfg = TC.VideoLayout(num_frames=8, frame_size=S // 8), TC.SAPConfig(**SAP_KW)
    state = SAPState(torch.from_numpy(qc), torch.from_numpy(kc), True, torch.zeros(B * H))
    res = ranks.run(lambda c: sap_ring_attention(_shard(tq, c.rank, n), _shard(tk, c.rank, n),
                                                 _shard(tv, c.rank, n), state, c, layout=lay, cfg=cfg))
    ours = torch.cat([r[0] for r in res], dim=2).numpy()
    jstate = JSAPState(jnp.asarray(qc), jnp.asarray(kc), jnp.ones((), bool), jnp.zeros((B * H,), jnp.float32))
    ref, ref_state = jax_sap_ring(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), jstate, jax.random.PRNGKey(0), mesh,
                                  axis="sp", layout=JC.VideoLayout(8, S // 8), cfg=JC.SAPConfig(**SAP_KW),
                                  interpret=True)
    np.testing.assert_allclose(ours, np.asarray(ref), atol=ATOL, rtol=0)
    np.testing.assert_allclose(res[0][1].k_centroids.numpy(), np.asarray(ref_state.k_centroids), atol=ATOL, rtol=0)
    one, one_state = sap_sparse_attention(tq, tk, tv, state, layout=lay, cfg=cfg)
    np.testing.assert_allclose(ours, one.numpy(), atol=ATOL, rtol=0)
    np.testing.assert_allclose(res[0][1].q_centroids.numpy(), one_state.q_centroids.numpy(), atol=ATOL, rtol=0)


def test_sap_ring_cold_start_draws_global_tokens():
    """A cold start takes the global token indices it is handed: every rank
    contributes the tokens it owns (init_centroids_sharded), the same set as
    init_centroids over the whole sequence."""
    q, k, _, _, _ = _sap_data(5)
    tk = torch.from_numpy(k).reshape(B * H, S_SAP, D)
    idx = torch.randint(0, S_SAP, (B * H, KC), generator=torch.Generator().manual_seed(0))
    Sl = S_SAP // 4
    res = ThreadRanks(4).run(lambda c: TKM.init_centroids_sharded(tk[:, c.rank * Sl:(c.rank + 1) * Sl], KC, c, idx))
    ref = TKM.init_centroids(tk, KC, idx=idx)
    for r in res:
        assert torch.equal(r, ref)
    assert torch.equal(TKM.label_counts(torch.tensor([[0, 2, 2, 1]]), 4), torch.tensor([[1, 1, 2, 0]],
                                                                                          dtype=torch.int32))


def _cli(tmp_path, name, pattern, ring):
    out = str(tmp_path / f"{name}.npz")
    args = ["-m", "sparse_videogen_tpu_torch.cli.wan_t2v", "--smoke", "--pattern", pattern, "--device", "cpu",
            "--output_file", out]
    # one thread a process, as torchrun gives each rank: the test workers share the host's cores
    env = {**os.environ, "PYTHONPATH": ROOT, "OMP_NUM_THREADS": "1"}
    if ring:
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1", "--nproc_per_node", "2",
               "--master_addr", "127.0.0.1", "--master_port", str(_free_port()), *args, "--ring_degree", "2"]
    else:
        cmd = [sys.executable, *args]
    subprocess.run(cmd, cwd=ROOT, env=env, check=True, timeout=300, capture_output=True)
    return np.load(out)["latents"]


def test_cli_ring_degree_2_gloo(tmp_path):
    """The CLI's --smoke run with --ring_degree 2 under torchrun (gloo, 2
    processes) against the same run on one device. Dense: equal, since the
    smoke's 144 tokens pad to 2 x 256 and the second shard holds padding
    only. SAP (shards of 72 tokens): rel L2 <= 5e-2: a bf16 model, the ring
    rounds each rotation's output to bf16 before the f32 merge, and the
    distributed Lloyd sums in another order, over 4 steps of 4 layers."""
    for pattern, tol in (("dense", 0.0), ("SAP", 5e-2)):
        ring, one = _cli(tmp_path, f"{pattern}_ring", pattern, True), _cli(tmp_path, pattern, pattern, False)
        assert ring.shape == one.shape and np.isfinite(ring).all()
        assert np.linalg.norm(ring - one) / np.linalg.norm(one) <= tol
