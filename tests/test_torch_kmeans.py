"""k-means of the torch port against the JAX package.

The port's plain fused pass (what a CPU tensor runs) is held against the JAX
Pallas kernel in interpret mode (at K > 128 its wide branch), and
batch_kmeans against the JAX batch_kmeans,
on the same numpy inputs. Labels and counts must be equal; sums and
centroids differ by f32 summation order only. The probe variants' plain
versions (K8) are held against the same JAX pass, and variant D against a
numpy transcription of scripts/probe_kmeans_variants.py's multi-hot.

The torch model of the card's sorted update (sorted_update_order) is held
against a stable argsort. The Hopper kernel against the plain version:
tests/test_torch_kernels.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sparse_videogen_tpu.core import kmeans as JKM
from sparse_videogen_tpu.ops.kmeans_pallas import kmeans_assign_update as jax_assign_update
from sparse_videogen_tpu_torch import _kernels
from sparse_videogen_tpu_torch.core import kmeans as TKM
from sparse_videogen_tpu_torch.ops.kmeans import VARIANTS, kmeans_assign_update, kmeans_variant_pass

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(seed, B, N, K, D):
    rng = np.random.default_rng(seed)
    return rng.standard_normal((B, N, D)).astype(np.float32), rng.standard_normal((B, K, D)).astype(np.float32)


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("B,N,K,D", [(2, 512, 7, 32), (1, 300, 130, 16), (1, 2048, 257, 16), (1, 2048, 300, 32),
                                     (2, 2048, 1000, 16)])
def test_assign_update_plain_matches_jax(B, N, K, D, dtype):
    """Labels and counts equal; f32 sums of the same tokens agree to 1e-5
    (rtol and atol: the sums are over at most N tokens of size ~1). K = 257,
    300 and 1000 take the JAX kernel's wide branch (k_pad >= 256)."""
    jd, td = DTYPES[dtype]
    x, c = _inputs(B + K, B, N, K, D)
    jl, js, jc = (np.asarray(a) for a in jax_assign_update(jnp.asarray(x, jd), jnp.asarray(c, jd), blk_n=256))
    _kernels.reset_counts()
    tl, ts, tc = kmeans_assign_update(torch.from_numpy(x).to(td), torch.from_numpy(c).to(td))
    assert _kernels.PLAIN_CALLS["kmeans_wide"] == 1 and _kernels.LAUNCHES["kmeans_wide"] == 0
    assert tl.dtype == torch.int32 and ts.dtype == torch.float32 and tc.dtype == torch.float32
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("mode", ["cold", "warm", "assign_only"])
def test_batch_kmeans_matches_jax(mode):
    """From the same initial centroids (cold: the tokens JAX's init_centroids
    draws, 8 iterations; warm: carried bf16 centroids, 2 iterations;
    assign_only: max_iters 0): labels and sizes equal, bf16 centroids equal
    (the f32 means agree to 1e-6 before the bf16 rounding)."""
    B, N, K, D = 2, 384, 9, 32
    x, c = _inputs(3, B, N, K, D)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    key = jax.random.PRNGKey(4)
    if mode == "cold":
        idx = np.array(jax.random.randint(key, (B, K), 0, N))
        j_init, t_init, iters = JKM.init_centroids(jx, K, key), TKM.init_centroids(tx, K, idx=torch.from_numpy(idx)), 8
        np.testing.assert_array_equal(t_init.float().numpy(), np.asarray(j_init, np.float32))
    else:
        j_init, t_init = jnp.asarray(c, jnp.bfloat16), torch.from_numpy(c).to(torch.bfloat16)
        iters = 2 if mode == "warm" else 0
    jl, jc, js = (np.asarray(a) for a in JKM.batch_kmeans(jx, K, iters, j_init))
    tl, tc, ts = TKM.batch_kmeans(tx, K, iters, t_init)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(ts.numpy(), js)
    assert tc.dtype == torch.bfloat16
    np.testing.assert_array_equal(tc.float().numpy(), np.asarray(jc, np.float32))


@pytest.mark.parametrize("mode", ["cold", "warm"])
def test_batch_kmeans_wide_k_matches_jax(mode):
    """K = 1000 (the reference 720p config's KC) over 2048 tokens, most
    clusters of a few tokens or empty: cold from JAX's draws (3 iterations),
    warm from carried bf16 centroids (2 iterations); labels and sizes equal,
    bf16 centroids equal."""
    B, N, K, D = 2, 2048, 1000, 16
    x, c = _inputs(8, B, N, K, D)
    jx, tx = jnp.asarray(x, jnp.bfloat16), torch.from_numpy(x).to(torch.bfloat16)
    if mode == "cold":
        key = jax.random.PRNGKey(9)
        idx = np.array(jax.random.randint(key, (B, K), 0, N))
        j_init, t_init, iters = JKM.init_centroids(jx, K, key), TKM.init_centroids(tx, K, idx=torch.from_numpy(idx)), 3
    else:
        j_init, t_init, iters = jnp.asarray(c, jnp.bfloat16), torch.from_numpy(c).to(torch.bfloat16), 2
    jl, jc, js = (np.asarray(a) for a in JKM.batch_kmeans(jx, K, iters, j_init))
    tl, tc, ts = TKM.batch_kmeans(tx, K, iters, t_init)
    np.testing.assert_array_equal(tl.numpy(), jl)
    np.testing.assert_array_equal(ts.numpy(), js)
    np.testing.assert_array_equal(tc.float().numpy(), np.asarray(jc, np.float32))


@pytest.fixture(scope="module")
def wide_case():
    """(x, centroids) at K = 300 with the JAX pass's (labels, sums, counts)."""
    x, c = _inputs(30, 2, 2048, 300, 32)
    return x, c, [np.asarray(a) for a in jax_assign_update(jnp.asarray(x), jnp.asarray(c))]


@pytest.mark.parametrize("variant", ["A", "B", "C", "E"])
def test_variant_plain_matches_jax_pass(wide_case, variant):
    """Probe variants A, B (two-min tiebreak) and C (counts as a product)
    give the JAX pass's labels and counts exactly and its sums to 1e-5; E its
    labels, with sums and counts 0."""
    x, c, (jl, js, jc) = wide_case
    _kernels.reset_counts()
    tl, ts, tc = kmeans_variant_pass(torch.from_numpy(x), torch.from_numpy(c), variant)
    assert _kernels.PLAIN_CALLS["kmeans_variants"] == 1 and not any(_kernels.LAUNCHES.values())
    np.testing.assert_array_equal(tl.numpy(), jl)
    if variant == "E":
        assert not ts.any() and not tc.any()
        return
    np.testing.assert_array_equal(tc.numpy(), jc)
    np.testing.assert_allclose(ts.numpy(), js, rtol=1e-5, atol=1e-5)


def _variant_d_oracle(x, c):
    """scripts/probe_kmeans_variants.py's variant D in numpy (one head at a
    time): dist = |c|^2 - 2 x.c in f32, onehot = dist <= its row minimum,
    labels 0, sums = onehot^T x, counts = onehot summed over the tokens."""
    labels, sums, counts = [], [], []
    for xb, cb in zip(x, c):
        dist = (cb * cb).sum(-1)[None, :] - np.float32(2.0) * (xb @ cb.T)
        onehot = (dist <= dist.min(axis=1, keepdims=True)).astype(np.float32)
        labels.append(np.zeros(len(xb), np.int32))
        sums.append(onehot.T @ xb)
        counts.append(onehot.sum(0))
    return np.stack(labels), np.stack(sums), np.stack(counts)


def test_variant_d_matches_numpy_oracle():
    """Variant D with exact ties: the last 3 centroids copy the first 3, so a
    token nearest one of them adds to both clusters. Labels 0, counts equal
    (each tied token twice), sums within 1e-5."""
    x, c = _inputs(31, 2, 1024, 300, 16)
    c[:, -3:] = c[:, :3]
    _kernels.reset_counts()
    tl, ts, tc = kmeans_variant_pass(torch.from_numpy(x), torch.from_numpy(c), "D")
    assert _kernels.PLAIN_CALLS["kmeans_variants"] == 1
    ol, os_, oc = _variant_d_oracle(x, c)
    np.testing.assert_array_equal(tl.numpy(), ol)
    np.testing.assert_array_equal(tc.numpy(), oc)
    assert tc.numpy().sum() > x.shape[0] * x.shape[1] and np.array_equal(oc[:, :3], oc[:, -3:])
    np.testing.assert_allclose(ts.numpy(), os_, rtol=1e-5, atol=1e-5)


def test_variant_pass_rejects_an_unknown_variant():
    x = torch.randn(1, 16, 8)
    assert set(VARIANTS) == {"A", "B", "C", "D", "E"}
    with pytest.raises(ValueError):
        kmeans_variant_pass(x, x[:, :3], "F")


def test_init_centroids_draws_from_the_generator():
    x = torch.randn(3, 50, 8)
    a = TKM.init_centroids(x, 4, torch.Generator().manual_seed(1))
    b = TKM.init_centroids(x, 4, torch.Generator().manual_seed(1))
    assert a.shape == (3, 4, 8) and torch.equal(a, b)
    # every centroid is one of its row's tokens
    assert all(any(torch.equal(a[i, j], x[i, n]) for n in range(50)) for i in range(3) for j in range(4))


@pytest.mark.parametrize("kw", [dict(metric="cosine", axis_name="sp"), dict(metric="dot", axis_name="sp"),
                                dict(axis_name="sp")], ids=["cosine", "dot", "axis_name"])
def test_unported_kmeans_options_raise(kw):
    """A JAX mesh axis name is refused with every metric (the port shards
    tokens through comm=); the cosine and dot metrics themselves run
    (tests/test_torch_kmeans_metrics.py)."""
    x = torch.randn(1, 16, 8)
    with pytest.raises(NotImplementedError):
        TKM.batch_kmeans(x, 2, 1, x[:, :2], **kw)


@pytest.mark.parametrize("B,N,K", [(2, 9000, 300), (3, 5000, 1000), (1, 4096, 50), (1, 100, 7)])
def test_sorted_update_order_is_a_stable_counting_sort(B, N, K):
    """The torch model of K5's sorted update (ops/kmeans.sorted_update_order,
    csrc/kmeans_lloyd.cu passes 1-3), exact integers: per-chunk histograms,
    their starts and the ranks in token order give the stable sort of the
    tokens by label (torch.argsort(stable=True)), across chunk edges (N >
    CH, N not a multiple of it); cluster k holds perm[offs[k] : offs[k] +
    counts[k]]; its segments hold at most SEG tokens, cover it exactly and
    number sum(ceil(counts / SEG)) <= ceil(N / SEG) + K (the kernel's
    partial-sum rows). Segment sums added in segment order equal the one-hot
    sums (f64, so that only the layout is tested: 1e-9)."""
    from sparse_videogen_tpu_torch.ops.kmeans import SEG, sorted_update_order

    g = torch.Generator().manual_seed(N + K)
    labels = torch.randint(0, K, (B, N), generator=g, dtype=torch.int32)
    labels[:, : N // 3] = labels[:, :1]  # one large cluster: several segments
    perm, offs, counts, seg_start = sorted_update_order(labels, K)
    assert torch.equal(perm, torch.argsort(labels.long(), dim=1, stable=True))
    assert torch.equal(counts, torch.stack([torch.bincount(r.long(), minlength=K) for r in labels]))
    assert torch.equal(offs, counts.cumsum(1) - counts)
    nseg = seg_start[:, 1:] - seg_start[:, :-1]
    assert torch.equal(nseg, (counts + SEG - 1) // SEG) and int(seg_start[:, -1].max()) <= -(-N // SEG) + K
    x = torch.randn(B, N, 8, generator=g, dtype=torch.float64)
    want = torch.zeros(B, K, 8, dtype=torch.float64).index_put_((torch.arange(B)[:, None].expand(B, N), labels.long()), x, accumulate=True)
    for b in range(B):
        for k in range(K):
            tok = perm[b, offs[b, k]:offs[b, k] + counts[b, k]]
            assert bool((labels[b, tok] == k).all())
            segs = [x[b, tok[j * SEG:(j + 1) * SEG]].sum(0) for j in range(int(nseg[b, k]))]
            got = torch.stack(segs).sum(0) if segs else torch.zeros(8, dtype=torch.float64)
            torch.testing.assert_close(got, want[b, k], atol=1e-9, rtol=0)
