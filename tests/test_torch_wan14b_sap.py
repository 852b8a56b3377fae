"""Wan 2.1 14B at the reference's 720p SAP config, torch port against the JAX package.

The config (scripts/wan/wan_t2v_720p_sap.sh: QC 300, KC 1000, top_p 0.9,
min_kc_ratio 0.10) at small widths and short layouts on the CPU: the
dynamic map and the run lists (2 KC + 1 entries a row), one SAP layer, and a
40-head narrow Wan forward whose weights go across by io/from_jax.py. The
k-means iterations are cut (4 cold, 2 warm) and block_q is 16 to keep the
CPU time short; the cold-start draws are JAX's, handed in. JAX's Pallas
kernels run in interpret mode, the port's plain versions on the CPU.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import torch

from sparse_videogen_tpu import config as JC
from sparse_videogen_tpu.core import dynamic_map as JDM
from sparse_videogen_tpu.models.wan import model as JWM
from sparse_videogen_tpu.ops import metadata as JMD
from sparse_videogen_tpu.pipelines import wan as JPW
from sparse_videogen_tpu.sparse import svg2 as J2
from sparse_videogen_tpu_torch import config as TC
from sparse_videogen_tpu_torch.core import dynamic_map as TDM
from sparse_videogen_tpu_torch.io.from_jax import wan_params_from_numpy
from sparse_videogen_tpu_torch.models.wan import model as TWM
from sparse_videogen_tpu_torch.ops import metadata as TMD
from sparse_videogen_tpu_torch.pipelines import wan as TPW
from sparse_videogen_tpu_torch.presets import PRESETS, T2V_720P_SAP
from sparse_videogen_tpu_torch.sparse import svg2 as T2

t = lambda a: torch.from_numpy(np.array(a))
SAP_720P = dataclasses.replace(T2V_720P_SAP.sap, kmeans_iter_init=4, block_q=16, block_kv=128)
JSAP_720P = JC.SAPConfig(**dataclasses.asdict(SAP_720P))  # the JAX package's own config, same values
QC, KC = SAP_720P.num_q_centroids, SAP_720P.num_k_centroids


def _jax_draws(key, H, S):
    """The cold-start token indices sap_cluster draws from `key`."""
    rq, rk = jax.random.split(key)
    return t(jax.random.randint(rq, (H, QC), 0, S)), t(jax.random.randint(rk, (H, KC), 0, S))


def test_wan_14b_config_matches_jax():
    shared = {f.name for f in dataclasses.fields(TWM.WanConfig)} & {f.name for f in dataclasses.fields(JWM.WanConfig)}
    assert {"dim", "ffn_dim", "num_heads", "num_layers", "patch_size", "text_dim"} <= shared
    for name in shared:
        assert getattr(TWM.WAN_14B, name) == getattr(JWM.WAN_14B, name), name
    assert TWM.WAN_14B.head_dim == 128
    assert T2V_720P_SAP.model == TWM.WAN_14B and PRESETS["14B-720p-sap"] is T2V_720P_SAP
    assert T2V_720P_SAP.sap == TC.SAPConfig(num_q_centroids=300, num_k_centroids=1000, top_p_kmeans=0.9,
                                            min_kc_ratio=0.10, kmeans_iter_init=50, kmeans_iter_step=2)


def test_dynamic_map_and_run_meta_at_720p_config():
    """identify_dynamic_map at QC 300 x KC 1000 (min_kc_ratio keeps >= 100
    clusters a row): equal to JAX's except in rows whose cumulative mass lies
    within 1e-6 of top_p (f32 cumsums in another order may cross it on the
    other side), density to 1e-6; then the popularity relabel and run_meta of
    the same map equal to JAX's, integer for integer, 2 KC + 1 entries a row."""
    rng = np.random.default_rng(0)
    B, H, D, S = 1, 3, 16, 3000
    qc = rng.standard_normal((B, H, QC, D)).astype(np.float32)
    kc = rng.standard_normal((B, H, KC, D)).astype(np.float32)
    klab = rng.integers(0, KC, (B * H, S)).astype(np.int32)
    klab[:, :KC] = np.arange(KC)
    klab[:, 0] = 1  # cluster 0 empty: it carries no mass and breaks runs
    ks = np.stack([np.bincount(row, minlength=KC) for row in klab]).astype(np.int32).reshape(B, H, KC)
    qs = rng.integers(1, 20, (B, H, QC)).astype(np.int32)
    tp, mk = SAP_720P.top_p_kmeans, SAP_720P.min_kc_ratio
    ref = np.asarray(JDM.identify_dynamic_map(*(jnp.asarray(a) for a in (qc, kc, qs, ks)), tp, mk))
    ours = TDM.identify_dynamic_map(t(qc), t(kc), t(qs), t(ks), tp, mk).numpy()
    probs = np.asarray(JDM.weighted_softmax(jnp.einsum("bhqd,bhkd->bhqk", qc, kc) * D ** -0.5, ks[..., None, :]))
    cum = np.cumsum(-np.sort(-probs, axis=-1), axis=-1)
    clear = ~np.any(np.abs(cum - tp) < 1e-6, axis=-1)
    assert clear.mean() > 0.9 and ref.sum(-1).min() >= int(mk * KC)
    np.testing.assert_array_equal(ours[clear], ref[clear])
    np.testing.assert_allclose(TDM.density_calculation(t(ref), t(qs), t(ks)).numpy(),
                               np.asarray(JDM.density_calculation(jnp.asarray(ref), qs, ks)), rtol=1e-6)
    kcent = rng.standard_normal((B * H, KC, D)).astype(np.float32)
    jdyn, jlab, jsz, _ = J2.popularity_relabel(jnp.asarray(ref.reshape(B * H, QC, KC)), jnp.asarray(klab),
                                               jnp.asarray(ks.reshape(B * H, KC)), jnp.asarray(kcent))
    tdyn, tlab, tsz, _ = T2.popularity_relabel(t(ref.reshape(B * H, QC, KC)), t(klab), t(ks.reshape(B * H, KC)),
                                               t(kcent))
    for o, r in ((tdyn, jdyn), (tlab, jlab), (tsz, jsz)):
        np.testing.assert_array_equal(o.numpy(), np.asarray(r))
    starts = np.concatenate([np.zeros((B * H, 1), np.int32), np.cumsum(np.asarray(jsz), axis=1)[:, :-1]], axis=1)
    jm = np.asarray(JMD.run_meta_jnp(jdyn, jnp.asarray(starts), jsz, block_kv=SAP_720P.block_kv, cap=KC))
    tm = TMD.run_meta(tdyn, t(starts), tsz, block_kv=SAP_720P.block_kv, cap=KC).numpy()
    assert tm.shape == (B * H, QC, 2 * KC + 1)
    np.testing.assert_array_equal(tm, jm)


def test_sap_layer_at_720p_config_matches_jax():
    """One SAP layer, cold from JAX's draws, on 2 x 1024 tokens (QC 300 q
    clusters of ~7 tokens, KC 1000 k clusters of ~2): bf16 centroids and
    densities equal, f32 outputs within atol 1e-5."""
    layout, jlayout = TC.VideoLayout(num_frames=2, frame_size=1024), JC.VideoLayout(num_frames=2, frame_size=1024)
    H, S, D = 1, layout.seq_len, 16
    rng = np.random.default_rng(1)
    q, k, v = (rng.standard_normal((1, H, S, D)).astype(np.float32) for _ in range(3))
    key = jax.random.PRNGKey(5)
    jo, js = J2.sap_sparse_attention(*(jnp.asarray(a) for a in (q, k, v)), J2.init_sap_state(H, D, JSAP_720P), key,
                                     layout=jlayout, cfg=JSAP_720P)
    to, ts = T2.sap_sparse_attention(t(q), t(k), t(v), T2.init_sap_state(H, D, SAP_720P), layout=layout,
                                     cfg=SAP_720P, init_idx=_jax_draws(key, H, S))
    np.testing.assert_array_equal(ts.q_centroids.float().numpy(), np.asarray(js.q_centroids, np.float32))
    np.testing.assert_array_equal(ts.k_centroids.float().numpy(), np.asarray(js.k_centroids, np.float32))
    np.testing.assert_allclose(ts.last_density.numpy(), np.asarray(js.last_density), rtol=1e-6)
    np.testing.assert_allclose(to.numpy(), np.asarray(jo), atol=1e-5, rtol=0)


class _Layer1Taps:
    """A JAX runtime seen through a wrapper that records each layer's
    (q, k, v) and, given `inject`, hands layer 1 those inputs instead."""

    def __init__(self, rt, inject=None):
        self.rt, self.inject, self.seen = rt, inject, {}

    def consts(self):
        return self.rt.consts()

    def init_state(self, *args):
        return self.rt.init_state(*args)

    def __call__(self, q, k, v, tt, rng, li, state, consts):
        jax.debug.callback(lambda *a: self.seen.setdefault(int(a[3]), tuple(np.asarray(x) for x in a[:3])), q, k, v, li)
        if self.inject is not None:
            q, k, v = (jnp.where(li == 1, jnp.asarray(a), b) for a, b in zip(self.inject, (q, k, v)))
        return self.rt(q, k, v, tt, rng, li, state, consts)


def _bf16_ulp(a):
    """The spacing of bf16 values at |a| (f32's spacing times 2^16)."""
    return np.spacing(np.abs(a).astype(np.float32)) * 2.0 ** 16


def test_wan_forward_40_heads_sap_matches_jax():
    """A narrow Wan with the 14B's 40 heads (dim 640, head_dim 16, 2 layers),
    f32, one batch-1 forward: layer 0 a dense warm-up layer, layer 1 SAP at
    QC 300 / KC 1000 cold from JAX's draws.

    What the two packages guarantee against each other, and so what is held:
    - Layer 0 is dense: layer 1's q, k, v agree to the f32 noise of two
      libraries' sums (rel L2 <= 1e-5; 1.1e-6 measured).
    - SAP is not continuous in its input. Its k-means labels and its kept
      cluster sets change where two candidates tie within that noise. With
      S = 120 tokens and KC = 1000 most k clusters hold one token, and
      min_kc_ratio keeps 100 of them a q cluster, so ties at the 100th rank
      occur: in head 20 the 100th and 101st centroid probabilities of token
      8's q cluster are both 0.00407667, 1.9e-9 apart; JAX keeps one cluster
      and the port the other. Token 8's output then differs by up to 7.0e-4
      (rel L2 1.38e-5 over the output), although the labels, the cluster
      sizes and so the densities are the same.
    - So the densities are held exactly equal, and each carried bf16
      centroid to one bf16 ulp of the larger value plus the largest
      difference of the k-means inputs (a centroid is the f32 mean of the
      same tokens on both sides, so it moves by at most that difference;
      rounding each side to bf16 adds at most half an ulp).
    - The output is held where the inputs of the discontinuous step are the
      same: JAX's forward with the port's layer-1 q, k, v handed to its
      layer 1 agrees with the port's forward to rel L2 1e-5 over every
      token (after layer 1's self-attention every operation is per token,
      and nothing but f32 noise is left). Against JAX's own forward, the
      tokens that JAX itself moves by more than 1e-4 when given the port's
      layer-1 inputs are the tokens at such ties: they are at most 2 of 120,
      and every other token agrees to rel L2 1e-5."""
    kw = dict(dim=640, ffn_dim=1280, num_heads=40, num_layers=2, freq_dim=32, text_dim=48, text_len=8)
    jcfg, tcfg = JWM.WanConfig(**kw), TWM.WanConfig(**kw)
    tree = JWM.init_wan_params(jax.random.PRNGKey(0), jcfg, dtype=jnp.float32)
    rng = np.random.default_rng(2)
    params = jax.tree.map(lambda a: (np.asarray(a) + 0.05 * rng.standard_normal(a.shape)).astype(np.float32), tree)
    model = TWM.WanModel(tcfg, dtype=torch.float32)
    model.load_state_dict(wan_params_from_numpy(params, tcfg))
    lay = JPW.wan_layout(jcfg, 80, 128, 9)  # latents (1, 16, 3, 10, 16): S = 120
    tlay = TPW.wan_layout(tcfg, 80, 128, 9)
    x = rng.standard_normal((1, 16, lay.num_frames, 10, 16)).astype(np.float32)
    ctx = rng.standard_normal((1, jcfg.text_len, jcfg.text_dim)).astype(np.float32)
    tt = np.asarray([700.0], np.float32)
    key = jax.random.PRNGKey(3)
    jrt = JPW.make_wan_runtime(lay, pattern="SAP", warmup=JC.WarmupSchedule(first_layers=1), sap=JSAP_720P)
    jtap = _Layer1Taps(jrt)
    jargs = (params, jcfg, jnp.asarray(x), jnp.asarray(tt), jnp.asarray(ctx))
    ref, jstates = JWM.wan_forward(*jargs, attention=jtap, rng=key)
    trt = TPW.make_wan_runtime(tlay, device="cpu", pattern="SAP", warmup=TC.WarmupSchedule(first_layers=1),
                               sap=SAP_720P)
    trt.kmeans_init = {li: _jax_draws(jax.random.fold_in(key, li), jcfg.num_heads, lay.seq_len) for li in range(2)}
    seen = {}

    def ttap(q, k, v, t_, li, **kwargs):
        seen.setdefault(li, tuple(a.numpy().copy() for a in (q, k, v)))
        return trt(q, k, v, t_, li, **kwargs)

    ours = TWM.wan_forward(model, t(x), t(tt), t(ctx), attention=ttap).numpy()
    ref = np.asarray(ref)
    assert trt.states[1].initialized and not trt.states[0].initialized
    rel = lambda a, b: np.linalg.norm(a - b) / np.linalg.norm(b)

    for a, b in zip(seen[1], jtap.seen[1]):
        assert rel(a, b) <= 1e-5
    np.testing.assert_array_equal(trt.states[1].last_density.numpy(), np.asarray(jstates.last_density[1]))
    dx = max(np.abs(a - b).max() for a, b in zip(seen[1][:2], jtap.seen[1][:2]))
    for name in ("q_centroids", "k_centroids"):
        a = getattr(trt.states[1], name).float().numpy()
        b = np.asarray(getattr(jstates, name)[1], np.float32)
        assert np.all(np.abs(a - b) <= _bf16_ulp(np.maximum(np.abs(a), np.abs(b))) + dx), name

    same_in, _ = JWM.wan_forward(*jargs, attention=_Layer1Taps(jrt, inject=seen[1]), rng=key)
    same_in = np.asarray(same_in)
    assert rel(ours, same_in) <= 1e-5
    # (B, C, F, H, W) -> one row per token's 1 x 2 x 2 patch
    tok = lambda a: a.reshape(16, lay.num_frames, 5, 2, 8, 2).transpose(1, 2, 4, 0, 3, 5).reshape(lay.seq_len, -1)
    at_tie = np.abs(tok(same_in) - tok(ref)).max(-1) > 1e-4
    assert at_tie.sum() <= 2
    assert rel(tok(ours)[~at_tie], tok(ref)[~at_tie]) <= 1e-5
