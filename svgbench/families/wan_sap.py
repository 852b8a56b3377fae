"""Wan 2.1 T2V with SAP (SVG2 cluster mode) through the port's
WanPipeline.generate_latents: the program's side of a run, the work of a
step, and the judged reference step.

A step is the CFG pair as two batch-1 forwards, each stream with its own
k-means carry, and the UniPC update. The weights and inputs are organic
(reference/sap.py): K projection := Q projection with the q norm times the
traffic's gain in every self-attention, and low-pass noise, so that SAP's
k-means finds real clusters and its map keeps a video-like share of the
pairs; every SAP computation stays the port's own. The untimed warm-up is a
one-step video on the timed video's noise and text: it pays the cold k-means
start, and its k-means states go into the timed video through
`generate_latents(sap_states=...)`, so every timed step is a warm SAP step.
At the judged step the runtime records each layer's decisions (labels, sizes
and map) for the reference (`SAPRuntime.record`).

The configuration's model and the weights' spec are families/wan.py's.
"""

from __future__ import annotations

import inspect
import math

import torch

from svgbench import flops_sap
from svgbench import inputs as I
from svgbench.families import common, wan as W
from svgbench.reference import sap as RS
from svgbench.reference.common import exact_matmul

model_cfg = W.model_cfg
layout = W.layout
latent_shape = W.latent_shape


def check_port() -> None:
    """Raise unless the port carries SAP's k-means states across videos
    (generate_latents' sap_states) and records SAP's decisions."""
    from sparse_videogen_tpu_torch.pipelines.wan import WanPipeline
    from sparse_videogen_tpu_torch.sparse import svg2

    if "sap_states" not in inspect.signature(WanPipeline.generate_latents).parameters:
        raise RuntimeError("the port's WanPipeline.generate_latents takes no sap_states: no warm start across videos")
    if "keep" not in inspect.signature(svg2.sap_sparse_attention).parameters:
        raise RuntimeError("the port's SAP runtime records no decisions")


def sap_config(traffic: dict):
    from sparse_videogen_tpu_torch.config import SAPConfig

    keys = ("num_q_centroids", "num_k_centroids", "top_p_kmeans", "min_kc_ratio", "kmeans_iter_init",
            "kmeans_iter_step", "block_q", "block_kv", "relabel", "block_mode")
    return SAPConfig(**{k: traffic[k] for k in keys})


def make_inputs(c: dict, traffic: dict, seed: int, device) -> dict:
    """families/wan.py's text states; low-pass noise; the judged rows of
    every layer and the map gap's rows, drawn over all tokens."""
    out = W.make_inputs(c, traffic, seed, device)
    out["noise"] = RS.smooth_noise(I.generator(seed, I.STREAM_NOISE, device), (1, *latent_shape(c)),
                                   traffic["smooth"])
    S, L = layout(c).seq, c["num_layers"]
    g = I.generator(seed, I.STREAM_ROWS, device)
    out["rows"] = torch.randint(0, S, (L, min(traffic["num_sampled_rows"], S)), generator=g, device=device)
    out["map_rows"] = torch.randint(0, S, (L, min(traffic["map_gap_rows"], S)), generator=g, device=device)
    return out


def f32_params(c: dict, traffic: dict, seed: int, device) -> dict:
    return RS.organic_params(I.f32_params(W.param_spec(c), seed, device), c["num_layers"], traffic["organic_gain"])


def counts(c: dict, traffic: dict, counters: dict | None = None, steps: int = 0) -> dict:
    """A step's work: families/wan.py's count of the linears and the
    cross-attention (CFG as two batch-1 forwards is the same work as one
    batch of two), with SAP's self-attention and k-means by
    svgbench/flops_sap.py from the program's counters over the window's
    `steps`; without them (an untraced run) the self-attention counts no
    pairs."""
    dense = W.counts(c, {"pattern": "dense"})
    return flops_sap.counts(dense, c, layout(c), counters or {}, steps, W.dense_layers(c))


class RecordingProbe(common.ModelProbe):
    """common.ModelProbe that, at the judged step, has the runtime record each
    layer's SAP decisions, a dict per forward (stream 0, then 1)."""

    def __call__(self, *args, attention, **kw):
        run = self._run
        rec = run.capturing
        if rec:
            attention.record = {}
        try:
            return super().__call__(*args, attention=attention, **kw)
        finally:
            if rec:
                run.records.append(attention.record)
                attention.record = None


class Run(common.RunBase):
    """One cell on the port."""

    def setup(self):
        check_port()
        from sparse_videogen_tpu_torch.models.wan.model import WanConfig, WanModel
        from sparse_videogen_tpu_torch.pipelines.wan import WanPipeline
        from sparse_videogen_tpu_torch.utils.organic import align_self_attn_qk

        c, t = self.c, self.cell.traffic
        keys = ("model_type", "patch_size", "text_len", "in_dim", "dim", "ffn_dim", "freq_dim", "text_dim",
                "out_dim", "num_heads", "num_layers", "eps")
        self.model = WanModel(WanConfig(**{k: (tuple(c[k]) if k == "patch_size" else c[k]) for k in keys}),
                              dtype=torch.bfloat16, device=self.device)
        I.load_into(self.model, W.param_spec(c), self.seed)
        align_self_attn_qk(self.model, gain=t["organic_gain"])
        self.pipe = WanPipeline(RecordingProbe(self.model, self))
        self.gen_kw = dict(height=c["height"], width=c["width"], num_frames=c["num_frames"],
                           guidance_scale=c["guidance_scale"], flow_shift=c["flow_shift"], sampler=c["sampler"],
                           pattern=t["pattern"], first_layers_fp=c["first_layers_fp"],
                           first_times_fp=common.FIRST_TIMES_FP, sap=sap_config(t),
                           num_inference_steps=c["num_inference_steps"], seed=self.seed)
        self.inputs = make_inputs(c, t, self.seed, self.device)
        self.sap_states = [{}, {}]  # the k-means carry of both streams, across videos
        self.records = []
        self.steps = 0

    def generate(self, latents, steps, callback):
        self.pipe.generate_latents(self.inputs["ctx"], self.inputs["ctx_null"], latents=latents, callback=callback,
                                   sap_states=self.sap_states,
                                   **(self.gen_kw | ({"num_inference_steps": steps} if steps else {})))

    def warm(self):
        """A one-step video on the timed video's noise: the cold k-means start
        and every shape, its states carried into the window."""
        self.rows_gen = I.generator(self.seed, I.STREAM_WARM, self.device)
        self.generate(self.inputs["noise"], 1, None)
        self.sync()

    def fresh_noise(self, gen):
        return RS.smooth_noise(gen, (1, *latent_shape(self.c)), self.cell.traffic["smooth"])

    def window(self, seconds: float) -> dict:
        from sparse_videogen_tpu_torch.utils import timer

        timer.counted_log(clear=True)
        win = super().window(seconds)
        self.steps = win["steps"]
        return win

    def counts(self) -> dict:
        from sparse_videogen_tpu_torch.utils import timer

        return counts(self.c, self.cell.traffic, timer.counted_log(), self.steps)

    def captured(self) -> dict:
        out = super().captured()
        out["decisions"] = [{li: {"qlab": d.qlab, "klab": d.klab, "qsz": d.qsz, "ksz": d.ksz, "dyn": d.dyn}
                             for li, d in rec.items()} for rec in self.records]
        return out

    def free_program(self):
        del self.sap_states
        super().free_program()


def _worst(values: list) -> float:
    """The largest reading; NaN if any is NaN or there is none."""
    return float("nan") if not values or any(math.isnan(v) for v in values) else max(values)


def judge(cell, seed: int, device, captured: dict) -> dict:
    """The f32 reference of the judged step under the program's recorded
    decisions, against what the program produced there: captured["latents"]
    (1, C, F, H, W) after the step, captured["rows"][l] (2, H, R, D) and
    captured["decisions"][b][l], stream b's decisions at layer l."""
    c, t = model_cfg(cell.config), cell.traffic
    dec = captured["decisions"]
    with exact_matmul(), torch.no_grad():
        inp = make_inputs(c, t, seed, device)
        P = f32_params(c, t, seed, device)
        judges = [RS.Judge(rows=inp["rows"], program_rows=[common.item(r, b) for r in captured["rows"]],
                           decisions=dec[b] if len(dec) > b else None, top_p=t["top_p_kmeans"],
                           min_kc_ratio=t["min_kc_ratio"], map_rows=inp["map_rows"]) for b in range(2)]
        ref = W._reference_step(c, t, P, inp, lambda b: judges[b], "f32")
        x = inp["noise"][0]
        d_ref, d_prog = ref - x, captured["latents"][0].float() - x
        worst = lambda name: _worst([g for j in judges for g in getattr(j, name)])
        dens = [g for j in judges for g in j.density]
        return {"update_rel_l2": float(torch.linalg.vector_norm(d_prog - d_ref) / torch.linalg.vector_norm(d_ref)),
                "attn_rows_rel": worst("rows_rel"), "sap_label_gap": worst("label_gap"),
                "sap_map_gap": worst("map_gap"), "sap_density": sum(dens) / len(dens) if dens else float("nan")}


def control_capture(cell, seed: int, device, prec: str = "fp8") -> dict:
    """The control in the program's place: the reference step computed in
    `prec` with SAP decisions of its own; returns what `judge` reads."""
    c, t = model_cfg(cell.config), cell.traffic
    with exact_matmul(), torch.no_grad():
        inp = make_inputs(c, t, seed, device)
        P = f32_params(c, t, seed, device)
        gen = I.generator(seed, I.STREAM_WARM, device)
        lows = [RS.Lowp(rows=inp["rows"], prec=prec, traffic=t, gen=gen) for _ in range(2)]
        lat = W._reference_step(c, t, P, inp, lambda b: lows[b], prec)
        rows = [torch.stack([lows[0].out_rows[li], lows[1].out_rows[li]]) for li in range(c["num_layers"])]
    return {"latents": lat[None], "rows": rows, "decisions": [lows[0].decisions, lows[1].decisions]}
