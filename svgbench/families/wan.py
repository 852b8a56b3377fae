"""Wan 2.1 T2V through the port's WanPipeline.generate_latents: the
program's side of a run (model, weights, inputs, the window), the work of a
step, and the judged reference step.

One step is the CFG pair in one batch-2 forward and the UniPC update. The
model is handed to the pipeline behind `common.ModelProbe`, which passes every
call through and (1) opens the benchmark's spans around the forward and
the runtime call, (2) hands the profiler of SVG1 the benchmark's sampled
rows, and (3) at the compared forward keeps the runtime's output on those
rows. Nothing else of the call changes.
"""

from __future__ import annotations

import math

import torch

from svgbench import inputs as I
from svgbench.families import common
from svgbench.reference import attn_judge, svg1 as RS, wan as RW
from svgbench.reference.common import exact_matmul


def model_cfg(config: dict) -> dict:
    """The model's keys and the generation settings of the configuration."""
    return config["model"] | config["generation"]


def param_spec(c: dict) -> list:
    """Every parameter of the port's WanModel (T2V) by its name, at the
    published init (JAX init_wan_params' distributions): linear weights
    N(0, 1/d_in), zero biases, modulation tables N(0, 1/dim), unit norms."""
    d, bf, f32 = c["dim"], "bf16", "f32"
    lp = I.linear_params
    spec = (lp("patch_embedding", c["in_dim"] * math.prod(c["patch_size"]), d, bf, "top")
            + lp("text_embedding.fc1", c["text_dim"], d, bf, "top") + lp("text_embedding.fc2", d, d, bf, "top")
            + lp("time_embedding.fc1", c["freq_dim"], d, f32, "top") + lp("time_embedding.fc2", d, d, f32, "top")
            + lp("time_projection", d, 6 * d, f32, "top")
            + [I.Param("head_modulation", (2, d), f32, std=d**-0.5, group="top")]
            + lp("head_out", d, math.prod(c["patch_size"]) * c["out_dim"], bf, "top"))
    for i in range(c["num_layers"]):
        g = f"blocks.{i}"
        spec.append(I.Param(f"{g}.modulation", (6, d), f32, std=d**-0.5, group=g))
        for a in ("self_attn", "cross_attn"):
            for n in "qkvo":
                spec += lp(f"{g}.{a}.{n}", d, d, bf, g)
            spec += [I.Param(f"{g}.{a}.norm_{n}", (d,), f32, value=1.0, group=g) for n in "qk"]
        spec += [I.Param(f"{g}.norm3.weight", (d,), f32, value=1.0, group=g),
                 I.Param(f"{g}.norm3.bias", (d,), f32, value=0.0, group=g)]
        spec += lp(f"{g}.ffn.fc1", d, c["ffn_dim"], bf, g) + lp(f"{g}.ffn.fc2", c["ffn_dim"], d, bf, g)
    return spec


def layout(c: dict) -> RS.Layout:
    f, h, w = RW.grid(c)
    return RS.Layout(nf=f, fs=h * w)


def latent_shape(c: dict) -> tuple:
    return (c["out_dim"], 1 + (c["num_frames"] - 1) // 4, c["height"] // 8, c["width"] // 8)


def counts(c: dict, traffic: dict) -> dict:
    """A step's work: FLOPs of the batch-2 forward and the self-attention's
    FLOPs and bytes (svgbench/flops.py)."""
    from svgbench import flops

    lay = layout(c)
    S, d, B, T = lay.seq, c["dim"], 2, c["text_len"]
    H, D, L = c["num_heads"], c["dim"] // c["num_heads"], c["num_layers"]
    per_token = c["in_dim"] * math.prod(c["patch_size"]) * d + L * (6 * d * d + 2 * d * c["ffn_dim"]) \
        + d * math.prod(c["patch_size"]) * c["out_dim"]
    per_text = c["text_dim"] * d + d * d + L * 2 * d * d
    per_item = c["freq_dim"] * d + d * d + 6 * d * d
    linear = 2 * B * (per_token * S + per_text * T + per_item)
    pairs = flops.attention_pairs(lay, traffic["pattern"], traffic.get("sparsity", 0.0), dense_layers(c), L)
    attn = 4 * D * H * B * pairs
    cross = 4 * D * H * B * L * S * T
    return {"flops": linear + attn + cross, "attn_flops": attn,
            "attn_bytes": 4 * flops.BF16 * B * H * S * D * L}


def dense_layers(c: dict) -> int:
    return math.floor(c["first_layers_fp"] * c["num_layers"])



class Run(common.RunBase):
    """One cell on the port."""

    def setup(self):
        from sparse_videogen_tpu_torch.models.wan.model import WanConfig, WanModel
        from sparse_videogen_tpu_torch.pipelines.wan import WanPipeline

        c = self.c
        keys = ("model_type", "patch_size", "text_len", "in_dim", "dim", "ffn_dim", "freq_dim", "text_dim",
                "out_dim", "num_heads", "num_layers", "eps")
        self.model = WanModel(WanConfig(**{k: (tuple(c[k]) if k == "patch_size" else c[k]) for k in keys}),
                              dtype=torch.bfloat16, device=self.device)
        I.load_into(self.model, param_spec(c), self.seed)
        self.pipe = WanPipeline(common.ModelProbe(self.model, self))
        t = self.cell.traffic
        self.gen_kw = dict(height=c["height"], width=c["width"], num_frames=c["num_frames"],
                           guidance_scale=c["guidance_scale"], flow_shift=c["flow_shift"], sampler=c["sampler"],
                           pattern=t["pattern"], first_layers_fp=c["first_layers_fp"],
                           first_times_fp=common.FIRST_TIMES_FP,
                           svg=common.svg_config(c, t),
                           num_inference_steps=c["num_inference_steps"], seed=self.seed)
        self.inputs = make_inputs(c, self.cell.traffic, self.seed, self.device)

    def generate(self, latents, steps, callback):
        self.pipe.generate_latents(self.inputs["ctx"], self.inputs["ctx_null"], latents=latents, callback=callback,
                                   **(self.gen_kw | ({"num_inference_steps": steps} if steps else {})))


def make_inputs(c: dict, traffic: dict, seed: int, device) -> dict:
    """The text states of the CFG pair (UMT5's (1, text_len, 4096), bf16),
    the timed video's noise and the compared forward's sampled rows."""
    g = I.generator(seed, I.STREAM_TEXT, device)
    ctx = torch.randn(1, c["text_len"], c["text_dim"], generator=g, device=device).to(torch.bfloat16)
    ctx_null = torch.randn(1, c["text_len"], c["text_dim"], generator=g, device=device).to(torch.bfloat16)
    noise = I.normal((1, *latent_shape(c)), seed, I.STREAM_NOISE, device)
    rows = common.sampled_rows(layout(c), traffic, c["num_layers"], seed, device)
    return {"ctx": ctx, "ctx_null": ctx_null, "noise": noise, "rows": rows}


def _reference_step(c, traffic, P, inp, attn_for_item, prec):
    """The step in the reference: both CFG items, the guidance combine and
    UniPC's first update; returns the new latents (C, F, H, W) f32."""
    x = inp["noise"][0]
    t0 = RW.timestep0(c["num_inference_steps"], c["flow_shift"])
    vs = [RW.forward(P, c, x, t0, inp[name][0].float(), attn_for_item(b), prec)
          for b, name in enumerate(("ctx", "ctx_null"))]
    v = vs[1] + c["guidance_scale"] * (vs[0] - vs[1])
    return RW.unipc_first_step(c["num_inference_steps"], c["flow_shift"], x, v)


def _attn_args(c, traffic):
    return common.attn_args(c, traffic, layout(c), dense_layers(c))


def judge(cell, seed: int, device, captured: dict) -> dict:
    """The f32 reference of the compared step against what the program
    produced there: captured["latents"] (1, C, F, H, W) after the step and
    captured["rows"][l] (2, H, R, D), layer l's attention on the rows."""
    c, traffic = model_cfg(cell.config), cell.traffic
    with exact_matmul(), torch.no_grad():
        inp = make_inputs(c, traffic, seed, device)
        P = I.f32_params(param_spec(c), seed, device)
        judges = [attn_judge.Judge(rows=inp["rows"], program_rows=[common.item(r, b) for r in captured["rows"]],
                                   **_attn_args(c, traffic)) for b in range(2)]
        ref = _reference_step(c, traffic, P, inp, lambda b: judges[b], "f32")
        x = inp["noise"][0]
        d_ref, d_prog = ref - x, captured["latents"][0].float() - x
        out = {"update_rel_l2": float(torch.linalg.vector_norm(d_prog - d_ref) / torch.linalg.vector_norm(d_ref)),
               "attn_rows_rel": max(r for j in judges for r in j.rows_rel)}
        if traffic["pattern"] == "SVG":
            out["svg1_class_gap"] = max(g for j in judges for g in j.class_gap)
            out["svg1_temporal_heads"] = sum(j.temporal_heads for j in judges)
    return out


def control_capture(cell, seed: int, device, prec: str = "fp8") -> dict:
    """The control in the program's place: the reference step computed in
    `prec`, with its own SVG1 classes; returns what `judge` reads."""
    c, traffic = model_cfg(cell.config), cell.traffic
    with exact_matmul(), torch.no_grad():
        inp = make_inputs(c, traffic, seed, device)
        P = I.f32_params(param_spec(c), seed, device)
        lows = [attn_judge.Lowp(rows=inp["rows"], prec=prec, **_attn_args(c, traffic)) for _ in range(2)]
        lat = _reference_step(c, traffic, P, inp, lambda b: lows[b], prec)
        rows = [torch.stack([lows[0].out_rows[li], lows[1].out_rows[li]]) for li in range(c["num_layers"])]
    return {"latents": lat[None], "rows": rows}
