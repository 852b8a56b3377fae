"""HunyuanVideo T2V through the port's HyVideoPipeline.generate_latents: the
program's side of a run, the work of a step, and the judged reference step.
One step is one forward with embedded guidance and the Euler update."""

from __future__ import annotations

import math

import torch

from svgbench import inputs as I
from svgbench.families import common
from svgbench.reference import attn_judge, hyvideo as RH, svg1 as RS
from svgbench.reference.common import exact_matmul


def model_cfg(config: dict) -> dict:
    return config["model"] | config["generation"]


def param_spec(c: dict) -> list:
    """Every parameter of the port's HyVideoModel by its name, at the
    published init (JAX init_hyvideo_params' distributions): linear weights
    N(0, 1/d_in) in bf16, zero biases; LayerNorm and qk-norm weights 1,
    biases 0, in f32."""
    h, mh, hd = c["hidden_size"], int(c["hidden_size"] * c["mlp_width_ratio"]), c["hidden_size"] // c["heads_num"]
    bf, f32 = "bf16", "f32"
    lp = I.linear_params

    def mlp2(n, a, b_, o, g):
        return lp(f"{n}.fc1", a, b_, bf, g) + lp(f"{n}.fc2", b_, o, bf, g)

    def norm(n, d, g, bias=False):
        out = [I.Param(f"{n}.weight" if bias else n, (d,), f32, value=1.0, group=g)]
        return out + ([I.Param(f"{n}.bias", (d,), f32, value=0.0, group=g)] if bias else [])

    top = "top"
    spec = (lp("img_in", c["in_channels"] * math.prod(c["patch_size"]), h, bf, top)
            + mlp2("time_in", 256, h, h, top) + mlp2("vector_in", c["text_states_dim_2"], h, h, top)
            + mlp2("guidance_in", 256, h, h, top)
            + lp("txt_in.input_embedder", c["text_states_dim"], h, bf, top)
            + mlp2("txt_in.t_embedder", 256, h, h, top) + mlp2("txt_in.c_embedder", c["text_states_dim"], h, h, top)
            + lp("final_adaln", h, 2 * h, bf, top)
            + lp("final_linear", h, math.prod(c["patch_size"]) * c["out_channels"], bf, top))
    for i in range(c["refiner_depth"]):
        g = f"txt_in.blocks.{i}"
        spec += (norm(f"{g}.norm1", h, g, True) + lp(f"{g}.qkv", h, 3 * h, bf, g) + lp(f"{g}.proj", h, h, bf, g)
                 + norm(f"{g}.norm2", h, g, True) + mlp2(f"{g}.mlp", h, 4 * h, h, g)
                 + lp(f"{g}.adaln", h, 2 * h, bf, g))
    for i in range(c["mm_double_blocks_depth"]):
        g = f"double_blocks.{i}"
        for s in ("img", "txt"):
            spec += (lp(f"{g}.{s}_mod", h, 6 * h, bf, g) + lp(f"{g}.{s}_qkv", h, 3 * h, bf, g)
                     + norm(f"{g}.{s}_q_norm", hd, g) + norm(f"{g}.{s}_k_norm", hd, g)
                     + lp(f"{g}.{s}_proj", h, h, bf, g) + mlp2(f"{g}.{s}_mlp", h, mh, h, g))
    for i in range(c["mm_single_blocks_depth"]):
        g = f"single_blocks.{i}"
        spec += (lp(f"{g}.modulation", h, 3 * h, bf, g) + lp(f"{g}.linear1", h, 3 * h + mh, bf, g)
                 + lp(f"{g}.linear2", h + mh, h, bf, g) + norm(f"{g}.q_norm", hd, g) + norm(f"{g}.k_norm", hd, g))
    return spec


def num_layers(c: dict) -> int:
    return c["mm_double_blocks_depth"] + c["mm_single_blocks_depth"]


def layout(c: dict) -> RS.Layout:
    f, h, w = RH.grid(c)
    return RS.Layout(nf=f, fs=h * w, text=c["text_len"], prompt=c["prompt_length"])


def latent_shape(c: dict) -> tuple:
    return (c["out_channels"], 1 + (c["num_frames"] - 1) // 4, c["height"] // 8, c["width"] // 8)


def dense_layers(c: dict) -> int:
    return math.floor(c["first_layers_fp"] * num_layers(c))



def counts(c: dict, traffic: dict) -> dict:
    """A step's work: FLOPs of the forward and the joint self-attention's
    FLOPs and bytes (svgbench/flops.py)."""
    from svgbench import flops

    lay = layout(c)
    h, mh, H = c["hidden_size"], int(c["hidden_size"] * c["mlp_width_ratio"]), c["heads_num"]
    D, T, P = h // H, c["text_len"], c["prompt_length"]
    nd, ns, L = c["mm_double_blocks_depth"], c["mm_single_blocks_depth"], num_layers(c)
    patch = math.prod(c["patch_size"])
    per_token = nd * (4 * h * h + 2 * h * mh) + ns * (h * (3 * h + mh) + (h + mh) * h)
    per_video = c["in_channels"] * patch * h + h * patch * c["out_channels"]
    per_text = c["text_states_dim"] * h + c["refiner_depth"] * (4 * h * h + 8 * h * h)
    per_item = (256 * h + h * h) * 3 + c["text_states_dim_2"] * h + h * h + c["text_states_dim"] * h + h * h \
        + nd * 12 * h * h + ns * 3 * h * h + 2 * h * h + c["refiner_depth"] * 2 * h * h
    linear = 2 * (per_token * lay.seq + per_video * lay.vid + per_text * T + per_item)
    pairs = flops.attention_pairs(lay, traffic["pattern"], traffic.get("sparsity", 0.0), dense_layers(c), L)
    attn = 4 * D * H * pairs
    refiner = 4 * D * H * c["refiner_depth"] * (P * P + (T - P))
    return {"flops": linear + attn + refiner, "attn_flops": attn, "attn_bytes": 4 * flops.BF16 * H * lay.seq * D * L}


def make_inputs(c: dict, traffic: dict, seed: int, device) -> dict:
    """LLaMA states (1, text_len, 4096) and CLIP-L's pooled (1, 768), bf16, the
    text mask of the configured prompt length, the noise and the compared
    forward's sampled rows."""
    g = I.generator(seed, I.STREAM_TEXT, device)
    states = torch.randn(1, c["text_len"], c["text_states_dim"], generator=g, device=device).to(torch.bfloat16)
    pooled = torch.randn(1, c["text_states_dim_2"], generator=g, device=device).to(torch.bfloat16)
    mask = torch.zeros(1, c["text_len"], dtype=torch.int64, device=device)
    mask[:, :c["prompt_length"]] = 1
    noise = I.normal((1, *latent_shape(c)), seed, I.STREAM_NOISE, device)
    rows = common.sampled_rows(layout(c), traffic, num_layers(c), seed, device)
    return {"states": states, "pooled": pooled, "mask": mask, "noise": noise, "rows": rows}


class Run(common.RunBase):
    def setup(self):
        from sparse_videogen_tpu_torch.models.hyvideo.model import HyVideoConfig, HyVideoModel
        from sparse_videogen_tpu_torch.pipelines.hyvideo import HyVideoPipeline

        c = self.c
        keys = ("in_channels", "out_channels", "hidden_size", "heads_num", "mlp_width_ratio", "mm_double_blocks_depth",
                "mm_single_blocks_depth", "text_states_dim", "text_states_dim_2", "text_len", "guidance_embed",
                "refiner_depth", "eps")
        self.model = HyVideoModel(HyVideoConfig(patch_size=tuple(c["patch_size"]),
                                                rope_dim_list=tuple(c["rope_dim_list"]), **{k: c[k] for k in keys}),
                                  dtype=torch.bfloat16, device=self.device)
        I.load_into(self.model, param_spec(c), self.seed)
        self.pipe = HyVideoPipeline(common.ModelProbe(self.model, self))
        t = self.cell.traffic
        self.gen_kw = dict(prompt_length=c["prompt_length"], height=c["height"], width=c["width"],
                           num_frames=c["num_frames"], embedded_guidance_scale=c["embedded_guidance_scale"],
                           flow_shift=c["flow_shift"], pattern=t["pattern"], first_layers_fp=c["first_layers_fp"],
                           first_times_fp=common.FIRST_TIMES_FP,
                           svg=common.svg_config(c, t),
                           num_inference_steps=c["num_inference_steps"], seed=self.seed)
        self.inputs = make_inputs(c, t, self.seed, self.device)

    def generate(self, latents, steps, callback):
        i = self.inputs
        self.pipe.generate_latents(i["states"], i["mask"], i["pooled"], latents=latents, callback=callback,
                                   **(self.gen_kw | ({"num_inference_steps": steps} if steps else {})))


def _attn_args(c, traffic):
    return common.attn_args(c, traffic, layout(c), dense_layers(c))


def _reference_step(c, P, inp, attn, prec):
    x = inp["noise"][0]
    v = RH.forward(P, c, x, RH.timestep0(c["num_inference_steps"], c["flow_shift"]), inp["states"][0].float(),
                   inp["mask"][0], inp["pooled"][0].float(), c["embedded_guidance_scale"] * 1000.0, attn, prec)
    return RH.euler_first_step(c["num_inference_steps"], c["flow_shift"], x, v)


def judge(cell, seed: int, device, captured: dict) -> dict:
    """The f32 reference of the compared step against what the program
    produced: captured["latents"] after the step, captured["rows"][l] (1, H,
    R, D) layer l's attention on the sampled rows."""
    c, traffic = model_cfg(cell.config), cell.traffic
    with exact_matmul(), torch.no_grad():
        inp = make_inputs(c, traffic, seed, device)
        P = I.f32_params(param_spec(c), seed, device)
        j = attn_judge.Judge(rows=inp["rows"], program_rows=[common.item(r, 0) for r in captured["rows"]],
                             **_attn_args(c, traffic))
        ref = _reference_step(c, P, inp, j, "f32")
        x = inp["noise"][0]
        d_ref, d_prog = ref - x, captured["latents"][0].float() - x
        out = {"update_rel_l2": float(torch.linalg.vector_norm(d_prog - d_ref) / torch.linalg.vector_norm(d_ref)),
               "attn_rows_rel": max(j.rows_rel)}
        if traffic["pattern"] == "SVG":
            out["svg1_class_gap"] = max(j.class_gap)
            out["svg1_temporal_heads"] = j.temporal_heads
    return out


def control_capture(cell, seed: int, device, prec: str = "fp8") -> dict:
    c, traffic = model_cfg(cell.config), cell.traffic
    with exact_matmul(), torch.no_grad():
        inp = make_inputs(c, traffic, seed, device)
        P = I.f32_params(param_spec(c), seed, device)
        low = attn_judge.Lowp(rows=inp["rows"], prec=prec, **_attn_args(c, traffic))
        lat = _reference_step(c, P, inp, low, prec)
    return {"latents": lat[None], "rows": [r[None] for r in low.out_rows]}
