"""HunyuanVideo T2V generation pipeline (counterpart of
sparse_videogen_tpu/pipelines/hyvideo.py): flow-match Euler (shift 7.0),
embedded guidance (the cfg-distilled checkpoint runs ONE forward per step
with guidance x 1000, no CFG batch), and the dense, SVG1 or SAP
self-attention runtime over the text-last layout, with the live prompt
length in the mask scalars and SAP's prompt and padding clusters. SAP keeps
one k-means state a layer (one stream). I2V conditions by latent_concat
(the community HunyuanVideo-I2V checkpoint, in_channels 33 = 16 noise + 16
image + 1 mask): the image latents in latent frame 0, zeros after, and a
mask channel of ones on frame 0. `generate(prompt)` runs the attached text
encoder (io/encoders.HyVideoTextEncoders) and VAE decoder. With a rank
group (`mesh`): the ring (--ring_degree) runs dense only, on the text-last
layout with the live prompt length (and the heads split over the head
axis: USP); the head axis alone (--ulysses_degree) runs every pattern.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import torch

from sparse_videogen_tpu_torch.config import SAPConfig, SparseMode, SVGConfig, TextPosition, VideoLayout, WarmupSchedule
from sparse_videogen_tpu_torch.models.hyvideo.model import HyVideoConfig, HyVideoModel
from sparse_videogen_tpu_torch.schedulers import FlowMatchEuler
from sparse_videogen_tpu_torch.sparse.runtimes import DenseRuntime, SAPRuntime, SVG1Runtime, is_sap
from sparse_videogen_tpu_torch.sparse.svg1 import make_svg1_plan
from sparse_videogen_tpu_torch.utils.density import DensityLogger, log_sap_states

VAE_SPATIAL = 8
VAE_TEMPORAL = 4


def hyvideo_layout(cfg: HyVideoConfig, height: int, width: int, num_frames: int) -> VideoLayout:
    """Token layout from pixel dims: the video tokens, then cfg.text_len text tokens."""
    pt, ph, pw = cfg.patch_size
    nf = (1 + (num_frames - 1) // VAE_TEMPORAL) // pt
    fs = (height // (VAE_SPATIAL * ph)) * (width // (VAE_SPATIAL * pw))
    return VideoLayout(num_frames=nf, frame_size=fs, context_length=cfg.text_len, text_position=TextPosition.LAST)


def make_hyvideo_runtime(layout: VideoLayout, *, device, prompt_length: int, pattern: str = "SVG",
                         warmup: WarmupSchedule = WarmupSchedule(), svg: SVGConfig = SVGConfig(),
                         sap: SAPConfig = SAPConfig(), mesh=None):
    """The dense, SVG1 or SAP runtime of a text-last layout (the JAX
    pipeline's plan: default block sizes). SAP's dense warm-up takes the
    layout's context_length as its live text, as the JAX pipeline's
    SAPRuntime does (runtimes.SAPRuntime); its sparse steps take the
    layout's prompt_length. mesh: a rank group (parallel/comm.py); its
    ring runs dense only, its head axis alone every pattern."""
    mode = SparseMode(pattern)
    plan = make_svg1_plan(layout, svg, warmup)
    if mesh is not None and mesh.rp > 1:
        from sparse_videogen_tpu_torch.parallel.ring_runtime import RingDenseRuntime

        if mode != SparseMode.DENSE:
            raise ValueError("hyvideo ring_degree>1 supports pattern=dense; use --ulysses_degree for SVG/SAP "
                             "(head-local algorithms)")
        return RingDenseRuntime(plan, mesh, device=device, prompt_length=prompt_length)
    if mode == SparseMode.SAP:
        rt = SAPRuntime(plan, sap, warmup, device=device)
    else:
        rt = (DenseRuntime if mode == SparseMode.DENSE else SVG1Runtime)(plan, device=device,
                                                                         prompt_length=prompt_length)
    if mesh is not None and mesh.sp > 1:
        from sparse_videogen_tpu_torch.parallel.ulysses import UlyssesRuntime

        rt = UlyssesRuntime(rt, mesh)
    return rt


def i2v_condition(cfg: HyVideoConfig, image_latents, num_latent_frames: int):
    """latent_concat: (1, 16, 1, h, w) image latents -> (1, 17, F, h, w) f32,
    the image in frame 0 and zeros after, then a mask channel (1 on frame 0)."""
    if cfg.in_channels != 2 * cfg.out_channels + 1:
        raise ValueError(f"I2V conditioning needs a latent_concat transformer (in_channels "
                         f"{2 * cfg.out_channels + 1}), this one takes {cfg.in_channels}")
    _, c, _, h, w = image_latents.shape
    cond = image_latents.new_zeros((1, c + 1, num_latent_frames, h, w), dtype=torch.float32)
    cond[:, :c, :1] = image_latents.float()
    cond[:, c, :1] = 1.0
    return cond


@dataclasses.dataclass
class HyVideoPipeline:
    model: HyVideoModel
    text_encoder: Optional[Callable] = None  # prompts -> (states, mask, pooled)
    vae_decode: Optional[Callable] = None

    def generate_latents(
        self,
        text_states,  # (1, text_len, 4096)
        text_mask,  # (1, text_len)
        text_pooled,  # (1, 768)
        *,
        prompt_length: int,  # real prompt tokens
        height: int = 720,
        width: int = 1280,
        num_frames: int = 129,
        num_inference_steps: int = 50,
        embedded_guidance_scale: float = 6.0,
        flow_shift: float = 7.0,
        pattern: str = "SVG",
        first_layers_fp: float = 0.025,
        first_times_fp: float = 0.15,
        svg: SVGConfig = SVGConfig(sparsity=0.25, profile_multiplier=1.5),
        sap: SAPConfig = SAPConfig(),
        seed: int = 0,
        image_latents=None,
        mesh=None,
        callback=None,
        logging_file: str | None = None,
        latents: torch.Tensor | None = None,
    ):
        """Run the denoise loop from noise drawn with torch.Generator(seed) on
        the model's device (or from `latents`, of the same shape; the
        generator also serves SVG1's profiler and SAP's k-means draws);
        return the final f32 latents (1, C, F', H', W'). With pattern SAP,
        `logging_file` receives the per-(step, layer) density as JSONL
        (utils/density.py). `image_latents` (1, 16, 1, h, w): I2V by
        latent_concat (i2v_condition)."""
        cfg = self.model.cfg
        device = self.model.img_in.weight.device
        gen = torch.Generator(device=device).manual_seed(seed)
        shape = (1, cfg.out_channels, 1 + (num_frames - 1) // VAE_TEMPORAL, height // VAE_SPATIAL,
                 width // VAE_SPATIAL)
        if latents is None:
            lat = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        elif tuple(latents.shape) == shape:
            lat = latents.float()
        else:
            raise ValueError(f"latents {tuple(latents.shape)}, expected {shape}")
        cond = None if image_latents is None else i2v_condition(cfg, image_latents.to(device), shape[2])
        return self._denoise(text_states, text_mask, text_pooled, lat, prompt_length=prompt_length, height=height,
                             width=width, num_frames=num_frames, num_inference_steps=num_inference_steps,
                             embedded_guidance_scale=embedded_guidance_scale, flow_shift=flow_shift,
                             pattern=pattern, first_layers_fp=first_layers_fp, first_times_fp=first_times_fp,
                             svg=svg, sap=sap, generator=gen, callback=callback, logging_file=logging_file, cond=cond,
                             mesh=mesh)

    def generate(self, prompt: str, **kw):
        """prompt -> the video (B, 3, T, H, W) through the attached VAE
        decoder, or the latents without one; the text encoder returns
        (states, mask, pooled) and its mask's sum is the prompt length."""
        if self.text_encoder is None:
            raise ValueError("attach a text encoder (io/encoders.HyVideoTextEncoders) to generate from a prompt")
        states, mask, pooled = self.text_encoder([prompt])
        lat = self.generate_latents(states, mask, pooled, prompt_length=int(mask[0].sum()), **kw)
        return lat if self.vae_decode is None else self.vae_decode(lat)

    def _denoise(self, text_states, text_mask, text_pooled, lat, *, prompt_length, height, width, num_frames,
                 num_inference_steps, embedded_guidance_scale, flow_shift, pattern, first_layers_fp,
                 first_times_fp, svg, sap=SAPConfig(), generator=None, profile_rows=None, kmeans_init=None,
                 callback=None, logging_file=None, cond=None, mesh=None):
        """The loop behind generate_latents, from the given initial latents
        (and the I2V condition `cond`, concatenated to them on the channels).
        `profile_rows[step][layer]` hands the SVG1 profiler fixed rows, and
        `kmeans_init[step][layer]` = (q indices, k indices) hands SAP's
        cold-start k-means its token draws, instead of drawing them from
        `generator` (tests hand in the JAX package's)."""
        model = self.model
        cfg = model.cfg
        device, dtype = model.img_in.weight.device, model.img_in.weight.dtype
        layout = dataclasses.replace(hyvideo_layout(cfg, height, width, num_frames), prompt_length=prompt_length)
        sch = FlowMatchEuler(num_inference_steps, shift=flow_shift)
        warmup = WarmupSchedule.from_fractions(first_layers_fp, first_times_fp, cfg.num_layers, sch.timesteps)
        runtime = make_hyvideo_runtime(layout, device=device, prompt_length=prompt_length, pattern=pattern,
                                       warmup=warmup, svg=svg, sap=sap, mesh=mesh)
        sap_mode = is_sap(runtime)
        dlog = DensityLogger(logging_file if sap_mode else None)
        states = text_states.to(device, dtype)
        mask = text_mask.to(device)
        pooled = text_pooled.to(device, dtype)
        guidance = torch.full((1,), embedded_guidance_scale * 1000.0, dtype=torch.float32, device=device)
        lat = lat.to(device)
        cond = None if cond is None else cond.to(device)
        sstate = sch.init_state()
        for i in range(num_inference_steps):
            t = torch.full((1,), float(sch.timesteps[i]), dtype=torch.float32, device=device)
            if sap_mode:
                runtime.kmeans_init = None if kmeans_init is None else kmeans_init[i]
            x = lat if cond is None else torch.cat([lat, cond], dim=1)
            v = model(x.to(dtype), t, states, mask, pooled, guidance=guidance, attention=runtime,
                      generator=generator, profile_rows=None if profile_rows is None else profile_rows[i])
            lat, sstate = sch.step(i, lat, v, sstate)
            if dlog.path:
                log_sap_states(dlog, float(sch.timesteps[i]), runtime.states)
            if callback is not None:
                callback(i, lat)
        return lat
