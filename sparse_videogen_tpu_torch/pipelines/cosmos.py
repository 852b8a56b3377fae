"""Cosmos Text2World generation pipeline (counterpart of
sparse_videogen_tpu/pipelines/cosmos.py): EDM Euler with Karras sigmas,
classifier-free guidance (default 7.0) over one forward a step on the CFG
batch of 2 ([cond, uncond]), and the dense / SVG1 / SAP self-attention
runtime over the video-only layout (1 + (frames - 1) / 8 latent frames of
(height / 16) x (width / 16) tokens: 16 x 3,520 at 704x1280x121).

As in the JAX pipeline, the EDM input scaling c_in is applied in f32 before
the cast to the model's dtype, the DiT sees c_noise = log(sigma) / 4 as its
timestep, and the warm-up's first_times comes from
WarmupSchedule.from_fractions over those c_noise values (its offset of 1.0
suits a 0-1000 scale, so more steps run dense than first_times_fp says:
ROADMAP.md section 3). SAP runs the CFG batch in one forward: its k-means
states cover 2 x heads (cond's heads, then uncond's), unlike Wan's two
batch-1 forwards. `fps` is accepted and, as in the JAX pipeline, not passed
to the DiT (its RoPE uses frame indices). A rank group (`mesh`) goes
through pipelines/runtime.make_runtime: the ring for dense and SAP (SVG
raises), Ulysses for every pattern.
"""

from __future__ import annotations

import dataclasses

import torch

from sparse_videogen_tpu_torch.config import SAPConfig, SVGConfig, VideoLayout, WarmupSchedule
from sparse_videogen_tpu_torch.models.cosmos.model import CosmosConfig, CosmosModel
from sparse_videogen_tpu_torch.pipelines.runtime import make_runtime
from sparse_videogen_tpu_torch.schedulers import EDMEuler
from sparse_videogen_tpu_torch.sparse.runtimes import SAPRuntime
from sparse_videogen_tpu_torch.sparse.svg1 import make_svg1_plan
from sparse_videogen_tpu_torch.utils.density import DensityLogger, log_sap_states

VAE_SPATIAL = 8
VAE_TEMPORAL = 8  # the CV8x8x8 tokenizer


def cosmos_layout(cfg: CosmosConfig, height: int, width: int, num_frames: int) -> VideoLayout:
    pt, ph, pw = cfg.patch_size
    nf = (1 + (num_frames - 1) // VAE_TEMPORAL) // pt
    fs = (height // (VAE_SPATIAL * ph)) * (width // (VAE_SPATIAL * pw))
    return VideoLayout(num_frames=nf, frame_size=fs)


def make_cosmos_runtime(layout: VideoLayout, *, device, pattern: str = "dense",
                        warmup: WarmupSchedule = WarmupSchedule(), svg: SVGConfig = SVGConfig(),
                        sap: SAPConfig = SAPConfig(), mesh=None):
    """The runtime of a pattern on the plan's default blocks (the JAX
    pipeline's make_svg1_plan(layout, svg, warmup)); mesh: a rank group
    (pipelines/runtime.make_runtime)."""
    plan = make_svg1_plan(layout, svg, warmup)
    return make_runtime(plan, pattern, device=device, sap=sap, warmup=warmup, mesh=mesh)


@dataclasses.dataclass
class CosmosPipeline:
    model: CosmosModel

    def generate_latents(
        self,
        context,  # (1, L, text_embed_dim)
        context_null,
        *,
        height: int = 704,
        width: int = 1280,
        num_frames: int = 121,
        num_inference_steps: int = 35,
        guidance_scale: float = 7.0,
        fps: int = 30,
        pattern: str = "dense",
        first_layers_fp: float = 0.025,
        first_times_fp: float = 0.075,
        svg: SVGConfig = SVGConfig(),
        sap: SAPConfig = SAPConfig(),
        seed: int = 0,
        logging_file: str | None = None,
        callback=None,
        mesh=None,
    ):
        """Run the denoise loop from noise drawn with torch.Generator(seed) on
        the model's device, times the first sigma; return the f32 latents
        (1, C, F_lat, h, w). With pattern SAP, `logging_file` receives the
        per-(step, layer) densities of both CFG halves as JSONL."""
        cfg = self.model.cfg
        device = self.model.device
        gen = torch.Generator(device=device).manual_seed(seed)
        shape = (1, cfg.in_channels, 1 + (num_frames - 1) // VAE_TEMPORAL, height // VAE_SPATIAL,
                 width // VAE_SPATIAL)
        lat = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        lat = lat * EDMEuler(num_inference_steps).init_noise_sigma
        return self._denoise(context, context_null, lat, height=height, width=width, num_frames=num_frames,
                             num_inference_steps=num_inference_steps, guidance_scale=guidance_scale, pattern=pattern,
                             first_layers_fp=first_layers_fp, first_times_fp=first_times_fp, svg=svg, sap=sap,
                             generator=gen, logging_file=logging_file, callback=callback, mesh=mesh)

    def _denoise(self, context, context_null, lat, *, height, width, num_frames, num_inference_steps,
                 guidance_scale, pattern, first_layers_fp, first_times_fp, svg=SVGConfig(), sap=SAPConfig(),
                 generator=None, profile_rows=None, kmeans_init=None, logging_file=None, callback=None, mesh=None):
        """The loop behind generate_latents, from the given initial latents
        (already times the first sigma). `profile_rows[step][layer]` hands
        the SVG1 profiler fixed rows, and `kmeans_init[step][layer]` = (q
        indices, k indices) of the 2 x heads hands SAP's cold-start k-means
        its draws, instead of drawing them from `generator` (tests hand in
        the JAX package's)."""
        model = self.model
        cfg = model.cfg
        device, dtype = model.device, model.patch_embed.weight.dtype
        layout = cosmos_layout(cfg, height, width, num_frames)
        sch = EDMEuler(num_inference_steps)
        warmup = WarmupSchedule.from_fractions(first_layers_fp, first_times_fp, cfg.num_layers, sch.timesteps)
        runtime = make_cosmos_runtime(layout, device=device, pattern=pattern, warmup=warmup, svg=svg, sap=sap,
                                      mesh=mesh)
        sap_mode = isinstance(runtime, SAPRuntime)
        dlog = DensityLogger(logging_file if sap_mode else None)
        ctx2 = torch.cat([context, context_null]).to(device, dtype)
        lat = lat.to(device)
        sstate = sch.init_state()
        for i in range(num_inference_steps):
            t = float(sch.timesteps[i])
            if sap_mode:
                runtime.kmeans_init = None if kmeans_init is None else kmeans_init[i]
            x = (lat * torch.tensor(sch.c_in(i), dtype=torch.float32)).to(dtype).expand(2, -1, -1, -1, -1)
            out = model(x, torch.full((2,), t, dtype=torch.float32, device=device), ctx2, attention=runtime,
                        generator=generator, profile_rows=None if profile_rows is None else profile_rows[i])
            cond, uncond = out[:1].float(), out[1:2].float()
            lat, sstate = sch.step(i, lat, uncond + guidance_scale * (cond - uncond), sstate)
            if dlog.path:
                log_sap_states(dlog, t, runtime.states)
            if callback is not None:
                callback(i, lat)
        return lat
