"""CogVideoX 1.5 I2V generation pipeline (counterpart of
sparse_videogen_tpu/pipelines/cog.py): the CogVideoX DDIM v-prediction
sampler, one forward a step over the CFG pair (batch 2: cond, uncond), the
image latents concatenated channel-wise (16 noise + 16 image channels, the
image in latent frame 0 and zeros after), and the v1.5 temporal padding:
latent frames padded at the front to a multiple of patch_size_t and dropped
after denoising. The self-attention runtime is dense or SVG1 over the
text-first layout (mask kind "cog", prompt_length = text_len); v1.0's
dynamic CFG is `use_dynamic_cfg`. SAP raises NotImplementedError. A rank
group (`mesh`) goes through pipelines/runtime.make_runtime: the ring for
dense (SVG raises), Ulysses for both patterns.
"""

from __future__ import annotations

import dataclasses

import torch

from sparse_videogen_tpu_torch.config import SVGConfig, TextPosition, VideoLayout, WarmupSchedule
from sparse_videogen_tpu_torch.models.cog.model import CogConfig, CogModel
from sparse_videogen_tpu_torch.pipelines.runtime import make_runtime
from sparse_videogen_tpu_torch.schedulers.ddim_cog import CogDDIM, dynamic_cfg_scale
from sparse_videogen_tpu_torch.sparse.svg1 import make_svg1_plan

VAE_SPATIAL = 8
VAE_TEMPORAL = 4
# the CLI's SVG1 knobs (scripts/cog/cog_inference.sh)
COG_SVG = SVGConfig(num_sampled_rows=32, sparsity=0.25)


def latent_frames(cfg: CogConfig, num_frames: int) -> tuple[int, int]:
    """(latent frames, front padding to a multiple of patch_size_t)."""
    f_lat = 1 + (num_frames - 1) // VAE_TEMPORAL
    return f_lat, (-f_lat) % cfg.patch_size_t


def cog_layout(cfg: CogConfig, height: int, width: int, num_frames: int) -> VideoLayout:
    """Token layout from pixel dims: cfg.text_len text tokens, then the video
    tokens (11 x 4080 at 768x1360x81 for v1.5)."""
    f_lat, extra = latent_frames(cfg, num_frames)
    p = cfg.patch_size
    fs = (height // (VAE_SPATIAL * p)) * (width // (VAE_SPATIAL * p))
    return VideoLayout(num_frames=(f_lat + extra) // cfg.patch_size_t, frame_size=fs, context_length=cfg.text_len,
                       text_position=TextPosition.FIRST)


def make_cog_runtime(layout: VideoLayout, *, device, pattern: str = "SVG", warmup: WarmupSchedule = WarmupSchedule(),
                     svg: SVGConfig = COG_SVG, mesh=None):
    """The dense or SVG1 runtime of a text-first layout; the whole text is
    live (prompt_length = context_length, as the JAX pipeline passes
    text_len). SAP raises NotImplementedError (pipelines/runtime.make_runtime)."""
    plan = make_svg1_plan(layout, svg, warmup)
    return make_runtime(plan, pattern, device=device, mesh=mesh, prompt_length=layout.context_length)


@dataclasses.dataclass
class CogPipeline:
    model: CogModel

    def generate_latents(
        self,
        context,  # (1, text_len, text_dim)
        context_null,
        image_latents,  # (1, 16, 1, h, w) VAE-encoded first frame
        *,
        height: int = 768,
        width: int = 1360,
        num_frames: int = 81,
        num_inference_steps: int = 50,
        guidance_scale: float = 6.0,
        use_dynamic_cfg: bool = False,
        pattern: str = "SVG",
        first_layers_fp: float = 0.025,
        first_times_fp: float = 0.2,
        svg: SVGConfig = COG_SVG,
        seed: int = 0,
        callback=None,
        mesh=None,
    ):
        """Run the denoise loop from noise drawn with torch.Generator(seed) on
        the model's device; return the final f32 latents (1, 16, F_lat, h, w),
        the front padding removed. pattern "SAP" raises NotImplementedError."""
        cfg = self.model.cfg
        device = self.model.patch_proj.weight.device
        gen = torch.Generator(device=device).manual_seed(seed)
        f_lat, extra = latent_frames(cfg, num_frames)
        shape = (1, cfg.out_channels, f_lat + extra, height // VAE_SPATIAL, width // VAE_SPATIAL)
        lat = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return self._denoise(context, context_null, image_latents, lat, height=height, width=width,
                             num_frames=num_frames, num_inference_steps=num_inference_steps,
                             guidance_scale=guidance_scale, use_dynamic_cfg=use_dynamic_cfg, pattern=pattern,
                             first_layers_fp=first_layers_fp, first_times_fp=first_times_fp, svg=svg,
                             generator=gen, callback=callback, mesh=mesh)

    def _denoise(self, context, context_null, image_latents, lat, *, height, width, num_frames, num_inference_steps,
                 guidance_scale, use_dynamic_cfg, pattern, first_layers_fp, first_times_fp, svg, generator=None,
                 profile_rows=None, callback=None, mesh=None):
        """The loop behind generate_latents, from the given initial latents
        (1, 16, F_lat + padding, h, w). `profile_rows[step][layer]` hands the
        SVG1 profiler fixed rows instead of drawing them from `generator`
        (tests hand in the JAX package's)."""
        model = self.model
        cfg = model.cfg
        if cfg.in_channels != 2 * cfg.out_channels:
            raise ValueError(f"I2V needs in_channels == 2 * out_channels (channel concat), got {cfg}")
        device, dtype = model.patch_proj.weight.device, model.patch_proj.weight.dtype
        layout = cog_layout(cfg, height, width, num_frames)
        sch = CogDDIM(num_inference_steps)
        warmup = WarmupSchedule.from_fractions(first_layers_fp, first_times_fp, cfg.num_layers, sch.timesteps)
        runtime = make_cog_runtime(layout, device=device, pattern=pattern, warmup=warmup, svg=svg, mesh=mesh)
        extra = latent_frames(cfg, num_frames)[1]
        lat = lat.to(device)
        img = torch.zeros_like(lat)
        img[:, :, :1] = image_latents.to(device, torch.float32)  # the image in padded latent frame 0, as JAX does
        ctx2 = torch.cat([context, context_null]).to(device, dtype)
        sstate = sch.init_state()
        for i in range(num_inference_steps):
            t = float(sch.timesteps[i])
            x = torch.cat([lat, img], dim=1).to(dtype).expand(2, -1, -1, -1, -1)
            v = model(x, torch.full((2,), t, dtype=torch.float32, device=device), ctx2, attention=runtime,
                      generator=generator, profile_rows=None if profile_rows is None else profile_rows[i])
            v = v.transpose(1, 2)  # frames-first -> channel-first
            g = dynamic_cfg_scale(guidance_scale, t, num_inference_steps) if use_dynamic_cfg else guidance_scale
            lat, sstate = sch.step(i, lat, v[1:2] + g * (v[:1] - v[1:2]), sstate)
            if callback is not None:
                callback(i, lat)
        return lat[:, :, extra:]
