"""Wan 2.1 T2V and I2V generation pipeline (counterpart of
sparse_videogen_tpu/pipelines/wan.py): FlowUniPC, CFG, and the dense / SVG1 /
SAP self-attention runtime. Dense and SVG1 batch CFG as [cond, null]; SAP
runs the two streams as separate batch-1 forwards, each with its own k-means
states, as the JAX pipeline does. I2V hands every forward the CLIP features
and the condition latents (`build_i2v_condition`: the first-frame mask and
the image's VAE latents), concatenated after the noise on channels. The
sampler is FlowUniPC or, with sampler="dpm++", FlowDPM. With a rank group
(`mesh`, parallel/mesh.make_mesh or parallel/comm.ThreadRanks), the runtime
follows pipelines/runtime.make_runtime's rules: a ring (--ring_degree) runs
dense and SAP token-sharded, the head axis alone (--ulysses_degree) every
pattern head-sharded.
`export_video` writes the VAE's output as a .y4m or .mp4.
"""

from __future__ import annotations

import dataclasses

import torch

from sparse_videogen_tpu_torch.config import SAPConfig, SparseMode, SVGConfig, VideoLayout, WarmupSchedule
from sparse_videogen_tpu_torch.models.wan.model import WanConfig, WanModel
from sparse_videogen_tpu_torch.pipelines.runtime import make_runtime
from sparse_videogen_tpu_torch.schedulers import FlowDPM, FlowUniPC
from sparse_videogen_tpu_torch.sparse.runtimes import SAPRuntime
from sparse_videogen_tpu_torch.sparse.svg1 import make_svg1_plan
from sparse_videogen_tpu_torch.utils.density import DensityLogger, log_sap_states
from sparse_videogen_tpu_torch.utils.timer import time_logging

VAE_SPATIAL = 8
VAE_TEMPORAL = 4
# SVG1 tiles of the pipeline (the JAX pipeline's): q blocks of the sparse
# path and KV chunks of both paths
BLOCK_Q = 512
BLOCK_KV = 1024


def wan_layout(model_cfg: WanConfig, height: int, width: int, num_frames: int) -> VideoLayout:
    """Token layout from pixel dims."""
    pt, ph, pw = model_cfg.patch_size
    nf = (1 + (num_frames - 1) // VAE_TEMPORAL) // pt
    fs = (height // (VAE_SPATIAL * ph)) * (width // (VAE_SPATIAL * pw))
    return VideoLayout(num_frames=nf, frame_size=fs)


def make_wan_runtime(layout: VideoLayout, *, device, pattern: str = "SVG", warmup: WarmupSchedule = WarmupSchedule(),
                     svg: SVGConfig = SVGConfig(), sap: SAPConfig = SAPConfig(), mesh=None,
                     inplace_temporal: bool = False):
    """The attention runtime of a pattern (pipelines/runtime.make_runtime);
    mesh: a rank group, None for a single device. inplace_temporal: SVG1
    without placement (a measurement switch, scripts/profile_wan.py
    --inplace_temporal)."""
    plan = make_svg1_plan(layout, svg, warmup, block_q=BLOCK_Q, block_kv=BLOCK_KV,
                          inplace_temporal=inplace_temporal and SparseMode(pattern) == SparseMode.SVG)
    return make_runtime(plan, pattern, device=device, sap=sap, warmup=warmup, mesh=mesh)


def make_sampler(sampler: str, num_steps: int, shift: float):
    """FlowUniPC ("unipc") or FlowDPM ("dpm++", wan_orig's alternative solver)."""
    if sampler not in ("unipc", "dpm++"):
        raise ValueError(f"sampler {sampler!r}: one of unipc, dpm++")
    return (FlowDPM if sampler == "dpm++" else FlowUniPC)(num_steps, shift=shift)


@dataclasses.dataclass
class WanPipeline:
    model: WanModel

    def generate_latents(
        self,
        context,  # (1, text_len, text_dim) conditional text embedding
        context_null,  # (1, text_len, text_dim) negative/unconditional
        *,
        height: int = 480,
        width: int = 832,
        num_frames: int = 81,
        num_inference_steps: int = 50,
        guidance_scale: float = 5.0,
        flow_shift: float = 3.0,
        sampler: str = "unipc",
        pattern: str = "SVG",
        first_layers_fp: float = 0.0,
        first_times_fp: float = 0.0,
        svg: SVGConfig = SVGConfig(),
        sap: SAPConfig = SAPConfig(),
        seed: int = 0,
        callback=None,
        logging_file: str | None = None,
        latents: torch.Tensor | None = None,
        mesh=None,
        inplace_temporal: bool = False,
        clip_fea: torch.Tensor | None = None,
        latent_cond: torch.Tensor | None = None,
        sap_states: list | None = None,
    ):
        """Run the denoise loop from noise drawn with torch.Generator(seed) on
        the model's device (or from `latents`, of the same shape; the generator
        still serves SAP's k-means); return the final f32 latents (1, C, F',
        H', W'). The noise has out_dim channels; I2V's clip_fea (1, 257,
        image_dim) and latent_cond (1, in_dim - out_dim, F', H', W') go to
        every forward of both CFG streams.
        With pattern SAP, `logging_file` receives the per-(step, layer) density
        of the cond stream as JSONL (utils/density.py). mesh and
        inplace_temporal go to make_wan_runtime.
        `sap_states` (pattern SAP): a list of the two streams' k-means carries
        [cond, uncond], each {layer: SAPState}, e.g. [{}, {}] or what an
        earlier video left there. The video starts from them (a carried layer
        runs kmeans_iter_step Lloyd passes from its centroids at its first
        sparse step) and leaves its states in the same list, after every
        forward. None: every video starts cold, as without the argument."""
        device = self.model.patch_embedding.weight.device
        gen = torch.Generator(device=device).manual_seed(seed)
        shape = (1, self.model.cfg.out_dim, 1 + (num_frames - 1) // VAE_TEMPORAL,
                 height // VAE_SPATIAL, width // VAE_SPATIAL)
        if latents is None:
            lat = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        elif tuple(latents.shape) == shape:
            lat = latents.float()
        else:
            raise ValueError(f"latents {tuple(latents.shape)}, expected {shape}")
        return self._denoise(
            context, context_null, lat, height=height, width=width, num_frames=num_frames,
            num_inference_steps=num_inference_steps, guidance_scale=guidance_scale, flow_shift=flow_shift,
            sampler=sampler, pattern=pattern, first_layers_fp=first_layers_fp, first_times_fp=first_times_fp, svg=svg, sap=sap,
            generator=gen, callback=callback, logging_file=logging_file, mesh=mesh,
            inplace_temporal=inplace_temporal, clip_fea=clip_fea, latent_cond=latent_cond, sap_states=sap_states,
        )

    def _denoise(self, context, context_null, lat, *, height, width, num_frames, num_inference_steps,
                 guidance_scale, flow_shift, pattern, first_layers_fp, first_times_fp, svg, sap=SAPConfig(),
                 sampler="unipc",
                 generator=None, profile_rows=None, kmeans_init=None, callback=None, logging_file=None, mesh=None,
                 inplace_temporal=False, clip_fea=None, latent_cond=None, sap_states=None):
        """The loop behind generate_latents, from the given initial latents.
        `profile_rows[step][layer]` hands the SVG1 profiler fixed rows, and
        `kmeans_init[step][stream][layer]` = (q indices, k indices) hands SAP's
        cold-start k-means its token draws (stream 0 cond, 1 uncond), instead
        of drawing them from `generator` (tests hand in the JAX package's).
        `sap_states`: generate_latents' carry, read and written in place."""
        model = self.model
        cfgm = model.cfg
        device, dtype = model.patch_embedding.weight.device, model.patch_embedding.weight.dtype
        layout = wan_layout(cfgm, height, width, num_frames)
        sch = make_sampler(sampler, num_inference_steps, flow_shift)
        warmup = WarmupSchedule.from_fractions(first_layers_fp, first_times_fp, cfgm.num_layers, sch.timesteps)
        with time_logging("video.plan", host=True):
            runtime = make_wan_runtime(layout, device=device, pattern=pattern, warmup=warmup, svg=svg, sap=sap,
                                       mesh=mesh, inplace_temporal=inplace_temporal)
        sap_mode = isinstance(runtime, SAPRuntime)
        dlog = DensityLogger(logging_file if sap_mode else None)
        # SAP: layer -> SAPState, per CFG stream
        stream_states = [{}, {}] if sap_states is None else sap_states
        ctx_pair = torch.cat([context, context_null], dim=0).to(device)
        lat = lat.to(device)
        if latent_cond is not None:
            latent_cond = latent_cond.to(device=device, dtype=dtype)
        if clip_fea is not None:
            clip_fea = clip_fea.to(device)
        pair = lambda y: None if y is None else torch.cat([y, y], dim=0)
        sstate = sch.init_state(lat)
        for i in range(num_inference_steps):
            if sap_mode:
                t = torch.full((1,), float(sch.timesteps[i]), dtype=torch.float32, device=device)
                x = _with_condition(lat.to(dtype), latent_cond)
                v_cond, v_uncond = (
                    self._sap_forward(runtime, stream_states, s, x, t, ctx_pair[s:s + 1], generator,
                                      None if kmeans_init is None else kmeans_init[i][s], clip_fea)
                    for s in range(2))
            else:
                t = torch.full((2,), float(sch.timesteps[i]), dtype=torch.float32, device=device)
                x = _with_condition(torch.cat([lat, lat], dim=0).to(dtype), pair(latent_cond))
                v = model(x, t, ctx_pair, attention=runtime, generator=generator, clip_fea=pair(clip_fea),
                          profile_rows=None if profile_rows is None else profile_rows[i])
                v_cond, v_uncond = v[:1], v[1:2]
            lat, sstate = sch.step(i, lat, v_uncond + guidance_scale * (v_cond - v_uncond), sstate)
            if dlog.path:
                log_sap_states(dlog, float(sch.timesteps[i]), stream_states[0])
            if callback is not None:
                callback(i, lat)
        return lat

    def _sap_forward(self, runtime, stream_states, s, x, t, ctx, generator, kmeans_init, clip_fea=None):
        """One batch-1 forward of CFG stream s with that stream's SAP states."""
        runtime.states, runtime.kmeans_init = stream_states[s], kmeans_init
        v = self.model(x, t, ctx, attention=runtime, generator=generator, clip_fea=clip_fea)
        stream_states[s] = runtime.states
        return v


def _with_condition(x, latent_cond):
    """The DiT's input: the noise latents, then I2V's condition on channels."""
    return x if latent_cond is None else torch.cat([x, latent_cond], dim=1)


def build_i2v_condition(latent_condition: torch.Tensor, *, vae_temporal: int = VAE_TEMPORAL) -> torch.Tensor:
    """I2V's condition (diffusers WanImageToVideoPipeline.prepare_latents):
    a vae_temporal-channel first-frame mask, then the VAE latents of the
    [image, zeros...] video -> (B, vae_temporal + 16, F_lat, h, w), which
    goes after the noise latents on channels (in_dim 36 = 16 + 20).
    latent_condition: (B, 16, F_lat, h, w), normalised (WanVAE.encode)."""
    B, _, F_lat, h, w = latent_condition.shape
    # pixel-frame mask: frame 0 repeated vae_temporal times is 1, the rest 0;
    # grouped (F_lat, vae_temporal), then transposed to (vae_temporal, F_lat)
    flat = torch.zeros(B, vae_temporal * F_lat, h, w, dtype=latent_condition.dtype, device=latent_condition.device)
    flat[:, :vae_temporal] = 1.0
    mask = flat.view(B, F_lat, vae_temporal, h, w).transpose(1, 2)
    return torch.cat([mask, latent_condition], dim=1)


def video_uint8(video) -> torch.Tensor:
    """(B, 3, T, H, W) in [-1, 1] -> the first video as (T, H, W, 3) uint8 on
    its device: (x + 1) * 127.5 in f32, clipped to [0, 255] and truncated,
    as the JAX package's numpy does it."""
    v = video[0].float()
    return ((v + 1.0) * 127.5).clamp_(0, 255).to(torch.uint8).permute(1, 2, 3, 0)


def export_video(video, path: str, fps: int = 16, stages: dict | None = None) -> None:
    """video (B, 3, T, H, W) in [-1, 1] (a tensor on any device) -> .mp4
    (MJPEG, io/mp4.py: the JPEGs encoded on the video's device; `stages`
    gets the encoder's seconds by stage) or, for any other name, .y4m
    (4:2:0, io/native.py). The uint8 conversion truncates, as in the JAX
    package."""
    v = video_uint8(video)
    if path.endswith(".mp4"):
        from sparse_videogen_tpu_torch.io.mp4 import write_mp4

        write_mp4(path, v, fps=fps, stages=stages)
    else:
        from sparse_videogen_tpu_torch.io.native import write_y4m

        write_y4m(path, v.cpu().numpy(), fps=fps)
