"""Runs of the repo's scripts: the model with its generation settings,
which chip_smoke.py, scripts/profile_wan.py and scripts/profile_hyvideo.py
run with random weights (no checkpoint).

T2V_480P ("1.3B-480p"): Wan 2.1 1.3B with the CLI's defaults
  (cli/wan_t2v.py of the JAX package) at 480x832x81, BASELINE.json
  configs[0]'s resolution; SAP in cluster mode at QC 50 / KC 200.
T2V_720P_SAP ("14B-720p-sap"): Wan 2.1 14B with the reference's canonical
  Wan 2.1 720p SAP run (scripts/wan/wan_t2v_720p_sap.sh): 720x1280x81, flow
  shift 5.0, SAP at QC 300 / KC 1000, top_p 0.9, min_kc_ratio 0.10, 50 cold
  / 2 warm k-means iterations, first_times_fp 0.2, first_layers_fp 0.03.
  "14B-720p-sap-tile": the same run with --sap_block_mode tile (the CLIs'
  tile settings: block_q = block_kv = 512, the tile grain).
Both keep the CLI's SVG1 sparsity (0.25) and guidance scale (5.0).

Wan 2.1 I2V 14B (WAN_14B_I2V: dim 5120, 40 layers, 40 heads, FFN 13,824,
in_dim 36, image_dim 1280) with the reference's six runs
(scripts/wan/wan_i2v_{480p,720p}_{svg,dense,sap}.sh), "14B-i2v-<res>-<run>"
in I2V_PRESETS: 81 frames, guidance 5.0; at 480p the example image
(examples/1/image.jpg, 480x832) fits to 480x832, flow shift 3.0; at 720p to
720x1264 (S = 21 x 3,555 = 74,655), flow shift 5.0. SVG1: sparsity 0.25, 64
sampled rows, first_times_fp 0.03, first_layers_fp 0.3; dense: the CLI's
defaults (the same fractions, unused); SAP: QC 300, KC 1000, top_p 0.9,
min_kc_ratio 0.10, 50 / 2 k-means iterations, first_times_fp 0.2,
first_layers_fp 0.03.

HunyuanVideo T2V at 720x1280x129 (HY_PRESETS), HYVIDEO_T2 with the
reference's canonical runs: "hyvideo-720p-svg"
(scripts/hyvideo/hyvideo_t2v_720p_svg.sh: 50 steps, flow shift 7.0, SVG1 at
sparsity 0.25 with 64 sampled rows, first_times_fp 0.1, first_layers_fp
0.025) and "hyvideo-720p-dense" (scripts/hyvideo/hyvideo_t2v_720p_dense.sh:
the same run, dense), and "hyvideo-720p-sap"
(scripts/hyvideo/hyvideo_t2v_720p_sap.sh: SAP at QC 400 / KC 1000, top_p
0.9, min_kc_ratio 0.10, 50 cold / 2 warm k-means iterations,
first_times_fp 0.1, first_layers_fp 0.025, flow shift 7.0; the script's
--zero_step_kmeans_init is dropped by the JAX CLI, so it is off here too)
with its tile variant "hyvideo-720p-sap-tile" (--sap_block_mode tile).
HunyuanVideo I2V at the I2V CLI's defaults (cli/hyvideo_i2v.py of the JAX
package): HYVIDEO_T2_I2V (HYVIDEO_T2 with in_channels 33, the community
HunyuanVideo-I2V's latent_concat) at 720x1280x129, flow shift 7.0,
embedded guidance 1.0, first_layers_fp 0.025, first_times_fp 0.15;
"hyvideo-i2v-720p-svg" (--pattern sparse: SVG1 at sparsity 0.25, 64
sampled rows) and "hyvideo-i2v-720p-dense" (the CLI's default pattern).
The T2V runs take the CLI's embedded guidance 6.0; all take its SVG1
profiling band (profile_multiplier 1.5).

CogVideoX 1.5 5B I2V at 768x1360x81 (COG_PRESETS), COG_1_5_5B_I2V with the
reference's canonical run (scripts/cog/cog_inference.sh, the CLI's defaults:
50 DDIM steps, guidance 6.0, SVG1 at sparsity 0.25 with 32 sampled rows,
first_layers_fp 0.025, first_times_fp 0.2): "cog-768p-svg" and
"cog-768p-dense" (the same run, dense).

Cosmos-1.0-Diffusion-7B Text2World at 704x1280x121 (COSMOS_PRESETS),
COSMOS_7B with the reference's three runs (scripts/cosmos/cosmos_t2v_
{dense,svg,sap}.sh: 35 EDM steps, guidance 7.0, fps 30): "cosmos-704p-dense"
(the CLI's first_layers_fp 0.025, first_times_fp 0.075), "cosmos-704p-svg"
(SVG1 at sparsity 0.25 with 64 sampled rows, first_times_fp 0.3,
first_layers_fp 0.025), "cosmos-704p-sap" (SAP at QC 300 / KC 1000, top_p
0.9, min_kc_ratio 0.10, 50 cold / 2 warm k-means iterations,
first_times_fp 0.3, first_layers_fp 0.025) and its tile variant
"cosmos-704p-sap-tile". The layout is 16 latent frames of 44 x 80 = 3,520
tokens (S = 56,320).
"""

from __future__ import annotations

import dataclasses

from sparse_videogen_tpu_torch.config import SAPConfig, SVGConfig
from sparse_videogen_tpu_torch.models.cog.model import COG_1_5_5B_I2V, CogConfig
from sparse_videogen_tpu_torch.models.cosmos.model import COSMOS_7B, CosmosConfig
from sparse_videogen_tpu_torch.models.hyvideo.model import HYVIDEO_T2, HyVideoConfig
from sparse_videogen_tpu_torch.models.wan.model import WAN_1_3B, WAN_14B, WanConfig
from sparse_videogen_tpu_torch.pipelines.cog import COG_SVG


@dataclasses.dataclass(frozen=True)
class WanRunSettings:
    model: WanConfig
    height: int
    width: int
    num_frames: int
    flow_shift: float
    first_layers_fp: float
    first_times_fp: float
    sap: SAPConfig

    def generate_kwargs(self) -> dict:
        """Keyword arguments of WanPipeline.generate_latents (the CLI's SVG1
        sparsity 0.25 and guidance scale 5.0)."""
        return dict(height=self.height, width=self.width, num_frames=self.num_frames, guidance_scale=5.0,
                    flow_shift=self.flow_shift, first_layers_fp=self.first_layers_fp,
                    first_times_fp=self.first_times_fp, svg=SVGConfig(sparsity=0.25), sap=self.sap)


T2V_480P = WanRunSettings(WAN_1_3B, 480, 832, 81, flow_shift=3.0, first_layers_fp=0.025, first_times_fp=0.075,
                          sap=SAPConfig())
T2V_720P_SAP = WanRunSettings(
    WAN_14B, 720, 1280, 81, flow_shift=5.0, first_layers_fp=0.03, first_times_fp=0.2,
    sap=SAPConfig(num_q_centroids=300, num_k_centroids=1000, top_p_kmeans=0.9, min_kc_ratio=0.10,
                  kmeans_iter_init=50, kmeans_iter_step=2))
WAN_14B_I2V = dataclasses.replace(WAN_14B, model_type="i2v", in_dim=36, image_dim=1280)
I2V_SAP = SAPConfig(num_q_centroids=300, num_k_centroids=1000, top_p_kmeans=0.9, min_kc_ratio=0.10,
                    kmeans_iter_init=50, kmeans_iter_step=2)
I2V_PRESETS = {
    f"14B-i2v-{res}-{run}": WanRunSettings(WAN_14B_I2V, h, w, 81, flow_shift=shift, sap=I2V_SAP if run == "sap"
                                           else SAPConfig(), **({"first_layers_fp": 0.03, "first_times_fp": 0.2}
                                                               if run == "sap" else
                                                               {"first_layers_fp": 0.3, "first_times_fp": 0.03}))
    for res, h, w, shift in (("480p", 480, 832, 3.0), ("720p", 720, 1264, 5.0)) for run in ("svg", "dense", "sap")}


def tile_variant(sap: SAPConfig) -> SAPConfig:
    """The same SAP run with --sap_block_mode tile: block_q = block_kv = 512,
    the tile grain (the JAX CLIs' tile settings; cli/_common.sap_config
    builds tile mode with this function)."""
    return dataclasses.replace(sap, block_mode="tile", block_q=512, block_kv=512)


PRESETS = {"1.3B-480p": T2V_480P, "14B-720p-sap": T2V_720P_SAP,
           "14B-720p-sap-tile": dataclasses.replace(T2V_720P_SAP, sap=tile_variant(T2V_720P_SAP.sap)), **I2V_PRESETS}


@dataclasses.dataclass(frozen=True)
class HyVideoRunSettings:
    model: HyVideoConfig
    height: int
    width: int
    num_frames: int
    flow_shift: float
    pattern: str
    first_layers_fp: float
    first_times_fp: float
    sap: SAPConfig = SAPConfig()
    embedded_guidance_scale: float = 6.0

    def generate_kwargs(self) -> dict:
        """Keyword arguments of HyVideoPipeline.generate_latents but the step
        count (the scripts run 50; the callers here cut it), the prompt
        length and I2V's image latents (the CLI's SVG1 knobs: sparsity 0.25,
        64 sampled rows, profiling band 1.5 frames)."""
        return dict(height=self.height, width=self.width, num_frames=self.num_frames,
                    embedded_guidance_scale=self.embedded_guidance_scale,
                    flow_shift=self.flow_shift, pattern=self.pattern, first_layers_fp=self.first_layers_fp,
                    first_times_fp=self.first_times_fp,
                    svg=SVGConfig(sparsity=0.25, num_sampled_rows=64, profile_multiplier=1.5), sap=self.sap)


HY_720P_SVG = HyVideoRunSettings(HYVIDEO_T2, 720, 1280, 129, flow_shift=7.0, pattern="SVG", first_layers_fp=0.025,
                                 first_times_fp=0.1)
HY_720P_DENSE = dataclasses.replace(HY_720P_SVG, pattern="dense", first_times_fp=0.15)
HY_720P_SAP = dataclasses.replace(
    HY_720P_SVG, pattern="SAP",
    sap=SAPConfig(num_q_centroids=400, num_k_centroids=1000, top_p_kmeans=0.9, min_kc_ratio=0.10,
                  kmeans_iter_init=50, kmeans_iter_step=2))
HYVIDEO_T2_I2V = dataclasses.replace(HYVIDEO_T2, in_channels=33)
HY_I2V_720P_DENSE = HyVideoRunSettings(HYVIDEO_T2_I2V, 720, 1280, 129, flow_shift=7.0, pattern="dense",
                                       first_layers_fp=0.025, first_times_fp=0.15, embedded_guidance_scale=1.0)
HY_PRESETS = {"hyvideo-720p-svg": HY_720P_SVG, "hyvideo-720p-dense": HY_720P_DENSE, "hyvideo-720p-sap": HY_720P_SAP,
              "hyvideo-720p-sap-tile": dataclasses.replace(HY_720P_SAP, sap=tile_variant(HY_720P_SAP.sap)),
              "hyvideo-i2v-720p-svg": dataclasses.replace(HY_I2V_720P_DENSE, pattern="SVG"),
              "hyvideo-i2v-720p-dense": HY_I2V_720P_DENSE}


@dataclasses.dataclass(frozen=True)
class CogRunSettings:
    model: CogConfig
    height: int
    width: int
    num_frames: int
    pattern: str

    def generate_kwargs(self) -> dict:
        """Keyword arguments of CogPipeline.generate_latents but the step
        count (the script runs 50; the callers here cut it): guidance 6.0
        (v1.5: no dynamic CFG), SVG1 sparsity 0.25 with 32 sampled rows,
        first_layers_fp 0.025, first_times_fp 0.2."""
        return dict(height=self.height, width=self.width, num_frames=self.num_frames, guidance_scale=6.0,
                    pattern=self.pattern, first_layers_fp=0.025, first_times_fp=0.2,
                    svg=COG_SVG)


COG_768P_SVG = CogRunSettings(COG_1_5_5B_I2V, 768, 1360, 81, pattern="SVG")
COG_768P_DENSE = dataclasses.replace(COG_768P_SVG, pattern="dense")
COG_PRESETS = {"cog-768p-svg": COG_768P_SVG, "cog-768p-dense": COG_768P_DENSE}


@dataclasses.dataclass(frozen=True)
class CosmosRunSettings:
    model: CosmosConfig
    height: int
    width: int
    num_frames: int
    pattern: str
    first_layers_fp: float
    first_times_fp: float
    svg: SVGConfig = SVGConfig()
    sap: SAPConfig = SAPConfig()

    def generate_kwargs(self) -> dict:
        """Keyword arguments of CosmosPipeline.generate_latents but the step
        count (the scripts run 35; the callers here cut it): guidance 7.0,
        fps 30."""
        return dict(height=self.height, width=self.width, num_frames=self.num_frames, guidance_scale=7.0, fps=30,
                    pattern=self.pattern, first_layers_fp=self.first_layers_fp, first_times_fp=self.first_times_fp,
                    svg=self.svg, sap=self.sap)


COSMOS_704P_DENSE = CosmosRunSettings(COSMOS_7B, 704, 1280, 121, pattern="dense", first_layers_fp=0.025,
                                      first_times_fp=0.075)
COSMOS_704P_SVG = dataclasses.replace(COSMOS_704P_DENSE, pattern="SVG", first_times_fp=0.3,
                                      svg=SVGConfig(sparsity=0.25, num_sampled_rows=64))
COSMOS_704P_SAP = dataclasses.replace(
    COSMOS_704P_DENSE, pattern="SAP", first_times_fp=0.3,
    sap=SAPConfig(num_q_centroids=300, num_k_centroids=1000, top_p_kmeans=0.9, min_kc_ratio=0.10,
                  kmeans_iter_init=50, kmeans_iter_step=2))
COSMOS_PRESETS = {"cosmos-704p-dense": COSMOS_704P_DENSE, "cosmos-704p-svg": COSMOS_704P_SVG,
                  "cosmos-704p-sap": COSMOS_704P_SAP,
                  "cosmos-704p-sap-tile": dataclasses.replace(COSMOS_704P_SAP, sap=tile_variant(COSMOS_704P_SAP.sap))}
