"""CogVideoX DDIM sampler (counterpart of
sparse_videogen_tpu/schedulers/ddim_cog.py): v-prediction with the
zero-terminal-SNR rescale, as CogVideoX1.5-5B-I2V ships it. Host-side f64
tables: scaled_linear betas, the SNR shift on alphas_cumprod, the rescale,
"trailing" timestep spacing. The step
    x_prev = a_t * x + b_t * pred_x0,  pred_x0 = sqrt(ac_t) x - sqrt(1 - ac_t) v,
    a_t = sqrt((1 - ac_prev) / (1 - ac_t)),  b_t = sqrt(ac_prev) - sqrt(ac_t) a_t
runs in the latents' dtype with Python-float coefficients.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np


@dataclasses.dataclass
class CogDDIM:
    num_steps: int
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    snr_shift_scale: float = 1.0  # 3.0 for CogVideoX-5B v1.0, 1.0 for v1.5
    rescale_zero_snr: bool = True
    set_alpha_to_one: bool = True

    def __post_init__(self):
        T = self.num_train_timesteps
        betas = np.linspace(self.beta_start**0.5, self.beta_end**0.5, T, dtype=np.float64) ** 2
        ac = np.cumprod(1.0 - betas)
        ac = ac / (self.snr_shift_scale + (1.0 - self.snr_shift_scale) * ac)
        if self.rescale_zero_snr:
            s = np.sqrt(ac)
            s0, sT = s[0], s[-1]
            s = (s - sT) * (s0 / (s0 - sT))
            ac = s**2
        self.alphas_cumprod = ac
        self.final_alpha_cumprod = 1.0 if self.set_alpha_to_one else float(ac[0])
        step_ratio = T / self.num_steps
        self.timesteps = np.round(np.arange(T, 0, -step_ratio)).astype(np.int64) - 1

    def init_state(self):
        return ()

    def step(self, i: int, x, v, state=()):
        t = int(self.timesteps[i])
        prev_t = t - self.num_train_timesteps // self.num_steps
        ac_t = float(self.alphas_cumprod[t])
        ac_prev = float(self.alphas_cumprod[prev_t]) if prev_t >= 0 else self.final_alpha_cumprod
        pred_x0 = (ac_t**0.5) * x - ((1.0 - ac_t) ** 0.5) * v.to(x.dtype)
        a_t = ((1.0 - ac_prev) / (1.0 - ac_t)) ** 0.5
        b_t = ac_prev**0.5 - ac_t**0.5 * a_t
        return a_t * x + b_t * pred_x0, state


def dynamic_cfg_scale(guidance_scale: float, t: float, num_inference_steps: int) -> float:
    """The use_dynamic_cfg schedule of CogVideoX v1.0 (a cosine ramp in the
    raw timestep t)."""
    return 1.0 + guidance_scale * (
        (1.0 - math.cos(math.pi * ((num_inference_steps - t) / num_inference_steps) ** 5.0)) / 2.0
    )
