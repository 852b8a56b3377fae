"""EDM Euler with Karras sigmas, the Cosmos Text2World sampler (counterpart
of sparse_videogen_tpu/schedulers/edm_euler.py).

The sigmas are built in f64 on the host; the "timesteps" the DiT sees are
c_noise = log(sigma) / 4 in f32. EDM preconditioning (Karras et al. 2022):
c_skip = sd^2 / (sigma^2 + sd^2), c_out = sigma sd / sqrt(sigma^2 + sd^2),
c_in = 1 / sqrt(sigma^2 + sd^2). The Euler step: d = (x - denoised) / sigma,
x <- x + (sigma_next - sigma) d, in x's dtype (f32 latents).
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class EDMEuler:
    num_steps: int
    sigma_min: float = 0.002
    sigma_max: float = 80.0
    sigma_data: float = 0.5
    rho: float = 7.0

    def __post_init__(self):
        ramp = np.linspace(0.0, 1.0, self.num_steps, dtype=np.float64)
        min_r, max_r = self.sigma_min ** (1.0 / self.rho), self.sigma_max ** (1.0 / self.rho)
        sig = (max_r + ramp * (min_r - max_r)) ** self.rho
        self.sigmas = np.concatenate([sig, [0.0]])
        self.timesteps = (0.25 * np.log(sig)).astype(np.float32)

    @property
    def init_noise_sigma(self) -> float:
        return float(self.sigmas[0])

    def c_in(self, i: int) -> float:
        return 1.0 / (float(self.sigmas[i]) ** 2 + self.sigma_data**2) ** 0.5

    def precondition_outputs(self, i: int, x, model_out):
        sigma, sd = float(self.sigmas[i]), self.sigma_data
        c_skip = sd**2 / (sigma**2 + sd**2)
        c_out = sigma * sd / (sigma**2 + sd**2) ** 0.5
        return c_skip * x + c_out * model_out.to(x.dtype)

    def init_state(self):
        return ()

    def step(self, i: int, x, model_out, state=()):
        """x: the current sample; model_out: the raw network output."""
        sigma = float(self.sigmas[i])
        d = (x - self.precondition_outputs(i, x, model_out)) / sigma
        return x + (float(self.sigmas[i + 1]) - sigma) * d, state
