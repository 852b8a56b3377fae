"""Flow-match Euler sampler (counterpart of
sparse_videogen_tpu/schedulers/euler.py): shifted sigmas
sigma' = shift*s / (1 + (shift-1)*s) from an f64 linspace, timesteps =
sigma*1000 (f32), update x_{i+1} = x_i + (sigma_{i+1} - sigma_i) * v in the
latents' dtype. HunyuanVideo runs it with shift 7.0.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class FlowMatchEuler:
    num_steps: int
    shift: float = 7.0
    num_train_timesteps: int = 1000

    def __post_init__(self):
        s = np.linspace(1.0, 0.0, self.num_steps + 1, dtype=np.float64)
        s = self.shift * s / (1 + (self.shift - 1) * s)
        self.sigmas = s
        self.timesteps = (s[:-1] * self.num_train_timesteps).astype(np.float32)

    def init_state(self):
        return ()

    def step(self, i: int, x, v, state=()):
        dt = float(self.sigmas[i + 1] - self.sigmas[i])
        return x + dt * v.to(x.dtype), state
