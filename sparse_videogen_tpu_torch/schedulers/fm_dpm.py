"""DPM-Solver++ multistep sampler for flow matching, predict-x0, order 2
(counterpart of sparse_videogen_tpu/schedulers/fm_dpm.py).

The coefficient tables are the JAX package's f64 numpy tables, computed the
same way: the shifted sigmas of FlowUniPC (set_timesteps shifts endpoints
that are already shifted), lambda = log(1 - sigma) - log(sigma), and every
step folded into x_next = c_x x + c_m0 x0 + c_m1 x0_prev with the order
warm-up and lower_order_final in the table. The last step's h is infinite
(sigma 0): it takes the first-order form (c_m1 = 0), as the JAX table does.
The step is plain torch in f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class FlowDPM:
    num_steps: int
    shift: float = 5.0
    num_train_timesteps: int = 1000
    solver_order: int = 2
    lower_order_final: bool = True

    def __post_init__(self):
        assert self.solver_order == 2, "order-2 (the reference default) is implemented"
        n_train = self.num_train_timesteps
        alphas = np.linspace(1, 1 / n_train, n_train, dtype=np.float64)[::-1]
        base = 1.0 - alphas
        base = self.shift * base / (1 + (self.shift - 1) * base)
        sigma_max, sigma_min = base[0], base[-1]
        s_raw = np.linspace(sigma_max, sigma_min, self.num_steps + 1, dtype=np.float64)[:-1]
        s2 = self.shift * s_raw / (1 + (self.shift - 1) * s_raw)
        self.sigmas = np.concatenate([s2, [0.0]])
        self.timesteps = (s2 * n_train).astype(np.float64)

        N = self.num_steps
        sig = self.sigmas

        def lam(i):
            with np.errstate(divide="ignore"):
                return np.log(1 - sig[i]) - np.log(sig[i])

        cx, cm0, cm1 = np.zeros(N), np.zeros(N), np.zeros(N)
        lower_order_nums = 0
        for i in range(N):
            order = self.solver_order
            if self.lower_order_final and (N - i) < order:
                order = N - i
            order = min(order, lower_order_nums + 1)
            s_t, s_s = sig[i + 1], sig[i]
            h = lam(i + 1) - lam(i)
            # sigma_final = 0 -> h = +inf: exp(-h) - 1 -> -1, s_t / s_s -> 0
            A = (1.0 - s_t) * (np.expm1(-h) if np.isfinite(h) else -1.0)
            cx[i] = s_t / s_s
            if order == 2 and np.isfinite(h):
                r0 = (lam(i) - lam(i - 1)) / h
                cm0[i] = -A * (1.0 + 0.5 / r0)
                cm1[i] = A * 0.5 / r0
            else:  # first order, and the infinite-h final step
                cm0[i] = -A
            lower_order_nums = min(lower_order_nums + 1, self.solver_order)
        self._cx, self._cm0, self._cm1 = cx, cm0, cm1

    def init_state(self, x):
        """The previous x0 (unused at step 0, where c_m1 is 0)."""
        return torch.zeros_like(x, dtype=torch.float32)

    def step(self, i: int, x, v, state):
        """x0 = x - sigma_i v, then c_x x + c_m0 x0 + c_m1 x0_prev. Returns
        (x_next, x0): x0 is the next step's state."""
        f32 = lambda a: float(np.float32(a))  # the JAX step's f32 scalars
        xf = x.float()
        x0 = xf - f32(self.sigmas[i]) * v.float()
        x_next = f32(self._cx[i]) * xf + f32(self._cm0[i]) * x0 + f32(self._cm1[i]) * state
        return x_next, x0
