"""UniPC multistep sampler for flow matching, predict-x0, bh2, order 2
(counterpart of sparse_videogen_tpu/schedulers/unipc.py).

The coefficient tables are the JAX package's f64 numpy tables, computed the
same way, including the deliberate double shift of the sigmas; the step is
plain torch in f32.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass
class FlowUniPC:
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
        # set_timesteps re-applies the shift to endpoints that are already
        # shifted: the reference's double shift, reproduced deliberately
        s_raw = np.linspace(sigma_max, sigma_min, self.num_steps + 1, dtype=np.float64)[:-1]
        s2 = self.shift * s_raw / (1 + (self.shift - 1) * s_raw)
        self.sigmas = np.concatenate([s2, [0.0]])
        self.timesteps = (s2 * n_train).astype(np.float64)

        N = self.num_steps
        sig = self.sigmas

        def lam(i):
            with np.errstate(divide="ignore"):
                return np.log(1 - sig[i]) - np.log(sig[i])  # lambda(sigma=0) = +inf

        orders = []
        lower_order_nums = 0
        for i in range(N):
            this = min(self.solver_order, N - i) if self.lower_order_final else self.solver_order
            orders.append(min(this, lower_order_nums + 1))
            if lower_order_nums < self.solver_order:
                lower_order_nums += 1
        self.pred_order = orders

        # predictor at step i (sigma_i -> sigma_{i+1}); B_h == h_phi_1 == expm1(-h)
        pc = {"a": [], "b": [], "c": [], "rk": []}
        for i in range(N):
            a_t, s_t = 1 - sig[i + 1], sig[i + 1]
            h = lam(i + 1) - lam(i)
            h_phi_1 = np.expm1(-h)
            pc["a"].append(s_t / sig[i])
            pc["b"].append(a_t * h_phi_1)
            if orders[i] == 2:
                pc["c"].append(a_t * h_phi_1 * 0.5)  # rhos_p = [0.5]
                pc["rk"].append((lam(i - 1) - lam(i)) / h)
            else:
                pc["c"].append(0.0)
                pc["rk"].append(1.0)
        self.pred_coeffs = {k: np.array(v) for k, v in pc.items()}

        # corrector applied at step i (sigma_{i-1} -> sigma_i) with the order
        # chosen at step i-1
        cc = {"use": [], "a": [], "b": [], "c_hist": [], "c_t": [], "rk": []}
        for i in range(N):
            if i == 0:
                for k in cc:
                    cc[k].append(0.0)
                continue
            order_c = orders[i - 1]
            a_t, s_t = 1 - sig[i], sig[i]
            h = lam(i) - lam(i - 1)
            B_h = h_phi_1 = np.expm1(-h)
            cc["use"].append(1.0)
            cc["a"].append(s_t / sig[i - 1])
            cc["b"].append(a_t * h_phi_1)
            if order_c == 1:
                cc["c_hist"].append(0.0)
                cc["c_t"].append(a_t * B_h * 0.5)  # rhos_c = [0.5]
                cc["rk"].append(1.0)
            else:
                rk = (lam(i - 2) - lam(i - 1)) / h
                rks = np.array([rk, 1.0])
                hh = -h
                h_phi_k = h_phi_1 / hh - 1
                R, b = [], []
                fact = 1
                for o in range(1, order_c + 1):
                    R.append(rks ** (o - 1))
                    b.append(h_phi_k * fact / B_h)
                    fact *= o + 1
                    h_phi_k = h_phi_k / hh - 1 / fact
                rhos = np.linalg.solve(np.stack(R), np.array(b))
                cc["c_hist"].append(a_t * B_h * rhos[0])
                cc["c_t"].append(a_t * B_h * rhos[1])
                cc["rk"].append(rk)
        self.corr_coeffs = {k: np.array(v) for k, v in cc.items()}

    def init_state(self, x):
        z = torch.zeros_like(x, dtype=torch.float32)
        return dict(m_last=z, m_prev=z, x_last=z)

    def step(self, i: int, x, v, state):
        """One predictor(-corrector) step from sample x with model output v
        (flow velocity) at step i. Returns (x_next, new_state)."""
        f32 = lambda a: float(np.float32(a))  # the JAX step's f32 scalars
        pc = {k: f32(a[i]) for k, a in self.pred_coeffs.items()}
        cc = {k: f32(a[i]) for k, a in self.corr_coeffs.items()}
        xf = x.float()
        x0 = xf - f32(self.sigmas[i]) * v.float()
        m0 = state["m_last"]
        if self.corr_coeffs["use"][i] > 0:
            corr = cc["c_t"] * (x0 - m0)
            if self.corr_coeffs["c_hist"][i] != 0.0:
                corr = corr + cc["c_hist"] * ((state["m_prev"] - m0) / cc["rk"])
            xf = cc["a"] * state["x_last"] - cc["b"] * m0 - corr
        new_state = dict(m_last=x0, m_prev=m0, x_last=xf)
        xp = pc["a"] * xf - pc["b"] * x0
        if self.pred_order[i] == 2:
            xp = xp - pc["c"] * ((m0 - x0) / pc["rk"])
        return xp.to(x.dtype), new_state
