"""DPM-Solver++(2M) (`mmgt_tpu/diffusion/dpm.py`): a second-order multistep
solver of the probability-flow ODE in the data-prediction (x0) form (Lu et
al., "DPM-Solver++", 2022).

`init` builds every per-step coefficient on the host, in float64 numpy,
and stores the tables as float32 numpy arrays (the port's `SolverTables`
convention). Zero-terminal SNR with trailing spacing makes two lambdas
infinite (-inf at the first step, where alpha = 0; +inf at the closing
boundary, where sigma_prev = 0); the coefficients stay finite in the limit:

  c_xt = sigma_prev / sigma_t         (0 at the closing boundary)
  c_x0 = alpha_prev * (1 - exp(-h))   (alpha_prev when h = +inf)
  cm   = h / (2 h_prev)               (0 when either gap is infinite: the
                                       step after the pure-noise step is
                                       first order)

`step_carry` threads the previous step's x0 (float32) as the multistep
history.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import numpy as np
import torch

from mmgt_tpu_torch.diffusion.schedules import (
    ScheduleTables,
    ddim_timesteps,
    make_beta_schedule,
    rescale_zero_terminal_snr,
)
from mmgt_tpu_torch.diffusion.solver import SolverTables, solver_step


class DPMState(NamedTuple):
    """Per-run tables, each (S,)."""

    timesteps: np.ndarray  # int32, descending train timesteps
    alpha_t: np.ndarray    # sqrt(alpha_prod[t])
    sigma_t: np.ndarray    # sqrt(1 - alpha_prod[t])
    c_xt: np.ndarray       # sigma_prev / sigma_t
    c_x0: np.ndarray       # alpha_prev * (1 - exp(-h))
    cm: np.ndarray         # second-order coefficient h / (2 h_prev)
    use2: np.ndarray       # 0/1: apply the multistep correction


@dataclasses.dataclass(frozen=True)
class DPMSolverPlusPlus2M:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"
    prediction_type: str = "v_prediction"  # "epsilon" | "sample" | "v_prediction"
    rescale_betas_zero_snr: bool = True
    timestep_spacing: str = "trailing"
    steps_offset: int = 1
    lower_order_final: bool = True  # first-order closing step

    def __post_init__(self):
        betas = make_beta_schedule(self.beta_schedule, self.num_train_timesteps,
                                   self.beta_start, self.beta_end)
        if self.rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        object.__setattr__(self, "tables", ScheduleTables(betas))

    def init(self, num_inference_steps: int) -> DPMState:
        S = num_inference_steps
        ts = ddim_timesteps(self.num_train_timesteps, S, self.timestep_spacing,
                            self.steps_offset)
        ap = np.asarray(self.tables.alphas_cumprod, np.float64)[ts]
        # the previous alpha of step i is the next table entry; the closing
        # step integrates to the exact alpha = 1, sigma = 0 boundary
        ap_prev = np.concatenate([ap[1:], [1.0]])
        a_t, s_t = np.sqrt(ap), np.sqrt(1.0 - ap)
        a_p, s_p = np.sqrt(ap_prev), np.sqrt(1.0 - ap_prev)
        with np.errstate(divide="ignore"):
            lam_t = np.log(a_t) - np.log(s_t)   # -inf where alpha == 0
            lam_p = np.log(a_p) - np.log(s_p)   # +inf where sigma_prev == 0
        h = lam_p - lam_t
        c_xt = s_p / s_t
        c_x0 = a_p * (1.0 - np.exp(-h))
        h_prev = np.concatenate([[np.inf], h[:-1]])
        # the correction needs both gaps finite
        ok = np.isfinite(h_prev) & np.isfinite(h)
        with np.errstate(invalid="ignore"):
            cm = np.where(ok, h / (2.0 * np.where(ok, h_prev, 1.0)), 0.0)
        use2 = ok.astype(np.float64)
        use2[0] = 0.0
        if self.lower_order_final and S > 1:
            use2[-1] = 0.0
        f32 = lambda a: np.asarray(a, np.float32)
        return DPMState(np.asarray(ts, np.int32), f32(a_t), f32(s_t), f32(c_xt), f32(c_x0),
                        f32(cm), f32(use2))

    def init_carry(self, latents: torch.Tensor) -> torch.Tensor:
        """Multistep history: the previous step's x0 prediction (f32)."""
        return torch.zeros(latents.shape, dtype=torch.float32, device=latents.device)

    def step_carry(self, state: DPMState, model_output: torch.Tensor, step_index: int,
                   sample: torch.Tensor, carry: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One solver step (float32); `step_index` indexes the tables
        (0 = most noisy). Returns (prev_sample, new carry = x0). The
        tables are `SolverTables`' fields, so this is the generic step."""
        return solver_step(SolverTables(*state), model_output, step_index, sample, carry,
                           self.prediction_type)

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def scale_model_input(self, sample: torch.Tensor, t=None) -> torch.Tensor:
        return sample
