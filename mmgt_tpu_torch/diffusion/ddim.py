"""DDIM sampler (`mmgt_tpu/diffusion/ddim.py`), the pipeline's default
configuration: v-prediction, zero-terminal-SNR betas, trailing spacing,
eta = 0, no clipping. `init` builds the per-step host tables (numpy); the
step itself is the table-driven `diffusion.solver.solver_step`. Stochastic
or clipped DDIM (Stage 1) waits for a later slice. `add_noise` and
`get_velocity` are the trainer's forward process and v-target."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple

import numpy as np
import torch

from mmgt_tpu_torch.diffusion.schedules import (
    ScheduleTables,
    ddim_timesteps,
    make_beta_schedule,
    rescale_zero_terminal_snr,
)


class DDIMState(NamedTuple):
    timesteps: np.ndarray        # (S,) int32, descending
    alpha_prod: np.ndarray       # (S,) alpha_cumprod[t]
    alpha_prod_prev: np.ndarray  # (S,) alpha_cumprod[t_prev] (1.0 past the end)


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"
    prediction_type: str = "v_prediction"
    rescale_betas_zero_snr: bool = True
    timestep_spacing: str = "trailing"
    steps_offset: int = 1
    set_alpha_to_one: bool = True

    def __post_init__(self):
        betas = make_beta_schedule(self.beta_schedule, self.num_train_timesteps,
                                   self.beta_start, self.beta_end)
        if self.rescale_betas_zero_snr:
            betas = rescale_zero_terminal_snr(betas)
        object.__setattr__(self, "tables", ScheduleTables(betas))

    def init(self, num_inference_steps: int) -> DDIMState:
        ts = ddim_timesteps(self.num_train_timesteps, num_inference_steps,
                            self.timestep_spacing, self.steps_offset)
        ac = self.tables.alphas_cumprod
        prev_ts = ts - self.num_train_timesteps // num_inference_steps
        final_alpha = 1.0 if self.set_alpha_to_one else float(ac[0])
        alpha_prev = np.where(prev_ts >= 0, ac[np.maximum(prev_ts, 0)], final_alpha)
        return DDIMState(np.asarray(ts, np.int32), np.asarray(ac[ts], np.float32),
                         np.asarray(alpha_prev, np.float32))

    def _coefs(self, x0: torch.Tensor, t: torch.Tensor):
        """sqrt(ac[t]) and sqrt(1 - ac[t]), shaped t.shape + 1s to x0's rank."""
        shape = tuple(t.shape) + (1,) * (x0.ndim - t.ndim)
        idx = t.long().cpu()
        sa = torch.from_numpy(self.tables.sqrt_alphas_cumprod)[idx]
        s1a = torch.from_numpy(self.tables.sqrt_one_minus_alphas_cumprod)[idx]
        return sa.reshape(shape).to(x0.device), s1a.reshape(shape).to(x0.device)

    def add_noise(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor):
        sa, s1a = self._coefs(x0, t)
        return sa * x0 + s1a * noise

    def get_velocity(self, x0: torch.Tensor, noise: torch.Tensor, t: torch.Tensor):
        sa, s1a = self._coefs(x0, t)
        return sa * noise - s1a * x0
