"""DDIM sampler (`mmgt_tpu/diffusion/ddim.py`). The pipeline's default
configuration (v-prediction, zero-terminal-SNR betas, trailing spacing,
eta = 0, no clipping) steps through the table-driven
`diffusion.solver.solver_step`; stochastic (eta > 0) or clipped DDIM steps
through `step` / `step_carry`. `init` builds the per-step host tables
(numpy). `add_noise` and `get_velocity` are the trainer's forward process
and v-target."""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from mmgt_tpu_torch.diffusion.schedules import (
    ScheduleTables,
    ddim_timesteps,
    make_beta_schedule,
    rescale_zero_terminal_snr,
)
from mmgt_tpu_torch.diffusion.solver import _scalar


class DDIMState(NamedTuple):
    timesteps: np.ndarray        # (S,) int32, descending
    alpha_prod: np.ndarray       # (S,) alpha_cumprod[t]
    alpha_prod_prev: np.ndarray  # (S,) alpha_cumprod[t_prev] (1.0 past the end)
    sigma: np.ndarray            # (S,) DDIM sigma_t (0 when eta = 0)


@dataclasses.dataclass(frozen=True)
class DDIMScheduler:
    num_train_timesteps: int = 1000
    beta_start: float = 0.00085
    beta_end: float = 0.012
    beta_schedule: str = "linear"
    prediction_type: str = "v_prediction"  # "epsilon" | "sample" | "v_prediction"
    rescale_betas_zero_snr: bool = True
    timestep_spacing: str = "trailing"
    steps_offset: int = 1
    clip_sample: bool = False
    clip_sample_range: float = 1.0
    set_alpha_to_one: bool = True
    eta: float = 0.0

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
        alpha_prod = ac[ts]
        alpha_prev = np.where(prev_ts >= 0, ac[np.maximum(prev_ts, 0)], final_alpha)
        if self.eta > 0:
            var = (1 - alpha_prev) / (1 - alpha_prod) * (1 - alpha_prod / alpha_prev)
            sigma = self.eta * np.sqrt(np.maximum(var, 0.0))
        else:
            sigma = np.zeros_like(alpha_prod)
        return DDIMState(np.asarray(ts, np.int32), np.asarray(alpha_prod, np.float32),
                         np.asarray(alpha_prev, np.float32), np.asarray(sigma, np.float32))

    def step(self, state: DDIMState, model_output: torch.Tensor, step_index: int,
             sample: torch.Tensor, noise: Optional[torch.Tensor] = None) -> torch.Tensor:
        """One reverse step, all math in float32; `step_index` indexes the
        tables (0 = most noisy). `noise` adds sigma * noise."""
        x, out = sample.float(), model_output.float()
        a_t = _scalar(state.alpha_prod, step_index)
        a_prev = _scalar(state.alpha_prod_prev, step_index)
        sigma = _scalar(state.sigma, step_index)
        sqrt_a_t, sqrt_1m_a_t = torch.sqrt(a_t), torch.sqrt(1.0 - a_t)
        if self.prediction_type == "epsilon":
            x0, eps = (x - sqrt_1m_a_t * out) / sqrt_a_t, out
        elif self.prediction_type == "sample":
            x0 = out
            eps = (x - sqrt_a_t * x0) / sqrt_1m_a_t
        elif self.prediction_type == "v_prediction":
            x0 = sqrt_a_t * x - sqrt_1m_a_t * out
            eps = sqrt_a_t * out + sqrt_1m_a_t * x
        else:
            raise ValueError(self.prediction_type)
        if self.clip_sample:
            x0 = x0.clamp(-self.clip_sample_range, self.clip_sample_range)
            eps = (x - sqrt_a_t * x0) / sqrt_1m_a_t
        dir_xt = torch.sqrt(torch.clamp(1.0 - a_prev - sigma**2, min=0.0)) * eps
        prev = torch.sqrt(a_prev) * x0 + dir_xt
        if noise is not None:
            prev = prev + sigma * noise.float()
        return prev.to(sample.dtype)

    # The sampler interface the pipeline shares with the multistep solver:
    # DDIM is single-step, so its carry is empty. As in the JAX package,
    # `step_carry` passes no noise, so at eta > 0 it shrinks the direction
    # term and adds nothing (ROADMAP.md §3).
    def init_carry(self, latents: torch.Tensor):
        return ()

    def step_carry(self, state, model_output, step_index, sample, carry):
        return self.step(state, model_output, step_index, sample), ()

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

    @property
    def init_noise_sigma(self) -> float:
        return 1.0

    def scale_model_input(self, sample: torch.Tensor, t=None) -> torch.Tensor:
        return sample
