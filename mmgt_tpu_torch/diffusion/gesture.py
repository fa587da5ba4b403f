"""Stage-1 (SMGA) motion diffusion, the sampling half
(`mmgt_tpu/diffusion/gesture.py`): cosine DDPM with T = 1000, the network
predicting x0, 50-step eta = 1 DDIM with x0 clipped to [-1, 1] and the
guidance weight clipped near the end of the chain (reference
diffusion.py:169-176,242-274). The loss waits for the Stage-1 trainer.

Randomness: the JAX package draws the initial x and one normal per step
from split keys. Here the draws are explicit: `draws(shape, steps,
generator)` gives {"x": (shape), "noise": (steps, *shape)} from a
`torch.Generator`, and `ddim_sample` takes them (or makes them), so a test
can feed in the numbers JAX's keys give.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mmgt_tpu_torch.diffusion.schedules import ScheduleTables, make_beta_schedule

# keypoint layout: 134 keypoints x (x, y, score); the face block is flat
# dims 72:276 (reference diffusion.py:332-333)
HEAD_SLICE = (72, 276)


class GestureDiffusionSchedule:
    def __init__(self, n_timestep: int = 1000, schedule: str = "cosine",
                 clip_denoised: bool = True, guidance_weight: float = 2.0):
        self.n_timestep = n_timestep
        self.clip_denoised = clip_denoised
        self.guidance_weight = guidance_weight
        self.tables = ScheduleTables(make_beta_schedule(schedule, n_timestep))
        self._device_tables = {}  # device -> the eps tables, copied to it once

    def guidance_weight_at(self, t: int) -> float:
        """The CFG weight, clipped to 1 near the end of the chain."""
        w = self.guidance_weight
        return min(w, 1.0) if t < 0.1 * self.n_timestep else w

    def predict_noise_from_start(self, x_t, t, x0):
        """eps from x_t and the predicted x0; t (B,) timesteps."""
        tabs = self._device_tables.get(x_t.device)
        if tabs is None:
            tabs = self._device_tables[x_t.device] = tuple(
                torch.from_numpy(a).to(x_t.device) for a in (
                    self.tables.sqrt_recip_alphas_cumprod,
                    self.tables.sqrt_recipm1_alphas_cumprod))
        recip, recipm1 = (a[t][:, None, None] for a in tabs)
        return (recip * x_t - x0) / recipm1

    def timestep_pairs(self, sampling_timesteps: int):
        """(t, t_next) of each step: linspace(-1, T-1, S+1) reversed."""
        times = np.linspace(-1, self.n_timestep - 1, sampling_timesteps + 1).astype(np.int64)
        times = list(reversed(times.tolist()))
        return list(zip(times[:-1], times[1:]))

    @staticmethod
    def draws(shape: Tuple[int, ...], sampling_timesteps: int,
              generator: Optional[torch.Generator] = None, device=None) -> Dict[str, torch.Tensor]:
        """The sampler's random numbers: the initial x and one normal a step
        (the last step's is drawn but unused, as in the JAX package)."""
        return {"x": torch.randn(shape, generator=generator, device=device),
                "noise": torch.randn((sampling_timesteps, *shape), generator=generator,
                                     device=device)}

    def ddim_sample(self, denoise_fn: Callable, shape: Tuple[int, ...],
                    sampling_timesteps: int = 50, eta: float = 1.0,
                    generator: Optional[torch.Generator] = None,
                    draws: Optional[Dict[str, torch.Tensor]] = None, device=None):
        """DDIM sampling, `denoise_fn(x, t (B,), guidance_weight) -> x0`.
        The step coefficients are f32 host scalars from the f32 tables, as
        the JAX scan computes them on the device."""
        if draws is None:
            draws = self.draws(shape, sampling_timesteps, generator, device)
        x = draws["x"].to(device).float()
        ac = self.tables.alphas_cumprod
        one, zero, eta32 = np.float32(1.0), np.float32(0.0), np.float32(eta)
        for (t, t_next), noise in zip(self.timestep_pairs(sampling_timesteps), draws["noise"]):
            tb = torch.full((shape[0],), t, dtype=torch.long, device=x.device)
            x0 = denoise_fn(x, tb, self.guidance_weight_at(t))
            if self.clip_denoised:
                x0 = x0.clamp(-1.0, 1.0)
            if t_next < 0:  # the final step returns x0 (diffusion.py:259-260)
                x = x0
                continue
            eps = self.predict_noise_from_start(x, tb, x0)
            alpha, alpha_next = ac[t], ac[t_next]
            sigma = eta32 * np.sqrt(np.maximum(
                (one - alpha / alpha_next) * (one - alpha_next) / (one - alpha), zero))
            c = np.sqrt(np.maximum(one - alpha_next - sigma**2, zero))
            x = x0 * float(np.sqrt(alpha_next)) + float(c) * eps + float(sigma) * noise.to(x)
        return x
