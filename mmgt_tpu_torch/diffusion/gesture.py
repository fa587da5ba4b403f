"""Stage-1 (SMGA) motion diffusion (`mmgt_tpu/diffusion/gesture.py`):
cosine DDPM with T = 1000, the network predicting x0, 50-step eta = 1 DDIM
with x0 clipped to [-1, 1] and the guidance weight clipped near the end of
the chain (reference diffusion.py:169-176,242-274), and the training loss:
`q_sample`, then the six-term l2 loss {pos, vel, acc} x {all dims, the
head block x HEAD_LOSS_WEIGHT} (diffusion.py:290-372).

Randomness: the JAX package draws from split keys. Here the draws are
explicit: `draws(shape, steps, generator)` gives the sampler's {"x": (shape),
"noise": (steps, *shape)} and `training_draws(shape, generator)` a training
step's {"t", "noise", "keep"} from a `torch.Generator`; `ddim_sample` and
`training_loss` take them, so a test can feed in the numbers JAX's keys
give.
"""
from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from mmgt_tpu_torch.diffusion.schedules import ScheduleTables, make_beta_schedule

# keypoint layout: 134 keypoints x (x, y, score); the face block is flat
# dims 72:276, its loss terms weighted 3x (reference diffusion.py:332-333)
HEAD_SLICE = (72, 276)
HEAD_LOSS_WEIGHT = 3.0


class GestureDiffusionSchedule:
    def __init__(self, n_timestep: int = 1000, schedule: str = "cosine",
                 clip_denoised: bool = True, guidance_weight: float = 2.0):
        self.n_timestep = n_timestep
        self.clip_denoised = clip_denoised
        self.guidance_weight = guidance_weight
        self.tables = ScheduleTables(make_beta_schedule(schedule, n_timestep))
        self._device_tables = {}  # (device, table name) -> the f32 table, copied once

    def _table(self, name: str, device: torch.device) -> torch.Tensor:
        tab = self._device_tables.get((device, name))
        if tab is None:
            tab = self._device_tables[(device, name)] = torch.from_numpy(
                getattr(self.tables, name)).to(device)
        return tab

    def guidance_weight_at(self, t: int) -> float:
        """The CFG weight, clipped to 1 near the end of the chain."""
        w = self.guidance_weight
        return min(w, 1.0) if t < 0.1 * self.n_timestep else w

    def predict_noise_from_start(self, x_t, t, x0):
        """eps from x_t and the predicted x0; t (B,) timesteps."""
        recip, recipm1 = (self._table(n, x_t.device)[t][:, None, None] for n in (
            "sqrt_recip_alphas_cumprod", "sqrt_recipm1_alphas_cumprod"))
        return (recip * x_t - x0) / recipm1

    def q_sample(self, x0, noise, t):
        """x_t = sqrt(abar_t) x0 + sqrt(1 - abar_t) noise; t (B,)."""
        sa, s1a = (self._table(n, x0.device)[t][:, None, None] for n in (
            "sqrt_alphas_cumprod", "sqrt_one_minus_alphas_cumprod"))
        return sa * x0 + s1a * noise

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

    # ---------------------------------------------------------------- training
    def losses(self, model_out: torch.Tensor, target: torch.Tensor
               ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
        """The six-term l2 loss: {pos, vel, acc} over all dims plus
        HEAD_LOSS_WEIGHT x the same over the head block HEAD_SLICE (p2
        weighting is the identity in the reference config)."""

        def mse(a, b):
            return ((a - b) ** 2).mean()

        def three_terms(out, tgt):
            ov, tv = out[:, 1:] - out[:, :-1], tgt[:, 1:] - tgt[:, :-1]
            return (mse(out, tgt), mse(ov, tv),
                    mse(ov[:, 1:] - ov[:, :-1], tv[:, 1:] - tv[:, :-1]))

        pos, vel, acc = three_terms(model_out, target)
        h0, h1 = HEAD_SLICE
        hpos, hvel, hacc = three_terms(model_out[:, :, h0:h1], target[:, :, h0:h1])
        comps = {"pos": pos, "vel": vel, "acc": acc,
                 "head_pos": hpos, "head_vel": hvel, "head_acc": hacc}
        total = pos + vel + acc + HEAD_LOSS_WEIGHT * (hpos + hvel + hacc)
        return total, comps

    def training_draws(self, shape: Tuple[int, ...], cond_drop_prob: float = 0.25,
                       generator: Optional[torch.Generator] = None,
                       device=None) -> Dict[str, torch.Tensor]:
        """One training step's random numbers for x0 of `shape` (B, T, D):
        t (B,) uniform in [0, T), the noise, and keep (B,) = whether each
        row keeps its condition (False with probability cond_drop_prob)."""
        b = shape[0]
        return {"t": torch.randint(0, self.n_timestep, (b,), generator=generator, device=device),
                "noise": torch.randn(shape, generator=generator, device=device),
                "keep": torch.rand((b,), generator=generator, device=device) >= cond_drop_prob}

    def training_loss(self, model_fn: Callable, x0: torch.Tensor, cond_frame: torch.Tensor,
                      cond: torch.Tensor, draws: Dict[str, torch.Tensor]):
        """Noise x0 at the drawn t, run `model_fn(x_noisy, cond_frame, cond,
        t, keep)`, return (loss, components) against x0: the network
        predicts x0 (predict_epsilon=False in the reference config)."""
        dev = x0.device
        t, noise = draws["t"].to(dev), draws["noise"].to(dev, x0.dtype)
        model_out = model_fn(self.q_sample(x0, noise, t), cond_frame, cond, t,
                             draws["keep"].to(dev))
        return self.losses(model_out, x0)
