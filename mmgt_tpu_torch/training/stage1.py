"""Stage-1 (SMGA) bundle, the sampling half (`mmgt_tpu/training/stage1.py`):
the GestureDecoder at the reference's widths (8 layers x 512, ff 1024, 8
heads; condition 1059-d WavLM + baseline or 35-d baseline) and its cosine
schedule, with `sample` = DDIM(50, eta = 1) under classifier-free
guidance. Adan, EMA and the train step wait for the Stage-1 trainer.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from mmgt_tpu_torch.diffusion.gesture import GestureDiffusionSchedule
from mmgt_tpu_torch.models.smga import NFEATS, GestureDecoder

HORIZON = 80  # 3.2 s x 25 fps (SMGA.py:64-66)


@dataclasses.dataclass(eq=False)
class SMGA:
    feature_type: str = "wavlm"          # "wavlm" (1024 + 35) or "baseline" (35)
    guidance_weight: float = 2.0
    horizon: int = HORIZON
    model: Optional[GestureDecoder] = None  # default: the reference's widths

    def __post_init__(self):
        if self.feature_type not in ("wavlm", "baseline"):
            raise ValueError(f"unknown feature_type {self.feature_type!r}")
        self.cond_dim = 1024 + 35 if self.feature_type == "wavlm" else 35
        if self.model is None:
            self.model = GestureDecoder(NFEATS, self.horizon, 512, 1024, 8, 8, self.cond_dim)
        self.schedule = GestureDiffusionSchedule(guidance_weight=self.guidance_weight)

    @property
    def device(self) -> torch.device:
        return self.model.final_layer.weight.device

    @torch.no_grad()
    def sample(self, cond_frame: torch.Tensor, cond: torch.Tensor,
               sampling_timesteps: int = 50, generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """cond_frame (B, 402), cond (B, T, Dc) -> sampled poses (B, T, 402),
        on the model's device. `draws`: {"x", "noise"} as
        `GestureDiffusionSchedule.draws` makes them (default: from
        `generator`)."""
        b, t = cond.shape[0], cond.shape[1]
        dtype = self.model.final_layer.weight.dtype
        cf, c = cond_frame.to(self.device, dtype), cond.to(self.device, dtype)

        def denoise_fn(x, tb, w):
            return self.model.guided_forward(x.to(dtype), cf, c, tb, w).float()

        return self.schedule.ddim_sample(denoise_fn, (b, t, NFEATS), sampling_timesteps,
                                         generator=generator, draws=draws, device=self.device)
