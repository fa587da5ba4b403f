"""Lmks2Video pipeline (`mmgt_tpu/pipelines/lmks2vid.py`): two landmark
guiders (e.g. upper and lower face-landmark streams) whose features sum
into the denoiser. The summed features replace the base
`Pose2VideoPipeline`'s PoseGuider (`_prepare(pose_feat=...)`, which skips
its forward) and are windowed as its own would be; the denoise loop and
the decode are the base pipeline's. The JAX package's `steps_per_launch`
is a TPU relay feature: all steps run as one chunk.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch
from torch import nn

from mmgt_tpu_torch.models.pose_guider import PoseGuider
from mmgt_tpu_torch.pipelines.pose2vid import (
    Pose2VideoPipeline,
    init_random_params,
    materialize,
)


@dataclasses.dataclass(eq=False)
class Lmks2VideoPipeline:
    base: Pose2VideoPipeline
    guider_a: PoseGuider  # e.g. upper landmarks
    guider_b: PoseGuider  # e.g. lower landmarks

    @classmethod
    def build(cls, dtype: torch.dtype = torch.bfloat16,
              device: Optional[Union[str, torch.device]] = None, seed: int = 0,
              **kwargs) -> "Lmks2VideoPipeline":
        """`Pose2VideoPipeline.build(dtype, device, seed, **kwargs)` and two
        full-width guiders beside it, with seeded random weights."""
        base = Pose2VideoPipeline.build(dtype, device, seed, **kwargs)
        with torch.device("meta"):
            guiders = materialize(dict(guider_a=PoseGuider(), guider_b=PoseGuider()),
                                  base.device, dtype)
        gen = torch.Generator(device=base.device).manual_seed(seed + 1)
        return cls(base, **{n: init_random_params(g, gen) for n, g in guiders.items()})

    def models(self) -> Dict[str, nn.Module]:
        return dict(self.base.models(), guider_a=self.guider_a, guider_b=self.guider_b)

    @torch.no_grad()
    def __call__(self, ref_image, lmks_a_video, lmks_b_video, clip_embed, masks,
                 audio_embeds=None, **kwargs) -> torch.Tensor:
        """lmks_*_video (1, F, H, W, 3) in [0, 1]; the other arguments and
        the result as `Pose2VideoPipeline.__call__`'s."""
        dev, dt = self.base.device, self.base.dtype
        summed = (self.guider_a(lmks_a_video.to(dev, dt))
                  + self.guider_b(lmks_b_video.to(dev, dt)))
        return self.base(ref_image, lmks_a_video, clip_embed, masks, audio_embeds,
                         pose_feat=summed, **kwargs)
