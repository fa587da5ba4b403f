"""Latent-space temporal interpolation (`mmgt_tpu/pipelines/interp.py`):
slerp-inserted in-between frames, the reference's optional frame-rate
upsampling."""
from __future__ import annotations

import torch


def slerp(v0: torch.Tensor, v1: torch.Tensor, t: float,
          dot_threshold: float = 0.9995) -> torch.Tensor:
    """Spherical linear interpolation over the flattened tensors, in f32;
    linear where they are nearly parallel."""
    f0, f1 = v0.float().reshape(-1), v1.float().reshape(-1)
    n0 = f0 / torch.clamp(torch.linalg.norm(f0), min=1e-12)
    n1 = f1 / torch.clamp(torch.linalg.norm(f1), min=1e-12)
    dot = torch.clamp((n0 * n1).sum(), -1.0, 1.0)
    theta = torch.arccos(dot)
    sin_theta = torch.clamp(torch.sin(theta), min=1e-12)
    sl = torch.sin((1.0 - t) * theta) / sin_theta * f0 + torch.sin(t * theta) / sin_theta * f1
    lerp = (1.0 - t) * f0 + t * f1
    out = torch.where(dot.abs() > dot_threshold, lerp, sl)
    return out.reshape(v0.shape).to(v0.dtype)


def interpolate_latents(latents: torch.Tensor, interpolation_factor: int) -> torch.Tensor:
    """(F, h, w, c) -> (F + (F - 1)(factor - 1), h, w, c)."""
    if interpolation_factor < 2:
        return latents
    out = [latents[0]]
    for i in range(1, latents.shape[0]):
        for k in range(1, interpolation_factor):
            out.append(slerp(latents[i - 1], latents[i], k / interpolation_factor))
        out.append(latents[i])
    return torch.stack(out)
