"""Diffusion noise schedules (`mmgt_tpu/diffusion/schedules.py`): numpy,
float64 host math, tables stored as float32 numpy arrays."""
from __future__ import annotations

import numpy as np


def make_beta_schedule(schedule: str, n_timestep: int, beta_start: float = 1e-4,
                       beta_end: float = 2e-2, cosine_s: float = 8e-3) -> np.ndarray:
    """betas[T] in float64 ("linear", "scaled_linear" or "cosine")."""
    if schedule == "linear":
        return np.linspace(beta_start, beta_end, n_timestep, dtype=np.float64)
    if schedule == "scaled_linear":
        return np.linspace(beta_start**0.5, beta_end**0.5, n_timestep, dtype=np.float64) ** 2
    if schedule == "cosine":
        steps = np.arange(n_timestep + 1, dtype=np.float64) / n_timestep + cosine_s
        alphas = np.cos(steps / (1 + cosine_s) * np.pi / 2) ** 2
        alphas = alphas / alphas[0]
        return np.clip(1.0 - alphas[1:] / alphas[:-1], 0.0, 0.999)
    raise ValueError(f"unknown beta schedule: {schedule!r}")


def alphas_cumprod_from_betas(betas: np.ndarray) -> np.ndarray:
    return np.cumprod(1.0 - betas, axis=0)


def rescale_zero_terminal_snr(betas: np.ndarray) -> np.ndarray:
    """Rescale betas so the terminal SNR is exactly zero (Lin et al.)."""
    sqrt_ac = np.sqrt(alphas_cumprod_from_betas(betas))
    first, last = sqrt_ac[0], sqrt_ac[-1]
    sqrt_ac = (sqrt_ac - last) * first / (first - last)
    ac = sqrt_ac**2
    alphas = np.concatenate([ac[:1], ac[1:] / ac[:-1]])
    return 1.0 - alphas


def ddim_timesteps(num_train_timesteps: int, num_inference_steps: int,
                   spacing: str = "trailing", steps_offset: int = 0) -> np.ndarray:
    """Descending integer timesteps for DDIM sampling."""
    T, S = num_train_timesteps, num_inference_steps
    if spacing == "trailing":
        ts = np.round(np.arange(T, 0, -T / S)).astype(np.int64) - 1
    elif spacing == "leading":
        ts = (np.arange(S) * (T // S)).round().astype(np.int64)[::-1] + steps_offset
    elif spacing == "linspace":
        ts = np.linspace(0, T - 1, S).round().astype(np.int64)[::-1]
    else:
        raise ValueError(f"unknown timestep spacing: {spacing!r}")
    return ts.astype(np.int32)


class ScheduleTables:
    """Per-timestep tables the sampler and the trainer need."""

    def __init__(self, betas: np.ndarray):
        betas = betas.astype(np.float64)
        ac = np.cumprod(1.0 - betas)
        self.num_train_timesteps = len(betas)
        self.betas = betas.astype(np.float32)
        self.alphas_cumprod = ac.astype(np.float32)
        self.sqrt_alphas_cumprod = np.sqrt(ac).astype(np.float32)
        self.sqrt_one_minus_alphas_cumprod = np.sqrt(1 - ac).astype(np.float32)
        self.snr = (ac / (1.0 - ac)).astype(np.float32)
        with np.errstate(divide="ignore"):  # zero-terminal-SNR schedules end at ac = 0
            self.sqrt_recip_alphas_cumprod = np.sqrt(1.0 / ac).astype(np.float32)
            self.sqrt_recipm1_alphas_cumprod = np.sqrt(1.0 / ac - 1.0).astype(np.float32)
