"""Training-loss weightings for Stage 2 (a copy of `mmgt_tpu/diffusion/losses.py`)."""
from __future__ import annotations

import torch

from mmgt_tpu_torch.diffusion.schedules import ScheduleTables


def min_snr_weight(tables: ScheduleTables, t: torch.Tensor, gamma: float = 5.0,
                   prediction_type: str = "v_prediction") -> torch.Tensor:
    """Min-SNR-gamma loss weight: min(snr, gamma) / (snr + 1) for
    v-prediction, min(snr, gamma) / snr for epsilon."""
    snr = torch.from_numpy(tables.snr)[t.long().cpu()].to(t.device)
    clipped = torch.clamp(snr, max=gamma)
    if prediction_type == "v_prediction":
        return clipped / (snr + 1.0)
    return clipped / torch.clamp(snr, min=1e-8)
