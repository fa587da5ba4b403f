"""Table-driven denoising step (`mmgt_tpu/diffusion/solver.py`).

DDIM with eta = 0 written in (x, x0) form,
    x0 = predict(x, model_output);  prev = c_xt * x + c_x0 * x0,
is the first-order case of DPM-Solver++(2M); the tables carry the
second-order terms (cm, use2) of the multistep solver (`diffusion/dpm.py`).
Tables are float32 numpy arrays; the step runs in torch, float32.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch


class SolverTables(NamedTuple):
    timesteps: np.ndarray  # int32 descending train timesteps
    alpha_t: np.ndarray    # sqrt(alpha_prod[t])
    sigma_t: np.ndarray    # sqrt(1 - alpha_prod[t])
    c_xt: np.ndarray       # sigma_prev / sigma_t
    c_x0: np.ndarray       # alpha_prev - sigma_prev * alpha_t / sigma_t
    cm: np.ndarray         # second-order coefficient
    use2: np.ndarray       # 0/1 gate on the multistep correction


def ddim_tables(timesteps, alpha_prod, alpha_prod_prev) -> SolverTables:
    """Exact DDIM(eta=0) as SolverTables (f64 host math)."""
    ap = np.asarray(alpha_prod, np.float64)
    app = np.asarray(alpha_prod_prev, np.float64)
    a_t, s_t = np.sqrt(ap), np.sqrt(1.0 - ap)
    a_p, s_p = np.sqrt(app), np.sqrt(1.0 - app)
    f32 = lambda a: np.asarray(a, np.float32)
    zeros = np.zeros((len(ap),), np.float32)
    return SolverTables(np.asarray(timesteps, np.int32), f32(a_t), f32(s_t),
                        f32(s_p / s_t), f32(a_p - s_p * a_t / s_t), zeros, zeros.copy())


def solver_tables_for(scheduler, num_inference_steps: int) -> Optional[SolverTables]:
    """SolverTables of a scheduler the generic step covers, else None
    (stochastic or clipped DDIM: the caller steps through the scheduler's
    own `step_carry`)."""
    from mmgt_tpu_torch.diffusion.ddim import DDIMScheduler
    from mmgt_tpu_torch.diffusion.dpm import DPMSolverPlusPlus2M

    if isinstance(scheduler, DPMSolverPlusPlus2M):
        return SolverTables(*scheduler.init(num_inference_steps))
    if isinstance(scheduler, DDIMScheduler):
        if scheduler.eta != 0.0 or scheduler.clip_sample:
            return None
        s = scheduler.init(num_inference_steps)
        return ddim_tables(s.timesteps, s.alpha_prod, s.alpha_prod_prev)
    return None


def _scalar(a, i) -> torch.Tensor:
    return torch.tensor(a[i], dtype=torch.float32)


def predict_x0(tables: SolverTables, model_output, step_index: int, sample,
               prediction_type: str):
    x, out = sample.float(), model_output.float()
    a_t, s_t = _scalar(tables.alpha_t, step_index), _scalar(tables.sigma_t, step_index)
    if prediction_type == "epsilon":
        return (x - s_t * out) / a_t
    if prediction_type == "sample":
        return out
    if prediction_type == "v_prediction":
        return a_t * x - s_t * out
    raise ValueError(prediction_type)


def solver_step(tables: SolverTables, model_output: torch.Tensor, step_index: int,
                sample: torch.Tensor, carry: torch.Tensor,
                prediction_type: str = "v_prediction") -> Tuple[torch.Tensor, torch.Tensor]:
    """One reverse step; returns (prev_sample, new carry = x0)."""
    x = sample.float()
    x0 = predict_x0(tables, model_output, step_index, sample, prediction_type)
    gate = _scalar(tables.use2, step_index) * _scalar(tables.cm, step_index)
    d = x0 + gate * (x0 - carry)
    prev = _scalar(tables.c_xt, step_index) * x + _scalar(tables.c_x0, step_index) * d
    return prev.to(sample.dtype), x0


def init_solver_carry(latents: torch.Tensor) -> torch.Tensor:
    """Multistep history (previous x0; never read while use2[0] = 0)."""
    return torch.zeros(latents.shape, dtype=torch.float32, device=latents.device)
