"""Adan (`mmgt_tpu/training/adan.py`), the Stage-1 optimizer, over lists of
f32 tensors.

The reference's lucidrains-style semantics exactly (src/audio2pose_model/
adan.py:9-121): `betas` are the (1 - decay) mixing factors (0.02, 0.08,
0.01); the moments are NOT updated on the first step (m, v and n stay 0
and only prev_grad is recorded); bias correction is 1 / (1 - (1 - beta)^step);
weight decay is the division p <- (p - lr * update) / (1 + lr * wd). On the
first step n = 0, so the step size is lr / eps times an update of exact
zeros: p <- p / (1 + lr * wd), with no inf or NaN.

No PyTorch optimizer computes this, so `Adan.step` does it with
`torch._foreach_*` over the parameter list, in place. The corrections are
f32 scalars, as the JAX package computes them from its int32 step.
"""
from __future__ import annotations

from typing import Dict, List, Sequence

import numpy as np
import torch


class Adan:
    """state: `step` (int) and, per parameter, prev_grad, m, v and n (f32,
    zeros at the start)."""

    BUFFERS = ("prev_grad", "m", "v", "n")

    def __init__(self, params: Sequence[torch.Tensor], lr: float = 1e-3,
                 betas=(0.02, 0.08, 0.01), eps: float = 1e-8, weight_decay: float = 0.0):
        self.params: List[torch.Tensor] = list(params)
        self.lr, self.betas, self.eps, self.weight_decay = lr, tuple(betas), eps, weight_decay
        self.step_count = 0
        self.buffers: Dict[str, List[torch.Tensor]] = {
            k: [torch.zeros_like(p) for p in self.params] for k in self.BUFFERS}

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor]) -> None:
        """One update of `self.params` in place from `grads` (one per
        parameter, f32)."""
        b1, b2, b3 = self.betas
        grads = list(grads)
        pg, m, v, n = (self.buffers[k] for k in self.BUFFERS)
        if self.step_count > 0:
            diff = torch._foreach_sub(grads, pg)                      # g - prev_g
            torch._foreach_lerp_(m, grads, b1)                        # m (1-b1) + b1 g
            torch._foreach_lerp_(v, diff, b2)                         # v (1-b2) + b2 (g - pg)
            nx = torch._foreach_add(grads, diff, alpha=1 - b2)        # g + (1-b2)(g - pg)
            torch._foreach_mul_(nx, nx)
            torch._foreach_lerp_(n, nx, b3)
            del diff, nx
        self.step_count += 1
        f32 = np.float32
        step = f32(self.step_count)
        cm, cv, cn = (f32(1.0) / (f32(1.0) - f32(1.0 - b) ** step) for b in (b1, b2, b3))
        denom = 1.0 + self.weight_decay * self.lr
        # update = m cm + (1 - b2) v cv; step size lr / (sqrt(n cn) + eps)
        upd = torch._foreach_mul(m, float(cm))
        torch._foreach_add_(upd, torch._foreach_mul(v, float((1 - b2) * cv)))
        root = torch._foreach_mul(n, float(cn))
        torch._foreach_sqrt_(root)
        torch._foreach_add_(root, self.eps)
        torch._foreach_div_(upd, root)
        del root
        # p <- (p - lr * update) / (1 + lr * wd), applied as p + (new - p)
        # as optax.apply_updates adds the update
        new = torch._foreach_add(self.params, upd, alpha=-self.lr)
        torch._foreach_div_(new, denom)
        torch._foreach_sub_(new, self.params)
        torch._foreach_add_(self.params, new)
        for i, g in enumerate(grads):
            pg[i].copy_(g)
