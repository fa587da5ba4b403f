"""Temporal context-window schedule (a copy of
`mmgt_tpu/pipelines/context.py`): 12-frame overlapping windows per step
with a bit-reversed rotating offset and wrap-around, precomputed into one
(num_steps, num_windows, context_size) int32 array."""
from __future__ import annotations

from typing import List

import numpy as np


def bit_reversed_fraction(val: int, bits: int = 64) -> float:
    """Step index -> [0, 1) by reversing its bits (`ordered_halving`)."""
    return int(f"{val:0{bits}b}"[::-1], 2) / (1 << bits)


def window_indices_for_step(step: int, num_frames: int, context_size: int = 12,
                            context_stride: int = 1, context_overlap: int = 4,
                            closed_loop: bool = True) -> List[List[int]]:
    if num_frames <= context_size:
        return [list(range(num_frames))]
    max_stride = int(np.ceil(np.log2(num_frames / context_size))) + 1
    context_stride = min(context_stride, max_stride)
    frac = bit_reversed_fraction(step)
    windows = []
    for context_step in (1 << np.arange(context_stride)):
        pad = int(round(num_frames * frac))
        start = int(frac * context_step) + pad
        stop = num_frames + pad + (0 if closed_loop else -context_overlap)
        stride = context_size * context_step - context_overlap
        for j in range(start, stop, stride):
            windows.append([e % num_frames
                            for e in range(j, j + context_size * context_step, context_step)])
    return windows


def compute_context_schedule(num_steps: int, num_frames: int, context_size: int = 12,
                             context_stride: int = 1, context_overlap: int = 4,
                             closed_loop: bool = True) -> np.ndarray:
    """(num_steps, num_windows, context_size) int32 schedule; the window
    count must not vary across steps (true for context_stride = 1)."""
    per_step = [
        window_indices_for_step(s, num_frames, context_size, context_stride,
                                context_overlap, closed_loop)
        for s in range(num_steps)
    ]
    counts = {len(w) for w in per_step}
    if len(counts) != 1:
        raise ValueError(f"variable window count across steps ({sorted(counts)}); "
                         "use context_stride=1 for the batched pipeline")
    return np.asarray(per_step, np.int32)
