"""The step loop the three training CLIs share: draw a batch, take a step
with that step's own generator, log, checkpoint.

A trainer here is anything with `train_step(state, batch, generator=...)`
and `checkpoint_tree(state)` (the Stage-2 trainers and `SMGA`). Each step's
random draws come from a generator seeded by (seed, step), so a run
resumed from a checkpoint draws what an uninterrupted one would have.
"""
from __future__ import annotations

from typing import Callable, Dict, Iterator, Optional

import torch


def step_generator(device, seed: int, step: int) -> torch.Generator:
    """The generator of the draws of the step that starts at `step`."""
    return torch.Generator(device=device).manual_seed(seed * 1_000_003 + step)


def fit(trainer, state, batches: Iterator[Dict], max_steps: int, manager, logger,
        checkpoint_every: int, device, seed: int = 0, log_every: int = 50,
        on_step: Optional[Callable[[int, Dict], None]] = None,
        log_fields: Optional[Callable[[int], Dict]] = None):
    """Steps until `state.step` reaches `max_steps`: the metrics of step 1
    and of every `log_every`-th step to `logger` (with `log_fields(step)`),
    a checkpoint every `checkpoint_every` steps and one at the end;
    `on_step(step, metrics)` after each step. Returns `state`."""
    saved = state.step  # nothing to save when no step runs
    while state.step < max_steps:
        batch = next(batches)
        metrics = trainer.train_step(state, batch,
                                     generator=step_generator(device, seed, state.step))
        step = state.step
        if on_step is not None:
            on_step(step, metrics)
        if step % log_every == 0 or step == 1:
            logger.log(step, {**(log_fields(step) if log_fields else {}), **metrics}, echo=True)
        if step % checkpoint_every == 0:
            manager.save(step, trainer.checkpoint_tree(state))
            saved = step
    if saved != state.step:
        manager.save(state.step, trainer.checkpoint_tree(state))
    return state
