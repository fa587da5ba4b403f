"""Profiling and timing helpers: the counterpart of
`mmgt_tpu/utils/profiling.py`.

  * `trace(log_dir)`: a `torch.profiler` window (CPU and CUDA activities)
    that writes a Chrome trace JSON into `log_dir`; `utils/device_trace.py`
    turns it into a table of device time by kernel;
  * `annotate(name)`: a named span in that trace (`record_function`), and
    an NVTX range on a card;
  * `device_time(fn, *args, iters)`: seconds a call, between two CUDA
    events on the card, on the host clock (after waiting for the card)
    for CPU tensors;
  * `StepTimer`: rolling wall-clock means for training loops.

The JAX version chains calls and syncs through a scalar fetch to time a
remote-attached TPU; CUDA events need neither.

    with trace("traces") as path:
        step()
    rows = device_trace.device_op_table(path)
"""
from __future__ import annotations

import contextlib
import os
import tempfile
import time
from pathlib import Path
from typing import Callable, Dict, Iterator

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[str]:
    """Profile the block with `torch.profiler` (CPU and, where this build
    supports it, CUDA activity); on exit write its Chrome trace into
    `log_dir`. Yields the path of the trace file (written on exit)."""
    from torch.profiler import ProfilerActivity, profile, supported_activities

    Path(log_dir).mkdir(parents=True, exist_ok=True)
    fd, path = tempfile.mkstemp(prefix="trace-", suffix=".json", dir=log_dir)
    os.close(fd)
    acts = [a for a in (ProfilerActivity.CPU, ProfilerActivity.CUDA)
            if a in supported_activities()]
    with profile(activities=acts) as prof:
        yield path
    prof.export_chrome_trace(path)


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """A named span: a `record_function` range in the profiler's trace and,
    when a card is present, an NVTX range."""
    with torch.profiler.record_function(name):
        if not torch.cuda.is_available():
            yield
            return
        torch.cuda.nvtx.range_push(name)
        try:
            yield
        finally:
            torch.cuda.nvtx.range_pop()


def _leaves(obj):
    if isinstance(obj, torch.Tensor):
        yield obj
    elif isinstance(obj, (list, tuple)):
        for o in obj:
            yield from _leaves(o)
    elif isinstance(obj, dict):
        for o in obj.values():
            yield from _leaves(o)


def device_time(fn: Callable, *args, iters: int = 10) -> float:
    """Seconds a call of fn(*args): one untimed call, then `iters` calls,
    timed between two CUDA events when an argument or the result lies on
    the card, else on the host clock, which waits for the card before and
    after when there is one (fn may launch work there all the same)."""
    out = fn(*args)
    card = torch.cuda.is_available()
    if any(t.is_cuda for t in _leaves((args, out))):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn(*args)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / 1e3 / iters
    if card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(iters):
        fn(*args)
    if card:
        torch.cuda.synchronize()
    return (time.perf_counter() - t0) / iters


class StepTimer:
    """Rolling wall-clock stats for training loops (data vs step time,
    like the reference's `td` postfix, train_stage_2.py:722-724)."""

    def __init__(self, window: int = 50):
        self.window = window
        self._samples: Dict[str, list] = {}
        self._marks: Dict[str, float] = {}

    def mark(self, name: str):
        self._marks[name] = time.time()

    def lap(self, name: str):
        now = time.time()
        if name in self._marks:
            self._samples.setdefault(name, []).append(now - self._marks[name])
            self._samples[name] = self._samples[name][-self.window :]
        self._marks[name] = now

    def means(self) -> Dict[str, float]:
        return {k: sum(v) / len(v) for k, v in self._samples.items() if v}
