"""A copy of `mmgt_tpu/utils/metrics.py`, with `clip_identity_drift` on
this package's CLIP model.

Training metrics logging (replaces the reference's mlflow/wandb/loss.txt
triple, SURVEY §5.5) — a dependency-free JSONL logger with console echo —
plus inference-quality metrics (PSNR / SSIM / temporal flicker / CLIP
identity drift) used to quantify sampler/step-count configurations
(tools/fewstep_quality.py; the reference evaluates FVD/lip-sync offline
with external toolchains — these are the in-image proxies, PERF.md).
"""
from __future__ import annotations

import json
import sys
import time
from pathlib import Path
from typing import Any, Dict, Optional

import numpy as np
import torch


# ------------------------------------------------------------------ quality
def psnr(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Peak signal-to-noise ratio between two same-shape arrays (dB)."""
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    mse = float(np.mean((a - b) ** 2))
    if mse == 0.0:
        return float("inf")
    return float(10.0 * np.log10(data_range**2 / mse))


def ssim(a: np.ndarray, b: np.ndarray, data_range: float = 1.0) -> float:
    """Mean SSIM (Wang et al. 2004), 8x8 uniform windows, per channel.

    Inputs: (..., H, W, C) in [0, data_range]; leading dims are averaged.
    Uniform (not gaussian) windows — adequate for config-to-config deltas.
    """
    a = np.asarray(a, np.float64)
    b = np.asarray(b, np.float64)
    k1, k2 = 0.01, 0.03
    c1, c2 = (k1 * data_range) ** 2, (k2 * data_range) ** 2
    win = 8
    H, W = a.shape[-3], a.shape[-2]
    hh, ww = H // win, W // win
    # fold each 8x8 tile into one sample: (..., hh, win, ww, win, C)
    at = a[..., : hh * win, : ww * win, :].reshape(
        *a.shape[:-3], hh, win, ww, win, a.shape[-1]
    )
    bt = b[..., : hh * win, : ww * win, :].reshape(
        *b.shape[:-3], hh, win, ww, win, b.shape[-1]
    )
    ax = (-4, -2)
    mu_a, mu_b = at.mean(axis=ax), bt.mean(axis=ax)
    va = at.var(axis=ax)
    vb = bt.var(axis=ax)
    cov = (at * bt).mean(axis=ax) - mu_a * mu_b
    s = ((2 * mu_a * mu_b + c1) * (2 * cov + c2)) / (
        (mu_a**2 + mu_b**2 + c1) * (va + vb + c2)
    )
    return float(s.mean())


def temporal_flicker(video: np.ndarray) -> float:
    """Frame-difference energy sqrt(mean((f[t+1]-f[t])^2)) — higher = more
    temporal flicker. `video`: (F, H, W, C) in [0, 1]."""
    v = np.asarray(video, np.float64)
    if v.shape[0] < 2:
        return 0.0
    return float(np.sqrt(np.mean((v[1:] - v[:-1]) ** 2)))


@torch.no_grad()
def clip_identity_drift(frames_a: np.ndarray, frames_b: np.ndarray, clip_model,
                        batch: int = 16) -> float:
    """Mean per-frame cosine distance between CLIP image embeddings of two
    renderings of the same clip (identity-drift proxy; the reference's
    identity metric is an offline face-embedding pipeline). Frames in [0,1];
    `clip_model` is this package's `CLIPVisionModel` (on its own device)."""
    from mmgt_tpu_torch.models.clip_vision import clip_preprocess

    w = clip_model.visual_projection.weight

    def embed(imgs):
        x = clip_preprocess(torch.from_numpy(np.asarray(imgs, np.float32)).to(w.device))
        e = clip_model(x.to(w.dtype))
        e = e.reshape(e.shape[0], -1).float()
        return (e / torch.linalg.vector_norm(e, dim=-1, keepdim=True)).cpu().numpy()

    dists = []
    for o in range(0, len(frames_a), batch):
        ea, eb = embed(frames_a[o : o + batch]), embed(frames_b[o : o + batch])
        dists.append(1.0 - (ea * eb).sum(-1))
    return float(np.concatenate(dists).mean())


class MetricsLogger:
    def __init__(self, out_dir: str, name: str = "metrics", echo_every: int = 50,
                 enabled: bool = True):
        """`enabled=False` (the ranks of a mesh other than 0): logs nothing."""
        self.path = Path(out_dir) / f"{name}.jsonl"
        self.enabled = enabled
        self._fh = None
        if enabled:
            self.path.parent.mkdir(parents=True, exist_ok=True)
            self._fh = open(self.path, "a")
        self.echo_every = echo_every
        self._t0 = time.time()

    def log(self, step: int, metrics: Dict[str, Any], echo: Optional[bool] = None):
        if not self.enabled:
            return
        rec = {"step": int(step), "time": round(time.time() - self._t0, 2)}
        for k, v in metrics.items():
            try:
                rec[k] = float(v)
            except (TypeError, ValueError):
                rec[k] = str(v)
        self._fh.write(json.dumps(rec) + "\n")
        self._fh.flush()
        if echo or (echo is None and step % self.echo_every == 0):
            kv = " ".join(f"{k}={v:.5g}" if isinstance(v, float) else f"{k}={v}"
                          for k, v in rec.items() if k != "time")
            print(f"[{rec['time']:.0f}s] {kv}", file=sys.stderr)

    def close(self):
        if self._fh is not None:
            self._fh.close()
