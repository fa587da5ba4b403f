"""Image ops (`mmgt_tpu/ops/image.py`): separable Gaussian blur, linear
resize, min-max normalisation and the mask pyramid, on the pipeline's
device.

  * `resize_linear` is `jax.image.resize(..., "linear")` with its default
    antialias (when an axis shrinks, the triangle kernel widens by the
    factor, so every input sample contributes): `F.interpolate` in
    bilinear mode with `antialias=True` computes the same weights, with a
    1-D resize put in as (1, N, 1, T);
  * `gaussian_blur` is a linear map along one axis at a time, a small
    (n, n) matrix built on the host in float64 with cv2's BORDER_REFLECT_101
    padding folded in, copied to each device once and applied with one f32
    matrix product per axis. A product rather than a cuDNN convolution
    keeps the f32 blur out of TF32, which cuDNN would use by default.
"""
from __future__ import annotations

import functools
from typing import Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def _cv2_sigma(ksize: int) -> float:
    """cv2.GaussianBlur's automatic sigma for sigma=0."""
    return 0.3 * ((ksize - 1) * 0.5 - 1) + 0.8


def gaussian_kernel(ksize: int, sigma: float = 0.0) -> np.ndarray:
    if sigma <= 0:
        sigma = _cv2_sigma(ksize)
    x = np.arange(ksize, dtype=np.float64) - (ksize - 1) / 2
    k = np.exp(-(x**2) / (2 * sigma**2))
    return k / k.sum()


@functools.lru_cache(maxsize=64)
def blur_matrix(n: int, ksize: int, sigma: float = 0.0) -> np.ndarray:
    """(n, n) f32: a 1-D Gaussian over n samples with reflect-101 padding
    (the kernel is symmetric, so correlation and convolution agree)."""
    k = gaussian_kernel(ksize, sigma)
    pad = ksize // 2
    if pad >= n:
        raise ValueError(f"a {ksize}-tap blur needs more than {pad} samples, got {n}")
    m = np.zeros((n, n), np.float64)
    for i in range(n):
        for j, kv in enumerate(k):
            p = i + j - pad
            p = -p if p < 0 else (2 * (n - 1) - p if p > n - 1 else p)
            m[i, p] += kv
    return m.astype(np.float32)


@functools.lru_cache(maxsize=64)
def _blur_matrix_on(n: int, ksize: int, sigma: float, device: torch.device) -> torch.Tensor:
    return torch.from_numpy(blur_matrix(n, ksize, sigma)).to(device)


def apply_axis(x: torch.Tensor, m: torch.Tensor, dim: int) -> torch.Tensor:
    """x with axis `dim` mapped through the (out, in) matrix m, in f32."""
    y = torch.matmul(x.float().movedim(dim, -1), m.T)
    return y.movedim(-1, dim)


def resize_linear(x: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """`jax.image.resize(x, shape, "linear")` for up to two changing axes:
    each is resized (antialiased when it shrinks); f32 in, x's dtype out."""
    if len(shape) != x.dim():
        raise ValueError(f"shape {tuple(shape)} does not match {x.dim()} dims")
    axes = [d for d in range(x.dim()) if x.shape[d] != shape[d]]
    if not axes:
        return x
    if len(axes) > 2:
        raise ValueError(f"resize_linear changes at most two axes, got {len(axes)}")
    last = list(range(x.dim() - len(axes), x.dim()))
    y = x.float().movedim(axes, last)
    lead, size = y.shape[:-len(axes)], [shape[d] for d in axes]
    if len(axes) == 1:
        y, size = y.reshape(1, -1, 1, y.shape[-1]), [1] + size
    else:
        y = y.reshape(1, -1, *y.shape[-2:])
    y = F.interpolate(y, size=size, mode="bilinear", align_corners=False, antialias=True)
    y = y.reshape(*lead, *size[-len(axes):]).movedim(last, axes)
    return y.to(x.dtype)


def gaussian_blur(img: torch.Tensor, ksize: int, sigma: float = 0.0) -> torch.Tensor:
    """Separable Gaussian blur over the trailing two axes of (..., H, W),
    along W first, then H; reflect-101 borders (cv2's default)."""
    h, w = img.shape[-2:]
    x = apply_axis(img, _blur_matrix_on(w, ksize, sigma, img.device), -1)
    return apply_axis(x, _blur_matrix_on(h, ksize, sigma, img.device), -2).to(img.dtype)


def resize_bilinear(img: torch.Tensor, hw: Tuple[int, int]) -> torch.Tensor:
    """Bilinear resize of (..., H, W)."""
    return resize_linear(img, tuple(img.shape[:-2]) + tuple(hw))


def normalize_minmax(x: torch.Tensor, axis=None) -> torch.Tensor:
    """Min-max normalise to [0, 1]; `axis` as in the JAX package (the
    reference's blur_mask normalises each frame: axis=(-2, -1))."""
    if axis is None:
        lo, hi = x.amin(), x.amax()
    else:
        lo, hi = x.amin(dim=axis, keepdim=True), x.amax(dim=axis, keepdim=True)
    return (x - lo) / torch.clamp(hi - lo, min=1e-8)


def mask_pyramid(mask64: torch.Tensor, levels: int = 4) -> list:
    """(..., 64, 64) mask -> flattened [(..., 4096), (..., 1024), (..., 256),
    (..., 64)] (the reference's attn_transform_{64,32,16,8} stack)."""
    out = []
    h = mask64.shape[-1]
    for lv in range(levels):
        m = mask64 if lv == 0 else resize_bilinear(mask64, (h >> lv, h >> lv))
        out.append(m.reshape(*m.shape[:-2], -1))
    return out

