"""LayerNorm fused into 1-3 projections: plain version and kernel K3.

    y_i = (LN(x) * gamma + beta) @ W_i^T + b_i

Weights use torch's Linear layout (N_i, C). Math as
`mmgt_tpu/ops/fused_ln.py` (f32 statistics, eps inside the rsqrt, the
normalised row rounded to the weight dtype, f32 accumulation and bias).

K3 (csrc/ln_proj.cu) replaces the TPU kernel
mmgt_tpu/ops/fused_ln.py:_ln_proj_kernel: a row-statistics pass, then one
hand-written tiled GEMM launch for all weights whose A-tile loader
normalises x on its way into shared memory and whose epilogue adds the
bias in f32. Bound on the H100: operations (the product). The normalised
tensor never reaches device memory.

On a CPU tensor `ln_projections` runs `ln_projections_plain`; on a CUDA
tensor it launches K3 or raises. Gradients (x, gamma, beta, each weight and
bias): the forward still runs K3 and the backward is autograd through
`ln_projections_plain`, recomputed, as the JAX package's
`_ln_projections_bwd` (`ops/_vjp.py`).
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch

from mmgt_tpu_torch.ops import _build
from mmgt_tpu_torch.ops._vjp import kernel_with_plain_vjp, needs_grad

LAUNCHES = 0  # K3 launches (one per ln_projections call on the card)


def ln_projections_plain(x, gamma, beta, ws, bs, eps: float = 1e-5):
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    xn = (xc * torch.rsqrt(var + eps) * gamma.float() + beta.float()).to(ws[0].dtype)
    outs = []
    for w, b in zip(ws, bs):
        y = xn.float() @ w.float().t()
        if b is not None:
            y = y + b.float()
        outs.append(y.to(x.dtype))
    return tuple(outs)


def ln_gemm(x2, stats, gamma, beta, ws, bs, res=None, pe=None, tokens=1, frames=1,
            f32_out=(False, False, False)):
    """One launch of csrc/ln_proj.cu's GEMM on a (M, K) bf16 matrix: the LN
    prologue when `stats` is given (plus pe[(m // tokens) % frames]), bias
    and optional residual in the epilogue. Shared by K3 and K4; it does
    not count launches itself."""
    m, k = x2.shape
    nw = len(ws)
    if not 1 <= nw <= 3:
        raise ValueError("1 to 3 weights per launch")
    if k % 8 != 0 or not x2.is_contiguous() or x2.dtype != torch.bfloat16:
        raise ValueError("the GEMM takes a contiguous bf16 (M, K) input with K % 8 == 0")
    for w in ws:
        if w.dtype != torch.bfloat16 or w.shape[1] != k or not w.is_contiguous():
            raise ValueError(f"weights must be contiguous bf16 (N, {k})")
    res = list(res) if res is not None else [None] * nw
    outs = [
        torch.empty((m, w.shape[0]), device=x2.device,
                    dtype=torch.float32 if f32_out[i] else torch.bfloat16)
        for i, w in enumerate(ws)
    ]
    bias = [None if b is None else b.float().contiguous() for b in bs]
    pad = lambda seq: list(seq) + [None] * (3 - nw)
    w3, b3, r3, o3 = pad(ws), pad(bias), pad(res), pad(outs)
    n3 = [w.shape[0] for w in ws] + [0] * (3 - nw)
    mask = sum(1 << i for i in range(nw) if f32_out[i])
    lib = _build.load("ln_proj")
    rc = lib.mmgt_ln_gemm(
        x2.data_ptr(), _build.ptr(stats), _build.ptr(gamma), _build.ptr(beta),
        _build.ptr(pe), m, k, tokens, frames, nw,
        *[_build.ptr(t) for t in w3], *n3,
        *[_build.ptr(t) for t in b3], *[_build.ptr(t) for t in r3],
        *[_build.ptr(t) for t in o3], mask, _build.stream_ptr(x2),
    )
    _build.check(lib, rc, "LN-projection GEMM")
    return outs


def row_stats(x2, eps: float):
    """(M, 2) f32 mean and rstd of each row of a bf16 (M, K) matrix."""
    stats = torch.empty((x2.shape[0], 2), dtype=torch.float32, device=x2.device)
    lib = _build.load("ln_proj")
    rc = lib.mmgt_ln_stats(x2.data_ptr(), stats.data_ptr(), x2.shape[0], x2.shape[1],
                           float(eps), _build.stream_ptr(x2))
    _build.check(lib, rc, "LayerNorm statistics")
    return stats


def _launch(x, gamma, beta, ws, bs, eps):
    global LAUNCHES
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    if not x2.is_contiguous() or x2.dtype != torch.bfloat16:
        raise ValueError("K3 takes a contiguous bf16 input")
    stats = row_stats(x2, eps)
    outs = ln_gemm(x2, stats, gamma.float().contiguous(), beta.float().contiguous(),
                   list(ws), list(bs))
    LAUNCHES += 1
    return tuple(o.reshape(*x.shape[:-1], o.shape[-1]) for o in outs)


def ln_projections(x: torch.Tensor, gamma: torch.Tensor, beta: torch.Tensor,
                   ws: Sequence[torch.Tensor], bs: Sequence[Optional[torch.Tensor]],
                   eps: float = 1e-5) -> Tuple[torch.Tensor, ...]:
    """tuple(LN(x) @ W_i^T + b_i) for x (..., C) and W_i (N_i, C)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no LN-projection kernel for device {x.device}")
    kernel = ln_projections_plain if x.device.type == "cpu" else _launch
    if needs_grad(x, gamma, beta, *ws, *bs):
        n = len(ws)
        return kernel_with_plain_vjp(
            lambda x, g, b, eps, *wb: kernel(x, g, b, wb[:n], wb[n:], eps),
            lambda x, g, b, eps, *wb: ln_projections_plain(x, g, b, wb[:n], wb[n:], eps),
            x, gamma, beta, eps, *ws, *bs)
    return kernel(x, gamma, beta, ws, bs, eps)
