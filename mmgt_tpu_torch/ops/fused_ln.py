"""LayerNorm fused into 1-3 projections: plain version and kernel K3.

    y_i = (LN(x) * gamma + beta) @ W_i^T + b_i

Weights use torch's Linear layout (N_i, C). Math as
`mmgt_tpu/ops/fused_ln.py` (f32 statistics, eps inside the rsqrt, the
normalised row rounded to the weight dtype, f32 accumulation and bias).

K3 (csrc/ln_proj.cu) replaces the TPU kernel
mmgt_tpu/ops/fused_ln.py:_ln_proj_kernel with one launch for all weights:
each block loads a stripe of x rows once by TMA, normalises it in shared
memory, and runs it against every weight tile (streamed through a TMA ring)
on wgmma; the epilogue adds the f32 bias. The tile plan (`gemm_plan`) is
computed here and checked by the C entry. The normalised tensor never
reaches device memory, and x is read once.

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


# K3's tile plan (csrc/ln_proj.cu): a block holds a stripe of BM rows of x
# (all K columns) and a ring of BN x 64 weight tiles in shared memory
SMEM_LIMIT = 232448      # 227 KB a block on the H100
SMS = 132                # streaming multiprocessors of the H100
BN = 160                 # output columns of a tile
MAX_STAGES = 8


def gemm_smem(bm: int, k: int, stages: int) -> int:
    """Shared-memory bytes of a K3 block (as `smem_bytes` in
    csrc/ln_proj.cu): 1024 of alignment slack, the stripe, the two consumer
    warpgroups' bf16 output staging tiles (64 rows x 160 columns at 128-row
    stripes, x 80 at 64-row ones), the weight ring and the mbarriers."""
    kchunks = -(-k // 64)
    wg_cols = BN if bm == 128 else BN // 2
    return (1024 + kchunks * bm * 128 + 2 * 64 * wg_cols * 2 + stages * BN * 128
            + 8 * (2 * stages + 3))


def gemm_plan(m: int, k: int, ns: Sequence[int]) -> dict:
    """K3's tile plan for x (m, k) against weights of ns[i] output columns:
    BM = 128 rows a stripe where a ring of at least two weight tiles fits
    beside it, else 64; as many ring stages as fit (up to 8); the N tiles
    split over enough blocks per stripe to give two waves of 132 SMs.
    Raises where no plan fits 227 KB."""
    if k <= 0 or k % 8 != 0:
        raise ValueError(f"K3 takes K % 8 == 0, got K = {k}")
    if not 1 <= len(ns) <= 3 or any(n <= 0 or n % 8 != 0 for n in ns):
        raise ValueError(f"K3 takes 1-3 weights with N % 8 == 0, got {list(ns)}")
    for bm in (128, 64):
        stages = min(MAX_STAGES, (SMEM_LIMIT - gemm_smem(bm, k, 0)) // (BN * 128 + 16))
        if stages >= 2:
            break
    else:
        raise ValueError(f"K3: a 64-row stripe of K = {k} and two weight tiles do not fit "
                         f"{SMEM_LIMIT} bytes of shared memory")
    tiles = sum(-(-n // BN) for n in ns)
    stripes = max(1, -(-m // bm))
    nsplit = min(tiles, max(1, -(-2 * SMS // stripes)))
    return dict(bm=bm, bn=BN, stages=stages, nsplit=nsplit, smem=gemm_smem(bm, k, stages),
                stripes=stripes, tiles=tiles)


def ln_gemm(x2, gamma, beta, ws, bs, eps: float = 1e-5, res=None):
    """One launch of csrc/ln_proj.cu's kernel on a bf16 (M, K) matrix: the
    LayerNorm of each row (gamma, beta f32) when `gamma` is given, else x
    as it is; the f32 bias and an optional bf16 residual in the epilogue.
    Shared by K3 and K4; it does not count launches itself."""
    m, k = x2.shape
    nw = len(ws)
    if not x2.is_contiguous() or x2.dtype != torch.bfloat16:
        raise ValueError("the GEMM takes a contiguous bf16 (M, K) input")
    for w in ws:
        if w.dtype != torch.bfloat16 or w.dim() != 2 or w.shape[1] != k or not w.is_contiguous():
            raise ValueError(f"weights must be contiguous bf16 (N, {k})")
    plan = gemm_plan(m, k, [w.shape[0] for w in ws])
    res = list(res) if res is not None else [None] * nw
    outs = [torch.empty((m, w.shape[0]), device=x2.device, dtype=torch.bfloat16) for w in ws]
    bias = [None if b is None else b.float().contiguous() for b in bs]
    pad = lambda seq: list(seq) + [None] * (3 - nw)
    w3, b3, r3, o3 = pad(ws), pad(bias), pad(res), pad(outs)
    n3 = [w.shape[0] for w in ws] + [0] * (3 - nw)
    lib = _build.load("ln_proj")
    rc = lib.mmgt_ln_gemm(
        x2.data_ptr(), _build.ptr(gamma), _build.ptr(beta), m, k, float(eps), nw,
        *[_build.ptr(t) for t in w3], *n3,
        *[_build.ptr(t) for t in b3], *[_build.ptr(t) for t in r3],
        *[_build.ptr(t) for t in o3], plan["bm"], plan["stages"], plan["nsplit"], plan["smem"],
        _build.stream_ptr(x2),
    )
    _build.check(lib, rc, "LN-projection GEMM")
    return outs


def _launch(x, gamma, beta, ws, bs, eps):
    global LAUNCHES
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    if not x2.is_contiguous() or x2.dtype != torch.bfloat16:
        raise ValueError("K3 takes a contiguous bf16 input")
    outs = ln_gemm(x2, gamma.float().contiguous(), beta.float().contiguous(), list(ws),
                   list(bs), eps)
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
