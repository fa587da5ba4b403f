"""LayerNorm fused into 1-3 projections: plain version and kernel K3.

    y_i = (LN(x) * gamma + beta) @ W_i^T + b_i

Weights use torch's Linear layout (N_i, C). Math as
`mmgt_tpu/ops/fused_ln.py` (f32 statistics, eps inside the rsqrt, the
normalised row rounded to the weight dtype, f32 accumulation and bias).

K3 (csrc/ln_proj.cu) replaces the TPU kernel
mmgt_tpu/ops/fused_ln.py:_ln_proj_kernel with one call for all weights,
in one of two regimes chosen by K (`gemm_plan`, checked by the C entry):
  * stripe (K <= 320, every level-0 width): persistent blocks, one an SM, walk (128-row stripe,
    N split) items. One thread loads the next item's stripe by TMA and
    streams the weight tiles through a ring; three warps normalise the
    stripe in shared memory while the consumers work on the previous item;
    each consumer warpgroup takes its 64 normalised rows into registers
    (wgmma's A fragments) and runs every weight tile from them, two
    accumulators taking turns so that each tile's epilogue (the bias from
    a shared f32 table, K4's residual, a swizzled staging tile stored by
    TMA) runs under the next tile's products. One launch; x is read once
    and the normalised tensor never reaches device memory;
  * tiled (K > 320, any K; the paths' K >= 640): a LayerNorm pre-pass (one warp a row, f32
    statistics, the normalised row rounded to bf16 into an (M, K) scratch
    that `ln_gemm` allocates), then persistent blocks walk 128 x 256 output
    tiles, x and the weights streamed through a TMA ring in 64-column
    chunks; the two 128-column units of a tile may belong to different
    weights.
gamma, beta and the biases are read as the model holds them, bf16 or f32,
and widened to f32 in registers: no cast runs on the host path (other
dtypes raise). What
bounds it: at K = 320 the consumers' issue (the epilogue's work for each
output element beside the products; PERF.md), not the bytes; at K >= 640
the operations, which the tiled GEMM feeds at about 47 bytes of x and
weights from L2 a clock an SM, with the tensor cores idle through each
tile's epilogue; its pre-pass moves x twice more.

On a CPU tensor `ln_projections` runs `ln_projections_plain`; on a CUDA
tensor it launches K3 or raises. Gradients (x, gamma, beta, each weight and
bias): the forward still runs K3 and the backward is autograd through
`ln_projections_plain`, recomputed, as the JAX package's
`_ln_projections_bwd` (`ops/_vjp.py`).
"""
from __future__ import annotations

import functools
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


# K3's tile plans (csrc/ln_proj.cu). Stripe: persistent blocks walk
# (128-row stripe, N split) items; each consumer warpgroup holds its 64 rows
# of the normalised stripe as register A fragments against BN x 64 weight
# tiles streamed through a ring. Tiled: persistent blocks walk 128 x 256
# output tiles through a ring of (128 x 64 x box, two 128 x 64 weight boxes)
# stages.
SMEM_LIMIT = 232448      # 227 KB a block on the H100
SMS = 132                # streaming multiprocessors of the H100
BM = 128                 # rows of a stripe or a tile
STRIPE_MAX_K = 320       # the stripe: up to 5 64-column chunks of A fragments in registers
STRIPE_BN = 80           # output columns of a stripe tile
UNIT = 128               # output columns of a tiled unit (one weight's box)
MAX_STAGES = 16
STG_BUFS = 2             # staging tiles a consumer warpgroup (stripe)
TILED_STAGE = BM * 128 + 2 * UNIT * 128   # bytes of one tiled ring stage
TILED_STAGES = 4


def gemm_smem(regime: str, k: int, stages: int) -> int:
    """Shared-memory bytes of a K3 block (as `stripe_smem` and `tiled_smem`
    in csrc/ln_proj.cu): 1024 of alignment slack; stripe: the 128-row x
    stripe (K rounded up to 64 columns), four 64 x BN bf16 staging tiles
    (two a consumer warpgroup), the weight ring, gamma and beta in f32 and
    the mbarriers (`gemm_plan` adds the bias table); tiled: the ring, two
    64 x 128 staging tiles and the mbarriers (K plays no part)."""
    if regime == "stripe":
        kc = -(-k // 64)
        return (1024 + kc * BM * 128 + 2 * STG_BUFS * 64 * STRIPE_BN * 2
                + stages * STRIPE_BN * 128 + kc * 64 * 8 + 8 * (2 * stages + 5))
    if regime == "tiled":
        return 1024 + stages * TILED_STAGE + 2 * 64 * UNIT * 2 + 8 * (2 * stages + 2)
    raise ValueError(f"K3 has no regime {regime!r}")


def gemm_plan(m: int, k: int, ns: Sequence[int], bias: bool = False) -> dict:
    """K3's plan for x (m, k) against weights of ns[i] output columns, with
    a bias on any of them or not.

    Stripe for K <= 320: 80-column tiles, as many ring stages
    as fit (up to 16) beside an f32 table of the biases (`cols` floats,
    where there is a bias); where the stripes alone leave SMs idle, the N
    tiles are split over that many more items a stripe; min(items, 132)
    persistent blocks. Tiled otherwise (K > 320, any K): 128 x 256 tiles
    of two 128-column units (units of different weights may share a tile),
    a ring of 4 stages, min(tiles, 132) persistent blocks. Keys: regime,
    bm, bn (rows and columns of a block's tile), stages, split (stripe: N
    splits a stripe; tiled: 1), blocks (persistent blocks), smem, stripes
    (row stripes or row tiles), tiles (stripe: N tiles a stripe; tiled:
    tiles in all), items (stripe), units (tiled), cols (the output columns
    the kernel computes, padded). Raises where the kernel cannot take the
    shape. The result is cached and shared: do not modify it."""
    return _gemm_plan(m, k, tuple(ns), bool(bias))


@functools.lru_cache(maxsize=None)
def _gemm_plan(m: int, k: int, ns: Tuple[int, ...], bias: bool) -> dict:
    if k <= 0 or k % 8 != 0:
        raise ValueError(f"K3 takes K % 8 == 0, got K = {k}")
    if not 1 <= len(ns) <= 3 or any(n <= 0 or n % 8 != 0 for n in ns):
        raise ValueError(f"K3 takes 1-3 weights with N % 8 == 0, got {list(ns)}")
    stripes = max(1, -(-m // BM))
    if k <= STRIPE_MAX_K:
        bn = STRIPE_BN
        tiles = sum(-(-n // bn) for n in ns)
        table = 4 * tiles * bn if bias else 0
        stages = min(MAX_STAGES,
                     (SMEM_LIMIT - gemm_smem("stripe", k, 0) - table) // (bn * 128 + 16))
        if stages < 2:
            raise ValueError(f"K3: a bias table of {tiles * bn} columns leaves no ring at K = {k}")
        split = 1 if stripes >= SMS else min(tiles, SMS // stripes)
        items = stripes * split
        return dict(regime="stripe", bm=BM, bn=bn, stages=stages, split=split,
                    blocks=min(items, SMS), smem=gemm_smem("stripe", k, stages) + table,
                    stripes=stripes, tiles=tiles, items=items, cols=tiles * bn)
    units = sum(-(-n // UNIT) for n in ns)
    ntiles = -(-units // 2)
    tiles = stripes * ntiles
    return dict(regime="tiled", bm=BM, bn=2 * UNIT, stages=TILED_STAGES, split=1,
                blocks=min(tiles, SMS), smem=gemm_smem("tiled", k, TILED_STAGES),
                stripes=stripes, tiles=tiles, units=units, cols=ntiles * 2 * UNIT)


def _is_bf16(ts, what: str) -> int:
    """Whether the vectors (gamma and beta, or the biases), which the kernel
    reads as they are, are bf16 (else f32); raises unless they are
    contiguous, 16-byte aligned and all bf16 or all f32."""
    dt = ts[0].dtype
    if dt not in (torch.bfloat16, torch.float32) or not all(
            t.dtype == dt and t.is_contiguous() and t.data_ptr() % 16 == 0 for t in ts):
        raise ValueError(f"K3 reads {what} as contiguous, 16-byte aligned bf16 or f32 "
                         f"vectors of one dtype")
    return int(dt == torch.bfloat16)


def ln_gemm(x2, gamma, beta, ws, bs, eps: float = 1e-5, res=None):
    """One call of csrc/ln_proj.cu on a bf16 (M, K) matrix: the LayerNorm
    of each row when `gamma` is given, else x as it is; the bias and an
    optional bf16 residual in the epilogue. gamma, beta and the biases are
    read as they are: contiguous bf16 or f32, one dtype for gamma and beta
    and one for the biases. Shared by K3 and K4; it does not count launches
    itself."""
    m, k = x2.shape
    nw = len(ws)
    if not x2.is_contiguous() or x2.dtype != torch.bfloat16:
        raise ValueError("the GEMM takes a contiguous bf16 (M, K) input")
    ns = []
    for w in ws:
        if w.dtype != torch.bfloat16 or w.dim() != 2 or w.shape[1] != k or not w.is_contiguous():
            raise ValueError(f"weights must be contiguous bf16 (N, {k})")
        ns.append(w.shape[0])
    given = [b for b in bs if b is not None]
    plan = gemm_plan(m, k, ns, bool(given))
    ln_bf16 = _is_bf16([gamma, beta], "gamma and beta") if gamma is not None else 0
    bias_bf16 = _is_bf16(given, "the biases") if given else 0
    tiled = plan["regime"] == "tiled"
    dev = x2.device
    outs = [torch.empty((m, n), device=dev, dtype=torch.bfloat16) for n in ns]
    # the tiled regime's LayerNorm pre-pass writes the normalised x here
    xn = torch.empty_like(x2) if tiled and gamma is not None else None
    ptr, pad = _build.ptr, [0] * (3 - nw)
    res = res if res is not None else ()
    lib = _build.load("ln_proj")
    rc = lib.mmgt_ln_gemm(
        x2.data_ptr(), ptr(gamma), ptr(beta), m, k, float(eps), nw, ln_bf16, bias_bf16,
        *[w.data_ptr() for w in ws], *pad, *ns, *pad,
        *[ptr(b) for b in bs], *pad, *[ptr(r) for r in res], *[0] * (3 - len(res)),
        *[o.data_ptr() for o in outs], *pad, ptr(xn), int(tiled),
        plan["stages"], plan["split"], plan["blocks"], plan["smem"], _build.stream_ptr(x2),
    )
    _build.check(lib, rc, "LN-projection GEMM")
    return outs


def _launch(x, gamma, beta, ws, bs, eps):
    global LAUNCHES
    c = x.shape[-1]
    x2 = x.reshape(-1, c)
    if not x2.is_contiguous() or x2.dtype != torch.bfloat16:
        raise ValueError("K3 takes a contiguous bf16 input")
    outs = ln_gemm(x2, gamma, beta, ws, bs, eps)
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
