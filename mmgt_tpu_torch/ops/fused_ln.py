"""LayerNorm fused into 1-3 projections: plain version and kernel K3.

    y_i = (LN(x) * gamma + beta) @ W_i^T + b_i

Weights use torch's Linear layout (N_i, C). Math as
`mmgt_tpu/ops/fused_ln.py` (f32 statistics, eps inside the rsqrt, the
normalised row rounded to the weight dtype, f32 accumulation and bias).

K3 (csrc/ln_proj.cu) replaces the TPU kernel
mmgt_tpu/ops/fused_ln.py:_ln_proj_kernel with one call for all weights,
in one of two regimes chosen by K (`gemm_plan`, checked by the C entry):
  * stripe (K <= 576): each block loads a 128-row stripe of x once by TMA,
    normalises it in shared memory, and runs it against every weight tile
    (streamed through a TMA ring) on wgmma; one launch, and the normalised
    tensor never reaches device memory;
  * tiled (K >= 640, any K): a LayerNorm pre-pass (one warp a row, f32
    statistics, the normalised row rounded to bf16 into an (M, K) scratch
    that `ln_gemm` allocates), then persistent blocks walk 128 x 256 output
    tiles, x and the weights streamed through a TMA ring in 64-column
    chunks; the two 128-column units of a tile may belong to different
    weights.
The epilogue adds the f32 bias (and K4's residual). What bounds it: at
K = 320 the bytes (x, the outputs); at K >= 640 the operations, which the
tiled GEMM feeds at about 47 bytes of x and weights from L2 a clock an
SM, with the tensor cores idle through each tile's epilogue; its
pre-pass moves x twice more.

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


# K3's tile plans (csrc/ln_proj.cu). Stripe: a block holds a stripe of 128
# rows of x (all K columns) and a ring of 160 x 64 weight tiles. Tiled:
# persistent blocks walk 128 x 256 output tiles through a ring of (128 x 64
# x box, two 128 x 64 weight boxes) stages.
SMEM_LIMIT = 232448      # 227 KB a block on the H100
SMS = 132                # streaming multiprocessors of the H100
BM = 128                 # rows of a stripe or a tile
BN = 160                 # output columns of a stripe tile
UNIT = 128               # output columns of a tiled unit (one weight's box)
MAX_STAGES = 8
TILED_STAGE = BM * 128 + 2 * UNIT * 128   # bytes of one tiled ring stage
TILED_STAGES = 4


def gemm_smem(regime: str, k: int, stages: int) -> int:
    """Shared-memory bytes of a K3 block (as `stripe_smem` and `tiled_smem`
    in csrc/ln_proj.cu): 1024 of alignment slack; stripe: the stripe, the
    two consumer warpgroups' 64 x 160 bf16 staging tiles, the weight ring
    and the mbarriers; tiled: the ring, two 64 x 128 staging tiles and the
    mbarriers (K plays no part)."""
    if regime == "stripe":
        return (1024 + -(-k // 64) * BM * 128 + 2 * 64 * BN * 2 + stages * BN * 128
                + 8 * (2 * stages + 3))
    if regime == "tiled":
        return 1024 + stages * TILED_STAGE + 2 * 64 * UNIT * 2 + 8 * (2 * stages + 2)
    raise ValueError(f"K3 has no regime {regime!r}")


def gemm_plan(m: int, k: int, ns: Sequence[int]) -> dict:
    """K3's plan for x (m, k) against weights of ns[i] output columns.

    Stripe, where a 128-row stripe of all K columns leaves room for a ring
    of at least two 160-column weight tiles (K <= 576): as many ring stages
    as fit (up to 8), and the N tiles split over enough blocks a stripe to
    give two waves of 132 SMs. Tiled otherwise (K >= 640, any K): 128 x 256
    tiles of two 128-column units (units of different weights may share a
    tile), a ring of 4 stages, min(tiles, 132) persistent blocks. Keys:
    regime, bm, bn (rows and columns of a block's tile), stages, split
    (stripe: blocks a stripe; tiled: persistent blocks), smem, stripes (row
    stripes or row tiles), tiles (stripe: N tiles a stripe; tiled: tiles in
    all), units (tiled), cols (the output columns the kernel computes,
    padded). Raises where the kernel cannot take the shape. The result is
    cached and shared: do not modify it."""
    return _gemm_plan(m, k, tuple(ns))


@functools.lru_cache(maxsize=None)
def _gemm_plan(m: int, k: int, ns: Tuple[int, ...]) -> dict:
    if k <= 0 or k % 8 != 0:
        raise ValueError(f"K3 takes K % 8 == 0, got K = {k}")
    if not 1 <= len(ns) <= 3 or any(n <= 0 or n % 8 != 0 for n in ns):
        raise ValueError(f"K3 takes 1-3 weights with N % 8 == 0, got {list(ns)}")
    stripes = max(1, -(-m // BM))
    stages = min(MAX_STAGES, (SMEM_LIMIT - gemm_smem("stripe", k, 0)) // (BN * 128 + 16))
    if stages >= 2:
        tiles = sum(-(-n // BN) for n in ns)
        nsplit = min(tiles, max(1, -(-2 * SMS // stripes)))
        return dict(regime="stripe", bm=BM, bn=BN, stages=stages, split=nsplit,
                    smem=gemm_smem("stripe", k, stages), stripes=stripes, tiles=tiles,
                    cols=tiles * BN)
    units = sum(-(-n // UNIT) for n in ns)
    ntiles = -(-units // 2)
    tiles = stripes * ntiles
    return dict(regime="tiled", bm=BM, bn=2 * UNIT, stages=TILED_STAGES, split=min(tiles, SMS),
                smem=gemm_smem("tiled", k, TILED_STAGES), stripes=stripes, tiles=tiles,
                units=units, cols=ntiles * 2 * UNIT)


def ln_gemm(x2, gamma, beta, ws, bs, eps: float = 1e-5, res=None):
    """One call of csrc/ln_proj.cu on a bf16 (M, K) matrix: the LayerNorm
    of each row (gamma, beta f32) when `gamma` is given, else x as it is;
    the bias (cast to f32 here where it is not) and an optional bf16
    residual in the epilogue. Shared by K3 and K4; it does not count
    launches itself."""
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
    # the tiled regime's LayerNorm pre-pass writes the normalised x here
    xn = torch.empty_like(x2) if plan["regime"] == "tiled" and gamma is not None else None
    pad = lambda seq: list(seq) + [None] * (3 - nw)
    w3, b3, r3, o3 = pad(ws), pad(bias), pad(res), pad(outs)
    n3 = [w.shape[0] for w in ws] + [0] * (3 - nw)
    lib = _build.load("ln_proj")
    rc = lib.mmgt_ln_gemm(
        x2.data_ptr(), _build.ptr(gamma), _build.ptr(beta), m, k, float(eps), nw,
        *[_build.ptr(t) for t in w3], *n3,
        *[_build.ptr(t) for t in b3], *[_build.ptr(t) for t in r3],
        *[_build.ptr(t) for t in o3], _build.ptr(xn), int(plan["regime"] == "tiled"),
        plan["stages"], plan["split"], plan["smem"], _build.stream_ptr(x2),
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
