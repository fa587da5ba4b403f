"""Motion-module (temporal) attention: plain version and kernel K4.

    out = x + W_o . MHA_frames(LN(x) * gamma + beta + pe) + b_o

over x (B, F, L, C): the attention runs across the F frames of each of the
L spatial tokens. Weights use torch's Linear layout (out, in). Numerics as
`mmgt_tpu/ops/motion_attention.py`'s kernel: f32 LN statistics, the
normalised row (+pe) rounded to the compute dtype, q and k kept in f32 from
the projection, f32 logits and softmax, probabilities rounded to the
compute dtype, P . V summed in f32.

K4 replaces the TPU kernel mmgt_tpu/ops/motion_attention.py:_motion_kernel
with three launches: `ln_pe` (csrc/motion_attn.cu), which writes the
bf16-rounded LN(x) * gamma + beta + pe row that the products take; kernel A
(csrc/motion_attn.cu `motion_attn`), one block per (head, block of Lt
tokens, row), which runs the head's q/k/v projections on wgmma (TMA-fed)
and the frame attention from shared memory, and writes only the attention
output o; and K3's GEMM (csrc/ln_proj.cu) without LayerNorm for W_o, with
the f32 bias and the residual. q and k never reach device memory. The plan
of kernel A (`attn_plan`) is computed here and checked by its C entry.
On a head shard (tensor parallelism) the q/k/v weights are (H_local D, C)
and W_o (C, H_local D): kernel A writes o (M, H_local D) and the W_o GEMM
runs without its residual and bias (`residual=False`), which the caller
adds once after the reduce. It
takes every token count L and up to 32 frames (the TPU's L % 128 == 0 gate
was a tiling rule); the head dims are those of `_HEAD_DIMS`. Bound on the
H100 for the whole: operations at level 0 (the four C x C products).

On a CPU tensor `motion_attention` runs `motion_attention_plain`; on a
CUDA tensor it launches K4 or raises. Gradients: the forward still runs K4
and the backward is autograd through `motion_attention_plain`, recomputed,
as the JAX package's `_motion_vjp_bwd` (`ops/_vjp.py`).
"""
from __future__ import annotations

import math
from typing import Optional

import torch

from mmgt_tpu_torch.ops import _build
from mmgt_tpu_torch.ops._vjp import kernel_with_plain_vjp, needs_grad
from mmgt_tpu_torch.ops.fused_ln import ln_gemm

LAUNCHES = 0  # K4 launches (one per motion_attention call on the card)


def sinusoidal_positions(max_len: int, dim: int, device=None) -> torch.Tensor:
    """Interleaved sin/cos positional table (AnimateDiff motion PE)."""
    position = torch.arange(max_len, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(
        torch.arange(0, dim, 2, dtype=torch.float32, device=device)
        * (-math.log(10000.0) / dim)
    )
    pe = torch.zeros((max_len, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(position * div)
    pe[:, 1::2] = torch.cos(position * div)
    return pe


def motion_attention_plain(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads: int,
                           eps: float = 1e-5, residual: bool = True):
    """`heads` heads of d = inner / heads on q/k/v weights (inner, C) and
    W_o (C, inner): inner = C unsharded, a head shard's columns under tensor
    parallelism. `residual=False` returns W_o . attn alone (plus b_o if
    given): a row-parallel partial sum, completed by the caller."""
    b, f, l, c = x.shape
    inner = wq.shape[0]
    d = inner // heads
    cdt = x.dtype
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    xc = xf - mean
    var = (xc * xc).mean(-1, keepdim=True)
    h = xc * torch.rsqrt(var + eps) * gamma.float() + beta.float()
    h = (h + pe.float()[None, :, None, :]).to(cdt).float()
    q = (h @ wq.float().t()).reshape(b, f, l, heads, d)
    k = (h @ wk.float().t()).reshape(b, f, l, heads, d)
    v = (h @ wv.float().t()).to(cdt).float().reshape(b, f, l, heads, d)
    logits = torch.einsum("bflhd,bglhd->blhfg", q, k) * (1.0 / math.sqrt(d))
    probs = torch.softmax(logits, dim=-1).to(cdt).float()
    o = torch.einsum("blhfg,bglhd->bflhd", probs, v).to(cdt).reshape(b, f, l, inner)
    if residual:
        out = xf + o.float() @ wo.float().t() + bo.float()
    else:
        out = o.float() @ wo.float().t()
        if bo is not None:
            out = out + bo.float()
    return out.to(cdt)


# kernel A's plan (csrc/motion_attn.cu): rows, tokens a block, ring depth
SMEM_LIMIT = 232448   # 227 KB a block on the H100
TWO_BLOCKS = 115712   # two blocks an SM: (228 KB - 2 x 1 KB reserved) / 2
_PAD = 4              # f32 padding of a staged q/k/v row
_HEAD_DIMS = (16, 32, 40, 64, 80, 96, 128, 160)
_MAX_CHANNELS = 2048  # ln_pe holds a row in one warp's registers


def attn_smem(rp: int, d: int, stages: int, frames: int, lt: int) -> int:
    """Shared-memory bytes of a kernel-A block (as `attn_smem` in
    csrc/motion_attn.cu): alignment slack, the ring of (h chunk, W_q, W_k,
    W_v chunks) stages or the staged q/k/v that alias it, the (Lt, F, F)
    probabilities and the mbarriers."""
    ring = stages * (rp * 128 + 3 * d * 128)
    region = max(ring, 3 * rp * (d + _PAD) * 4)
    probs = -(-lt * frames * frames * 4 // 16) * 16
    return 1024 + region + probs + 8 * stages


def attn_plan(frames: int, tokens: int, channels: int, heads: int,
              inner: Optional[int] = None) -> dict:
    """Kernel A's plan for x (B, F, L, C) and `heads` heads of d = inner /
    heads (inner = C unless the weights are a head shard of
    (inner, C)): RP = 128 rows a block (two
    warpgroups of 64 rows) for d <= 96, else 64 (the warpgroups split the
    head's columns); Lt = RP // F tokens (frame-major rows f Lt + t, the rest
    padding); the deepest ring (2-4 stages) that lets two blocks share an
    SM, else the deepest that fits one. Raises on a shape it does not take."""
    inner = channels if inner is None else inner
    d = inner // heads
    if inner != heads * d or d not in _HEAD_DIMS or channels % 8 != 0:
        raise ValueError(f"K4 takes inner = heads * d with d in {_HEAD_DIMS} and C % 8 == 0, "
                         f"got inner = {inner}, {heads} heads, C = {channels}")
    if not 1 <= frames <= 32:
        raise ValueError(f"K4 takes 1 to 32 frames, got {frames}")
    if channels > _MAX_CHANNELS:
        raise ValueError(f"K4's LayerNorm pre-pass takes C <= {_MAX_CHANNELS}, got {channels}")
    rp = 128 if d <= 96 else 64
    lt = max(1, min(rp // frames, tokens))
    fits = [s for s in (4, 3, 2) if attn_smem(rp, d, s, frames, lt) <= TWO_BLOCKS]
    if not fits:
        fits = [s for s in (4, 3, 2) if attn_smem(rp, d, s, frames, lt) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"K4: no plan fits {SMEM_LIMIT} bytes at d = {d}, {frames} frames")
    stages = fits[0]
    return dict(rp=rp, lt=lt, stages=stages, smem=attn_smem(rp, d, stages, frames, lt))


def ln_pe(x, gamma, beta, pe, eps: float):
    """h = bf16(LN(x) * gamma + beta + pe[f]) for x (B, F, L, C) bf16, as
    one (B F L, C) matrix (csrc/motion_attn.cu `ln_pe`)."""
    b, f, l, c = x.shape
    h = torch.empty((b * f * l, c), dtype=torch.bfloat16, device=x.device)
    lib = _build.load("motion_attn")
    rc = lib.mmgt_ln_pe(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), pe.data_ptr(),
                        h.data_ptr(), b * f * l, l, f, c, float(eps), _build.stream_ptr(x))
    _build.check(lib, rc, "LayerNorm + pe (K4)")
    return h


def _launch(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads, eps, residual=True):
    global LAUNCHES
    b, f, l, c = x.shape
    inner = wq.shape[0]
    plan = attn_plan(f, l, c, heads, inner)
    if not x.is_contiguous() or x.dtype != torch.bfloat16:
        raise ValueError("K4 takes a contiguous bf16 input")
    for w, shape in ((wq, (inner, c)), (wk, (inner, c)), (wv, (inner, c)), (wo, (c, inner))):
        if w.dtype != torch.bfloat16 or tuple(w.shape) != shape or not w.is_contiguous():
            raise ValueError(f"K4 takes contiguous bf16 ({inner}, {c}) q/k/v and ({c}, {inner}) "
                             "W_o weights")
    if tuple(pe.shape) != (f, c):
        raise ValueError(f"K4 takes pe ({f}, {c}), got {tuple(pe.shape)}")
    x2 = x.reshape(-1, c)
    h = ln_pe(x, gamma.float().contiguous(), beta.float().contiguous(),
              pe.float().contiguous(), eps)
    o = torch.empty((x2.shape[0], inner), dtype=x.dtype, device=x.device)
    d = inner // heads
    lib = _build.load("motion_attn")
    rc = lib.mmgt_motion_attn(
        h.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), o.data_ptr(), b, f, l, c,
        heads, d, 1.0 / math.sqrt(d), plan["rp"], plan["lt"], plan["stages"],
        plan["smem"], _build.stream_ptr(x2))
    _build.check(lib, rc, "motion attention (K4)")
    (out,) = ln_gemm(o, None, None, [wo], [bo], res=[x2] if residual else None)
    LAUNCHES += 1
    return out.reshape(x.shape)


def motion_attention(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads: int,
                     eps: float = 1e-5, residual: bool = True) -> torch.Tensor:
    """x + W_o attn_frames(LN(x) * gamma + beta + pe) + b_o; pe (F, C).
    `heads` of the weights' inner = wq.shape[0] columns; `residual=False`
    (a head shard): W_o attn (+ b_o if given) alone."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no motion-attention kernel for device {x.device}")
    kernel = motion_attention_plain if x.device.type == "cpu" else _launch
    args = (x, gamma, beta, pe, wq, wk, wv, wo, bo, heads, eps, residual)
    if needs_grad(x, gamma, beta, pe, wq, wk, wv, wo, bo):
        return kernel_with_plain_vjp(kernel, motion_attention_plain, *args)
    return kernel(*args)
