"""Motion-module (temporal) attention: plain version and kernel K4.

    out = x + W_o . MHA_frames(LN(x) * gamma + beta + pe) + b_o

over x (B, F, L, C): the attention runs across the F frames of each of the
L spatial tokens. Weights use torch's Linear layout (out, in). Numerics as
`mmgt_tpu/ops/motion_attention.py`'s kernel: f32 LN statistics, the
normalised row (+pe) rounded to the compute dtype, q and k kept in f32 from
the projection, f32 logits and softmax, probabilities rounded to the
compute dtype, P . V summed in f32.

K4 replaces the TPU kernel mmgt_tpu/ops/motion_attention.py:_motion_kernel
with the port's own launches: csrc/ln_proj.cu's row statistics and its GEMM
with an LN + pe prologue (q/k written in f32, v in bf16), the frame
attention of csrc/motion_attn.cu (one warp per (row, token, head); bound by
bytes), and the GEMM again with a bias + residual epilogue for W_o. It
takes every token count L (the TPU's L % 128 == 0 and d % 8 == 0 gates
were tiling rules). Bound on the H100 for the whole: operations at level 0
(the four C x C products), bytes in the frame-attention part.

On a CPU tensor `motion_attention` runs `motion_attention_plain`; on a
CUDA tensor it launches K4 or raises. Gradients: the forward still runs K4
and the backward is autograd through `motion_attention_plain`, recomputed,
as the JAX package's `_motion_vjp_bwd` (`ops/_vjp.py`).
"""
from __future__ import annotations

import math

import torch

from mmgt_tpu_torch.ops import _build
from mmgt_tpu_torch.ops._vjp import kernel_with_plain_vjp, needs_grad
from mmgt_tpu_torch.ops.fused_ln import ln_gemm, row_stats

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
                           eps: float = 1e-5):
    b, f, l, c = x.shape
    d = c // heads
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
    o = torch.einsum("blhfg,bglhd->bflhd", probs, v).to(cdt).reshape(b, f, l, c)
    out = xf + o.float() @ wo.float().t() + bo.float()
    return out.to(cdt)


def _launch(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads, eps):
    global LAUNCHES
    b, f, l, c = x.shape
    d = c // heads
    if c != heads * d or f > 32:
        raise ValueError(f"K4 takes C = heads * d and at most 32 frames, got {x.shape}")
    x2 = x.reshape(-1, c)
    if not x2.is_contiguous() or x2.dtype != torch.bfloat16:
        raise ValueError("K4 takes a contiguous bf16 input")
    stats = row_stats(x2, eps)
    q, k, v = ln_gemm(
        x2, stats, gamma.float().contiguous(), beta.float().contiguous(),
        [wq, wk, wv], [None, None, None], pe=pe.float().contiguous(),
        tokens=l, frames=f, f32_out=(True, True, False),
    )
    o = torch.empty_like(x2)
    lib = _build.load("motion_attn")
    rc = lib.mmgt_frame_attn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                             b, f, l, heads, d, 1.0 / math.sqrt(d), _build.stream_ptr(x2))
    _build.check(lib, rc, "frame attention (K4)")
    (out,) = ln_gemm(o, None, None, None, [wo], [bo], res=[x2])
    LAUNCHES += 1
    return out.reshape(x.shape)


def motion_attention(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads: int,
                     eps: float = 1e-5) -> torch.Tensor:
    """x + W_o attn_frames(LN(x) * gamma + beta + pe) + b_o; pe (F, C)."""
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no motion-attention kernel for device {x.device}")
    kernel = motion_attention_plain if x.device.type == "cpu" else _launch
    args = (x, gamma, beta, pe, wq, wk, wv, wo, bo, heads, eps)
    if needs_grad(x, gamma, beta, pe, wq, wk, wv, wo, bo):
        return kernel_with_plain_vjp(kernel, motion_attention_plain, *args)
    return kernel(*args)
