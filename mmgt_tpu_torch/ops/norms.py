"""Normalisation: GroupNorm (+SiLU) with kernel K2 (Triton), and LayerNorm.

Channel-last (N, ..., C) layout, f32 statistics, as `mmgt_tpu/ops/norms.py`.

K2 replaces the TPU kernels mmgt_tpu/ops/norms.py:_gn_kernel (one batch
row in VMEM) and _gn_kernel_blocked (two-phase, for rows too big for
VMEM); one design takes every row size, up to the VAE decoder's
(8, 512*512, 128). Bound on the H100: bytes (a reduction and an
elementwise pass, ~10 flops per element). Design, three Triton launches:
  1. split-row partial sums of x and x^2 per (row, split, channel), each
     program streaming a (rows, 128-channel) slab with coalesced loads;
  2. per (row, group): the partials of the group's channels summed into
     mean and rstd (E[x^2] - E[x]^2, clamped at 0, as the TPU kernel);
  3. the affine (+ SiLU) applied tile by tile.
x is read twice and written once; the statistics are a few KB.

On a CPU tensor `group_norm` runs `group_norm_plain`; on a CUDA tensor it
launches K2 or raises. Triton is imported inside the launching function.
Gradients: when autograd needs them, the forward still runs K2 and the
backward is autograd through `group_norm_plain`, recomputed, as the JAX
package's `_gn_diff_bwd` (`ops/_vjp.py`).
"""
from __future__ import annotations

from typing import Optional

import torch

from mmgt_tpu_torch.ops._vjp import kernel_with_plain_vjp, needs_grad

LAUNCHES = 0  # K2 launches (one per group_norm call on the card)
_KERNELS = None


def group_norm_plain(x, num_groups: int, weight=None, bias=None, eps: float = 1e-6,
                     act: Optional[str] = None):
    """The XLA math of the JAX package (`_group_norm_xla`): two-pass f32
    statistics over (spatial, channels-in-group) per leading row."""
    c = x.shape[-1]
    gs = c // num_groups
    xg = x.float().reshape(x.shape[0], -1, num_groups, gs)
    mean = xg.mean(dim=(1, 3), keepdim=True)
    var = (xg - mean).square().mean(dim=(1, 3), keepdim=True)
    out = ((xg - mean) * torch.rsqrt(var + eps)).reshape(x.shape)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    if act == "silu":
        out = out * torch.sigmoid(out)
    elif act is not None:
        raise ValueError(f"unknown fused activation {act!r}")
    return out.to(x.dtype)


def _kernels():
    global _KERNELS
    if _KERNELS is not None:
        return _KERNELS
    import triton
    import triton.language as tl

    @triton.jit
    def gn_partial(x_ptr, ws_ptr, L, C, rows_per_split,
                   BL: tl.constexpr, BC: tl.constexpr):
        n = tl.program_id(0)
        s = tl.program_id(1)
        cb = tl.program_id(2)
        nsplit = tl.num_programs(1)
        cols = cb * BC + tl.arange(0, BC)
        cmask = cols < C
        row0 = s * rows_per_split
        row_end = tl.minimum(row0 + rows_per_split, L)
        base = x_ptr + n.to(tl.int64) * L * C
        acc = tl.zeros([BC], dtype=tl.float32)
        acc2 = tl.zeros([BC], dtype=tl.float32)
        for r in range(row0, row_end, BL):
            rows = r + tl.arange(0, BL)
            m = (rows[:, None] < row_end) & cmask[None, :]
            v = tl.load(base + rows[:, None].to(tl.int64) * C + cols[None, :],
                        mask=m, other=0.0).to(tl.float32)
            acc += tl.sum(v, axis=0)
            acc2 += tl.sum(v * v, axis=0)
        out = ws_ptr + ((n * nsplit + s) * 2).to(tl.int64) * C
        tl.store(out + cols, acc, mask=cmask)
        tl.store(out + C + cols, acc2, mask=cmask)

    @triton.jit
    def gn_stats(ws_ptr, st_ptr, C, G, gs, nsplit, count, eps,
                 BS: tl.constexpr, BG: tl.constexpr):
        n = tl.program_id(0)
        g = tl.program_id(1)
        ch = g * gs + tl.arange(0, BG)
        chm = tl.arange(0, BG) < gs
        tot = tl.zeros([BS, BG], dtype=tl.float32)
        tot2 = tl.zeros([BS, BG], dtype=tl.float32)
        for s0 in range(0, nsplit, BS):
            sp = s0 + tl.arange(0, BS)
            m = (sp[:, None] < nsplit) & chm[None, :]
            off = ((n * nsplit + sp[:, None]) * 2).to(tl.int64) * C + ch[None, :]
            tot += tl.load(ws_ptr + off, mask=m, other=0.0)
            tot2 += tl.load(ws_ptr + off + C, mask=m, other=0.0)
        mean = tl.sum(tl.sum(tot, axis=1), axis=0) / count
        ex2 = tl.sum(tl.sum(tot2, axis=1), axis=0) / count
        var = tl.maximum(ex2 - mean * mean, 0.0)
        rstd = 1.0 / tl.sqrt(var + eps)
        tl.store(st_ptr + (n * G + g) * 2, mean)
        tl.store(st_ptr + (n * G + g) * 2 + 1, rstd)

    @triton.jit
    def gn_apply(x_ptr, o_ptr, st_ptr, w_ptr, b_ptr, L, C, G, gs,
                 SILU: tl.constexpr, BL: tl.constexpr, BC: tl.constexpr):
        n = tl.program_id(0)
        rb = tl.program_id(1)
        cb = tl.program_id(2)
        rows = rb * BL + tl.arange(0, BL)
        cols = cb * BC + tl.arange(0, BC)
        cmask = cols < C
        m = (rows[:, None] < L) & cmask[None, :]
        off = n.to(tl.int64) * L * C + rows[:, None].to(tl.int64) * C + cols[None, :]
        v = tl.load(x_ptr + off, mask=m, other=0.0).to(tl.float32)
        grp = cols // gs
        mean = tl.load(st_ptr + (n * G + grp) * 2, mask=cmask, other=0.0)
        rstd = tl.load(st_ptr + (n * G + grp) * 2 + 1, mask=cmask, other=0.0)
        w = tl.load(w_ptr + cols, mask=cmask, other=0.0)
        b = tl.load(b_ptr + cols, mask=cmask, other=0.0)
        y = (v - mean[None, :]) * rstd[None, :] * w[None, :] + b[None, :]
        if SILU:
            y = y * tl.sigmoid(y)
        tl.store(o_ptr + off, y.to(o_ptr.dtype.element_ty), mask=m)

    _KERNELS = (triton, gn_partial, gn_stats, gn_apply)
    return _KERNELS


def _next_pow2(n: int) -> int:
    return 1 << max(0, (n - 1).bit_length())


def _launch(x, num_groups, weight, bias, eps, act):
    global LAUNCHES
    if not x.is_contiguous():
        raise ValueError("K2 takes a contiguous channel-last tensor")
    triton, gn_partial, gn_stats, gn_apply = _kernels()
    n, c = x.shape[0], x.shape[-1]
    l = x.numel() // max(n * c, 1)
    gs = c // num_groups
    dev = x.device
    w = (weight if weight is not None else torch.ones(c, device=dev)).float().contiguous()
    b = (bias if bias is not None else torch.zeros(c, device=dev)).float().contiguous()
    rows_per_split = 512
    nsplit = triton.cdiv(l, rows_per_split)
    bc = min(128, _next_pow2(c))
    ws = torch.empty((n, nsplit, 2, c), dtype=torch.float32, device=dev)
    stats = torch.empty((n, num_groups, 2), dtype=torch.float32, device=dev)
    out = torch.empty_like(x)
    gn_partial[(n, nsplit, triton.cdiv(c, bc))](
        x, ws, l, c, rows_per_split, BL=32, BC=bc, num_warps=4)
    gn_stats[(n, num_groups)](
        ws, stats, c, num_groups, gs, nsplit, float(l * gs), float(eps),
        BS=32, BG=_next_pow2(gs), num_warps=4)
    gn_apply[(n, triton.cdiv(l, 32), triton.cdiv(c, bc))](
        x, out, stats, w, b, l, c, num_groups, gs,
        SILU=(act == "silu"), BL=32, BC=bc, num_warps=4)
    LAUNCHES += 1
    return out


def group_norm(x: torch.Tensor, num_groups: int, weight=None, bias=None,
               eps: float = 1e-6, act: Optional[str] = None) -> torch.Tensor:
    """GroupNorm over the trailing channels of an (N, ..., C) tensor,
    statistics per leading row; optional fused act="silu"."""
    if x.shape[-1] % num_groups != 0:
        raise ValueError(f"{x.shape[-1]} channels do not split into {num_groups} groups")
    if act not in (None, "silu"):
        raise ValueError(f"unknown fused activation {act!r}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no GroupNorm kernel for device {x.device}")
    kernel = group_norm_plain if x.device.type == "cpu" else _launch
    if needs_grad(x, weight, bias):
        return kernel_with_plain_vjp(kernel, group_norm_plain, x, num_groups, weight, bias,
                                     eps, act)
    return kernel(x, num_groups, weight, bias, eps, act)


def layer_norm(x, weight=None, bias=None, eps: float = 1e-5):
    """LayerNorm over the last axis with f32 statistics (`mmgt_tpu.ops.norms.
    layer_norm`); a plain op in the JAX package as well."""
    xf = x.float()
    mean = xf.mean(-1, keepdim=True)
    var = (xf - mean).square().mean(-1, keepdim=True)
    out = (xf - mean) * torch.rsqrt(var + eps)
    if weight is not None:
        out = out * weight.float()
    if bias is not None:
        out = out + bias.float()
    return out.to(x.dtype)
