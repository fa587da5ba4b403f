"""Normalisation: GroupNorm (+SiLU) with kernel K2 (CUDA), and LayerNorm.

Channel-last (N, ..., C) layout, f32 statistics, as `mmgt_tpu/ops/norms.py`.

K2 (csrc/group_norm.cu) replaces the TPU kernels
mmgt_tpu/ops/norms.py:_gn_kernel (one batch row in VMEM, read once) and
_gn_kernel_blocked (two phases, for rows too big for VMEM). Bound on the
H100: bytes (~10 flops an element). Two regimes, picked by `gn_plan` from
the shape alone and checked by the C entry:
  * resident: a row held in the shared memory of a thread block cluster
    of k <= 16 CTAs (`cp.async`); each CTA pushes its group sums to every
    CTA of the cluster through distributed shared memory; as many clusters
    as the card holds walk the rows, each loading its next row while it
    stores this one; x is read once and written once;
  * streaming, for rows larger than a cluster holds: per-(row, split,
    group) partial sums, then an apply pass that finishes the statistics
    in its prologue; x is read twice.
Both sum d = x - K_g and d^2, K_g the group's first element in the row,
so that E[d^2] - E[d]^2 (clamped at 0, as the TPU kernel) does not cancel
when a group's mean is far from 0.
gamma and beta are read in their own dtype (bf16 or f32) or left out; a
call allocates only its output (and, streaming, a few KB of partials).

On a CPU tensor `group_norm` runs `group_norm_plain`; on a CUDA tensor it
launches K2 or raises. Gradients: when autograd needs them, the forward
still runs K2 and the backward is autograd through `group_norm_plain`,
recomputed, as the JAX package's `_gn_diff_bwd` (`ops/_vjp.py`).
"""
from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from mmgt_tpu_torch.ops import _build
from mmgt_tpu_torch.ops._vjp import kernel_with_plain_vjp, needs_grad

LAUNCHES = 0  # K2 launches (one per group_norm call on the card)


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


# K2's plan (csrc/group_norm.cu). A thread owns one 16-byte column of the
# row and walks the rows `lanes` apart; a resident CTA holds `rows` rows of
# the row (its slab) and its reduction scratch in shared memory.
SMEM_LIMIT = 232448       # 227 KB a block on the H100
TWO_CTAS = 115712         # half an SM's 228 KB less the 1 KB reserved a block
SMS = 132                 # streaming multiprocessors of the H100
MAX_CLUSTER = 16          # non-portable cluster size limit
STREAM_CTAS = 4 * SMS     # streaming grid: about four CTAs an SM


def _align(v: int, a: int) -> int:
    return -(-v // a) * a


def gn_threads(c: int, esize: int) -> int:
    """Threads of a K2 CTA: whole 16-byte columns, as many row lanes as fit
    512 threads (at least one)."""
    v = c * esize // 16
    return v * max(1, 512 // v)


def gn_resident_smem(rows: int, c: int, groups: int, esize: int, k: int) -> int:
    """Shared-memory bytes of a resident CTA of a k-CTA cluster (as
    `resident_smem` in csrc/group_norm.cu): the slab, the per-lane channel
    sums (lanes x C f32), the channel totals (C), the group partials,
    statistics and pilots (5 G), the cluster's partials for two rows (4 G
    k) and two mbarriers."""
    lanes = gn_threads(c, esize) // (c * esize // 16)
    floats = lanes * c + c + (5 + 4 * k) * groups
    return _align(_align(rows * c * esize, 128) + 4 * floats, 8) + 16


def gn_stream_smem(c: int, groups: int, esize: int) -> int:
    lanes = gn_threads(c, esize) // (c * esize // 16)
    return 4 * (lanes * c + c + 2 * groups)


@functools.lru_cache(maxsize=None)
def gn_plan(n: int, l: int, c: int, groups: int, dtype=torch.bfloat16) -> dict:
    """K2's plan for x (n, l, c) in `dtype`, from the shape alone.

    Resident (one launch, x read once) where a row fits the shared memory of
    a cluster of k <= 16 CTAs. k is only ever one that fits (`fits`; with
    many groups the cluster's partials grow with k, so the k that fit need
    not be a run up to 16): the smallest k whose slabs leave room for two
    CTAs an SM (one CTA's load then overlaps the other's stores), else the
    largest k that fits, at one CTA an SM; k is then raised to the largest
    fitting k towards 132 / n CTAs (at least 8 rows a CTA) so that few rows
    still spread over the card. Streaming (two launches, x read twice)
    where no k fits, split into enough CTAs for about four an SM. Raises
    where the kernel cannot take the shape. The result is cached and
    shared: do not modify it."""
    if dtype not in (torch.bfloat16, torch.float32):
        raise ValueError(f"K2 takes bf16 or f32 x, got {dtype}")
    esize = 2 if dtype == torch.bfloat16 else 4
    if n < 1 or n > 65535 or l < 1 or groups < 1 or c % groups:
        raise ValueError(f"K2 cannot take x ({n}, {l}, {c}) in {groups} groups")
    if (c * esize) % 16 or c * esize // 16 > 1024:
        raise ValueError(f"K2 takes rows of 16-byte vectors, at most 1024 a row; C = {c}")
    threads = gn_threads(c, esize)
    smem = lambda k: gn_resident_smem(-(-l // k), c, groups, esize, k)
    fits = [k for k in range(1, MAX_CLUSTER + 1) if smem(k) <= SMEM_LIMIT]
    if fits:
        two = [k for k in fits if smem(k) <= TWO_CTAS]
        k = two[0] if two else fits[-1]
        spread = min(MAX_CLUSTER, -(-SMS // n), max(1, l // 8))
        k = max([k] + [j for j in fits if j <= spread])
        rows = -(-l // k)
        return dict(regime="resident", k=k, threads=threads, rows=rows, smem=smem(k),
                    slab=rows * c * esize, ws=0)
    return gn_stream_plan(n, l, c, groups, esize)


def gn_stream_plan(n: int, l: int, c: int, groups: int, esize: int) -> dict:
    """The streaming regime's plan (`gn_plan` takes it for rows larger than
    a cluster holds): each row split into enough CTAs for about four an SM,
    each CTA at least four rows a lane."""
    threads = gn_threads(c, esize)
    lanes = threads // (c * esize // 16)
    splits = max(1, min(-(-STREAM_CTAS // n), -(-l // (4 * lanes)), 65535))
    rows = -(-l // splits)
    splits = -(-l // rows)
    return dict(regime="streaming", k=splits, threads=threads, rows=rows,
                smem=gn_stream_smem(c, groups, esize), slab=0, ws=n * splits * 2 * groups)


_PARAM_KIND = {None: 0, torch.bfloat16: 1, torch.float32: 2}
_MAX_CLUSTERS = {}


def _max_clusters(lib, plan, f32: bool) -> int:
    """Clusters of the plan's shape that the card holds at once
    (cudaOccupancyMaxActiveClusters, asked at first use of a shape); the
    resident grid launches that many, each walking rows. Raises where such
    a cluster cannot be scheduled at all."""
    key = (plan["k"], plan["threads"], plan["smem"], f32)
    if key in _MAX_CLUSTERS:
        return _MAX_CLUSTERS[key]
    out = ctypes.c_int(0)
    _build.check(lib, lib.mmgt_gn_max_clusters(plan["k"], plan["threads"], plan["smem"],
                                                int(f32), ctypes.addressof(out)),
                 "K2 cluster occupancy")
    if out.value < 1:
        raise RuntimeError(f"K2: a cluster of {plan['k']} CTAs with {plan['smem']} bytes of "
                           f"shared memory each cannot be scheduled on this card")
    _MAX_CLUSTERS[key] = out.value
    return out.value


def _param(p, c: int):
    if p is None:
        return None
    if p.dtype not in (torch.bfloat16, torch.float32) or p.numel() != c:
        raise ValueError(f"K2 takes bf16 or f32 gamma/beta of {c} channels")
    return p.contiguous()


def run_plan(x, num_groups, weight, bias, eps, act, plan, clusters=None):
    """One K2 call on a contiguous x (n, ..., c) under `plan`; a resident
    plan runs on `clusters` clusters (default: as many as the card holds,
    at most n). `group_norm` calls it with `gn_plan`'s plan; it counts no
    launch itself."""
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("K2 takes a contiguous, 16-byte aligned channel-last tensor")
    n, c = x.shape[0], x.shape[-1]
    l = x.numel() // max(n * c, 1)
    w, b = _param(weight, c), _param(bias, c)
    f32 = x.dtype == torch.float32
    lib = _build.load("group_norm")
    if plan["regime"] == "resident" and clusters is None:
        clusters = min(n, _max_clusters(lib, plan, f32))
    out = torch.empty_like(x)
    ws = torch.empty(plan["ws"], dtype=torch.float32, device=x.device) if plan["ws"] else None
    rc = lib.mmgt_group_norm(
        x.data_ptr(), _build.ptr(w), _PARAM_KIND[None if w is None else w.dtype], _build.ptr(b),
        _PARAM_KIND[None if b is None else b.dtype], out.data_ptr(), _build.ptr(ws), n, l, c,
        num_groups, float(eps), int(act == "silu"), int(f32),
        0 if plan["regime"] == "resident" else 1, plan["k"], plan["threads"], plan["rows"],
        plan["smem"], clusters or 0, _build.stream_ptr(x))
    _build.check(lib, rc, "K2 GroupNorm")
    return out


def _launch(x, num_groups, weight, bias, eps, act):
    global LAUNCHES
    n, c = x.shape[0], x.shape[-1]
    out = run_plan(x, num_groups, weight, bias, eps, act,
                   gn_plan(n, x.numel() // max(n * c, 1), c, num_groups, x.dtype))
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
