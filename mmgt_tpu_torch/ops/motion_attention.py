"""Motion-module (temporal) attention: plain version and kernel K4.

    out = x + W_o . MHA_frames(LN(x) * gamma + beta + pe) + b_o

over x (B, F, L, C): the attention runs across the F frames of each of the
L spatial tokens. Weights use torch's Linear layout (out, in). Numerics as
`mmgt_tpu/ops/motion_attention.py`'s kernel: f32 LN statistics, the
normalised row (+pe) rounded to the compute dtype, q and k kept in f32 from
the projection, f32 logits and softmax, probabilities rounded to the
compute dtype, P . V summed in f32.

K4 replaces the TPU kernel mmgt_tpu/ops/motion_attention.py:_motion_kernel
(csrc/motion_attn.cu), in one of three regimes chosen by `attn_plan`:
  * fused (C <= 320, d <= 64: level 0 and its head shards): one persistent
    kernel (`motion_fused`) reads x once per token block, normalises it on
    chip (the normalised rows never reach device memory), runs every head's
    q/k/v products on wgmma, the logits on the CUDA cores and P . V on
    wgmma, and writes only the attention output o;
  * clusters (d = 80, 128, 160: levels 1-3, the mid block and their head
    shards): `ln_pe` writes the bf16 normalised row h, then persistent
    thread block clusters of cs CTAs (`motion_cluster`) run one head over
    cs token blocks a unit. Each CTA loads its h rows and 1 / cs of every
    64-column weight chunk, multicast to the cluster, so a weight byte
    fetched from L2 serves cs times the rows (cs = 2 at d = 80, 4 above),
    and keeps the next chunk's product in flight. The frame attention runs
    on 11 warps from a staging in the ring's last stages while the next
    unit's first chunks load, P . V on wgmma;
  * per head (every other shape: d <= 64 at C > 320 and d = 96, off the
    main path): `ln_pe`, then one block per (head, block of tokens, row)
    runs that head's products and frame attention (`motion_attn`).
Then K3's GEMM (csrc/ln_proj.cu) without LayerNorm for W_o, with the bias
and the residual. The plans are computed here and checked by the C
entries; a cluster regime launch the card cannot hold raises there. gamma
and beta are read as the model holds them (bf16 or f32), pe
as f32: the host casts nothing. On a head shard (tensor parallelism) the
q/k/v weights are (H_local d, C) and W_o (C, H_local d): the kernels write
o (M, H_local d) and the W_o GEMM runs without its residual and bias
(`residual=False`), which the caller adds once after the reduce. K4 takes
every token count L and up to 32 frames (the TPU's L % 128 == 0 gate was a
tiling rule); the head dims are those of `_HEAD_DIMS`. Bound on the H100
for the whole: operations (the four C x C products).

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


# K4's plans (csrc/motion_attn.cu). The fused regime: x (B, F, L, C) with
# C <= 320 and d <= 64; the cluster regime: d = 80, 128, 160; the per-head
# regime: every other shape
SMEM_LIMIT = 232448   # 227 KB a block on the H100
TWO_BLOCKS = 115712   # two blocks an SM: (228 KB - 2 x 1 KB reserved) / 2
SMS = 132             # the H100's SMs: the fused regime's persistent grid
_PAD = 4              # f32 padding of a staged q/k row
_HEAD_ROWS = 128      # rows of a per-head block: 64 a warpgroup
_HEAD_DIMS = (16, 32, 40, 64, 80, 96, 128, 160)
_MAX_CHANNELS = 2048  # ln_pe holds a row in one warp's registers
_FUSED_C, _FUSED_D = 320, 64  # the fused regime's widest rows and heads
# the cluster regime's head dims and the CTAs of a cluster, each loading
# 1 / cs of a head's weight chunks for all of them (d / cs a multiple of 8)
_CLUSTER = {80: 2, 128: 4, 160: 4}


def _up(v: int, a: int) -> int:
    return -(-v // a) * a


def fused_smem(d: int, channels: int, stages: int) -> int:
    """Shared-memory bytes of a fused block (as `fused_smem` in
    csrc/motion_attn.cu): alignment slack; the stripe (128 rows x C); the
    weight stages (a 64-column chunk of the head's W_q, W_k and W_v); two
    attention groups (q and k in f32, P and v transposed in bf16); the f32
    table of gamma and beta; the mbarriers."""
    stripe = _up(channels, 64) // 64 * 128 * 128
    stage = _up(3 * d * 128, 1024)
    group = _up(2 * 64 * (d + _PAD) * 4, 1024) + 64 * 128 + d * 128
    return 1024 + stripe + stages * stage + 2 * group + 2 * channels * 4 + 8 * (2 * stages + 3)


def attn_smem(d: int, stages: int, frames: int, lt: int) -> int:
    """Shared-memory bytes of a per-head block (as `attn_smem` in
    csrc/motion_attn.cu): alignment slack, the ring of (h chunk, W_q, W_k,
    W_v chunks) stages or the staged q/k/v that alias it, the (Lt, F, F)
    probabilities and the mbarriers."""
    ring = stages * (_HEAD_ROWS * 128 + 3 * d * 128)
    region = max(ring, 3 * _HEAD_ROWS * (d + _PAD) * 4)
    probs = -(-lt * frames * frames * 4 // 16) * 16
    return 1024 + region + probs + 8 * stages


def cluster_smem(d: int, stages: int) -> int:
    """Shared-memory bytes of a cluster-regime CTA (as `cl_smem` in
    csrc/motion_attn.cu): alignment slack; the ring of stages (the CTA's h
    chunk, 64 rows x 64 columns a group, and the head's W_q, W_k and W_v
    chunks), whose last stages the attention's staging aliases (q and k in
    f32, P and v transposed in bf16: one group at d >= 128, else two); the
    mbarriers."""
    return 1024 + stages * cluster_stage(d) + 16 * stages


def cluster_stage(d: int) -> int:
    """A cluster-regime ring stage: 64 columns of the CTA's h rows and of
    the head's three weights."""
    return _up(((1 if d >= 128 else 2) * 64 + 3 * d) * 128, 1024)


def cluster_staging(d: int) -> int:
    """The cluster regime's attention staging (aliasing the ring's tail)."""
    group = _up(2 * 64 * (d + _PAD) * 4, 1024) + 64 * 128 + d * 128
    return (1 if d >= 128 else 2) * group


def attn_plan(frames: int, tokens: int, channels: int, heads: int,
              inner: Optional[int] = None, batch: int = 1) -> dict:
    """K4's plan for x (batch, F, L, C) and `heads` heads of d = inner /
    heads (inner = C unless the weights are a head shard of (inner, C)).

    The fused regime (C <= 320, d <= 64): Lh = min(64 // F, L) tokens a
    64-row half (frame-major rows f Lh + t), 2 Lh tokens a unit; the deepest
    weight ring (2-8 stages) that fits 227 KB; the heads a unit (hg, a
    divisor of the heads: the fewest groups that fill the card as well as
    any) and the persistent grid (at most one block an SM).

    The cluster regime (d = 80, 128, 160): Lh = min(64 // F, L) tokens a
    64-row group, two groups a CTA at d = 80 and one above; cs CTAs a
    cluster (2 at d = 80, 4 above: d / cs rows of each weight a CTA); the
    deepest ring of 64-column stages that fits (the staging aliases its
    last stages, `free` stages are left); units = heads x the clusters'
    token-block groups. The grid (as many clusters as the card holds at
    once) is the C entry's.

    The per-head regime (d <= 64 at C > 320, and d = 96): 128 rows a block
    (two warpgroups of 64 rows); Lt = 128 // F tokens; the deepest ring
    (2-4 stages) that lets two blocks share an SM, else the deepest that
    fits one. Raises on a shape it does not take."""
    inner = channels if inner is None else inner
    d = inner // heads
    if inner != heads * d or d not in _HEAD_DIMS or channels % 8 != 0:
        raise ValueError(f"K4 takes inner = heads * d with d in {_HEAD_DIMS} and C % 8 == 0, "
                         f"got inner = {inner}, {heads} heads, C = {channels}")
    if not 1 <= frames <= 32:
        raise ValueError(f"K4 takes 1 to 32 frames, got {frames}")
    if channels > _MAX_CHANNELS:
        raise ValueError(f"K4's LayerNorm pre-pass takes C <= {_MAX_CHANNELS}, got {channels}")
    if channels <= _FUSED_C and d <= _FUSED_D:
        lh = min(64 // frames, tokens)
        fits = [s for s in range(8, 1, -1) if fused_smem(d, channels, s) <= SMEM_LIMIT]
        if fits:
            items = batch * -(-tokens // (2 * lh))
            # makespan in heads, ceil(units / SMs) rounds of hg heads each
            # plus a quarter of a head for each unit's own stripe: the fewest
            # head groups within 5 % of the best
            cost = {g: -(-items * g // SMS) * (heads // g + 0.25)
                    for g in range(1, heads + 1) if heads % g == 0}
            groups = min(g for g in cost if cost[g] <= 1.05 * min(cost.values()))
            units = items * groups
            return dict(regime="fused", lh=lh, stages=fits[0], hg=heads // groups,
                        groups=groups, units=units, grid=min(units, SMS),
                        smem=fused_smem(d, channels, fits[0]))
    if d in _CLUSTER:
        cs, groups = _CLUSTER[d], 1 if d >= 128 else 2
        lh = min(64 // frames, tokens)
        # the deepest ring that fits, which leaves a stage or more to the
        # next unit's loads while the staging holds the rest
        stages = max(s for s in range(2, 9) if cluster_smem(d, s) <= SMEM_LIMIT)
        free = (stages * cluster_stage(d) - cluster_staging(d)) // cluster_stage(d)
        if free < 1:
            raise ValueError(f"K4: no cluster plan at d = {d}")
        blocks = batch * -(-tokens // (groups * lh))
        return dict(regime="cluster", cs=cs, lh=lh, groups=groups, stages=stages, free=free,
                    units=heads * -(-blocks // cs), smem=cluster_smem(d, stages))
    lt = max(1, min(_HEAD_ROWS // frames, tokens))
    fits = [s for s in (4, 3, 2) if attn_smem(d, s, frames, lt) <= TWO_BLOCKS]
    if not fits:
        fits = [s for s in (4, 3, 2) if attn_smem(d, s, frames, lt) <= SMEM_LIMIT]
    if not fits:
        raise ValueError(f"K4: no plan fits {SMEM_LIMIT} bytes at d = {d}, {frames} frames")
    stages = fits[0]
    return dict(regime="heads", lt=lt, stages=stages, smem=attn_smem(d, stages, frames, lt))


def _check_param(t, n: int, what: str) -> None:
    if tuple(t.shape) != (n,) or not t.is_contiguous() or t.data_ptr() % 16:
        raise ValueError(f"K4 takes a contiguous, 16-byte aligned ({n},) {what}")


def _launch(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads, eps, residual=True):
    global LAUNCHES
    b, f, l, c = x.shape
    inner = wq.shape[0]
    plan = attn_plan(f, l, c, heads, inner, b)
    if not x.is_contiguous() or x.dtype != torch.bfloat16:
        raise ValueError("K4 takes a contiguous bf16 input")
    for w, shape in ((wq, (inner, c)), (wk, (inner, c)), (wv, (inner, c)), (wo, (c, inner))):
        if w.dtype != torch.bfloat16 or tuple(w.shape) != shape or not w.is_contiguous():
            raise ValueError(f"K4 takes contiguous bf16 ({inner}, {c}) q/k/v and ({c}, {inner}) "
                             "W_o weights")
    # gamma and beta are read as the model holds them, pe as f32: no cast
    if gamma.dtype != beta.dtype or gamma.dtype not in (torch.bfloat16, torch.float32):
        raise ValueError("K4 takes gamma and beta in bf16 or f32, of one dtype")
    _check_param(gamma, c, "gamma")
    _check_param(beta, c, "beta")
    if tuple(pe.shape) != (f, c) or pe.dtype != torch.float32 or not pe.is_contiguous() \
            or pe.data_ptr() % 16:
        raise ValueError(f"K4 takes a contiguous f32 pe ({f}, {c}), got {tuple(pe.shape)} "
                         f"{pe.dtype}")
    x2 = x.reshape(-1, c)
    o = torch.empty((x2.shape[0], inner), dtype=x.dtype, device=x.device)
    d = inner // heads
    ln_bf16 = int(gamma.dtype == torch.bfloat16)
    stream = _build.stream_ptr(x2)
    lib = _build.load("motion_attn")
    if plan["regime"] == "fused":
        rc = lib.mmgt_motion_fused(
            x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ln_bf16, pe.data_ptr(),
            wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), o.data_ptr(), b, f, l, c, heads, d,
            1.0 / math.sqrt(d), float(eps), plan["lh"], plan["stages"], plan["hg"], plan["grid"],
            plan["smem"], stream)
        _build.check(lib, rc, "motion attention (K4, fused)")
    else:
        h = torch.empty((x2.shape[0], c), dtype=torch.bfloat16, device=x.device)
        rc = lib.mmgt_ln_pe(x.data_ptr(), gamma.data_ptr(), beta.data_ptr(), ln_bf16,
                            pe.data_ptr(), h.data_ptr(), b * f * l, l, f, c, float(eps), stream)
        _build.check(lib, rc, "LayerNorm + pe (K4)")
        ws = (h.data_ptr(), wq.data_ptr(), wk.data_ptr(), wv.data_ptr(), o.data_ptr(), b, f, l, c,
              heads, d, 1.0 / math.sqrt(d))
        if plan["regime"] == "cluster":
            rc = lib.mmgt_motion_cluster(*ws, plan["cs"], plan["lh"], plan["stages"],
                                         plan["smem"], stream)
            _build.check(lib, rc, "motion attention (K4, clusters)")
        else:
            rc = lib.mmgt_motion_heads(*ws, plan["lt"], plan["stages"], plan["smem"], stream)
            _build.check(lib, rc, "motion attention (K4, per head)")
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
