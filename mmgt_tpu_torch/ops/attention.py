"""Attention: the plain PyTorch version and kernel K1 (csrc/flash_attn.cu).

Layout: (batch, seq, heads, head_dim), the projections' own layout, so no
head transposes are written. One wrapper, `flash_attention`, covers every
flash call site of the JAX package (`mmgt_tpu/ops/attention.py`):

* self-attention over one segment with optional per-row `kv_lens`
  (`_flash_attention`, `_flash_attention_fwd_lse`,
  `_flash_attention_packed_fwd`);
* the two-segment bank form (`_flash_attention_packed_2seg_fwd`): a
  batch-1 bank `(1, Lb, H, D)` shared by every row follows the self keys,
  and `kv_lens` (the valid prefix of [self ; bank]) turns it off for the
  CFG-uncond rows;
* the optional f32 log-sum-exp, shaped (B, H, Sq).

Replaces: mmgt_tpu/ops/attention.py:_flash_kernel, _flash_fwd_lse_kernel
and _flash_fwd_lse_2seg_kernel. Bound on the H100: operations (see the
source note in csrc/flash_attn.cu for the design).

The backward is kernel K5 (csrc/flash_attn_bwd.cu, `flash_attention_bwd`),
which replaces `_flash_attention_bwd` (its dq and dk/dv kernels). When
autograd is on and an input requires grad, `flash_attention` runs through
`_FlashAttention`: the forward is K1 with the LSE, the backward K5 (the
bank form concatenates the broadcast bank into the self keys and sums the
bank's dK/dV over the batch, as `_packed_2seg_bwd`). Under `no_grad` the
wrapper launches K1 alone.

On a CPU tensor the wrappers run `attention_plain` / `attention_bwd_plain`;
on a CUDA tensor they launch K1 / K5 or raise. `attention_plain` is also
what the MM-HAA audio cross-attention uses directly: its 32-token KV runs
the XLA math in the JAX package too (`dot_product_attention` picks
`_xla_attention` there).

`dot_product_attention` is the JAX package's routing function of the same
name for the encoders and Stage 1 (CLIP, wav2vec2, SMGA): the plain math
under 512 tokens, K1 (in bf16) at 512 or more on both sides.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple, Union

import torch

from mmgt_tpu_torch.ops import _build
from mmgt_tpu_torch.ops._vjp import needs_grad

NEG_INF = -1e30
LAUNCHES = 0  # K1 launches; a run reads it to prove the path used the kernel
BWD_LAUNCHES = 0  # K5 launches (one per flash_attention_bwd call on the card)


def attention_plain(q, k, v, kv_lens=None, k_bank=None, v_bank=None,
                    scale: Optional[float] = None, return_lse: bool = False):
    """Reference math of K1: f32 logits and softmax, probabilities rounded
    to v's dtype, f32 product sums. Keys past a row's kv_len are masked;
    a row with no valid key returns 0."""
    b, sq, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    if k_bank is not None:
        k = torch.cat([k, k_bank.expand(b, *k_bank.shape[1:])], 1)
        v = torch.cat([v, v_bank.expand(b, *v_bank.shape[1:])], 1)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), k.float()) * scale
    if kv_lens is not None:
        col = torch.arange(k.shape[1], device=q.device)
        valid = (col[None, :] < kv_lens.to(q.device)[:, None])[:, None, None, :]
    else:
        valid = torch.ones((1, 1, 1, k.shape[1]), dtype=torch.bool, device=q.device)
    logits = torch.where(valid, logits, torch.full_like(logits, NEG_INF))
    m = logits.amax(-1, keepdim=True)
    p = torch.exp(logits - m) * valid
    l = p.sum(-1, keepdim=True).clamp_min(1e-30)
    probs = (p / l).to(v.dtype)
    o = torch.einsum("bhqk,bkhd->bqhd", probs.float(), v.float()).to(q.dtype)
    if return_lse:
        return o, (m + torch.log(l))[..., 0]
    return o


def attention_bwd_plain(q, k, v, o, do, lse, kv_lens=None, scale: Optional[float] = None):
    """Reference math of K5 (`_flash_dq_kernel` / `_flash_dkv_kernel`), all
    in f32: D = rowsum(dO o O), P = exp(s * scale - lse) over the columns
    < kv_len (masked before the exp), dV = P^T dO, dS = P o (dO V^T - D),
    dQ = scale dS K, dK = scale dS^T Q. lse is (B, H, Sq)."""
    b, sq, h, d = q.shape
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    qf, kf, vf, dof = q.float(), k.float(), v.float(), do.float()
    dsum = (dof * o.float()).sum(-1).transpose(1, 2)                  # (B, H, Sq)
    s = torch.einsum("bqhd,bkhd->bhqk", qf, kf) * scale
    if kv_lens is not None:
        col = torch.arange(k.shape[1], device=q.device)
        valid = (col[None, :] < kv_lens.to(q.device)[:, None])[:, None, None, :]
        s = torch.where(valid, s - lse.float()[..., None], torch.full_like(s, NEG_INF))
    else:
        s = s - lse.float()[..., None]
    p = torch.exp(s)
    dv = torch.einsum("bhqk,bqhd->bkhd", p, dof)
    dp = torch.einsum("bqhd,bkhd->bhqk", dof, vf)
    ds = p * (dp - dsum[..., None])
    dq = torch.einsum("bhqk,bkhd->bqhd", ds, kf) * scale
    dk = torch.einsum("bhqk,bqhd->bkhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


WIDE_TILE = 64  # the query and key tiles of K1's d > 160 path
MAX_SPLITS = 4  # csrc/flash_attn.cu, `kMaxSplits`


def wide_splits(b: int, h: int, sq: int, keys: int, sms: int) -> int:
    """How many key ranges K1's d > 160 path splits a row's keys into: one
    block per (64-query tile, head, row) fills fewer than half the SMs at
    the reference encode's (1, 4096, 1, 512) (64 blocks on 132), so each
    block takes 1/n of the key tiles and a second grid combines the n
    partial outputs in a fixed order. n = SMs // blocks, at most 4 and at
    most the key tiles."""
    blocks = -(-sq // WIDE_TILE) * h * b
    return max(1, min(MAX_SPLITS, sms // blocks, -(-keys // WIDE_TILE)))


def _launch(q, k, v, kv_lens, k_bank, v_bank, scale, return_lse):
    global LAUNCHES
    b, sq, h, d = q.shape
    dev = q.device
    # each tensor's shape, strides and address are read once: the host's
    # time is most of a small call's wall time
    shapes, strides, ptrs = [], [], []
    for t in (q, k, v) if k_bank is None else (q, k, v, k_bank, v_bank):
        shape, st = t.shape, t.stride()
        if t.dtype != torch.bfloat16 or t.device != dev:
            raise ValueError("K1 takes bf16 CUDA tensors on one device")
        if len(shape) != 4 or st[3] != 1 or shape[2] != h or shape[3] != d:
            raise ValueError(f"K1 takes (B, S, {h}, {d}) tensors with unit last stride")
        ptr = t.data_ptr()  # the kernel loads 16-byte vectors
        if ptr % 16 or any(n > 1 and s_ % 8 for s_, n in zip(st[:3], shape[:3])):
            raise ValueError("K1 takes 16-byte aligned tensors with strides a multiple of 8")
        shapes.append(shape)
        strides.append(st)
        ptrs.append(ptr)
    if shapes[1][0] != b or shapes[2][:2] != shapes[1][:2]:
        raise ValueError("self K/V must match the query batch")
    if k_bank is not None and (shapes[3][0] != 1 or shapes[4][:2] != shapes[3][:2]):
        raise ValueError("the bank is batch 1, shared by every row")
    if d > 512 or d % 8:
        raise ValueError(f"K1 takes a head_dim <= 512 and a multiple of 8, got {d}")
    ls = shapes[1][1]
    lb = 0 if k_bank is None else shapes[3][1]
    lens = None
    if kv_lens is not None:
        lens = kv_lens.to(device=dev, dtype=torch.int32).contiguous()
        if lens.shape != (b,):
            raise ValueError(f"kv_lens must be ({b},)")
    o = torch.empty((b, sq, h, d), dtype=q.dtype, device=dev)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=dev) if return_lse else None
    nsplit = 1 if d <= 160 else wide_splits(
        b, h, sq, ls + lb, torch.cuda.get_device_properties(dev).multi_processor_count)
    # the splits' f32 outputs and LSEs (csrc/flash_attn.cu, `WideParams::part`)
    part = (torch.empty(nsplit * b * h * sq * (d + 1), dtype=torch.float32, device=dev)
            if nsplit > 1 else None)
    if k_bank is None:  # the bank's strides are not read without a bank
        ptrs += [0, 0]
        strides += strides[1:3]
    lib = _build.load("flash_attn")
    rc = lib.mmgt_flash_attn(
        *ptrs, _build.ptr(lens), o.data_ptr(), _build.ptr(lse), _build.ptr(part),
        *strides[0][:3], *strides[1][:3], *strides[2][:3], *strides[3][1:3], *strides[4][1:3],
        sq * h * d, h * d, d,  # o's strides: contiguous
        b, h, sq, ls, lb, d, nsplit, float(scale), _build.stream_ptr(q),
    )
    _build.check(lib, rc, "flash attention (K1)")
    LAUNCHES += 1
    return (o, lse) if return_lse else o


def _launch_bwd(q, k, v, o, do, lse, kv_lens, scale):
    global BWD_LAUNCHES
    b, sq, h, d = q.shape
    skv = k.shape[1]
    if d > 160 or d % 8:
        raise ValueError(f"K5 takes a head_dim <= 160 and a multiple of 8, got {d}")
    if do.stride(-1) != 1:
        do = do.contiguous()
    for t, s_len in ((q, sq), (k, skv), (v, skv), (o, sq), (do, sq)):
        if t.device != q.device or t.dtype != torch.bfloat16:
            raise ValueError("K5 takes bf16 CUDA tensors on one device")
        if t.shape != (b, s_len, h, d) or t.stride(-1) != 1:
            raise ValueError(f"K5 takes (B, S, {h}, {d}) tensors with unit last stride")
        if t.data_ptr() % 16 or any(st % 8 for st, n in zip(t.stride()[:3], t.shape[:3])
                                    if n > 1):
            raise ValueError("K5 takes 16-byte aligned tensors with strides a multiple of 8")
    if lse.shape != (b, h, sq) or lse.dtype != torch.float32 or not lse.is_contiguous():
        raise ValueError(f"K5 takes a contiguous f32 lse of shape ({b}, {h}, {sq})")
    lens = None
    if kv_lens is not None:
        lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
        if lens.shape != (b,):
            raise ValueError(f"kv_lens must be ({b},)")
    # the kernel's statistics (lse * log2(e) and D), queries padded to a
    # multiple of 128 (csrc/flash_attn_bwd.cu, `kStatsPad`)
    stats = torch.empty((b, h, 2, -(-sq // 128) * 128), dtype=torch.float32, device=q.device)
    dq = torch.empty((b, sq, h, d), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, skv, h, d), dtype=q.dtype, device=q.device)
    dv = torch.empty((b, skv, h, d), dtype=q.dtype, device=q.device)
    strides = [st for t in (q, k, v, o, do, dq, dk, dv) for st in t.stride()[:3]]
    lib = _build.load("flash_attn_bwd")
    rc = lib.mmgt_flash_attn_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), do.data_ptr(),
        lse.data_ptr(), _build.ptr(lens), stats.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), *strides,
        b, h, sq, skv, d, float(scale), _build.stream_ptr(q),
    )
    _build.check(lib, rc, "flash attention backward (K5)")
    BWD_LAUNCHES += 1
    return dq, dk, dv


def flash_attention_bwd(q, k, v, o, do, lse, kv_lens=None, scale: Optional[float] = None):
    """(dq, dk, dv) of softmax(q k^T * scale) v over (B, S, H, D), from the
    forward's output o and log-sum-exp lse (B, H, Sq); keys past a row's
    kv_len get no probability and zero gradient."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return attention_bwd_plain(q, k, v, o, do, lse, kv_lens, scale)
    if q.device.type != "cuda":
        raise ValueError(f"no attention backward kernel for device {q.device}")
    return _launch_bwd(q, k, v, o, do, lse, kv_lens, scale)


class _FlashAttention(torch.autograd.Function):
    """K1 forward (saving its LSE), K5 backward; plain versions on the CPU."""

    @staticmethod
    def forward(ctx, q, k, v, kv_lens, k_bank, v_bank, scale):
        o, lse = flash_attention(q, k, v, kv_lens, k_bank, v_bank, scale, return_lse=True)
        ctx.scale = scale
        ctx.save_for_backward(q, k, v, kv_lens, k_bank, v_bank, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, kv_lens, k_bank, v_bank, o, lse = ctx.saved_tensors
        b, ls = q.shape[0], k.shape[1]
        if k_bank is not None:
            k = torch.cat([k, k_bank.expand(b, *k_bank.shape[1:])], 1)
            v = torch.cat([v, v_bank.expand(b, *v_bank.shape[1:])], 1)
        dq, dk, dv = flash_attention_bwd(q, k, v, o, do, lse, kv_lens, ctx.scale)
        dkb = dvb = None
        if k_bank is not None:
            dkb = dk[:, ls:].sum(0, keepdim=True, dtype=torch.float32).to(k_bank.dtype)
            dvb = dv[:, ls:].sum(0, keepdim=True, dtype=torch.float32).to(v_bank.dtype)
            dk, dv = dk[:, :ls], dv[:, :ls]
        return dq, dk, dv, None, dkb, dvb, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    kv_lens: Optional[torch.Tensor] = None,
    k_bank: Optional[torch.Tensor] = None,
    v_bank: Optional[torch.Tensor] = None,
    scale: Optional[float] = None,
    return_lse: bool = False,
) -> Union[torch.Tensor, Tuple[torch.Tensor, torch.Tensor]]:
    """softmax(q [k; k_bank]^T * scale) [v; v_bank] over (B, S, H, D).

    kv_lens (B,): valid prefix of the concatenated keys per row. With one
    key, no bank and no kv_lens the result is v broadcast (softmax over one
    key is identically 1), as in the JAX package. Differentiable: with
    autograd on and an input that requires grad, the backward is K5."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if k.shape[1] == 1 and kv_lens is None and k_bank is None and not return_lse:
        return v.expand(q.shape[0], q.shape[1], *v.shape[2:]).to(q.dtype)
    if q.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no attention kernel for device {q.device}")
    if not return_lse and needs_grad(q, k, v, k_bank, v_bank):
        return _FlashAttention.apply(q, k, v, kv_lens, k_bank, v_bank, scale)
    if q.device.type == "cpu":
        return attention_plain(q, k, v, kv_lens, k_bank, v_bank, scale, return_lse)
    return _launch(q, k, v, kv_lens, k_bank, v_bank, scale, return_lse)


FLASH_MIN_SEQ = 512  # both sides at least this long: K1 (the JAX package's rule)


def dot_product_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                          scale: Optional[float] = None) -> torch.Tensor:
    """Full attention over (B, S, H, D), routed as the JAX package's
    `dot_product_attention` (`mmgt_tpu/ops/attention.py:679-688`): the plain
    math (`attention_plain`, which is `_xla_attention`'s) on the CPU or when
    either side has fewer than 512 tokens (CLIP's 257, SMGA's 80-82,
    wav2vec2's 50 frames a second of a clip shorter than 10.24 s), K1 on a
    CUDA tensor otherwise.
    K1 takes bf16 only: f32 inputs (wav2vec2 on long audio) are rounded to
    bf16 around it and its output cast back; chip_smoke.py states that
    route's error against the f32 plain version."""
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    if k.shape[1] == 1:  # softmax over a single key is identically 1
        return v.expand(q.shape[0], q.shape[1], *v.shape[2:]).to(q.dtype)
    if q.device.type == "cpu" or min(q.shape[1], k.shape[1]) < FLASH_MIN_SEQ:
        return attention_plain(q, k, v, scale=scale)
    bf = torch.bfloat16
    return flash_attention(q.to(bf), k.to(bf), v.to(bf), scale=scale).to(q.dtype)
