"""Core layers shared by every model of the port (`mmgt_tpu/nn/layers.py`).

Channel-last everywhere: images (N, H, W, C), tokens (N, L, C). Parameter
names follow the reference's torch state dicts (`weight`, `bias`,
`to_out.0`, `ff.net.0.proj`, ...), so a module's `state_dict()` keys are
the reference checkpoint's keys. The lane-packed projections of the JAX
package (`_PackedQKV`, `_PackedOut`) are a TPU layout and have no
counterpart here.

Tensor parallelism: `parallel.mesh.shard_` leaves each rank the slice of
every q/k/v, GEGLU-in, to_out and FFN-out weight that the JAX rules give
it and sets `module.tp` (the mesh) on every module. Then `Attention` runs
on its local heads (q/k/v column slices, K1 on those heads, a row-parallel
to_out whose bias is added once after the reduce) and `FeedForward` on its
GEGLU half-pairs (hidden[r], gate[r]) with a row-parallel proj_out. An
attention with fewer heads than tp ranks (the VAE's one head at d = 512)
gathers its q/k/v shards before K1 and slices o for to_out, as XLA
gathers around a custom call. Without a mesh (`tp` unset) every layer
computes as before.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmgt_tpu_torch.ops.attention import flash_attention
from mmgt_tpu_torch.parallel.collectives import (
    copy_to_tp,
    gather_last,
    reduce_from_tp,
    tp_slice_last,
)
from mmgt_tpu_torch.parallel.mesh import local_slice
from mmgt_tpu_torch.ops.fused_ln import ln_projections
from mmgt_tpu_torch.ops.norms import group_norm, layer_norm


def tp_mesh(module: nn.Module):
    """The mesh `shard_` gave `module` (tp > 1), else None."""
    return getattr(module, "tp", None)


def col_bias(lin: nn.Linear) -> Optional[torch.Tensor]:
    """A column-parallel layer's bias slice; the bias itself stays whole
    (replicated), and its gradient is summed over tp."""
    mesh = tp_mesh(lin)
    if lin.bias is None or mesh is None:
        return lin.bias
    return local_slice(copy_to_tp(lin.bias, mesh), lin.tp_shard, mesh)


def col_linear(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """`lin(x)`; on a column shard, the local output columns of the
    replicated x."""
    mesh = tp_mesh(lin)
    if mesh is None:
        return lin(x)
    return F.linear(copy_to_tp(x, mesh), lin.weight, col_bias(lin))


def row_linear(x_local: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """`lin(x)`; on a row shard, x's local columns times the local weight,
    reduced over tp, then the bias once."""
    mesh = tp_mesh(lin)
    if mesh is None:
        return lin(x_local)
    y = reduce_from_tp(F.linear(x_local, lin.weight), mesh)
    return y if lin.bias is None else y + lin.bias


def row_linear_replicated(x: torch.Tensor, lin: nn.Linear) -> torch.Tensor:
    """`lin(x)` for a replicated x; on a row shard, x is sliced first."""
    mesh = tp_mesh(lin)
    if mesh is None:
        return lin(x)
    return row_linear(tp_slice_last(x, mesh), lin)


def timestep_embedding(t: torch.Tensor, dim: int, flip_sin_to_cos: bool = True,
                       downscale_freq_shift: float = 0.0,
                       max_period: float = 10000.0) -> torch.Tensor:
    """Sinusoidal timestep embedding (SD1.5 time_proj with the defaults)."""
    half = dim // 2
    freqs = torch.exp(
        -math.log(max_period)
        * torch.arange(half, dtype=torch.float32, device=t.device)
        / (half - downscale_freq_shift)
    )
    args = t.float()[:, None] * freqs[None, :]
    emb = torch.cat([torch.sin(args), torch.cos(args)], -1)
    if flip_sin_to_cos:
        emb = torch.cat([emb[:, half:], emb[:, :half]], -1)
    if dim % 2 == 1:
        emb = F.pad(emb, (0, 1))
    return emb


class TimestepEmbedding(nn.Module):
    """linear -> silu -> linear time-embedding MLP."""

    def __init__(self, in_dim: int, dim: int):
        super().__init__()
        self.linear_1 = nn.Linear(in_dim, dim)
        self.linear_2 = nn.Linear(dim, dim)

    def forward(self, t_emb):
        return self.linear_2(F.silu(self.linear_1(t_emb)))


class GroupNorm(nn.Module):
    """GroupNorm over trailing channels (K2 on the card), per leading row;
    frames fold into the batch first (the reference's InflatedGroupNorm)."""

    def __init__(self, num_channels: int, num_groups: int = 32, eps: float = 1e-5,
                 act: Optional[str] = None):
        super().__init__()
        self.num_groups = (
            num_groups if num_channels % num_groups == 0
            else math.gcd(num_channels, num_groups)
        )
        self.eps = eps
        self.act = act
        self.weight = nn.Parameter(torch.ones(num_channels))
        self.bias = nn.Parameter(torch.zeros(num_channels))

    def forward(self, x):
        return group_norm(x, self.num_groups, self.weight, self.bias, self.eps, self.act)


class LayerNorm(nn.Module):
    """LayerNorm with f32 statistics. Callers that fuse the normalisation
    into their projections (K3) read `weight`, `bias` and `eps` instead of
    calling it."""

    def __init__(self, dim: int, eps: float = 1e-5):
        super().__init__()
        self.eps = eps
        self.weight = nn.Parameter(torch.ones(dim))
        self.bias = nn.Parameter(torch.zeros(dim))

    def forward(self, x):
        return layer_norm(x, self.weight, self.bias, self.eps)


class ConvNHWC(nn.Conv2d):
    """nn.Conv2d on channel-last tensors: the (N, H, W, C) input is handed
    to cuDNN as a channels_last NCHW view, so no transpose is written."""

    def forward(self, x):
        return super().forward(x.permute(0, 3, 1, 2)).permute(0, 2, 3, 1).contiguous()


class _GEGLUProj(nn.Module):
    def __init__(self, dim: int, out: int):
        super().__init__()
        self.proj = nn.Linear(dim, out)


class FeedForward(nn.Module):
    """GEGLU feed-forward (dim -> mult*dim -> dim), diffusers key layout.

    `pre_norm`: the caller's LayerNorm, fused into the GEGLU projection
    (K3 on the card)."""

    def __init__(self, dim: int, mult: int = 4):
        super().__init__()
        inner = dim * mult
        self.net = nn.ModuleList([_GEGLUProj(dim, inner * 2), nn.Identity(),
                                  nn.Linear(inner, dim)])

    def forward(self, x, pre_norm: Optional[LayerNorm] = None):
        proj = self.net[0].proj
        mesh = tp_mesh(self)
        if pre_norm is not None:
            (h,) = ln_projections(copy_to_tp(x, mesh), copy_to_tp(pre_norm.weight, mesh),
                                  copy_to_tp(pre_norm.bias, mesh), (proj.weight,),
                                  (col_bias(proj),), pre_norm.eps)
        else:
            h = col_linear(x, proj)
        h, gate = h.chunk(2, dim=-1)
        return row_linear(h * F.gelu(gate), self.net[2])


class Attention(nn.Module):
    """Multi-head attention with an optional context (cross) input.

    Biasless to_q/to_k/to_v and a biased to_out.0 (diffusers layout).
    forward(x, context, kv_lens, pre_norm, bank_kv, bank):
      * `pre_norm`: the caller's LayerNorm; for self-attention it fuses into
        the q/k/v projections (K3);
      * `bank_kv`: pre-projected (k, v) reference-bank operands, each
        (1, L_bank, heads, head_dim), appended to the self keys by K1's
        second segment; `kv_lens` gates them per row (inference);
      * `bank`: raw reference tokens (B, L_bank, C), one set per row,
        projected by to_k/to_v and concatenated after the self K/V, gated
        per row by `kv_lens` (training, `mmgt_tpu/nn/layers.py:333-339`);
      * one context token and no kv_lens: softmax over one key is 1, so the
        result is to_out(to_v(context)) broadcast over the queries.
    """

    def __init__(self, query_dim: int, heads: int, head_dim: int,
                 out_dim: Optional[int] = None, context_dim: Optional[int] = None):
        super().__init__()
        inner = heads * head_dim
        self.heads, self.head_dim = heads, head_dim
        ctx = context_dim or query_dim
        self.to_q = nn.Linear(query_dim, inner, bias=False)
        self.to_k = nn.Linear(ctx, inner, bias=False)
        self.to_v = nn.Linear(ctx, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, out_dim or query_dim), nn.Identity()])

    def forward(self, x, context=None, kv_lens=None, pre_norm: Optional[LayerNorm] = None,
                bank_kv=None, bank=None):
        b, lq = x.shape[0], x.shape[1]
        if (bank_kv is not None or bank is not None) and context is not None:
            raise ValueError("bank extends SELF-attention K/V only")
        if bank_kv is not None and bank is not None:
            raise ValueError("pass the bank raw or pre-projected, not both")
        mesh = tp_mesh(self)
        # fewer heads than tp ranks: the q/k/v shards are gathered
        gather = mesh is not None and self.heads % mesh.tp != 0
        if context is not None and context.shape[1] == 1 and kv_lens is None:
            v1 = col_linear(context, self.to_v)
            out = self._out(gather_last(v1, mesh) if gather else v1, gather)
            return out.expand(b, lq, out.shape[-1])
        if pre_norm is not None and context is None:
            q, k, v = ln_projections(
                copy_to_tp(x, mesh), copy_to_tp(pre_norm.weight, mesh),
                copy_to_tp(pre_norm.bias, mesh),
                (self.to_q.weight, self.to_k.weight, self.to_v.weight),
                (None, None, None), pre_norm.eps,
            )
        else:
            x_in = pre_norm(x) if pre_norm is not None else x
            kv = x_in if context is None else context
            q, k, v = col_linear(x_in, self.to_q), col_linear(kv, self.to_k), \
                col_linear(kv, self.to_v)
        if bank is not None:
            k = torch.cat([k, col_linear(bank, self.to_k)], 1)
            v = torch.cat([v, col_linear(bank, self.to_v)], 1)
        if gather:
            q, k, v = gather_last(q, mesh), gather_last(k, mesh), gather_last(v, mesh)
        d = self.head_dim
        q = q.reshape(b, lq, -1, d)
        k = k.reshape(b, k.shape[1], -1, d)
        v = v.reshape(b, v.shape[1], -1, d)
        kb, vb = bank_kv if bank_kv is not None else (None, None)
        o = flash_attention(q, k, v, kv_lens, kb, vb)
        return self._out(o.reshape(b, lq, -1), gather)

    def _out(self, o, gathered: bool):
        """to_out.0 on the (local-head or gathered) attention output."""
        lin = self.to_out[0]
        return row_linear_replicated(o, lin) if gathered else row_linear(o, lin)
