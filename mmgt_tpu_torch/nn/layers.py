"""Core layers shared by every model of the port (`mmgt_tpu/nn/layers.py`).

Channel-last everywhere: images (N, H, W, C), tokens (N, L, C). Parameter
names follow the reference's torch state dicts (`weight`, `bias`,
`to_out.0`, `ff.net.0.proj`, ...), so a module's `state_dict()` keys are
the reference checkpoint's keys. The lane-packed projections of the JAX
package (`_PackedQKV`, `_PackedOut`) are a TPU layout and have no
counterpart here.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from mmgt_tpu_torch.ops.attention import flash_attention
from mmgt_tpu_torch.ops.fused_ln import ln_projections
from mmgt_tpu_torch.ops.norms import group_norm, layer_norm


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
        if pre_norm is not None:
            (h,) = ln_projections(x, pre_norm.weight, pre_norm.bias, (proj.weight,),
                                  (proj.bias,), pre_norm.eps)
        else:
            h = proj(x)
        h, gate = h.chunk(2, dim=-1)
        return self.net[2](h * F.gelu(gate))


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
        if context is not None and context.shape[1] == 1 and kv_lens is None:
            out = self.to_out[0](self.to_v(context))
            return out.expand(b, lq, out.shape[-1])
        if pre_norm is not None and context is None:
            q, k, v = ln_projections(
                x, pre_norm.weight, pre_norm.bias,
                (self.to_q.weight, self.to_k.weight, self.to_v.weight),
                (None, None, None), pre_norm.eps,
            )
        else:
            x_in = pre_norm(x) if pre_norm is not None else x
            kv = x_in if context is None else context
            q, k, v = self.to_q(x_in), self.to_k(kv), self.to_v(kv)
        if bank is not None:
            k = torch.cat([k, self.to_k(bank)], 1)
            v = torch.cat([v, self.to_v(bank)], 1)
        h, d = self.heads, self.head_dim
        q = q.reshape(b, lq, h, d)
        k = k.reshape(b, k.shape[1], h, d)
        v = v.reshape(b, v.shape[1], h, d)
        kb, vb = bank_kv if bank_kv is not None else (None, None)
        o = flash_attention(q, k, v, kv_lens, kb, vb)
        return self.to_out[0](o.reshape(b, lq, h * d))
