"""UNet building blocks (`mmgt_tpu/models/blocks.py`), channel-last.

Spatial ops run on frame-folded tensors (N = batch*frames, H, W, C);
temporal ops receive `video_length` to unfold. Module and parameter names
follow the reference's torch checkpoints (resnets, attentions,
audio_modules, motion_modules.N.temporal_transformer, ...).

Reference-bank injection: at inference the denoiser's self-attentions take
the bank as pre-projected batch-1 K/V (`unet3d.precompute_bank_kv`); in
training as raw per-example tokens (B, L_ref, C), repeated over the frames
and concatenated after the self K/V. Either way `kv_lens` gates the bank
per row (the CFG-uncond or dropped rows stop at their own tokens).

Tensor parallelism (`parallel.mesh.shard_`): besides `Attention` and
`FeedForward` (nn/layers.py), the audio block's three cross-attentions run
on local heads and complete their partial sums with one reduce after the
zero convs; the spatial wrappers' and the motion module's proj_out are
row-parallel on a replicated input (sliced, then reduced); the temporal
attention runs K4 on its head shard without residual and bias, which are
added once after the reduce.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mmgt_tpu_torch.nn.layers import (
    Attention,
    ConvNHWC,
    FeedForward,
    GroupNorm,
    LayerNorm,
    row_linear_replicated,
    tp_mesh,
)
from mmgt_tpu_torch.ops.attention import attention_plain
from mmgt_tpu_torch.ops.fused_ln import ln_projections
from mmgt_tpu_torch.ops.motion_attention import motion_attention, sinusoidal_positions
from mmgt_tpu_torch.parallel.collectives import copy_to_tp, reduce_from_tp


# --------------------------------------------------------------------------
# resnet / sampling blocks
# --------------------------------------------------------------------------
class ResnetBlock(nn.Module):
    """GN-SiLU-conv x2 with an optional time-embedding add."""

    def __init__(self, in_channels: int, out_channels: int,
                 temb_channels: Optional[int] = None, eps: float = 1e-5,
                 groups: int = 32):
        super().__init__()
        self.norm1 = GroupNorm(in_channels, groups, eps, act="silu")
        self.conv1 = ConvNHWC(in_channels, out_channels, 3, padding=1)
        if temb_channels is not None:
            self.time_emb_proj = nn.Linear(temb_channels, out_channels)
        self.norm2 = GroupNorm(out_channels, groups, eps, act="silu")
        self.conv2 = ConvNHWC(out_channels, out_channels, 3, padding=1)
        if in_channels != out_channels:
            self.conv_shortcut = nn.Linear(in_channels, out_channels)

    def forward(self, x, temb=None):
        h = self.conv1(self.norm1(x))
        if temb is not None:
            h = h + self.time_emb_proj(F.silu(temb))[:, None, None, :]
        h = self.conv2(self.norm2(h))
        if hasattr(self, "conv_shortcut"):
            x = self.conv_shortcut(x)
        return x + h


class Downsample(nn.Module):
    """Stride-2 3x3 conv. The UNets pad (1, 1) on both sides (torch's
    Downsample padding=1); the VAE encoder pads right/bottom only,
    pad=((0, 1), (0, 1)), as diffusers' Downsample2D(padding=0) + F.pad."""

    def __init__(self, channels: int, pad=((1, 1), (1, 1))):
        super().__init__()
        self.pad = pad
        symmetric = pad == ((1, 1), (1, 1))
        self.conv = ConvNHWC(channels, channels, 3, stride=2, padding=1 if symmetric else 0)

    def forward(self, x):
        if self.pad != ((1, 1), (1, 1)):
            (t, b), (l, r) = self.pad
            x = F.pad(x, (0, 0, l, r, t, b))
        return self.conv(x)


class Upsample(nn.Module):
    """Nearest x2 then a 3x3 conv."""

    def __init__(self, channels: int):
        super().__init__()
        self.conv = ConvNHWC(channels, channels, 3, padding=1)

    def forward(self, x):
        x = x.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        return self.conv(x)


# --------------------------------------------------------------------------
# transformer blocks
# --------------------------------------------------------------------------
class BasicTransformerBlock(nn.Module):
    """ReferenceNet block: self-attn, CLIP cross-attn, GEGLU ff. Returns
    (out, bank) with bank = norm1(x), the denoiser's extra K/V source."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int = 768):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, head_dim, context_dim=context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context):
        normed = self.norm1(x)
        x = x + self.attn1(normed)
        # a 1-token cross-attention ignores its queries: norm2 is skipped
        q_in = x if context.shape[1] == 1 else self.norm2(x)
        x = x + self.attn2(q_in, context)
        x = x + self.ff(self.norm3(x))
        return x, normed


class TemporalBasicTransformerBlock(nn.Module):
    """Denoiser block: bank-augmented self-attn + CLIP cross-attn + ff.

    `bank_kv`: (k, v), each (1, L_ref, heads, head_dim), or `bank`: raw
    (B, L_ref, C) tokens, one set per example (`mmgt_tpu/models/blocks.py:
    219-237`); `bank_gate` (B,) in {0, 1}: rows with gate 0 (CFG uncond,
    or reference dropout in training) attend to their own tokens only, as
    the reference's uc_mask. norm1 and norm3 fuse into their projections
    (K3)."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int = 768):
        super().__init__()
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = LayerNorm(dim)
        self.attn2 = Attention(dim, heads, head_dim, context_dim=context_dim)
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, context, bank_kv=None, video_length: int = 1, bank_gate=None,
                bank=None):
        kv_lens = None
        if (bank_kv is not None or bank is not None) and bank_gate is not None:
            gate_f = bank_gate.to(torch.int32).repeat_interleave(video_length)
            l_ref = bank.shape[1] if bank is not None else bank_kv[0].shape[1]
            kv_lens = x.shape[1] + gate_f * l_ref
        bank_f = None if bank is None else bank.repeat_interleave(video_length, 0)
        x = x + self.attn1(x, kv_lens=kv_lens, pre_norm=self.norm1, bank_kv=bank_kv,
                           bank=bank_f)
        q_in = x if context.shape[1] == 1 else self.norm2(x)
        x = x + self.attn2(q_in, context)
        return x + self.ff(x, pre_norm=self.norm3)


class CrossAttnProj(nn.Module):
    """q/k/v/out projections of one audio cross-attention (Attention's key
    layout) with the attention itself batched by the caller."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int = 768):
        super().__init__()
        inner = heads * head_dim
        self.to_q = nn.Linear(dim, inner, bias=False)
        self.to_k = nn.Linear(context_dim, inner, bias=False)
        self.to_v = nn.Linear(context_dim, inner, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(inner, inner)])


_AUDIO_REGIONS = ("full", "face", "lip")


class AudioTransformerBlock(nn.Module):
    """MM-HAA block: self-attn + 3 masked audio cross-attentions.

    x: (B*F, L, C); audio_tokens: (B*F, L_a, 768); masks: (full, face, lip),
    each (B*F, L). The three attentions share one batched call (stacked on
    the head axis); their out and zero-conv projections run as two batched
    contractions. The first `n_uncond_rows` rows (CFG uncond, zero audio
    tokens) take the closed form x + sum_i s_i (mask_i (b_out_i W_zc_i) +
    b_zc_i), as the JAX package. Their 32-token KV uses the plain attention
    math, as the XLA route of the JAX package does. The other rows take
    the out projections' bias terms in the same closed form, added apart
    from the products: on a head shard the products are partial sums, and
    mask, scale and zero conv are linear, so one reduce follows them and
    the bias terms are added once after it. The closed form uses
    replicated weights only and is not reduced."""

    def __init__(self, dim: int, heads: int, head_dim: int, context_dim: int = 768):
        super().__init__()
        self.heads, self.head_dim = heads, head_dim
        self.norm1 = LayerNorm(dim)
        self.attn1 = Attention(dim, heads, head_dim)
        self.norm2 = LayerNorm(dim)
        for i in range(3):
            setattr(self, f"attn2_{i}", CrossAttnProj(dim, heads, head_dim, context_dim))
        for name in _AUDIO_REGIONS:
            setattr(self, f"zero_conv_{name}", nn.Linear(dim, dim))
        self.norm3 = LayerNorm(dim)
        self.ff = FeedForward(dim)

    def forward(self, x, audio_tokens, masks, motion_scale: Sequence[float] = (1.0, 1.0, 1.0),
                n_uncond_rows: int = 0):
        x = x + self.attn1(x, pre_norm=self.norm1)
        nu = n_uncond_rows
        b, lq, c = x.shape
        mesh = tp_mesh(self)
        d = self.head_dim
        projs = [getattr(self, f"attn2_{i}") for i in range(3)]
        zcs = [getattr(self, f"zero_conv_{n}") for n in _AUDIO_REGIONS]
        h = projs[0].to_q.weight.shape[0] // d    # this rank's heads
        inner = h * d
        assert mesh is not None or inner == c, (inner, c)
        xc = x[nu:]
        q3 = ln_projections(copy_to_tp(xc, mesh), copy_to_tp(self.norm2.weight, mesh),
                            copy_to_tp(self.norm2.bias, mesh),
                            [p.to_q.weight for p in projs], [None] * 3, self.norm2.eps)
        ctx = copy_to_tp(audio_tokens[nu:], mesh)
        q = torch.cat([t.reshape(b - nu, lq, h, d) for t in q3], 2)
        k = torch.cat([F.linear(ctx, p.to_k.weight).reshape(b - nu, -1, h, d) for p in projs], 2)
        v = torch.cat([F.linear(ctx, p.to_v.weight).reshape(b - nu, -1, h, d) for p in projs], 2)
        o3 = attention_plain(q, k, v).reshape(b - nu, lq, 3, inner)
        wo = torch.stack([p.to_out[0].weight.t() for p in projs])     # (3, inner, C)
        bo = torch.stack([p.to_out[0].bias for p in projs])           # (3, C)
        scales = torch.tensor(list(motion_scale), dtype=x.dtype, device=x.device)
        mask3 = torch.stack([m[nu:] for m in masks], 2).to(o3.dtype)
        w_zc = torch.cat([z.weight.t() for z in zcs], 0)             # (3C, C)
        b_zc = (scales[:, None] * torch.stack([z.bias for z in zcs])).sum(0)
        part = torch.einsum("blid,idc->blic", o3, wo) * (mask3 * scales)[..., None]
        # the zero convs meet (under tp) partial sums: their gradient is summed over tp
        part = reduce_from_tp(part.reshape(b - nu, lq, 3 * c) @ copy_to_tp(w_zc, mesh), mesh)
        zc_b = torch.stack([bo[i] @ zcs[i].weight.t() for i in range(3)])   # (3, C)
        out_c = xc + part + torch.einsum("bli,ic->blc", mask3 * scales, zc_b) + b_zc
        if nu:
            mask_u3 = torch.stack([m[:nu] for m in masks], 2).to(x.dtype)
            hu = torch.einsum("bli,ic->blc", mask_u3 * scales, zc_b)
            x = torch.cat([x[:nu] + hu + b_zc, out_c], 0)
        else:
            x = out_c
        return x + self.ff(x, pre_norm=self.norm3)


# --------------------------------------------------------------------------
# spatial transformer wrappers (GN + proj_in/out + residual)
# --------------------------------------------------------------------------
class _SpatialWrapper(nn.Module):
    def __init__(self, channels: int, inner: int, block: nn.Module):
        super().__init__()
        self.norm = GroupNorm(channels, 32, 1e-6)
        self.proj_in = nn.Linear(channels, inner)
        self.transformer_blocks = nn.ModuleList([block])
        self.proj_out = nn.Linear(inner, channels)

    def _tokens(self, x):
        n, hh, ww, c = x.shape
        return self.proj_in(self.norm(x).reshape(n, hh * ww, c))

    def _out(self, tokens, residual):
        return row_linear_replicated(tokens, self.proj_out).reshape(residual.shape) + residual


class SpatialTransformer2D(_SpatialWrapper):
    """ReferenceNet transformer: returns (out, bank)."""

    def __init__(self, channels: int, heads: int, context_dim: int = 768):
        super().__init__(channels, channels,
                         BasicTransformerBlock(channels, heads, channels // heads, context_dim))

    def forward(self, x, context):
        tokens, bank = self.transformer_blocks[0](self._tokens(x), context)
        return self._out(tokens, x), bank


class SpatialTransformerRef(_SpatialWrapper):
    """Denoiser transformer with reference-bank self-attention."""

    def __init__(self, channels: int, heads: int, context_dim: int = 768):
        super().__init__(channels, channels, TemporalBasicTransformerBlock(
            channels, heads, channels // heads, context_dim))

    def forward(self, x, context, bank_kv=None, video_length: int = 1, bank_gate=None,
                bank=None):
        tokens = self.transformer_blocks[0](self._tokens(x), context, bank_kv,
                                            video_length, bank_gate, bank)
        return self._out(tokens, x)


class SpatialTransformerAudio(_SpatialWrapper):
    """MM-HAA wrapper; `inner_dim` follows the block INPUT channels (the
    reference's width quirk, reproduced for weight parity)."""

    def __init__(self, channels: int, heads: int, inner_dim: int):
        super().__init__(channels, inner_dim,
                         AudioTransformerBlock(inner_dim, heads, inner_dim // heads))

    def forward(self, x, audio_tokens, masks, motion_scale=(1.0, 1.0, 1.0),
                n_uncond_rows: int = 0):
        tokens = self.transformer_blocks[0](self._tokens(x), audio_tokens, masks,
                                            motion_scale, n_uncond_rows)
        return self._out(tokens, x)


# --------------------------------------------------------------------------
# temporal (motion) module
# --------------------------------------------------------------------------
class TemporalAttention(nn.Module):
    """Frame-axis attention with LN + PE + residual fused (K4 on the card).
    On a head shard K4 takes the local heads and gives W_o's partial sum;
    the reduce, b_o and the residual follow."""

    def __init__(self, channels: int, heads: int):
        super().__init__()
        self.heads = heads
        self.to_q = nn.Linear(channels, channels, bias=False)
        self.to_k = nn.Linear(channels, channels, bias=False)
        self.to_v = nn.Linear(channels, channels, bias=False)
        self.to_out = nn.ModuleList([nn.Linear(channels, channels), nn.Identity()])

    def forward(self, x, norm: LayerNorm, pe):
        """x (B, F, L, C) -> x + attn_frames(norm(x) + pe)."""
        mesh = tp_mesh(self)
        if mesh is None:
            return motion_attention(
                x, norm.weight, norm.bias, pe, self.to_q.weight, self.to_k.weight,
                self.to_v.weight, self.to_out[0].weight, self.to_out[0].bias,
                self.heads, norm.eps,
            )
        d = x.shape[-1] // self.heads
        part = motion_attention(
            copy_to_tp(x, mesh), copy_to_tp(norm.weight, mesh), copy_to_tp(norm.bias, mesh), pe,
            self.to_q.weight, self.to_k.weight, self.to_v.weight, self.to_out[0].weight, None,
            self.to_q.weight.shape[0] // d, norm.eps, residual=False,
        )
        out = reduce_from_tp(part, mesh).float() + self.to_out[0].bias.float() + x.float()
        return out.to(x.dtype)


class TemporalTransformerBlock(nn.Module):
    """Two temporal self-attentions + ff over (B, F, L, C) tokens."""

    def __init__(self, channels: int, heads: int, max_len: int = 32):
        super().__init__()
        self.max_len = max_len
        self.attention_blocks = nn.ModuleList(
            [TemporalAttention(channels, heads) for _ in range(2)])
        self.norms = nn.ModuleList([LayerNorm(channels) for _ in range(2)])
        self.ff = FeedForward(channels)
        self.ff_norm = LayerNorm(channels)

    def forward(self, x):
        b, f, l, c = x.shape
        pe = sinusoidal_positions(self.max_len, c, x.device)[:f]
        for attn, norm in zip(self.attention_blocks, self.norms):
            x = attn(x, norm, pe)
        x2 = x.reshape(b, f * l, c)
        x2 = x2 + self.ff(x2, pre_norm=self.ff_norm)
        return x2.reshape(b, f, l, c)


class _TemporalTransformer(nn.Module):
    def __init__(self, channels: int, heads: int, max_len: int):
        super().__init__()
        self.norm = GroupNorm(channels, 32, 1e-6)
        self.proj_in = nn.Linear(channels, channels)
        self.transformer_blocks = nn.ModuleList(
            [TemporalTransformerBlock(channels, heads, max_len)])
        self.proj_out = nn.Linear(channels, channels)


class MotionModule(nn.Module):
    """AnimateDiff-style temporal transformer over the frame axis.
    Input (B*F, H, W, C); attention runs over frames at every position."""

    def __init__(self, channels: int, heads: int = 8, max_len: int = 32):
        super().__init__()
        self.temporal_transformer = _TemporalTransformer(channels, heads, max_len)

    def forward(self, x, video_length: int):
        n, hh, ww, c = x.shape
        tt = self.temporal_transformer
        tokens = tt.norm(x).reshape(n // video_length, video_length, hh * ww, c)
        tokens = tt.proj_in(tokens)
        tokens = tt.transformer_blocks[0](tokens)
        return x + row_linear_replicated(tokens, tt.proj_out).reshape(n, hh, ww, c)
