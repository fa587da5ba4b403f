"""Wav2Vec2 audio encoder (`mmgt_tpu/models/wav2vec2.py`): Stage-2 audio
conditioning, with HF Wav2Vec2Model's state-dict names.

Base config: 7 conv layers (512 channels, strides 5,2,2,2,2,2,2, kernels
10,3,3,3,3,2,2, no bias), GroupNorm(512 groups of one channel) after conv
0 only, the conv features linearly resized to the video frame count before
the transformer (antialiased, as jax.image.resize), feature projection to
768, a grouped conv positional embedding (kernel 128, 16 groups), 12
post-norm transformer layers (12 heads, ff 3072, exact GELU); every
layer's hidden state is returned, stacked: (B, T, 12, 768).

Kernel call sites: conv 0's GroupNorm is K2 on the card (f32, 512 groups,
C = 512: the streaming regime for a clip's ~10k-20k samples); attention
takes K1 only when a clip has 512 or more frames (`dot_product_attention`).
"""
from __future__ import annotations

import torch
import torch.nn.functional as F
from torch import nn

from mmgt_tpu_torch.nn.layers import GroupNorm, LayerNorm
from mmgt_tpu_torch.ops.attention import dot_product_attention
from mmgt_tpu_torch.ops.image import resize_linear

CONV_DIMS = (512,) * 7
CONV_KERNELS = (10, 3, 3, 3, 3, 2, 2)
CONV_STRIDES = (5, 2, 2, 2, 2, 2, 2)


def linear_interpolate_seq(x: torch.Tensor, seq_len: int) -> torch.Tensor:
    """(B, T, C) -> (B, seq_len, C), linear along T with align_corners False;
    antialiased when it shrinks, as `jax.image.resize` (the JAX package's
    version) is."""
    b, _, c = x.shape
    return resize_linear(x, (b, seq_len, c))


def _gelu(x):
    return F.gelu(x, approximate="none")


class _GroupConvLayer(nn.Module):
    """HF Wav2Vec2GroupNormConvLayer / NoLayerNormConvLayer: conv (+ the
    GroupNorm of layer 0)."""

    def __init__(self, c_in: int, c_out: int, k: int, s: int, norm: bool):
        super().__init__()
        self.conv = nn.Conv1d(c_in, c_out, k, stride=s, bias=False)
        self.layer_norm = GroupNorm(c_out, c_out, eps=1e-5) if norm else None


class ConvFeatureExtractor(nn.Module):
    """Waveform (B, samples) -> (B, T', 512) features.

    norm_mode "group" (wav2vec2-base): GroupNorm after conv 0, keys
    `conv_layers.i.conv` / `conv_layers.0.layer_norm`; "layer" (WavLM
    Large): a LayerNorm after every conv, keys `conv_layers.i.0` /
    `conv_layers.i.2.1` (the reference's Sequential(conv, dropout,
    Sequential(transpose, LayerNorm, transpose), GELU))."""

    def __init__(self, norm_mode: str = "group"):
        super().__init__()
        if norm_mode not in ("group", "layer"):
            raise ValueError(f"unknown norm_mode {norm_mode!r}")
        self.norm_mode = norm_mode
        layers, c_in = [], 1
        for i, (d, k, s) in enumerate(zip(CONV_DIMS, CONV_KERNELS, CONV_STRIDES)):
            if norm_mode == "group":
                layers.append(_GroupConvLayer(c_in, d, k, s, i == 0))
            else:
                layers.append(nn.ModuleList([
                    nn.Conv1d(c_in, d, k, stride=s, bias=False), nn.Identity(),
                    nn.ModuleList([nn.Identity(), LayerNorm(d)])]))
            c_in = d
        self.conv_layers = nn.ModuleList(layers)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        x = wav[:, None, :].to(next(self.parameters()).dtype)  # (B, 1, samples)
        for layer in self.conv_layers:
            if self.norm_mode == "group":
                x = layer.conv(x)
                if layer.layer_norm is not None:  # channel-last (B, T', C) for K2
                    x = layer.layer_norm(x.transpose(1, 2).contiguous()).transpose(1, 2)
            else:
                x = layer[2][1](layer[0](x).transpose(1, 2)).transpose(1, 2)
            x = _gelu(x)
        return x.transpose(1, 2)


class ConvPositionalEmbedding(nn.Conv1d):
    """Grouped conv over time (kernel 128, padding 64, 16 groups) on (B, T,
    C), the trailing output dropped (even kernel), then GELU."""

    def __init__(self, d: int, kernel: int = 128, groups: int = 16):
        super().__init__(d, d, kernel, padding=kernel // 2, groups=groups)

    def forward(self, x):
        h = super().forward(x.transpose(1, 2))[:, :, : x.shape[1]]
        return _gelu(h.transpose(1, 2))


class _SelfAttention(nn.Module):
    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, x):
        b, l, d = x.shape
        split = lambda t: t.reshape(b, l, self.heads, d // self.heads)
        o = dot_product_attention(split(self.q_proj(x)), split(self.k_proj(x)),
                                  split(self.v_proj(x)))
        return self.out_proj(o.reshape(b, l, d))


class _FeedForward(nn.Module):
    def __init__(self, d: int, ff: int):
        super().__init__()
        self.intermediate_dense, self.output_dense = nn.Linear(d, ff), nn.Linear(ff, d)

    def forward(self, x):
        return self.output_dense(_gelu(self.intermediate_dense(x)))


class TransformerLayer(nn.Module):
    """Post-norm encoder layer (wav2vec2-base): LN(x + attn(x)), then
    LN(x + ff(x))."""

    def __init__(self, d: int, heads: int, ff_dim: int):
        super().__init__()
        self.attention = _SelfAttention(d, heads)
        self.layer_norm = LayerNorm(d)
        self.feed_forward = _FeedForward(d, ff_dim)
        self.final_layer_norm = LayerNorm(d)

    def forward(self, x):
        x = self.layer_norm(x + self.attention(x))
        return self.final_layer_norm(x + self.feed_forward(x))


class _FeatureProjection(nn.Module):
    def __init__(self, c: int, d: int):
        super().__init__()
        self.layer_norm, self.projection = LayerNorm(c), nn.Linear(c, d)


class _PosConvEmbed(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.conv = ConvPositionalEmbedding(d)


class _Encoder(nn.Module):
    def __init__(self, d, num_layers, heads, ff_dim):
        super().__init__()
        self.pos_conv_embed = _PosConvEmbed(d)
        self.layer_norm = LayerNorm(d)
        self.layers = nn.ModuleList([TransformerLayer(d, heads, ff_dim)
                                     for _ in range(num_layers)])


class Wav2Vec2Model(nn.Module):
    def __init__(self, hidden_dim: int = 768, num_layers: int = 12, heads: int = 12,
                 ff_dim: int = 3072):
        super().__init__()
        self.feature_extractor = ConvFeatureExtractor("group")
        self.feature_projection = _FeatureProjection(CONV_DIMS[-1], hidden_dim)
        self.encoder = _Encoder(hidden_dim, num_layers, heads, ff_dim)

    def forward(self, wav: torch.Tensor, seq_len: int) -> torch.Tensor:
        """wav (B, samples), normalised -> (B, seq_len, num_layers, hidden)."""
        feats = linear_interpolate_seq(self.feature_extractor(wav), seq_len)
        fp = self.feature_projection
        h = fp.projection(fp.layer_norm(feats))
        enc = self.encoder
        h = enc.layer_norm(h + enc.pos_conv_embed.conv(h))
        outs = []
        for layer in enc.layers:
            h = layer(h)
            outs.append(h)
        return torch.stack(outs, 2)
