"""WavLM audio encoder (`mmgt_tpu/models/wavlm.py`): Stage-1 audio
features, with the microsoft WavLM checkpoint's state-dict names.

Large config: layer-norm conv feature extractor, 24 pre-norm layers of
1024 (16 heads, ffn 4096), T5-style bucketed relative position bias made
in layer 0 and gated per layer by the raw per-head hidden states
(gru_rel_pos, as the reference's fast path). The biased attention is
plain einsum math, as in the JAX package: no kernel.
"""
from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmgt_tpu_torch.models.wav2vec2 import ConvFeatureExtractor, ConvPositionalEmbedding
from mmgt_tpu_torch.nn.layers import LayerNorm


def relative_position_buckets(q_len: int, k_len: int, num_buckets: int = 320,
                              max_distance: int = 800) -> np.ndarray:
    """T5 bidirectional bucketing (reference modules_wavlm.py:417-456)."""
    context = np.arange(q_len)[:, None]
    memory = np.arange(k_len)[None, :]
    rel = memory - context
    nb = num_buckets // 2
    buckets = (rel > 0).astype(np.int64) * nb
    rel = np.abs(rel)
    max_exact = nb // 2
    is_small = rel < max_exact
    large = max_exact + (
        np.log(np.maximum(rel, 1) / max_exact)
        / math.log(max_distance / max_exact)
        * (nb - max_exact)
    ).astype(np.int64)
    large = np.minimum(large, nb - 1)
    buckets += np.where(is_small, rel, large)
    return buckets


class GatedRelPosAttention(nn.Module):
    """Self-attention with the gated relative position bias; layer 0 owns
    the bucket embedding (`relative_attention_bias`) and hands the bias on."""

    def __init__(self, d: int, heads: int, has_rel_embed: bool, num_buckets: int = 320,
                 max_distance: int = 800):
        super().__init__()
        self.heads, self.num_buckets, self.max_distance = heads, num_buckets, max_distance
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.grep_linear = nn.Linear(d // heads, 8)
        self.grep_a = nn.Parameter(torch.ones(1, heads, 1, 1))
        self.relative_attention_bias = (nn.Embedding(num_buckets, heads) if has_rel_embed
                                        else None)

    def forward(self, x, position_bias: Optional[torch.Tensor] = None):
        b, l, d = x.shape
        h, hd = self.heads, d // self.heads
        if self.relative_attention_bias is not None and position_bias is None:
            buckets = torch.from_numpy(relative_position_buckets(
                l, l, self.num_buckets, self.max_distance)).to(x.device)
            position_bias = self.relative_attention_bias.weight.float()[buckets].permute(2, 0, 1)
        heads = lambda t: t.reshape(b, l, h, hd).transpose(1, 2)
        qh, kh, vh = heads(self.q_proj(x)), heads(self.k_proj(x)), heads(self.v_proj(x))
        logits = torch.einsum("bhqd,bhkd->bhqk", qh.float(), kh.float()) / math.sqrt(hd)
        if position_bias is not None:
            # the gate reads the raw per-head input chunks, not q (the
            # reference's fast path, modules_wavlm.py:523-534)
            g = self.grep_linear(heads(x)).reshape(b, h, l, 2, 4).sum(-1)
            gate = torch.sigmoid(g.float())
            gate_a_1 = gate[..., 0] * (gate[..., 1] * self.grep_a.float()[..., 0] - 1.0) + 2.0
            logits = logits + gate_a_1[..., None] * position_bias[None]
        probs = torch.softmax(logits, -1).to(vh.dtype)
        o = torch.einsum("bhqk,bhkd->bhqd", probs, vh)
        return self.out_proj(o.transpose(1, 2).reshape(b, l, d)), position_bias


class WavLMLayer(nn.Module):
    """Pre-norm layer (layer_norm_first, WavLM Large)."""

    def __init__(self, d: int, heads: int, ff_dim: int, has_rel_embed: bool,
                 num_buckets: int = 320, max_distance: int = 800):
        super().__init__()
        self.self_attn = GatedRelPosAttention(d, heads, has_rel_embed, num_buckets,
                                              max_distance)
        self.self_attn_layer_norm = LayerNorm(d)
        self.fc1, self.fc2 = nn.Linear(d, ff_dim), nn.Linear(ff_dim, d)
        self.final_layer_norm = LayerNorm(d)

    def forward(self, x, position_bias=None):
        h, position_bias = self.self_attn(self.self_attn_layer_norm(x), position_bias)
        x = x + h
        h = F.gelu(self.fc1(self.final_layer_norm(x)), approximate="none")
        return x + self.fc2(h), position_bias


class _Encoder(nn.Module):
    def __init__(self, d, num_layers, heads, ff_dim, num_buckets, max_distance):
        super().__init__()
        self.pos_conv = nn.ModuleList([ConvPositionalEmbedding(d)])
        self.layers = nn.ModuleList([
            WavLMLayer(d, heads, ff_dim, i == 0, num_buckets, max_distance)
            for i in range(num_layers)])
        self.layer_norm = LayerNorm(d)


class WavLMModel(nn.Module):
    def __init__(self, hidden_dim: int = 1024, num_layers: int = 24, heads: int = 16,
                 ff_dim: int = 4096, num_buckets: int = 320, max_distance: int = 800):
        super().__init__()
        self.feature_extractor = ConvFeatureExtractor("layer")
        self.layer_norm = LayerNorm(512)
        self.post_extract_proj = nn.Linear(512, hidden_dim)
        self.encoder = _Encoder(hidden_dim, num_layers, heads, ff_dim, num_buckets,
                                max_distance)

    def forward(self, wav: torch.Tensor) -> torch.Tensor:
        """wav (B, samples) at 16 kHz, already layer-normalised ->
        (B, T', hidden) final-layer features (~50 fps)."""
        h = self.post_extract_proj(self.layer_norm(self.feature_extractor(wav)))
        h = h + self.encoder.pos_conv[0](h)
        pos_bias = None
        for layer in self.encoder.layers:
            h, pos_bias = layer(h, pos_bias)
        return self.encoder.layer_norm(h)
