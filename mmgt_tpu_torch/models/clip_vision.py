"""CLIP ViT image encoder (`mmgt_tpu/models/clip_vision.py`): the
reference-image embedding of Stage 2.

ViT-L/14 at 224 px (hidden 1024, 24 layers, 16 heads, quick-GELU MLP,
projection to 768), with HF CLIPVisionModelWithProjection's state-dict
names. Only the projected pooled embedding is used, as one context token
(B, 1, 768). Its 257-token attention is the plain math, as it is XLA math
in the JAX package (`ops.attention.dot_product_attention`).
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import nn

from mmgt_tpu_torch.nn.layers import ConvNHWC, LayerNorm
from mmgt_tpu_torch.ops.attention import dot_product_attention
from mmgt_tpu_torch.ops.image import resize_linear

# CLIP preprocessing constants (openai/clip-vit-large-patch14)
CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], np.float32)


def clip_preprocess(image01: torch.Tensor, size: int = 224) -> torch.Tensor:
    """(B, H, W, 3) in [0, 1] -> resized (antialiased, as jax.image.resize)
    and normalised (B, 224, 224, 3) f32."""
    b = image01.shape[0]
    img = resize_linear(image01.float(), (b, size, size, 3))
    mean = torch.from_numpy(CLIP_MEAN).to(img.device)
    std = torch.from_numpy(CLIP_STD).to(img.device)
    return (img - mean) / std


class CLIPAttention(nn.Module):
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


class CLIPMLP(nn.Module):
    def __init__(self, d: int, mlp: int):
        super().__init__()
        self.fc1, self.fc2 = nn.Linear(d, mlp), nn.Linear(mlp, d)

    def forward(self, x):
        h = self.fc1(x)
        return self.fc2(h * torch.sigmoid(1.702 * h))  # quick_gelu


class CLIPLayer(nn.Module):
    def __init__(self, d: int, heads: int, mlp: int):
        super().__init__()
        self.layer_norm1 = LayerNorm(d)
        self.self_attn = CLIPAttention(d, heads)
        self.layer_norm2 = LayerNorm(d)
        self.mlp = CLIPMLP(d, mlp)

    def forward(self, x):
        x = x + self.self_attn(self.layer_norm1(x))
        return x + self.mlp(self.layer_norm2(x))


class _Embeddings(nn.Module):
    def __init__(self, d: int, patch: int, n_pos: int):
        super().__init__()
        self.class_embedding = nn.Parameter(torch.zeros(d))
        self.patch_embedding = ConvNHWC(3, d, patch, stride=patch, bias=False)
        self.position_embedding = nn.Embedding(n_pos, d)


class _Encoder(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.layers = nn.ModuleList(layers)


class _VisionTransformer(nn.Module):
    def __init__(self, d, num_layers, heads, patch, image_size, mlp):
        super().__init__()
        self.embeddings = _Embeddings(d, patch, (image_size // patch) ** 2 + 1)
        self.pre_layrnorm = LayerNorm(d)
        self.encoder = _Encoder([CLIPLayer(d, heads, mlp) for _ in range(num_layers)])
        self.post_layernorm = LayerNorm(d)


class CLIPVisionModel(nn.Module):
    """pixels (B, 224, 224, 3), CLIP-normalised -> (B, 1, proj_dim)."""

    def __init__(self, hidden_dim: int = 1024, num_layers: int = 24, heads: int = 16,
                 patch: int = 14, image_size: int = 224, proj_dim: int = 768,
                 mlp_dim: Optional[int] = None):
        super().__init__()
        self.vision_model = _VisionTransformer(hidden_dim, num_layers, heads, patch,
                                               image_size, mlp_dim or 4 * hidden_dim)
        self.visual_projection = nn.Linear(hidden_dim, proj_dim, bias=False)

    def forward(self, pixels: torch.Tensor) -> torch.Tensor:
        vm = self.vision_model
        emb = vm.embeddings
        w = emb.patch_embedding.weight
        x = emb.patch_embedding(pixels.to(w.dtype))
        b, d = x.shape[0], x.shape[-1]
        x = x.reshape(b, -1, d)
        cls = emb.class_embedding.to(x.dtype).expand(b, 1, d)
        x = torch.cat([cls, x], 1) + emb.position_embedding.weight.to(x.dtype)
        x = vm.pre_layrnorm(x)
        for layer in vm.encoder.layers:
            x = layer(x)
        pooled = vm.post_layernorm(x[:, 0])
        return self.visual_projection(pooled)[:, None, :]
