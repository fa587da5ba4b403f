"""SMGA Stage-1 model (`mmgt_tpu/models/smga.py`): audio -> whole-body
keypoint motion, the GestureDecoder denoiser, with the reference
checkpoint's state-dict names (after `split_packed_qkv`).

A FiLM-conditioned transformer that splits the 402-d DWPose keypoint
stream into face (flat dims 72:276) and body streams, runs self and cross
attention per stream in each of 8 decoder layers and merges them by
addition, conditioned on the audio tokens (1059-d WavLM + baseline, or
35-d baseline), the first pose frame and the diffusion timestep. The
reference's quirks are kept: rotary on the full model dim before the
projections with values unrotated; the merged output re-enters as the
face stream while the body stream stays the layer-0 embedding; learned
null embeddings for classifier-free dropout; the network predicts x0.
Attention over 80-82 tokens is the plain math (`dot_product_attention`),
as it is XLA math in the JAX package.
"""
from __future__ import annotations

import functools
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from mmgt_tpu_torch.nn.layers import LayerNorm
from mmgt_tpu_torch.ops.attention import dot_product_attention

NFEATS = 402
FACE_LO, FACE_HI = 72, 276  # keypoints 24..92 x (x, y, score)


def face_body_split(x: torch.Tensor):
    """x (..., 402) -> (face_only, body_only), zero-filled complements."""
    sel = torch.zeros(NFEATS, dtype=x.dtype, device=x.device)
    sel[FACE_LO:FACE_HI] = 1.0
    return x * sel, x * (1.0 - sel)


def mish(x):
    return x * torch.tanh(F.softplus(x))


def sinusoidal_pos_emb(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Diffusion-timestep embedding (utils.py:37-49 semantics)."""
    half = dim // 2
    freqs = torch.exp(torch.arange(half, dtype=torch.float32, device=t.device)
                      * (-math.log(10000.0) / (half - 1)))
    args = t.float()[:, None] * freqs[None, :]
    return torch.cat([torch.sin(args), torch.cos(args)], -1)


@functools.lru_cache(maxsize=16)
def rotary_cos_sin(n: int, dim: int, device: torch.device, theta: float = 10000.0):
    """Interleaved rotary tables over the full model dim (float64 on the
    host, f32 on `device`), made once per shape and device: a decoder
    forward applies them ~50 times, and a host table plus a copy each time
    held the card's Stage 1 back."""
    freqs = 1.0 / (theta ** (np.arange(0, dim, 2, dtype=np.float64) / dim))
    angles = np.repeat(np.arange(n)[:, None] * freqs[None, :], 2, axis=-1)
    return (torch.from_numpy(np.cos(angles).astype(np.float32)).to(device),
            torch.from_numpy(np.sin(angles).astype(np.float32)).to(device))


def apply_rotary(x: torch.Tensor) -> torch.Tensor:
    """Rotate (B, N, D) on the model dim (interleaved pairs)."""
    n, d = x.shape[-2], x.shape[-1]
    cos, sin = rotary_cos_sin(n, d, x.device)
    x2 = x.reshape(*x.shape[:-1], d // 2, 2)
    rot = torch.stack([-x2[..., 1], x2[..., 0]], -1).reshape(x.shape)
    return x * cos.to(x.dtype) + rot * sin.to(x.dtype)


class MHA(nn.Module):
    """torch.nn.MultiheadAttention's math (biased q/k/v and out) with its
    packed projection split into q_proj / k_proj / v_proj."""

    def __init__(self, d: int, heads: int):
        super().__init__()
        self.heads = heads
        self.q_proj, self.k_proj = nn.Linear(d, d), nn.Linear(d, d)
        self.v_proj, self.out_proj = nn.Linear(d, d), nn.Linear(d, d)

    def forward(self, q_in, k_in, v_in):
        b, lq, d = q_in.shape
        lk, hd = k_in.shape[1], d // self.heads
        q = self.q_proj(q_in).reshape(b, lq, self.heads, hd)
        k = self.k_proj(k_in).reshape(b, lk, self.heads, hd)
        v = self.v_proj(v_in).reshape(b, lk, self.heads, hd)
        return self.out_proj(dot_product_attention(q, k, v).reshape(b, lq, d))


class DenseFiLM(nn.Module):
    """Mish -> Linear(2d): (scale, shift), each (B, 1, d) (model.py:44-63)."""

    def __init__(self, d: int):
        super().__init__()
        self.block = nn.ModuleList([nn.Identity(), nn.Linear(d, 2 * d)])  # [Mish, Linear]

    def forward(self, t_cond):
        return self.block[1](mish(t_cond))[:, None, :].chunk(2, dim=-1)


def film(x, scale_shift):
    scale, shift = scale_shift
    return (scale + 1.0) * x + shift


class EncoderLayer(nn.Module):
    """Pre-norm rotary self-attention layer (audio conditioning encoder)."""

    def __init__(self, d: int, heads: int, ff_size: int):
        super().__init__()
        self.norm1, self.self_attn = LayerNorm(d), MHA(d, heads)
        self.norm2 = LayerNorm(d)
        self.linear1, self.linear2 = nn.Linear(d, ff_size), nn.Linear(ff_size, d)

    def forward(self, x):
        h = self.norm1(x)
        qk = apply_rotary(h)
        x = x + self.self_attn(qk, qk, h)
        h = self.linear1(self.norm2(x))
        return x + self.linear2(F.gelu(h, approximate="none"))


class SplitDecoderLayer(nn.Module):
    """Face/body split FiLM decoder layer (model.py:139-308)."""

    STREAMS = ("face", "body")

    def __init__(self, d: int, heads: int, ff_size: int):
        super().__init__()
        for s in self.STREAMS:
            setattr(self, f"norm_{s}_1", LayerNorm(d))
            setattr(self, f"{s}_self_attn", MHA(d, heads))
            setattr(self, f"film_{s}_1", DenseFiLM(d))
            setattr(self, f"norm_{s}_2", LayerNorm(d))
            setattr(self, f"{s}_cross_attn", MHA(d, heads))
            setattr(self, f"film_{s}_2", DenseFiLM(d))
        self.norm_final = LayerNorm(d)
        self.linear1, self.linear2 = nn.Linear(d, ff_size), nn.Linear(ff_size, d)
        self.film_final = DenseFiLM(d)

    def _stream(self, s, x, cond, t_cond):
        m = lambda name: getattr(self, name.format(s))
        h = m("norm_{}_1")(x)
        qk = apply_rotary(h)
        x = x + film(m("{}_self_attn")(qk, qk, h), m("film_{}_1")(t_cond))
        h = m("norm_{}_2")(x)
        a = m("{}_cross_attn")(apply_rotary(h), apply_rotary(cond), cond)
        return x + film(a, m("film_{}_2")(t_cond))

    def forward(self, x_face, x_body, cond, t_cond):
        merged = self._stream("face", x_face, cond, t_cond) + self._stream("body", x_body, cond,
                                                                            t_cond)
        h = self.linear1(self.norm_final(merged))
        h = self.linear2(F.gelu(h, approximate="none"))
        return merged + film(h, self.film_final(t_cond))


class _DecoderStack(nn.Module):
    def __init__(self, layers):
        super().__init__()
        self.stack = nn.ModuleList(layers)


class GestureDecoder(nn.Module):
    def __init__(self, nfeats: int = NFEATS, seq_len: int = 80, latent_dim: int = 512,
                 ff_size: int = 1024, num_layers: int = 8, num_heads: int = 8,
                 cond_feature_dim: int = 1024 + 35):
        super().__init__()
        d = latent_dim
        self.input_projection = nn.Linear(2 * nfeats, d)
        self.cond_projection = nn.Linear(cond_feature_dim, d)
        self.cond_encoder = nn.ModuleList([EncoderLayer(d, num_heads, ff_size) for _ in range(2)])
        self.null_cond_embed = nn.Parameter(torch.zeros(1, seq_len, d))
        # [LayerNorm, Linear, SiLU, Linear]
        self.non_attn_cond_projection = nn.ModuleList([
            LayerNorm(d), nn.Linear(d, d), nn.Identity(), nn.Linear(d, d)])
        self.null_cond_hidden = nn.Parameter(torch.zeros(1, d))
        self.time_mlp = nn.ModuleList([nn.Identity(), nn.Linear(d, 4 * d)])  # [pos emb, Linear]
        self.to_time_cond = nn.ModuleList([nn.Linear(4 * d, d)])
        self.to_time_tokens = nn.ModuleList([nn.Linear(4 * d, 2 * d)])
        self.norm_cond = LayerNorm(d)
        self.seqTransDecoder = _DecoderStack([SplitDecoderLayer(d, num_heads, ff_size)
                                              for _ in range(num_layers)])
        self.final_layer = nn.Linear(d, nfeats)

    def forward(self, x, cond_frame, cond, t, keep_mask: Optional[torch.Tensor] = None):
        """x (B, T, 402) noisy pose; cond_frame (B, 402); cond (B, T, Dc);
        t (B,) timesteps; keep_mask (B,) bool, False drops the condition.
        Returns the predicted x0 (B, T, 402)."""
        b, T = x.shape[0], x.shape[1]
        d = self.input_projection.out_features
        if keep_mask is None:
            keep_mask = torch.ones(b, dtype=torch.bool, device=x.device)
        face_x, body_x = face_body_split(x)
        face_cf, body_cf = face_body_split(cond_frame[:, None, :])
        proj = self.input_projection
        x_face = proj(torch.cat([face_x, face_cf.expand_as(face_x)], -1))
        x_body = proj(torch.cat([body_x, body_cf.expand_as(body_x)], -1))

        cond_tokens = self.cond_projection(cond)
        for layer in self.cond_encoder:
            cond_tokens = layer(cond_tokens)
        cond_tokens = torch.where(keep_mask[:, None, None], cond_tokens,
                                  self.null_cond_embed[:, :T].to(cond_tokens.dtype))

        nap = self.non_attn_cond_projection
        h = nap[3](F.silu(nap[1](nap[0](cond_tokens.mean(-2)))))
        cond_hidden = torch.where(keep_mask[:, None], h, self.null_cond_hidden.to(h.dtype))

        t_hidden = sinusoidal_pos_emb(t, d).to(x.dtype)
        t_hidden = mish(self.time_mlp[1](t_hidden))
        t_cond = self.to_time_cond[0](t_hidden) + cond_hidden
        t_tokens = self.to_time_tokens[0](t_hidden).reshape(b, 2, d)
        cond_tokens = self.norm_cond(torch.cat([cond_tokens, t_tokens], -2))

        out = x_face
        for layer in self.seqTransDecoder.stack:
            out = layer(out, x_body, cond_tokens, t_cond)
        return self.final_layer(out)

    def guided_forward(self, x, cond_frame, cond, t, guidance_weight):
        """CFG as one doubled-batch forward: [uncond ; cond] rows."""
        b = x.shape[0]
        keep = torch.cat([torch.zeros(b, dtype=torch.bool, device=x.device),
                          torch.ones(b, dtype=torch.bool, device=x.device)])
        two = lambda a: torch.cat([a, a])
        out = self(two(x), two(cond_frame), two(cond), two(t), keep)
        unc, con = out[:b], out[b:]
        return unc + (con - unc) * guidance_weight
