"""Pose sequence conv VAE (`mmgt_tpu/models/motion_autoencoder.py`,
EmbeddingNet): the reference's motion_autoencoder
(src/audio2pose_model/motion_autoencoder.py:38-204: PoseEncoderConv /
PoseDecoderConv / EmbeddingNet). The reference never imports it (SURVEY
§2.2 marks it dead code); the JAX package keeps it for inventory parity
and as a pose-embedding utility, and so does the port.

(B, T, D) pose sequences -> 32-d latent -> reconstruction, via 1-D convs
over time. The convolutions pad as flax's default "SAME": out =
ceil(T / stride), the odd pixel at the end, so the stride-2 conv_1 pads
(0, 1) on an even length (80), not Conv1d(padding=1)'s (1, 1). Parameter
names are the JAX package's, with dots (`utils.convert.map_flax`); no
checkpoint of the reference names them.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from mmgt_tpu_torch.device import resolve_device


def _conv_same(conv: nn.Conv1d, x: torch.Tensor) -> torch.Tensor:
    """`conv` (built without padding) with lax's "SAME" padding."""
    n, k, s = x.shape[-1], conv.kernel_size[0], conv.stride[0]
    total = max((math.ceil(n / s) - 1) * s + k - n, 0)
    return conv(F.pad(x, (total // 2, total - total // 2)))


def _length_after(length: int, strides) -> int:
    for s in strides:
        length = math.ceil(length / s)
    return length


class PoseEncoderConv(nn.Module):
    STAGES = ((32, 1), (64, 2), (64, 1))

    def __init__(self, length: int, dim: int, latent_dim: int = 32):
        super().__init__()
        cin = dim
        for i, (ch, stride) in enumerate(self.STAGES):
            setattr(self, f"conv_{i}", nn.Conv1d(cin, ch, 3, stride))
            cin = ch
        flat = _length_after(length, [s for _, s in self.STAGES]) * cin
        self.fc1 = nn.Linear(flat, 256)
        self.fc2 = nn.Linear(256, 128)
        self.fc_mu = nn.Linear(128, latent_dim)
        self.fc_logvar = nn.Linear(128, latent_dim)

    def forward(self, poses: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """poses (B, T, D) -> (mu, logvar), each (B, latent_dim)."""
        x = poses.transpose(1, 2)
        for i in range(len(self.STAGES)):
            x = F.leaky_relu(_conv_same(getattr(self, f"conv_{i}"), x), 0.2)
        x = x.transpose(1, 2).reshape(x.shape[0], -1)  # flax flattens (T, C)
        x = F.relu(self.fc1(x))
        x = F.relu(self.fc2(x))
        return self.fc_mu(x), self.fc_logvar(x)


class PoseDecoderConv(nn.Module):
    def __init__(self, length: int, dim: int, latent_dim: int = 32):
        super().__init__()
        self.length = length
        self.pre_fc1 = nn.Linear(latent_dim, 64)
        self.pre_fc2 = nn.Linear(64, length * 4)
        self.conv_0 = nn.Conv1d(4, 32, 3)
        self.conv_1 = nn.Conv1d(32, 32, 3)
        self.conv_out = nn.Conv1d(32, dim, 3)

    def forward(self, z: torch.Tensor) -> torch.Tensor:
        """(B, latent) -> (B, T, D)."""
        x = self.pre_fc2(F.relu(self.pre_fc1(z)))
        x = x.reshape(z.shape[0], self.length, 4).transpose(1, 2)
        for conv in (self.conv_0, self.conv_1):
            x = F.leaky_relu(_conv_same(conv, x), 0.2)
        return _conv_same(self.conv_out, x).transpose(1, 2)


class EmbeddingNet(nn.Module):
    """VAE over pose sequences; deterministic (mu) unless a generator is
    given for the reparameterised draw."""

    def __init__(self, length: int = 80, dim: int = 402, latent_dim: int = 32):
        super().__init__()
        self.encoder = PoseEncoderConv(length, dim, latent_dim)
        self.decoder = PoseDecoderConv(length, dim, latent_dim)

    def forward(self, poses: torch.Tensor, generator: Optional[torch.Generator] = None):
        mu, logvar = self.encoder(poses)
        z = mu
        if generator is not None:
            eps = torch.randn(mu.shape, generator=generator, device=mu.device, dtype=mu.dtype)
            z = mu + torch.exp(0.5 * logvar) * eps
        return self.decoder(z), mu, logvar

    def encode(self, poses: torch.Tensor) -> torch.Tensor:
        return self.encoder(poses)[0]

    @classmethod
    @torch.no_grad()
    def build(cls, device=None, seed: int = 0, **kwargs) -> "EmbeddingNet":
        """An f32 EmbeddingNet on `device` (the card unless the caller asks
        for the CPU) with seeded weights N(0, 1 / fan_in) and biases
        0.1 N, in eval mode without gradients."""
        model = cls(**kwargs).to(resolve_device(device)).eval().requires_grad_(False)
        dev = next(model.parameters()).device
        gen = torch.Generator(device=dev).manual_seed(seed)
        for mod in model.modules():
            if isinstance(mod, (nn.Conv1d, nn.Linear)):
                w = mod.weight
                w.copy_(torch.randn(w.shape, generator=gen, device=dev) / math.sqrt(w[0].numel()))
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=gen, device=dev) * 0.1)
        return model
