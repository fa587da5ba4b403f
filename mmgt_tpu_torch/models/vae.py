"""AutoencoderKL (`mmgt_tpu/models/vae.py`): the SD VAE, channel-last.

4 stages at (128, 256, 512, 512) channels, 2 resnets per encoder stage and
3 per decoder stage, single-head mid attention at d = 512 (K1), latent
channels 4, scaling factor 0.18215. The encoder's stride-2 convs pad
right/bottom only, as diffusers' VAE.
"""
from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from mmgt_tpu_torch.models.blocks import Downsample, ResnetBlock, Upsample
from mmgt_tpu_torch.nn.layers import Attention, ConvNHWC, GroupNorm

SD_VAE_SCALE = 0.18215


class VAEAttention(Attention):
    """Single-head self-attention over spatial tokens (VAE mid block). The
    JAX rules column-shard its to_q/k/v anyway; one head cannot be split,
    so under tensor parallelism `Attention` gathers the q/k/v shards before
    K1 at d = 512 and runs to_out row-parallel on o's local columns (the
    VAE's only layer that gathers)."""

    def __init__(self, channels: int):
        super().__init__(channels, 1, channels)
        self.group_norm = GroupNorm(channels, 32, 1e-6)

    def forward(self, x):
        n, h, w, c = x.shape
        t = self.group_norm(x).reshape(n, h * w, c)
        return x + super().forward(t).reshape(n, h, w, c)


def _mid_block(ch: int) -> nn.Module:
    mid = nn.Module()
    mid.resnets = nn.ModuleList([ResnetBlock(ch, ch, eps=1e-6) for _ in range(2)])
    mid.attentions = nn.ModuleList([VAEAttention(ch)])
    return mid


def _run_mid(mid, h):
    return mid.resnets[1](mid.attentions[0](mid.resnets[0](h)))


class Encoder(nn.Module):
    def __init__(self, block_out_channels=(128, 256, 512, 512), layers_per_block: int = 2,
                 latent_channels: int = 4):
        super().__init__()
        chans = list(block_out_channels)
        self.conv_in = ConvNHWC(3, chans[0], 3, padding=1)
        self.down_blocks = nn.ModuleList()
        prev = chans[0]
        for bi, ch in enumerate(chans):
            blk = nn.Module()
            res = []
            for _ in range(layers_per_block):
                res.append(ResnetBlock(prev, ch, eps=1e-6))
                prev = ch
            blk.resnets = nn.ModuleList(res)
            if bi < len(chans) - 1:
                blk.downsamplers = nn.ModuleList([Downsample(ch, pad=((0, 1), (0, 1)))])
            self.down_blocks.append(blk)
        self.mid_block = _mid_block(chans[-1])
        self.conv_norm_out = GroupNorm(chans[-1], 32, 1e-6, act="silu")
        self.conv_out = ConvNHWC(chans[-1], 2 * latent_channels, 3, padding=1)

    def forward(self, x):
        h = self.conv_in(x)
        for blk in self.down_blocks:
            for resnet in blk.resnets:
                h = resnet(h)
            if hasattr(blk, "downsamplers"):
                h = blk.downsamplers[0](h)
        h = _run_mid(self.mid_block, h)
        return self.conv_out(self.conv_norm_out(h))


class Decoder(nn.Module):
    def __init__(self, block_out_channels=(128, 256, 512, 512), layers_per_block: int = 3,
                 out_channels: int = 3, latent_channels: int = 4):
        super().__init__()
        chans = list(reversed(block_out_channels))
        self.conv_in = ConvNHWC(latent_channels, chans[0], 3, padding=1)
        self.mid_block = _mid_block(chans[0])
        self.up_blocks = nn.ModuleList()
        prev = chans[0]
        for bi, ch in enumerate(chans):
            blk = nn.Module()
            res = []
            for _ in range(layers_per_block):
                res.append(ResnetBlock(prev, ch, eps=1e-6))
                prev = ch
            blk.resnets = nn.ModuleList(res)
            if bi < len(chans) - 1:
                blk.upsamplers = nn.ModuleList([Upsample(ch)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(chans[-1], 32, 1e-6, act="silu")
        self.conv_out = ConvNHWC(chans[-1], out_channels, 3, padding=1)

    def forward(self, z):
        h = _run_mid(self.mid_block, self.conv_in(z))
        for blk in self.up_blocks:
            for resnet in blk.resnets:
                h = resnet(h)
            if hasattr(blk, "upsamplers"):
                h = blk.upsamplers[0](h)
        return self.conv_out(self.conv_norm_out(h))


class AutoencoderKL(nn.Module):
    """encode(images) -> (mean, logvar); decode(latents) -> images. The
    pipeline works in the scaled latent space (`encode_scaled` /
    `decode_scaled`)."""

    def __init__(self, block_out_channels: Sequence[int] = (128, 256, 512, 512),
                 latent_channels: int = 4):
        super().__init__()
        self.encoder = Encoder(block_out_channels, 2, latent_channels)
        self.decoder = Decoder(block_out_channels, 3, 3, latent_channels)
        self.quant_conv = nn.Linear(2 * latent_channels, 2 * latent_channels)
        self.post_quant_conv = nn.Linear(latent_channels, latent_channels)

    def encode(self, x) -> Tuple[torch.Tensor, torch.Tensor]:
        mean, logvar = self.quant_conv(self.encoder(x)).chunk(2, dim=-1)
        return mean, logvar.clamp(-30.0, 20.0)

    def decode(self, z):
        return self.decoder(self.post_quant_conv(z))

    def encode_scaled(self, x, generator: Optional[torch.Generator] = None):
        mean, logvar = self.encode(x)
        if generator is not None:
            noise = torch.randn(mean.shape, generator=generator, device=mean.device,
                                dtype=mean.dtype)
            mean = mean + torch.exp(0.5 * logvar) * noise
        return mean * SD_VAE_SCALE

    def decode_scaled(self, z):
        return self.decode(z / SD_VAE_SCALE)

    def forward(self, x):
        return self.decode(self.encode(x)[0])
