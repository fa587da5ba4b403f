"""ReferenceNet (`mmgt_tpu/models/unet_ref.py`): the SD1.5 2D UNet run once
per generation on the reference latent. Its useful output is the 16 banks
(6 down + 1 mid + 9 up) of pre-attention hidden states, returned in the
order the denoiser consumes them.

forward(latent (B, h, w, 4), t (B,), context (B, L, 768))
  -> (sample (B, h, w, 4), banks: list of 16 (B, L_i, C_i))
"""
from __future__ import annotations

from typing import Sequence

import torch
from torch import nn

from mmgt_tpu_torch.models.blocks import (
    Downsample,
    ResnetBlock,
    SpatialTransformer2D,
    Upsample,
)
from mmgt_tpu_torch.models.unet3d import skip_channels
from mmgt_tpu_torch.nn.layers import ConvNHWC, GroupNorm, TimestepEmbedding, timestep_embedding


class ReferenceUNet2D(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, heads: int = 8, context_dim: int = 768):
        super().__init__()
        chans = list(block_out_channels)
        self.block_out_channels = tuple(chans)
        n = len(chans)
        temb = chans[0] * 4
        self.conv_in = ConvNHWC(4, chans[0], 3, padding=1)
        self.time_embedding = TimestepEmbedding(chans[0], temb)
        self.down_blocks = nn.ModuleList()
        for bi, out_ch in enumerate(chans):
            in_ch = chans[bi - 1] if bi > 0 else chans[0]
            blk = nn.Module()
            blk.resnets = nn.ModuleList(
                [ResnetBlock(in_ch if li == 0 else out_ch, out_ch, temb)
                 for li in range(layers_per_block)])
            if bi < n - 1:
                blk.attentions = nn.ModuleList(
                    [SpatialTransformer2D(out_ch, heads, context_dim)
                     for _ in range(layers_per_block)])
                blk.downsamplers = nn.ModuleList([Downsample(out_ch)])
            self.down_blocks.append(blk)
        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock(chans[-1], chans[-1], temb) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList(
            [SpatialTransformer2D(chans[-1], heads, context_dim)])
        skips = skip_channels(chans, layers_per_block)
        self.up_blocks = nn.ModuleList()
        x_ch = chans[-1]
        for bi, out_ch in enumerate(reversed(chans)):
            blk = nn.Module()
            res = []
            for _ in range(layers_per_block + 1):
                res.append(ResnetBlock(x_ch + skips.pop(), out_ch, temb))
                x_ch = out_ch
            blk.resnets = nn.ModuleList(res)
            if bi > 0:
                blk.attentions = nn.ModuleList(
                    [SpatialTransformer2D(out_ch, heads, context_dim)
                     for _ in range(layers_per_block + 1)])
            if bi < n - 1:
                blk.upsamplers = nn.ModuleList([Upsample(out_ch)])
            self.up_blocks.append(blk)
        self.conv_norm_out = GroupNorm(chans[0], 32, 1e-5, act="silu")
        self.conv_out = ConvNHWC(chans[0], 4, 3, padding=1)

    def forward(self, latent, t, context):
        dtype = self.conv_in.weight.dtype
        temb = self.time_embedding(timestep_embedding(t, self.block_out_channels[0]).to(dtype))
        banks = []
        x = self.conv_in(latent)
        res_stack = [x]
        for blk in self.down_blocks:
            for li, resnet in enumerate(blk.resnets):
                x = resnet(x, temb)
                if hasattr(blk, "attentions"):
                    x, bank = blk.attentions[li](x, context)
                    banks.append(bank)
                res_stack.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                res_stack.append(x)
        mid = self.mid_block
        x = mid.resnets[0](x, temb)
        x, bank = mid.attentions[0](x, context)
        banks.append(bank)
        x = mid.resnets[1](x, temb)
        for blk in self.up_blocks:
            for li, resnet in enumerate(blk.resnets):
                x = resnet(torch.cat([x, res_stack.pop()], -1), temb)
                if hasattr(blk, "attentions"):
                    x, bank = blk.attentions[li](x, context)
                    banks.append(bank)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)
        x = self.conv_out(self.conv_norm_out(x))
        return x, banks
