"""PoseGuider (`mmgt_tpu/models/pose_guider.py`): ControlNet-lite encoder
of the pose video, (B, F, H, W, 3) -> (B, F, H/8, W/8, 320), added to the
denoiser's conv_in output. Frames fold into the batch."""
from __future__ import annotations

from typing import Sequence

import torch.nn.functional as F
from torch import nn

from mmgt_tpu_torch.nn.layers import ConvNHWC


class PoseGuider(nn.Module):
    def __init__(self, embedding_channels: int = 320,
                 block_out_channels: Sequence[int] = (16, 32, 96, 256)):
        super().__init__()
        chans = list(block_out_channels)
        self.conv_in = ConvNHWC(3, chans[0], 3, padding=1)
        blocks = []
        for i in range(len(chans) - 1):
            blocks.append(ConvNHWC(chans[i], chans[i], 3, padding=1))
            blocks.append(ConvNHWC(chans[i], chans[i + 1], 3, stride=2, padding=1))
        self.blocks = nn.ModuleList(blocks)
        self.conv_out = ConvNHWC(chans[-1], embedding_channels, 3, padding=1)

    def forward(self, pose):
        b, f = pose.shape[:2]
        x = F.silu(self.conv_in(pose.reshape(b * f, *pose.shape[2:])))
        for conv in self.blocks:
            x = F.silu(conv(x))
        x = self.conv_out(x)
        return x.reshape(b, f, *x.shape[1:])
