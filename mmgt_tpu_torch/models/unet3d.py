"""Denoising video UNet (`mmgt_tpu/models/unet3d.py`): SD1.5 inflated to
video with reference-bank self-attention, MM-HAA masked audio
cross-attention in the three cross-attention down blocks, and motion
modules in every block including mid.

Forward, all channel-last:
  latents      (B, F, h, w, 4)
  t            (B,) int
  context      (B, L_ctx, 768)    CLIP image embedding tokens
  audio_tokens (B, F, 32, 768)    AudioProjModel output, or None: the
                                  audio modules are skipped
  pose_feat    (B, F, h, w, C0)   PoseGuider output (added after conv_in),
                                  or None
  masks        3 levels x (full, face, lip), each (B, F, L_level), or None
                                  without audio tokens
  banks_kv     16 (k, v) pairs, each (1, L_i, heads, d_i): the reference
               banks projected once per generation (`precompute_bank_kv`),
               the inference route
  n_uncond     the first n_uncond rows are the CFG-uncond half: no bank,
               and their audio tokens / context must be zeros
  banks        16 raw (B, L_i, C_i) banks, one set per example: the
               training route (instead of banks_kv)
  bank_gate    (B,) in {0, 1}, the rows that attend to the bank; by
               default the rows from n_uncond on (`unet3d.py:99-101`)

`use_audio_module=False` / `use_motion_module=False` leave the audio /
motion modules out: they are neither built (so `state_dict()` matches the
JAX tree of the same flags) nor run (pose2img's single-frame UNet).

`remat=True` checkpoints every ResnetBlock, SpatialTransformerRef and
MotionModule (`torch.utils.checkpoint`, non-reentrant) when autograd
records, as `nn.remat` does in the JAX package (`unet3d.py:91-96`). The
motion modules keep K4 under remat; the JAX package's remat-only unfused
motion path (`fuse_kernels`) has no counterpart.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from mmgt_tpu_torch.models.blocks import (
    Downsample,
    MotionModule,
    ResnetBlock,
    SpatialTransformerAudio,
    SpatialTransformerRef,
    Upsample,
)
from mmgt_tpu_torch.nn.layers import (
    ConvNHWC,
    GroupNorm,
    TimestepEmbedding,
    col_linear,
    timestep_embedding,
)


def _fold(x):
    return x.reshape(x.shape[0] * x.shape[1], *x.shape[2:])


def skip_channels(chans: Sequence[int], layers_per_block: int) -> List[int]:
    """Channels of the skip tensors the down path pushes, in push order."""
    out = [chans[0]]
    for bi, ch in enumerate(chans):
        out += [ch] * layers_per_block
        if bi < len(chans) - 1:
            out.append(ch)
    return out


class DenoisingUNet3D(nn.Module):
    def __init__(self, block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                 layers_per_block: int = 2, heads: int = 8, motion_max_len: int = 32,
                 context_dim: int = 768, remat: bool = False,
                 use_audio_module: bool = True, use_motion_module: bool = True):
        super().__init__()
        chans = list(block_out_channels)
        self.block_out_channels, self.layers_per_block = tuple(chans), layers_per_block
        self.heads = heads
        self.remat = remat
        self.use_audio_module, self.use_motion_module = use_audio_module, use_motion_module
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
                    [SpatialTransformerRef(out_ch, heads, context_dim)
                     for _ in range(layers_per_block)])
                if use_audio_module:
                    blk.audio_modules = nn.ModuleList(
                        [SpatialTransformerAudio(out_ch, heads, in_ch if li == 0 else out_ch)
                         for li in range(layers_per_block)])
                blk.downsamplers = nn.ModuleList([Downsample(out_ch)])
            if use_motion_module:
                blk.motion_modules = nn.ModuleList(
                    [MotionModule(out_ch, heads, motion_max_len) for _ in range(layers_per_block)])
            self.down_blocks.append(blk)

        self.mid_block = nn.Module()
        self.mid_block.resnets = nn.ModuleList(
            [ResnetBlock(chans[-1], chans[-1], temb) for _ in range(2)])
        self.mid_block.attentions = nn.ModuleList(
            [SpatialTransformerRef(chans[-1], heads, context_dim)])
        if use_motion_module:
            self.mid_block.motion_modules = nn.ModuleList(
                [MotionModule(chans[-1], heads, motion_max_len)])

        skips = skip_channels(chans, layers_per_block)
        rev = list(reversed(chans))
        self.up_blocks = nn.ModuleList()
        x_ch = chans[-1]
        for bi, out_ch in enumerate(rev):
            blk = nn.Module()
            res = []
            for _ in range(layers_per_block + 1):
                res.append(ResnetBlock(x_ch + skips.pop(), out_ch, temb))
                x_ch = out_ch
            blk.resnets = nn.ModuleList(res)
            if bi > 0:
                blk.attentions = nn.ModuleList(
                    [SpatialTransformerRef(out_ch, heads, context_dim)
                     for _ in range(layers_per_block + 1)])
            if use_motion_module:
                blk.motion_modules = nn.ModuleList(
                    [MotionModule(out_ch, heads, motion_max_len)
                     for _ in range(layers_per_block + 1)])
            if bi < n - 1:
                blk.upsamplers = nn.ModuleList([Upsample(out_ch)])
            self.up_blocks.append(blk)

        self.conv_norm_out = GroupNorm(chans[0], 32, 1e-5, act="silu")
        self.conv_out = ConvNHWC(chans[0], 4, 3, padding=1)

    def bank_attentions(self) -> List[nn.Module]:
        """The 16 bank self-attentions, in the order `forward` consumes
        `banks_kv` (== the ReferenceNet's bank order)."""
        mods = []
        for blk in self.down_blocks:
            if hasattr(blk, "attentions"):
                mods += [st.transformer_blocks[0].attn1 for st in blk.attentions]
        mods.append(self.mid_block.attentions[0].transformer_blocks[0].attn1)
        for blk in self.up_blocks:
            if hasattr(blk, "attentions"):
                mods += [st.transformer_blocks[0].attn1 for st in blk.attentions]
        return mods

    def _run(self, mod, *args):
        """mod(*args), checkpointed when `remat` is on and autograd records."""
        if self.remat and torch.is_grad_enabled():
            return checkpoint(mod, *args, use_reentrant=False)
        return mod(*args)

    def forward(self, latents, t, context, audio_tokens=None, pose_feat=None, masks=None,
                banks_kv: Optional[List[Tuple[torch.Tensor, torch.Tensor]]] = None,
                motion_scale: Sequence[float] = (1.0, 1.0, 1.0), n_uncond: int = 0,
                banks: Optional[List[torch.Tensor]] = None, bank_gate=None):
        b, f = latents.shape[:2]
        dtype = self.conv_in.weight.dtype
        if (banks is None) == (banks_kv is None):
            raise ValueError("pass the banks raw (banks) or pre-projected (banks_kv)")
        if bank_gate is None:
            # the first n_uncond rows (CFG uncond) attend without the bank
            bank_gate = (torch.arange(b, device=latents.device) >= n_uncond).to(torch.int32)
        temb = timestep_embedding(t, self.block_out_channels[0]).to(dtype)
        temb = self.time_embedding(temb).repeat_interleave(f, 0)
        context = context.repeat_interleave(f, 0)
        audio_ctx = (None if audio_tokens is None
                     else audio_tokens.reshape(b * f, *audio_tokens.shape[2:]))
        bank_iter = iter(banks if banks is not None else banks_kv)
        run = self._run

        def attend(st, x):
            bank = next(bank_iter)
            if banks is not None:
                return run(st, x, context, None, f, bank_gate, bank)
            return run(st, x, context, bank, f, bank_gate)

        def level_masks(level):
            return tuple(m.reshape(b * f, m.shape[-1]) for m in masks[level])

        def motion(blk, i, x):
            if not self.use_motion_module:
                return x
            return run(blk.motion_modules[i], x, f)

        x = self.conv_in(_fold(latents))
        if pose_feat is not None:
            x = x + _fold(pose_feat)
        res_stack = [x]
        for bi, blk in enumerate(self.down_blocks):
            for li, resnet in enumerate(blk.resnets):
                x = run(resnet, x, temb)
                if hasattr(blk, "attentions"):
                    x = attend(blk.attentions[li], x)
                    if self.use_audio_module and audio_ctx is not None:
                        x = blk.audio_modules[li](x, audio_ctx, level_masks(bi), motion_scale,
                                                  n_uncond * f)
                x = motion(blk, li, x)
                res_stack.append(x)
            if hasattr(blk, "downsamplers"):
                x = blk.downsamplers[0](x)
                res_stack.append(x)

        mid = self.mid_block
        x = run(mid.resnets[0], x, temb)
        x = attend(mid.attentions[0], x)
        x = motion(mid, 0, x)
        x = run(mid.resnets[1], x, temb)

        for blk in self.up_blocks:
            for li, resnet in enumerate(blk.resnets):
                x = run(resnet, torch.cat([x, res_stack.pop()], -1), temb)
                if hasattr(blk, "attentions"):
                    x = attend(blk.attentions[li], x)
                x = motion(blk, li, x)
            if hasattr(blk, "upsamplers"):
                x = blk.upsamplers[0](x)

        x = self.conv_out(self.conv_norm_out(x))
        return x.reshape(b, f, *x.shape[1:])


def bank_attn_names(block_out_channels: Sequence[int] = (320, 640, 1280, 1280),
                    layers_per_block: int = 2) -> List[Tuple[str, int]]:
    """(JAX module name, channels) of every bank self-attention, in the
    order the UNet consumes the banks (`mmgt_tpu.models.unet3d`)."""
    chans = list(block_out_channels)
    n = len(chans)
    names = [(f"down_{bi}_attn_{li}", chans[bi])
             for bi in range(n - 1) for li in range(layers_per_block)]
    names.append(("mid_attn", chans[-1]))
    rev = list(reversed(chans))
    names += [(f"up_{bi}_attn_{li}", rev[bi])
              for bi in range(1, n) for li in range(layers_per_block + 1)]
    return names


@torch.no_grad()
def precompute_bank_kv(unet: DenoisingUNet3D, banks: Sequence[torch.Tensor]):
    """Project every reference bank (1, L_i, C_i) through its block's attn1
    to_k/to_v ONCE per generation, in the plain (1, L_i, heads, d_i) layout
    that K1's bank segment reads with batch stride 0 (on a head shard: this
    rank's heads)."""
    attns = unet.bank_attentions()
    assert len(attns) == len(banks), (len(attns), len(banks))
    out = []
    for attn, bank in zip(attns, banks):
        bank = bank.to(attn.to_k.weight.dtype)
        shape = (1, bank.shape[1], -1, attn.head_dim)   # the local heads on a head shard
        out.append((col_linear(bank, attn.to_k).reshape(shape).contiguous(),
                    col_linear(bank, attn.to_v).reshape(shape).contiguous()))
    return out
