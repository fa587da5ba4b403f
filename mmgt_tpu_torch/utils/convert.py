"""Carry `mmgt_tpu` (flax) parameters into the port's modules.

The port's modules keep the reference's torch state-dict key names. For
each port key, `load_jax_params` finds the flax leaf whose name the
mapper translates to that key, using this module's copies of
`mmgt_tpu.utils.convert.map_unet3d`, `map_unet2d`, `map_vae`,
`map_pose_guider` and `map_audio_proj`, and inverts the converter's
layout change (`to_flax_tensor`): Dense (in, out) -> (out, in), Conv
(kh, kw, in, out) -> (out, in, kh, kw). A port key with no flax leaf, or a
flax leaf that no port key takes, raises.
"""
from __future__ import annotations

import re
from typing import Any, Callable, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch
from torch import nn


# --------------------------------------------------------- name translation
def _tx_block_suffix(s: str) -> str:
    """Transformer-block-internal names (shared by 2D/3D/audio blocks)."""
    s = s.replace("ff/proj_geglu", "ff.net.0.proj")
    s = s.replace("ff/proj_out", "ff.net.2")
    s = re.sub(r"(attn[\w]*)/to_out", r"\1.to_out.0", s)
    s = re.sub(r"zero_conv_0$", "zero_conv_full", s)
    s = re.sub(r"zero_conv_1$", "zero_conv_face", s)
    s = re.sub(r"zero_conv_2$", "zero_conv_lip", s)
    return s.replace("/", ".")


def _leaf(s: str) -> Tuple[str, str]:
    if "/" not in s:
        return "", s
    path, leaf = s.rsplit("/", 1)
    return path, {"kernel": "weight", "scale": "weight"}.get(leaf, leaf)


def _unet_common(s: str) -> str:
    s = re.sub(r"^down_(\d+)_res_(\d+)", r"down_blocks.\1.resnets.\2", s)
    s = re.sub(r"^down_(\d+)_attn_(\d+)/block", r"down_blocks.\1.attentions.\2.transformer_blocks.0", s)
    s = re.sub(r"^down_(\d+)_attn_(\d+)", r"down_blocks.\1.attentions.\2", s)
    s = re.sub(r"^down_(\d+)_downsample", r"down_blocks.\1.downsamplers.0", s)
    s = re.sub(r"^up_(\d+)_res_(\d+)", r"up_blocks.\1.resnets.\2", s)
    s = re.sub(r"^up_(\d+)_attn_(\d+)/block", r"up_blocks.\1.attentions.\2.transformer_blocks.0", s)
    s = re.sub(r"^up_(\d+)_attn_(\d+)", r"up_blocks.\1.attentions.\2", s)
    s = re.sub(r"^up_(\d+)_upsample", r"up_blocks.\1.upsamplers.0", s)
    s = re.sub(r"^mid_res_(\d+)", r"mid_block.resnets.\1", s)
    s = re.sub(r"^mid_attn/block", r"mid_block.attentions.0.transformer_blocks.0", s)
    s = re.sub(r"^mid_attn", r"mid_block.attentions.0", s)
    return _tx_block_suffix(s)


def map_unet2d(key: str) -> str:
    """ReferenceUNet2D key -> diffusers UNet2DConditionModel key."""
    path, leaf = _leaf(key)
    return f"{_unet_common(path)}.{leaf}"


def map_unet3d(key: str) -> str:
    """DenoisingUNet3D key -> merged reference UNet3D key (SD1.5 names +
    motion_modules + audio_modules)."""
    path, leaf = _leaf(key)
    s = path
    s = re.sub(r"^(down|up)_(\d+)_motion_(\d+)",
               r"\1_blocks.\2.motion_modules.\3.temporal_transformer", s)
    s = re.sub(r"^mid_motion", r"mid_block.motion_modules.0.temporal_transformer", s)
    s = re.sub(r"/block/attn_(\d+)", r".transformer_blocks.0.attention_blocks.\1", s)
    s = re.sub(r"(attention_blocks\.\d+)/to_out", r"\1.to_out.0", s)
    s = re.sub(r"/block/norm_(\d+)", r".transformer_blocks.0.norms.\1", s)
    s = re.sub(r"/block/ff_norm", r".transformer_blocks.0.ff_norm", s)
    s = re.sub(r"(temporal_transformer)/block/ff", r"\1.transformer_blocks.0.ff", s)
    s = re.sub(r"^down_(\d+)_audio_(\d+)/block",
               r"down_blocks.\1.audio_modules.\2.transformer_blocks.0", s)
    s = re.sub(r"^down_(\d+)_audio_(\d+)", r"down_blocks.\1.audio_modules.\2", s)
    return f"{_unet_common(s)}.{leaf}"


def map_vae(key: str) -> str:
    path, leaf = _leaf(key)
    s = path
    s = re.sub(r"^(encoder|decoder)/down_(\d+)_res_(\d+)", r"\1.down_blocks.\2.resnets.\3", s)
    s = re.sub(r"^(encoder|decoder)/down_(\d+)_downsample", r"\1.down_blocks.\2.downsamplers.0", s)
    s = re.sub(r"^(encoder|decoder)/up_(\d+)_res_(\d+)", r"\1.up_blocks.\2.resnets.\3", s)
    s = re.sub(r"^(encoder|decoder)/up_(\d+)_upsample", r"\1.up_blocks.\2.upsamplers.0", s)
    s = re.sub(r"^(encoder|decoder)/mid_res_(\d+)", r"\1.mid_block.resnets.\2", s)
    s = re.sub(r"^(encoder|decoder)/mid_attn/attn", r"\1.mid_block.attentions.0", s)
    s = re.sub(r"^(encoder|decoder)/mid_attn", r"\1.mid_block.attentions.0", s)
    s = re.sub(r"^encoder/quant_conv", "quant_conv", s)
    s = re.sub(r"^decoder/post_quant_conv", "post_quant_conv", s)
    s = re.sub(r"/to_out$", ".to_out.0", s)
    return f"{s.replace('/', '.')}.{leaf}"


def map_pose_guider(key: str) -> str:
    """PoseGuider: the blocks list interleaves [conv, down] pairs 0..5."""
    path, leaf = _leaf(key)
    m = re.match(r"^block_(\d+)_(conv|down)$", path)
    if m:
        return f"blocks.{2 * int(m.group(1)) + (m.group(2) == 'down')}.{leaf}"
    return f"{path.replace('/', '.')}.{leaf}"


def map_audio_proj(key: str) -> str:
    path, leaf = _leaf(key)
    return f"{path.replace('/', '.')}.{leaf}"


PIPELINE_MAPPERS: Dict[str, Callable[[str], str]] = {
    "vae": map_vae,
    "reference_unet": map_unet2d,
    "denoising_unet": map_unet3d,
    "pose_guider": map_pose_guider,
    "audio_proj": map_audio_proj,
}


# ------------------------------------------------------------------- loading
def _flatten(tree: Mapping, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    for k, v in tree.items():
        if isinstance(v, Mapping):
            yield from _flatten(v, f"{prefix}{k}/")
        else:
            yield f"{prefix}{k}", v


def from_flax_tensor(flax_key: str, arr, shape) -> np.ndarray:
    """Flax layout -> torch layout for one leaf (inverse of
    `mmgt_tpu.utils.convert.to_flax_tensor` for the port's modules)."""
    a = np.asarray(arr)
    if flax_key.rsplit("/", 1)[-1] == "kernel":
        if a.ndim == 4:      # conv HWIO -> OIHW
            a = a.transpose(3, 2, 0, 1)
        elif a.ndim == 2:    # dense (in, out) -> (out, in)
            a = a.T
    if a.shape != tuple(shape):
        raise ValueError(f"{flax_key}: flax shape {np.shape(arr)} does not fit {tuple(shape)}")
    return np.ascontiguousarray(a)


def load_jax_params(module: nn.Module, flax_tree: Mapping,
                    mapper: Callable[[str], str]) -> nn.Module:
    """Copy a flax param tree (numpy leaves, with or without the top-level
    "params" collection) into `module`, in place; returns the module."""
    tree = flax_tree["params"] if "params" in flax_tree else flax_tree
    by_key: Dict[str, Tuple[str, Any]] = {}
    for flax_key, arr in _flatten(tree):
        torch_key = mapper(flax_key)
        if torch_key in by_key:
            raise KeyError(f"{flax_key} and {by_key[torch_key][0]} both map to {torch_key}")
        by_key[torch_key] = (flax_key, arr)
    sd = module.state_dict()
    missing = [k for k in sd if k not in by_key]
    left = [fk for tk, (fk, _) in by_key.items() if tk not in sd]
    if missing or left:
        raise KeyError(
            f"{len(missing)} port keys without a flax leaf (e.g. {missing[:3]}), "
            f"{len(left)} flax leaves left over (e.g. {left[:3]})")
    with torch.no_grad():
        for key, t in sd.items():
            flax_key, arr = by_key[key]
            t.copy_(torch.from_numpy(from_flax_tensor(flax_key, arr, t.shape)))
    return module
