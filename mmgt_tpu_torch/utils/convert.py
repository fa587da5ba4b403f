"""Carry `mmgt_tpu` (flax) parameters into the port's modules.

The port's modules keep the reference's torch state-dict key names. For
each port key, `load_jax_params` finds the flax leaf whose name the
mapper translates to that key, using this module's copies of
`mmgt_tpu.utils.convert.map_unet3d`, `map_unet2d`, `map_vae`,
`map_pose_guider`, `map_audio_proj` (`PIPELINE_MAPPERS`) and
`map_clip_vision`, `map_wav2vec2`, `map_wavlm`, `map_smga`
(`ENCODER_MAPPERS`), and inverts the converter's layout change
(`to_flax_tensor`): Dense (in, out) -> (out, in), Conv (kh, kw, in, out)
-> (out, in, kh, kw), Conv1d (k, in/groups, out) -> (out, in/groups, k).
A port key with no flax leaf, or a flax leaf that no port key takes,
raises.
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


def map_clip_vision(key: str) -> str:
    """our CLIPVisionModel -> HF CLIPVisionModelWithProjection."""
    pre = "vision_model."
    if key == "class_embedding":
        return pre + "embeddings.class_embedding"
    if key == "position_embedding":
        return pre + "embeddings.position_embedding.weight"
    path, leaf = _leaf(key)
    s = path
    table = {
        "patch_embed": pre + "embeddings.patch_embedding",
        "pre_norm": pre + "pre_layrnorm",
        "post_norm": pre + "post_layernorm",
        "visual_projection": "visual_projection",
    }
    if s in table:
        return f"{table[s]}.{leaf}"
    m = re.match(r"^layer_(\d+)/(.*)$", s)
    if m:
        i, rest = m.group(1), m.group(2)
        rest = {
            "ln1": "layer_norm1",
            "ln2": "layer_norm2",
            "q_proj": "self_attn.q_proj",
            "k_proj": "self_attn.k_proj",
            "v_proj": "self_attn.v_proj",
            "out_proj": "self_attn.out_proj",
            "fc1": "mlp.fc1",
            "fc2": "mlp.fc2",
        }[rest]
        return f"{pre}encoder.layers.{i}.{rest}.{leaf}"
    raise KeyError(key)


def map_wav2vec2(key: str) -> str:
    """our Wav2Vec2Model -> HF Wav2Vec2Model state dict."""
    path, leaf = _leaf(key)
    s = path
    m = re.match(r"^feature_extractor/conv_(\d+)$", s)
    if m:
        return f"feature_extractor.conv_layers.{m.group(1)}.conv.{leaf}"
    if key.startswith("feature_extractor/gn_0"):
        l = "weight" if key.endswith("scale") else "bias"
        return f"feature_extractor.conv_layers.0.layer_norm.{l}"
    table = {
        "fp_norm": "feature_projection.layer_norm",
        "fp_proj": "feature_projection.projection",
        "encoder_norm": "encoder.layer_norm",
        "pos_conv/conv": "encoder.pos_conv_embed.conv",
    }
    if s in table:
        return f"{table[s]}.{leaf}"
    m = re.match(r"^layer_(\d+)/(.*)$", s)
    if m:
        i, rest = m.group(1), m.group(2)
        rest = {
            "q_proj": "attention.q_proj",
            "k_proj": "attention.k_proj",
            "v_proj": "attention.v_proj",
            "out_proj": "attention.out_proj",
            "attn_norm": "layer_norm",
            "ff_in": "feed_forward.intermediate_dense",
            "ff_out": "feed_forward.output_dense",
            "ff_norm": "final_layer_norm",
        }[rest]
        return f"encoder.layers.{i}.{rest}.{leaf}"
    raise KeyError(key)


def map_wavlm(key: str) -> str:
    """our WavLMModel -> microsoft WavLM checkpoint ['model'] keys."""
    m = re.match(r"^layer_(\d+)/attn/grep_a$", key)
    if m:
        return f"encoder.layers.{m.group(1)}.self_attn.grep_a"
    path, leaf = _leaf(key)
    s = path
    m = re.match(r"^feature_extractor/conv_(\d+)$", s)
    if m:
        return f"feature_extractor.conv_layers.{m.group(1)}.0.{leaf}"
    m = re.match(r"^feature_extractor/ln_(\d+)$", s)
    if m:
        return f"feature_extractor.conv_layers.{m.group(1)}.2.1.{leaf}"
    table = {
        "post_extract_norm": "layer_norm",
        "post_extract_proj": "post_extract_proj",
        "pos_conv/conv": "encoder.pos_conv.0",
        "final_norm": "encoder.layer_norm",
    }
    if s in table:
        return f"{table[s]}.{leaf}"
    if key == "layer_0/attn/rel_attn_embed":
        return "encoder.layers.0.self_attn.relative_attention_bias.weight"
    m = re.match(r"^layer_(\d+)/(.*)$", s)
    if m:
        i, rest = m.group(1), m.group(2)
        rest = {
            "attn/q_proj": "self_attn.q_proj",
            "attn/k_proj": "self_attn.k_proj",
            "attn/v_proj": "self_attn.v_proj",
            "attn/out_proj": "self_attn.out_proj",
            "attn/grep_linear": "self_attn.grep_linear",
            "attn/grep_a": "self_attn.grep_a",
            "attn_norm": "self_attn_layer_norm",
            "ff_in": "fc1",
            "ff_out": "fc2",
            "ff_norm": "final_layer_norm",
        }[rest]
        out_leaf = "" if rest.endswith("grep_a") else f".{leaf}"
        return f"encoder.layers.{i}.{rest}{out_leaf}"
    raise KeyError(key)


def map_smga(key: str) -> str:
    """our GestureDecoder (models/smga.py) -> reference Stage-1 checkpoint
    keys (src/audio2pose_model/model.py:324-490), after split_packed_qkv.

    The reference module declares several params its forward never uses
    (per-layer merged `self_attn`, `norm_face_3/norm_body_3`,
    `film_face_3/film_body_3`) — those stay unmapped and show up only in
    report["unexpected"].
    """
    if key in ("null_cond_embed", "null_cond_hidden"):
        return key
    path, leaf = _leaf(key)
    s = path
    # sequential-wrapped singles
    s = re.sub(r"^time_mlp$", "time_mlp.1", s)
    s = re.sub(r"^to_time_cond$", "to_time_cond.0", s)
    s = re.sub(r"^to_time_tokens$", "to_time_tokens.0", s)
    s = re.sub(r"^non_attn_norm$", "non_attn_cond_projection.0", s)
    s = re.sub(r"^non_attn_proj1$", "non_attn_cond_projection.1", s)
    s = re.sub(r"^non_attn_proj2$", "non_attn_cond_projection.3", s)
    # audio cond encoder layers
    s = re.sub(r"^cond_encoder_(\d+)", r"cond_encoder.\1", s)
    # split face/body decoder layers
    s = re.sub(r"^decoder_(\d+)", r"seqTransDecoder.stack.\1", s)
    # attention: our to_q/to_k/to_v/to_out -> synthetic q_proj/... + out_proj
    s = re.sub(r"(self_attn|cross_attn)/to_q$", r"\1.q_proj", s)
    s = re.sub(r"(self_attn|cross_attn)/to_k$", r"\1.k_proj", s)
    s = re.sub(r"(self_attn|cross_attn)/to_v$", r"\1.v_proj", s)
    s = re.sub(r"(self_attn|cross_attn)/to_out$", r"\1.out_proj", s)
    # FiLM generators: our film_x/proj -> block.1 (Sequential[Mish, Linear])
    s = re.sub(r"(film_\w+)/proj$", r"\1.block.1", s)
    return f"{s.replace('/', '.')}.{leaf}"


PIPELINE_MAPPERS: Dict[str, Callable[[str], str]] = {
    "vae": map_vae,
    "reference_unet": map_unet2d,
    "denoising_unet": map_unet3d,
    "pose_guider": map_pose_guider,
    "audio_proj": map_audio_proj,
}

# the audio2vid slice's encoders and Stage 1 (HF CLIPVisionModelWithProjection,
# HF Wav2Vec2Model, microsoft WavLM, the reference GestureDecoder)
ENCODER_MAPPERS: Dict[str, Callable[[str], str]] = {
    "clip": map_clip_vision,
    "wav2vec2": map_wav2vec2,
    "wavlm": map_wavlm,
    "smga": map_smga,
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
        elif a.ndim == 3:    # conv1d (k, in/groups, out) -> (out, in/groups, k)
            a = a.transpose(2, 1, 0)
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
