"""Checkpoints and flax parameters into the port's modules.

The port's modules keep the reference's torch state-dict key names, so a
reference checkpoint loads by its own keys (`load_checkpoint`); the
readers are the port's copies of `mmgt_tpu/utils/convert.py`'s
`load_torch_state_dict`, `fold_weight_norm`, `split_packed_qkv`,
`load_smga_state_dict` and `split_net_checkpoint`, plus a `.safetensors`
reader of its own (`read_safetensors`).

`load_jax_params` carries a flax tree in: for each port key it finds the
flax leaf whose name the mapper translates to that key, using this
module's copies of `mmgt_tpu.utils.convert.map_unet3d`, `map_unet2d`,
`map_vae`, `map_pose_guider`, `map_audio_proj` (`PIPELINE_MAPPERS`) and
`map_clip_vision`, `map_wav2vec2`, `map_wavlm`, `map_smga`
(`ENCODER_MAPPERS`), `map_yolox`, `map_rtmpose` (`DWPOSE_MAPPERS`; their
BatchNorm statistics from the "batch_stats" collection), and inverts the converter's layout change
(`to_flax_tensor`): Dense (in, out) -> (out, in), Conv (kh, kw, in, out)
-> (out, in, kh, kw), Conv1d (k, in/groups, out) -> (out, in/groups, k).
A port key with no flax leaf, or a flax leaf that no port key takes,
raises. `load_dwpose_weights` fills the DWPose nets from their .onnx
files by the initializers' names.
"""
from __future__ import annotations

import json
import os
import pickle
import re
import struct
from typing import Any, Callable, Dict, Iterator, List, Mapping, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from mmgt_tpu_torch.utils.onnx_reader import load_onnx


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


# ------------------------------------------------------- DWPose (ONNX nets)
def _dwpose_leaf(key: str) -> Tuple[str, str]:
    """Split key into (path, torch leaf) with BatchNorm-stat awareness.

    flax ConvBnAct stores conv/kernel + bn/{scale,bias} in params and
    bn/{mean,var} in batch_stats — torch ConvModule uses .conv.weight,
    .bn.{weight,bias,running_mean,running_var}."""
    key = key.replace("batch_stats/", "", 1) if key.startswith("batch_stats/") else key
    path, leaf = key.rsplit("/", 1) if "/" in key else ("", key)
    leaf = {
        "kernel": "weight", "scale": "weight",
        "mean": "running_mean", "var": "running_var",
    }.get(leaf, leaf)
    return path, leaf


def _map_csp_inner(s: str) -> str:
    """CSPLayer/CSPNeXt internals: our names -> mmdet/mmpose names."""
    s = re.sub(r"/main(/|$)", r"/main_conv\1", s)
    s = re.sub(r"/short(/|$)", r"/short_conv\1", s)
    s = re.sub(r"/final(/|$)", r"/final_conv\1", s)
    s = re.sub(r"/block_(\d+)", r"/blocks.\1", s)
    s = re.sub(r"/attn/fc", "/attention.fc", s)
    s = re.sub(r"/dw(/|$)", r"/conv2.depthwise_conv\1", s)
    s = re.sub(r"/pw(/|$)", r"/conv2.pointwise_conv\1", s)
    return s


def map_yolox(key: str) -> str:
    """our YOLOXL (models/dwpose.py) -> mmdet YOLOX state-dict keys, the
    naming the reference's yolox_l.onnx initializers carry (mmdeploy export
    of mmdet YOLOX-L; reference runs it via onnxruntime,
    src/dwpose/wholebody.py:14-27)."""
    path, leaf = _dwpose_leaf(key)
    s = "/" + path
    # backbone: our dark{n}_* -> mmdet stage{n-1}.{idx}
    s = re.sub(r"/backbone/stem/conv", "/backbone.stem.conv", s)
    for n in (2, 3, 4):
        s = s.replace(f"/backbone/dark{n}_conv", f"/backbone.stage{n - 1}.0")
        s = s.replace(f"/backbone/dark{n}_csp", f"/backbone.stage{n - 1}.1")
    s = s.replace("/backbone/dark5_conv", "/backbone.stage4.0")
    s = s.replace("/backbone/dark5_spp", "/backbone.stage4.1")
    s = s.replace("/backbone/dark5_csp", "/backbone.stage4.2")
    # PAFPN neck
    s = s.replace("/lateral5", "/neck.reduce_layers.0")
    s = s.replace("/lateral4", "/neck.reduce_layers.1")
    s = s.replace("/fpn_c4", "/neck.top_down_blocks.0")
    s = s.replace("/fpn_c3", "/neck.top_down_blocks.1")
    s = s.replace("/down3", "/neck.downsamples.0")
    s = s.replace("/down4", "/neck.downsamples.1")
    s = s.replace("/pan_c4", "/neck.bottom_up_blocks.0")
    s = s.replace("/pan_c5", "/neck.bottom_up_blocks.1")
    s = re.sub(r"/head_stem_(\d+)", r"/neck.out_convs.\1", s)
    # decoupled head
    s = re.sub(r"/head_cls(\d)_(\d+)", r"/bbox_head.multi_level_cls_convs.\2.\1", s)
    s = re.sub(r"/head_reg(\d)_(\d+)", r"/bbox_head.multi_level_reg_convs.\2.\1", s)
    s = re.sub(r"/cls_pred_(\d+)", r"/bbox_head.multi_level_conv_cls.\1", s)
    s = re.sub(r"/reg_pred_(\d+)", r"/bbox_head.multi_level_conv_reg.\1", s)
    s = re.sub(r"/obj_pred_(\d+)", r"/bbox_head.multi_level_conv_obj.\1", s)
    s = _map_csp_inner(s)
    return f"{s[1:].replace('/', '.')}.{leaf}"


def map_rtmpose(key: str) -> str:
    """our RTMPose (models/dwpose.py) -> mmpose RTMPose-L state-dict keys,
    the naming the reference's dw-ll_ucoco_384.onnx initializers carry."""
    # bare params of the RTMCC head
    if key.endswith("gau/gamma") or key.endswith("gau/beta"):
        return f"head.gau.{key.rsplit('/', 1)[-1]}"
    if key.endswith("gau/res_scale"):
        return "head.gau.res_scale.scale"
    path, leaf = _dwpose_leaf(key)
    s = "/" + path
    s = re.sub(r"/stem(\d)", r"/backbone.stem.\1", s)
    s = re.sub(r"/stage(\d)_down", lambda m: f"/backbone.stage{int(m.group(1)) + 1}.0", s)
    s = s.replace("/stage3_spp", "/backbone.stage4.1")
    s = s.replace("/stage3_csp", "/backbone.stage4.2")
    s = re.sub(r"/stage(\d)_csp", lambda m: f"/backbone.stage{int(m.group(1)) + 1}.1", s)
    s = s.replace("/final_layer", "/head.final_layer")
    s = s.replace("/mlp_norm", "/head.mlp.0")
    s = s.replace("/mlp", "/head.mlp.1")  # mlp_norm already rewritten above
    s = s.replace("/gau/ln", "/head.gau.ln")
    s = s.replace("/gau/uv", "/head.gau.uv")
    s = s.replace("/gau/out", "/head.gau.o")
    s = s.replace("/cls_x", "/head.cls_x")
    s = s.replace("/cls_y", "/head.cls_y")
    s = _map_csp_inner(s)
    return f"{s[1:].replace('/', '.')}.{leaf}"


# the preprocessing nets (mmdet YOLOX-L, mmpose RTMPose-L DW-LL)
DWPOSE_MAPPERS: Dict[str, Callable[[str], str]] = {
    "yolox": map_yolox,
    "rtmpose": map_rtmpose,
}


def map_flax(key: str) -> str:
    """A module whose port names are its flax names with dots
    (`models/motion_autoencoder.py`, which no reference checkpoint names)."""
    path, leaf = _leaf(key)
    return f"{path.replace('/', '.')}.{leaf}"


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
    "params" collection) into `module`, in place; returns the module. A
    "batch_stats" collection beside "params" (BatchNorm running mean/var)
    crosses too, its keys prefixed "batch_stats/" for the mapper."""
    tree = flax_tree["params"] if "params" in flax_tree else flax_tree
    leaves = list(_flatten(tree))
    if "batch_stats" in flax_tree:
        leaves += list(_flatten(flax_tree["batch_stats"], "batch_stats/"))
    by_key: Dict[str, Tuple[str, Any]] = {}
    for flax_key, arr in leaves:
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


# --------------------------------------------------------------- checkpoints
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16,
    "BF16": torch.bfloat16, "I64": torch.int64, "I32": torch.int32, "I16": torch.int16,
    "I8": torch.int8, "U8": torch.uint8, "BOOL": torch.bool,
}


def read_safetensors(path: str) -> Dict[str, torch.Tensor]:
    """A `.safetensors` file as CPU tensors: an 8-byte little-endian header
    length, a JSON header {name: {"dtype", "shape", "data_offsets"}} (and
    an optional "__metadata__"), then the tensors' raw little-endian bytes,
    each at its offsets from the end of the header (read as they are: the
    host is little-endian). The tensors share one buffer of the file's
    data."""
    with open(path, "rb") as f:
        (n,) = struct.unpack("<Q", f.read(8))
        header = json.loads(f.read(n))
        buf = bytearray(os.fstat(f.fileno()).st_size - 8 - n)
        if f.readinto(buf) != len(buf):
            raise ValueError(f"{path}: short read")
    out = {}
    for name, info in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES[info["dtype"]]
        shape = [int(d) for d in info["shape"]]
        start, end = info["data_offsets"]
        numel = int(np.prod(shape))
        itemsize = torch.empty((), dtype=dtype).element_size()
        if not 0 <= start <= end <= len(buf) or end - start != numel * itemsize:
            raise ValueError(f"{path}: {name} has offsets {start}..{end} for {shape} "
                             f"{info['dtype']} in {len(buf)} data bytes")
        if numel == 0:
            out[name] = torch.empty(shape, dtype=dtype)
            continue
        out[name] = torch.frombuffer(buf, dtype=dtype, count=numel, offset=start).reshape(shape)
    return out


def _numpy(t: torch.Tensor) -> np.ndarray:
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()


def fold_weight_norm(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Torch weight-norm parametrizations as plain weights: `X.weight_g` +
    `X.weight_v` (old API) or `X.parametrizations.weight.original0/1`
    (new API) -> `X.weight` = g * v / ||v||, the norm over every axis where
    g has size 1, in float64 numpy as the JAX package computes it, rounded
    to v's dtype."""
    out = dict(sd)
    pairs = []
    for k in sd:
        m = re.match(r"(.*)\.weight_g$", k)
        if m and f"{m.group(1)}.weight_v" in sd:
            pairs.append((m.group(1), k, f"{m.group(1)}.weight_v"))
        m = re.match(r"(.*)\.parametrizations\.weight\.original0$", k)
        if m:
            v_key = f"{m.group(1)}.parametrizations.weight.original1"
            if v_key in sd:
                pairs.append((m.group(1), k, v_key))
    for base, g_key, v_key in pairs:
        g = _numpy(sd[g_key]).astype(np.float32)
        v = _numpy(sd[v_key]).astype(np.float32)
        axes = tuple(i for i, s in enumerate(g.shape) if s == 1) or tuple(range(v.ndim - 1))
        norm = np.sqrt((v.astype(np.float64) ** 2).sum(axis=axes, keepdims=True))
        w = g * (v / norm)
        dtype = sd[v_key].dtype
        out[base + ".weight"] = (torch.from_numpy(w).to(dtype) if dtype == torch.bfloat16
                                 else torch.from_numpy(w.astype(_numpy(sd[v_key]).dtype)))
        del out[g_key], out[v_key]
    return out


def load_torch_state_dict(path: str) -> Dict[str, torch.Tensor]:
    """A `.pth` / `.pt` / `.ckpt` / `.bin` / `.safetensors` file as a flat
    dict of CPU tensors in the file's own dtypes. Torch files are read
    with `weights_only=True` first, and again unrestricted when that
    refuses them (the microsoft WavLM release pickles its argparse cfg;
    only load files you trust); a "state_dict" or "model" wrapper is
    unwrapped, non-tensor entries dropped and weight norms folded."""
    if str(path).endswith(".safetensors"):
        return read_safetensors(path)
    try:
        sd = torch.load(path, map_location="cpu", weights_only=True)
    except pickle.UnpicklingError:
        sd = torch.load(path, map_location="cpu", weights_only=False)
    for wrapper in ("state_dict", "model"):
        if isinstance(sd, dict) and isinstance(sd.get(wrapper), dict):
            sd = sd[wrapper]
    return fold_weight_norm({k: v for k, v in sd.items() if isinstance(v, torch.Tensor)})


def split_packed_qkv(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """nn.MultiheadAttention's packed `in_proj_weight` / `in_proj_bias` as
    `q_proj` / `k_proj` / `v_proj` keys (rows [0:d], [d:2d], [2d:3d])."""
    out = dict(sd)
    for k in list(sd):
        m = re.match(r"(.*)\.in_proj_(weight|bias)$", k)
        if not m:
            continue
        base, kind = m.groups()
        d = sd[k].shape[0] // 3
        for i, name in enumerate(("q_proj", "k_proj", "v_proj")):
            out[f"{base}.{name}.{kind}"] = sd[k][i * d:(i + 1) * d]
        del out[k]
    return out


def load_smga_state_dict(path: str, ema: bool = True) -> Dict[str, torch.Tensor]:
    """A reference Stage-1 checkpoint (a dict of ema_state_dict /
    model_state_dict / optimizer_state_dict / normalizer, read
    unrestricted) as the GestureDecoder's state dict: the EMA weights
    unless `ema` is False or absent, a leading `module.` stripped, the
    packed q/k/v split."""
    ckpt = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(ckpt, dict) and ("ema_state_dict" in ckpt or "model_state_dict" in ckpt):
        ckpt = ckpt["ema_state_dict" if ema and "ema_state_dict" in ckpt else "model_state_dict"]
    sd = {(k[len("module."):] if k.startswith("module.") else k): v
          for k, v in ckpt.items() if isinstance(v, torch.Tensor)}
    return split_packed_qkv(sd)


def split_net_checkpoint(sd: Dict[str, torch.Tensor]) -> Dict[str, Dict[str, torch.Tensor]]:
    """The reference's trained Stage-2 `net-*.pth`, the state dict of
    Net(reference_unet, denoising_unet, pose_guider, audioproj), split by
    the wrapper's attribute prefixes into per-module dicts (unprefixed
    keys are dropped)."""
    out: Dict[str, Dict[str, torch.Tensor]] = {
        "reference_unet": {}, "denoising_unet": {}, "pose_guider": {}, "audioproj": {}}
    for k, v in sd.items():
        for prefix, d in out.items():
            if k.startswith(prefix + "."):
                d[k[len(prefix) + 1:]] = v
                break
    return out


def _as_shape(key: str, src: torch.Tensor, shape: torch.Size) -> torch.Tensor:
    """A checkpoint tensor in the port's shape: a 1x1 convolution's
    (O, I, 1, 1) feeds a Linear's (O, I) (SD1.5's proj_in / proj_out), and
    any tensor of the same size is reshaped (() <-> (1,)); else raise."""
    if src.shape == shape:
        return src
    if src.ndim == 4 and src.shape[2:] == (1, 1) and src.shape[:2] == shape:
        return src[:, :, 0, 0]
    if src.numel() == int(np.prod(shape)):
        return src.reshape(shape)
    raise ValueError(f"{key}: checkpoint shape {tuple(src.shape)} does not fit {tuple(shape)}")


def load_checkpoint(module: nn.Module, state_dicts: Sequence[Mapping[str, torch.Tensor]],
                    missing_ok: Sequence[str] = (), value_dtype=None) -> Dict[str, List[str]]:
    """Fill `module` in place from checkpoint state dicts by the module's
    own keys (the reference's; `mmgt_tpu.utils.convert.convert`'s rules):

    * later dicts win;
    * a module key absent from every dict raises KeyError unless it
      matches one of the `missing_ok` regexes; such keys keep their
      current values and are listed in report["missing"];
    * checkpoint keys the module does not take are listed in
      report["unexpected"];
    * each tensor is cast to the module's dtype on the module's device,
      through `value_dtype` first when given (an f32 module holding the
      pipeline dtype's values, as the JAX package's bf16 parameters
      computed in f32).

    Nothing is written unless every key is covered. Where the port's keys
    differ from a published file's, the caller adapts the dict:
    `split_net_checkpoint` strips the Net wrapper's prefixes,
    `split_packed_qkv` splits SMGA's packed q/k/v, `fold_weight_norm`
    folds wav2vec2's and WavLM's positional-conv weight norm."""
    merged: Dict[str, torch.Tensor] = {}
    for sd in state_dicts:
        merged.update(sd)
    ok = [re.compile(p) for p in missing_ok]
    target = module.state_dict()
    missing = [k for k in target if k not in merged and any(r.search(k) for r in ok)]
    refused = [k for k in target if k not in merged and k not in missing]
    if refused:
        raise KeyError(f"{len(refused)} params missing from checkpoint and not covered by "
                       f"missing_ok, e.g. {refused[:5]}")
    srcs = {k: _as_shape(k, merged[k], t.shape) for k, t in target.items() if k in merged}
    with torch.no_grad():
        for k, src in srcs.items():
            target[k].copy_(src if value_dtype is None else src.to(value_dtype))
    return {"missing": missing, "unexpected": [k for k in merged if k not in target]}


def load_dwpose_weights(onnx_path: str, module: nn.Module) -> Dict[str, List[str]]:
    """Fill a `models.dwpose` YOLOXL / RTMPose in place from a DWPose .onnx
    file (`mmgt_tpu.utils.convert.load_dwpose_weights`): the initializers,
    read by the port's protobuf wire parser (`utils/onnx_reader.py`), with
    the exporters' `model.` / `module.` prefixes stripped, load by the
    module's own (mmdet / mmpose) keys under `load_checkpoint`'s strict
    rules. Returns the report (KeyError when a module key is absent)."""
    inits, _nodes = load_onnx(onnx_path)
    sd = {re.sub(r"^(model|module)\.", "", k): torch.from_numpy(np.ascontiguousarray(v))
          for k, v in inits.items()}
    return load_checkpoint(module, [sd])
