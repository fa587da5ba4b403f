"""A directory of reference checkpoints into the port's models
(`mmgt_tpu/utils/weights.py`), by the files' own key names.

Expected layout (the reference's pretrained_weights/):
  stable-diffusion-v1-5/unet/diffusion_pytorch_model.(bin|safetensors)
  sd-vae-ft-mse/diffusion_pytorch_model.(bin|safetensors)
  image_encoder/model.* or image_encoder/pytorch_model.*   (CLIP ViT-L/14)
  wav2vec2-base-960h/pytorch_model.bin
  wavlm/WavLM-Large.pt
  denoising_unet-*.pth / reference_unet-*.pth / pose_guider-*.pth
  net-*.pth                                    (the trained Net wrapper)
  mm_sd_v15_v2.ckpt                            (AnimateDiff motion modules)
  smga*.pt / a2p*.pt / train-*.pt              (Stage 1)

As in the JAX package, a model whose checkpoint is absent, unreadable or
does not cover it gets seeded random weights (`init_random_params`) with
a warning on stderr, so the pipelines run end to end either way. The
Stage-2 models load in place on the pipeline's device in its dtype; CLIP
takes the pipeline dtype; wav2vec2 and WavLM stay f32 modules holding the
pipeline dtype's values (the JAX package casts their parameters to the
pipeline dtype and computes in f32); the SMGA decoder stays f32.
"""
from __future__ import annotations

import pickle
import sys
import zipfile
from pathlib import Path
from typing import Any, Dict, Optional, Sequence, Union

import torch
from torch import nn

from mmgt_tpu_torch.data.audio import AudioProcessor, WavLMFeatureExtractor
from mmgt_tpu_torch.device import resolve_device
from mmgt_tpu_torch.models.clip_vision import CLIPVisionModel
from mmgt_tpu_torch.models.wav2vec2 import Wav2Vec2Model
from mmgt_tpu_torch.models.wavlm import WavLMModel
from mmgt_tpu_torch.pipelines.pose2vid import init_random_params, materialize
from mmgt_tpu_torch.training.stage1 import SMGA
from mmgt_tpu_torch.utils import convert as cv

# Allowed-missing keys, the JAX package's patterns (`weights.py:139,153-154`)
# in the port's key names. The trained ReferenceNet has no output head
# (`^(params/)?conv_(norm_)?out`). A bare SD1.5 UNet has no audio or motion
# modules: `_(audio|motion)_` and `zero_conv` name the down and up blocks'
# ones; `^mid_(audio|motion)` never matches the JAX package's
# "params/"-prefixed keys, so the mid block's motion module is not allowed
# missing there, nor here (`audio_cross` and `motion_pe` match no key).
REFERENCE_UNET_MISSING_OK = (r"^conv_(norm_)?out\.",)
DENOISING_UNET_MISSING_OK = (r"^(down|up)_blocks\.\d+\.(audio|motion)_modules\.", r"zero_conv")

# what a file that cannot be read raises
_READ_ERRORS = (OSError, RuntimeError, ValueError, KeyError, EOFError, pickle.UnpicklingError,
                zipfile.BadZipFile)


def _find(root: Path, *patterns) -> Optional[Path]:
    for pat in patterns:
        hits = sorted(root.glob(pat))
        if hits:
            return hits[-1]
    return None


def _warn(msg: str) -> None:
    print(f"[weights] {msg}", file=sys.stderr)


class _Loader:
    """Loads one model at a time, or random-fills it, and keeps the record."""

    def __init__(self):
        self.random_fill, self.reports = [], {}

    def fill(self, name: str, model: nn.Module) -> None:
        dev = next(model.parameters()).device
        init_random_params(model, torch.Generator(device=dev).manual_seed(0))
        self.random_fill.append(name)

    def load(self, name: str, model: nn.Module, sources: Sequence[Any],
             missing_ok: Sequence[str] = (), value_dtype=None) -> None:
        sds = []
        for src in sources:
            if isinstance(src, dict):  # an already split state dict
                if src:
                    sds.append(src)
            elif src is not None:
                try:
                    sds.append(cv.load_torch_state_dict(str(src)))
                except _READ_ERRORS as e:
                    _warn(f"{name}: failed to read {src}: {e}")
        if not sds:
            _warn(f"{name}: no checkpoint found, using random fill")
            return self.fill(name, model)
        try:
            report = cv.load_checkpoint(model, sds, missing_ok, value_dtype)
        except KeyError as e:
            # a partly matching checkpoint would silently break the model
            _warn(f"{name}: checkpoint does not cover the model, using random fill ({e})")
            return self.fill(name, model)
        if report["missing"]:
            _warn(f"{name}: {len(report['missing'])} allowed-missing params keep their values")
        model.eval().requires_grad_(False)
        self.reports[name] = report


def load_all_weights(weights_dir: str, pipe, smga: SMGA,
                     device: Optional[Union[str, torch.device]] = None) -> Dict[str, Any]:
    """Load every model of a reference-style weights directory: the
    Stage-2 models of `pipe` (a `Pose2VideoPipeline`) and `smga.model` in
    place; CLIP, wav2vec2 and WavLM are built on `device` (the card unless
    the caller asks for the CPU) where their files exist.

    Returns {"smga": the loaded SMGA (a new one, of the other feature
    type, when the checkpoint is of that width), "smga_feature_type",
    "clip_model" / "audio_processor" / "wavlm" for the encoder files
    found, "random_fill": the names of the models that got random
    weights, "reports": each loaded model's missing and unexpected keys}.
    """
    dev = resolve_device(device)
    root = Path(weights_dir)
    dt = pipe.dtype
    loader = _Loader()
    out: Dict[str, Any] = {}

    net_ckpt = _find(root, "net-*.pth", "modules/net-*.pth")
    net_parts: Dict[str, Dict[str, torch.Tensor]] = {}
    if net_ckpt is not None:
        try:
            net_parts = cv.split_net_checkpoint(cv.load_torch_state_dict(str(net_ckpt)))
        except _READ_ERRORS as e:
            _warn(f"net ckpt: failed to read {net_ckpt}: {e}")
    sd15 = _find(root, "stable-diffusion-v1-5/unet/diffusion_pytorch_model.*")

    loader.load("vae", pipe.vae, [_find(root, "sd-vae-ft-mse/diffusion_pytorch_model.*")])
    loader.load("reference_unet", pipe.reference_unet,
                [sd15, _find(root, "reference_unet-*.pth"), net_parts.get("reference_unet")],
                REFERENCE_UNET_MISSING_OK)
    loader.load("denoising_unet", pipe.denoising_unet,
                [sd15, _find(root, "mm_sd_v15_v2.ckpt"), _find(root, "denoising_unet-*.pth"),
                 net_parts.get("denoising_unet")], DENOISING_UNET_MISSING_OK)
    loader.load("pose_guider", pipe.pose_guider,
                [_find(root, "pose_guider-*.pth"), net_parts.get("pose_guider")])
    if pipe.audio_proj is not None:
        loader.load("audio_proj", pipe.audio_proj,
                    [_find(root, "audio_proj*.pth"), net_parts.get("audioproj")])

    out["smga"], out["smga_feature_type"] = smga, smga.feature_type
    smga_ckpt = _find(root, "smga*.pt*", "a2p*.pt*", "train-*.pt")
    if smga_ckpt is None:
        _warn("smga: no checkpoint found, using random fill")
        loader.fill("smga", smga.model)
    else:
        try:
            sd = cv.load_smga_state_dict(str(smga_ckpt))
        except _READ_ERRORS as e:
            _warn(f"smga: failed to read {smga_ckpt}: {e}; random fill")
            sd = None
        if sd is None:
            loader.fill("smga", smga.model)
        else:
            out["smga"], out["smga_feature_type"] = _load_smga(loader, smga, sd, smga_ckpt)

    clip_ckpt = _find(root, "image_encoder/model.*", "image_encoder/pytorch_model.*")
    if clip_ckpt is not None:
        with torch.device("meta"):
            clip = CLIPVisionModel()
        clip = materialize({"clip": clip}, dev, dt)["clip"]
        loader.load("clip", clip, [clip_ckpt])
        out["clip_model"] = clip.eval()
    w2v_ckpt = _find(root, "wav2vec2-base-960h/pytorch_model.bin", "wav2vec/*/pytorch_model.bin")
    if w2v_ckpt is not None:
        with torch.device("meta"):
            w2v = Wav2Vec2Model()
        w2v = materialize({"w2v": w2v}, dev, torch.float32)["w2v"]
        loader.load("wav2vec2", w2v, [w2v_ckpt], value_dtype=dt)
        out["audio_processor"] = AudioProcessor(w2v.eval())
    wavlm_ckpt = _find(root, "wavlm/WavLM-Large.pt", "WavLM-Large.pt")
    if wavlm_ckpt is not None:
        with torch.device("meta"):
            wavlm = WavLMModel()
        wavlm = materialize({"wavlm": wavlm}, dev, torch.float32)["wavlm"]
        loader.load("wavlm", wavlm, [wavlm_ckpt], value_dtype=dt)
        out["wavlm"] = WavLMFeatureExtractor(wavlm.eval())
    out["random_fill"], out["reports"] = loader.random_fill, loader.reports
    return out


def _load_smga(loader: _Loader, smga: SMGA, sd, path):
    """The SMGA decoder from its state dict; a checkpoint of the other
    feature width (WavLM 1059 against baseline 35) loads into a new SMGA
    of that type, as the JAX package retries."""
    try:
        loader.reports["smga"] = cv.load_checkpoint(smga.model, [sd])
        _warn(f"smga: loaded {path}")
        return smga, smga.feature_type
    except (KeyError, ValueError) as e:
        first = e
    other = "baseline" if smga.feature_type == "wavlm" else "wavlm"
    with torch.device("meta"):
        alt = SMGA(feature_type=other, guidance_weight=smga.guidance_weight,
                   horizon=smga.horizon)
    alt.model.to_empty(device=smga.device)
    try:
        loader.reports["smga"] = cv.load_checkpoint(alt.model, [sd])
    except (KeyError, ValueError):
        _warn(f"smga: failed to convert {path}: {first}; random fill")
        loader.fill("smga", smga.model)
        return smga, smga.feature_type
    alt.model.eval().requires_grad_(False)
    _warn(f"smga: loaded {path} as feature_type={other} (caller asked for "
          f"{smga.feature_type})")
    return alt, other
