"""A reference-layout weights directory of seeded random values: the port's
counterpart of `tools/synth_weights.py`, the drill of the converters and
loaders for the day real checkpoints arrive.

The JAX tool builds the reference's own UNet2DConditionModel and
UNet3DConditionModel through `tests/diffusers_stub`, which needs the
reference checkout, and HF transformers' wav2vec2. This one writes from
the port's own full-width modules, whose state-dict keys are the
reference's, in the layout the reference's inference reads
(scripts/audio2vid.py:193-272):

  net-1000.pth                              the Net wrapper of train_stage_2.py:
                                            reference_unet., denoising_unet.,
                                            pose_guider., audioproj. prefixes
  sd-vae-ft-mse/diffusion_pytorch_model.bin
  image_encoder/pytorch_model.bin           CLIP ViT-L/14
  wav2vec2-base-960h/pytorch_model.bin      the positional conv as
                                            weight_norm(dim=2) g and v (HF)
  wavlm/WavLM-Large.pt                      {"model", "cfg"}, the positional
                                            conv likewise
  smga.pt                                   {"ema_state_dict", "model_state_dict",
                                            "normalizer"}: `module.`-prefixed,
                                            q/k/v packed as nn.MultiheadAttention's
                                            in_proj

Every tensor is fp16, as in the published checkpoints; the values come
from `init_random_params` (seeded), so `load_all_weights` and
`verify_weights` see full-size shapes. The free space is checked before
anything is written. `--tiny` writes the Stage-2 models and the SMGA
decoder at `verify_weights.tiny_models`' widths and no encoder file (the
loaders build the encoders at full size).

    python -m mmgt_tpu_torch.tools.synth_weights OUT_DIR [--seed 0] [--device cuda] [--tiny]
"""
from __future__ import annotations

import argparse
import os
import re
import shutil
import sys
import time
from typing import Dict, Tuple

import torch

STAGE2_FILE = "net-1000.pth"
# the Net wrapper's prefix of each Stage-2 model (train_stage_2.py)
NET_PREFIX = {"reference_unet": "reference_unet", "denoising_unet": "denoising_unet",
              "pose_guider": "pose_guider", "audio_proj": "audioproj"}


def pack_qkv(sd: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The reference GestureDecoder's layout: each attention's q/k/v packed
    into nn.MultiheadAttention's in_proj_weight / in_proj_bias."""
    out = dict(sd)
    for k in list(sd):
        m = re.match(r"(.*)\.q_proj\.(weight|bias)$", k)
        if m:
            base, kind = m.groups()
            out[f"{base}.in_proj_{kind}"] = torch.cat(
                [out.pop(f"{base}.{p}_proj.{kind}") for p in "qkv"], 0)
    return out


def source_models(device=None, seed: int = 0, tiny: bool = False) -> Dict[str, torch.nn.Module]:
    """The models whose values are written, seeded, on `device` (the card
    unless the caller asks for the CPU): the Stage-2 five and CLIP in
    bf16, wav2vec2, WavLM and the SMGA decoder (WavLM features) in f32."""
    from mmgt_tpu_torch.device import resolve_device
    from mmgt_tpu_torch.models.clip_vision import CLIPVisionModel
    from mmgt_tpu_torch.models.wav2vec2 import Wav2Vec2Model
    from mmgt_tpu_torch.models.wavlm import WavLMModel
    from mmgt_tpu_torch.pipelines.pose2vid import (
        Pose2VideoPipeline,
        init_random_params,
        materialize,
    )
    from mmgt_tpu_torch.scripts.verify_weights import tiny_models
    from mmgt_tpu_torch.training.stage1 import SMGA

    dev, bf16, f32 = resolve_device(device), torch.bfloat16, torch.float32
    if tiny:
        shapes = tiny_models()
        with torch.device("meta"):
            stage2 = {n: shapes[n]() for n in Pose2VideoPipeline.MODEL_NAMES}
        pipe = Pose2VideoPipeline(**materialize(stage2, dev, bf16))
        pipe.init_params(seed)
    else:
        pipe = Pose2VideoPipeline.build(bf16, device=dev, seed=seed)
    gen = torch.Generator(device=dev).manual_seed(seed + 1)
    with torch.device("meta"):
        smga = SMGA(feature_type="wavlm")
        if tiny:
            smga.model = shapes["smga"](smga.cond_dim)
        enc = {} if tiny else dict(clip=CLIPVisionModel(), wav2vec2=Wav2Vec2Model(),
                                   wavlm=WavLMModel())
    enc = {n: init_random_params(materialize({n: m}, dev, bf16 if n == "clip" else f32)[n], gen)
           for n, m in enc.items()}
    smga.model.to_empty(device=dev)
    init_random_params(smga.model, gen)
    return dict(pipe.models(), smga=smga.model, **enc)


def _weight_norm(sd: Dict[str, torch.Tensor], key: str, expected: Dict[str, torch.Tensor]):
    """HF's and WavLM's weight_norm(dim=2) layout for the positional conv
    `key`, in place; `expected[key]` becomes the weight it folds to."""
    from mmgt_tpu_torch.utils.convert import fold_weight_norm

    base = key[:-len(".weight")]
    w = sd.pop(key)
    g = torch.sqrt((w.float() ** 2).sum((0, 1), keepdim=True)).to(torch.float16)
    sd[base + ".weight_g"], sd[base + ".weight_v"] = g, w
    expected[key] = fold_weight_norm({base + ".weight_g": g, base + ".weight_v": w})[key]
    return sd


def reference_files(written: Dict[str, Dict[str, torch.Tensor]]
                    ) -> Tuple[Dict[str, object], Dict[str, Dict[str, torch.Tensor]]]:
    """The files of the models in `written` (fp16 state dicts by model
    name): {path in the directory: object to save}, and the values each
    model must hold once loaded, before the cast to its dtype (a
    weight-normed conv's folded weight)."""
    expected = {n: dict(sd) for n, sd in written.items()}
    files: Dict[str, object] = {}
    if "denoising_unet" in written:
        files[STAGE2_FILE] = {f"{pre}.{k}": v for n, pre in NET_PREFIX.items()
                              for k, v in written[n].items()}
        files["sd-vae-ft-mse/diffusion_pytorch_model.bin"] = written["vae"]
    if "clip" in written:
        files["image_encoder/pytorch_model.bin"] = written["clip"]
    if "wav2vec2" in written:
        files["wav2vec2-base-960h/pytorch_model.bin"] = _weight_norm(
            dict(written["wav2vec2"]), "encoder.pos_conv_embed.conv.weight", expected["wav2vec2"])
    if "wavlm" in written:
        files["wavlm/WavLM-Large.pt"] = {
            "model": _weight_norm(dict(written["wavlm"]), "encoder.pos_conv.0.weight",
                                  expected["wavlm"]),
            "cfg": argparse.Namespace(encoder_layers=24)}
    if "smga" in written:
        ema = {f"module.{k}": v for k, v in pack_qkv(written["smga"]).items()}
        files["smga.pt"] = {"ema_state_dict": ema,
                            "model_state_dict": {k: torch.zeros_like(v) for k, v in ema.items()},
                            "normalizer": None}
    return files, expected


def _tensor_bytes(obj) -> int:
    if isinstance(obj, dict):
        return sum(_tensor_bytes(v) for v in obj.values())
    return obj.numel() * obj.element_size() if isinstance(obj, torch.Tensor) else 0


def write_files(root: str, files: Dict[str, object]) -> Dict[str, float]:
    """torch.save each file under `root` after checking that its free
    space exceeds the tensors' bytes by 1 GiB; returns the tensors' bytes,
    the bytes on disk and the seconds."""
    need = sum(_tensor_bytes(v) for v in files.values())
    os.makedirs(root, exist_ok=True)
    free = shutil.disk_usage(root).free
    if free <= need + 2**30:
        raise OSError(f"{need} bytes to write, {free} free in {root}")
    t0 = time.perf_counter()
    for rel, obj in files.items():
        path = os.path.join(root, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        torch.save(obj, path)
    return {"tensor_bytes": need, "bytes": sum(os.path.getsize(os.path.join(root, rel))
                                               for rel in files),
            "write_s": time.perf_counter() - t0}


def synth_weights(out_dir: str, device=None, seed: int = 0, tiny: bool = False) -> Dict:
    """Write the directory; returns {"files", "tensor_bytes", "bytes",
    "write_s", "expected"} (`reference_files`' expected values)."""
    half = lambda m: {k: v.detach().to("cpu", torch.float16)  # noqa: E731
                      for k, v in m.state_dict().items()}
    written = {n: half(m) for n, m in source_models(device, seed, tiny).items()}
    files, expected = reference_files(written)
    info = write_files(out_dir, files)
    return dict(info, files=sorted(files), expected=expected)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("out_dir")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny Stage-2 and SMGA widths, no encoder files")
    args = ap.parse_args(argv)
    info = synth_weights(args.out_dir, args.device, args.seed, args.tiny)
    print(f"synthetic weights at {args.out_dir}: {len(info['files'])} files, {info['bytes']} "
          f"bytes, written in {info['write_s']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
