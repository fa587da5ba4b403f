"""Certify a reference-style weights directory against the port's modules:
the counterpart of `scripts/verify_weights.py`.

The reference loads its published checkpoints directly
(scripts/audio2vid.py:193-272: SD1.5 unet, sd-vae-ft-mse, image_encoder
CLIP, net-*.pth Net-wrapper ckpt, pose_guider/denoising/reference .pth,
wav2vec2, WavLM-Large.pt, SMGA ckpt; src/dwpose/wholebody.py:14-27:
yolox_l.onnx + dw-ll_ucoco_384.onnx; audio-separator: Kim_Vocal_2.onnx).
This CLI loads each file it finds STRICTLY into the full-size port module,
built on the meta device (shapes only, no memory; the port's
`jax.eval_shape`), and reports per file the key and shape coverage; the
separator entry lists the graph's ops that the port's `OnnxRunner` lacks.
With --forward it loads the modules for real on --device (the card unless
--device cpu; the Stage-2 models and CLIP in bf16, the rest in f32) and
runs each net once on a small input.

    python -m mmgt_tpu_torch.scripts.verify_weights /path/to/pretrained_weights \\
        [--forward] [--json report.json] [--device cuda] [--tiny]

`--tiny` holds the Stage-2 models and the SMGA decoder to the tiny widths
of `tiny_models` instead (the drills of `mmgt_tpu_torch.tools.synth_weights
--tiny` and `release_check --tiny`); every other entry keeps its full size.

Exit code 0 = every artifact that was found converted cleanly (and, with
--forward, ran to finite outputs).
"""
from __future__ import annotations

import argparse
import json
import sys
import traceback
from pathlib import Path
from typing import Callable, Dict, List, Optional

import numpy as np
import torch
from torch import nn

from mmgt_tpu_torch.utils import convert as cv
from mmgt_tpu_torch.utils.weights import (DENOISING_UNET_MISSING_OK,
                                          REFERENCE_UNET_MISSING_OK, _find)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("weights_dir")
    ap.add_argument("--forward", action="store_true",
                    help="also load each net on --device and run it once (small inputs)")
    ap.add_argument("--json", default=None, help="write the report as JSON")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny Stage-2 and SMGA widths (drills on synthetic weights)")
    return ap.parse_args(argv)


# the Stage-2 models and CLIP in the pipelines' dtype, the rest in f32, as
# `utils.weights.load_all_weights` and the DWPose / SMGA entry points hold them
_BF16 = ("vae", "reference_unet", "denoising_unet", "pose_guider", "audio_proj", "clip_vision")


def tiny_models() -> Dict[str, Callable[..., nn.Module]]:
    """The tiny widths of the drills: the Stage-2 models of the JAX
    training CLIs' --tiny (UNets (16, 32, 32, 32) with 4 heads) and a
    one-layer SMGA decoder, `smga(cond_dim)`."""
    from mmgt_tpu_torch.models.audio_proj import AudioProjModel
    from mmgt_tpu_torch.models.pose_guider import PoseGuider
    from mmgt_tpu_torch.models.smga import GestureDecoder
    from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D
    from mmgt_tpu_torch.models.unet_ref import ReferenceUNet2D
    from mmgt_tpu_torch.models.vae import AutoencoderKL

    unet = dict(block_out_channels=(16, 32, 32, 32), heads=4)
    return {"vae": lambda: AutoencoderKL((16, 16, 32, 32)),
            "reference_unet": lambda: ReferenceUNet2D(**unet),
            "denoising_unet": lambda: DenoisingUNet3D(**unet),
            "pose_guider": lambda: PoseGuider(16, (4, 8, 8, 16)),
            "audio_proj": lambda: AudioProjModel(intermediate_dim=32),
            "smga": lambda cond_dim: GestureDecoder(latent_dim=64, ff_size=64, num_layers=1,
                                                    num_heads=4, cond_feature_dim=cond_dim)}


def _models(tiny: bool = False) -> Dict[str, Callable[[], nn.Module]]:
    """Each entry's full-size module (the Stage-2 ones at `tiny_models`'
    widths when `tiny`), built wherever the caller's device context puts
    it."""
    from mmgt_tpu_torch.models.audio_proj import AudioProjModel
    from mmgt_tpu_torch.models.clip_vision import CLIPVisionModel
    from mmgt_tpu_torch.models.dwpose import RTMPose, YOLOXL
    from mmgt_tpu_torch.models.pose_guider import PoseGuider
    from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D
    from mmgt_tpu_torch.models.unet_ref import ReferenceUNet2D
    from mmgt_tpu_torch.models.vae import AutoencoderKL
    from mmgt_tpu_torch.models.wav2vec2 import Wav2Vec2Model
    from mmgt_tpu_torch.models.wavlm import WavLMModel

    models = {"vae": AutoencoderKL, "reference_unet": ReferenceUNet2D,
              "denoising_unet": DenoisingUNet3D, "pose_guider": PoseGuider,
              "audio_proj": AudioProjModel, "clip_vision": CLIPVisionModel,
              "wav2vec2": Wav2Vec2Model, "wavlm": WavLMModel, "dwpose_yolox": YOLOXL,
              "dwpose_rtmpose": RTMPose}
    if tiny:
        models.update({k: f for k, f in tiny_models().items() if k in models})
    return models


class Verifier:
    """Runs each entry's loader strictly and keeps the report; `device` is
    where the modules live: meta (shapes only) or, for --forward, a real
    device."""

    def __init__(self, device: torch.device, tiny: bool = False):
        self.device, self.tiny = device, tiny
        self.report: Dict[str, dict] = {}
        self.failed: List[str] = []
        self.loaded: Dict[str, nn.Module] = {}

    def build(self, name: str) -> nn.Module:
        with torch.device("meta"):
            model = _models(self.tiny)[name]()
        if self.device.type != "meta":
            model.to_empty(device=self.device)
            model.to(torch.bfloat16 if name in _BF16 else torch.float32)
        return model.eval().requires_grad_(False)

    def record(self, name: str, path: Optional[Path], fn) -> None:
        """Run one loader strictly; record coverage or the error."""
        entry = {"file": str(path) if path else None}
        self.report[name] = entry
        if path is None:
            entry["status"] = "absent"
            print(f"[absent ] {name}")
            return
        try:
            model, rep, extra = fn(path)
        except Exception as e:  # noqa: BLE001 - report every file, don't stop at one
            entry["status"] = "failed"
            entry["error"] = f"{type(e).__name__}: {e}"
            self.failed.append(name)
            print(f"[FAILED ] {name}: {entry['error']}")
            traceback.print_exc(limit=3)
            return
        n = len(model.state_dict()) if isinstance(model, nn.Module) else len(model)
        entry.update(status="ok", n_params=n,
                     n_allowed_missing=len(rep.get("missing", [])),
                     n_unexpected=len(rep.get("unexpected", [])), **extra)
        print(f"[ok     ] {name}: {n} params covered, {entry['n_allowed_missing']} "
              f"allowed-missing, {entry['n_unexpected']} ckpt keys unused")
        if isinstance(model, nn.Module):
            self.loaded[name] = model

    def load(self, name: str, sources, missing_ok=()):
        sds = [s if isinstance(s, dict) else cv.load_torch_state_dict(str(s))
               for s in sources if s is not None]
        sds = [s for s in sds if s]
        if not sds:
            raise FileNotFoundError("no loadable state dict")
        model = self.build(name)
        return model, cv.load_checkpoint(model, sds, missing_ok), {}


def verify(weights_dir: str, device: Optional[torch.device] = None, tiny: bool = False):
    """The report of every file found under `weights_dir`, loaded into
    modules on `device` (meta when None; the Stage-2 models and SMGA at
    `tiny_models`' widths when `tiny`), and the names that failed.
    Returns (report, failed, loaded modules)."""
    from mmgt_tpu_torch.training.stage1 import SMGA
    from mmgt_tpu_torch.utils.onnx_exec import unsupported_ops
    from mmgt_tpu_torch.utils.onnx_reader import parse_onnx_model

    root = Path(weights_dir)
    v = Verifier(device or torch.device("meta"), tiny)

    net_ckpt = _find(root, "net-*.pth", "modules/net-*.pth", "audio_ckpt/modules/net-*.pth")
    net_parts: Dict[str, dict] = {}
    if net_ckpt is not None:
        try:
            net_parts = cv.split_net_checkpoint(cv.load_torch_state_dict(str(net_ckpt)))
            sizes = {k: len(p) for k, p in net_parts.items()}
            v.report["net_ckpt"] = {"file": str(net_ckpt), "status": "ok", "split_sizes": sizes}
            print(f"[ok     ] net ckpt split: {sizes}")
        except Exception as e:  # noqa: BLE001
            v.report["net_ckpt"] = {"file": str(net_ckpt), "status": "failed", "error": str(e)}
            v.failed.append("net_ckpt")

    vae = _find(root, "sd-vae-ft-mse/diffusion_pytorch_model.*")
    v.record("vae", vae, lambda p: v.load("vae", [p]))
    sd15 = _find(root, "stable-diffusion-v1-5/unet/diffusion_pytorch_model.*")
    ref = _find(root, "reference_unet-*.pth")
    v.record("reference_unet", sd15 or ref or net_ckpt, lambda _: v.load(
        "reference_unet", [sd15, ref, net_parts.get("reference_unet")],
        REFERENCE_UNET_MISSING_OK))
    den = _find(root, "denoising_unet-*.pth")
    v.record("denoising_unet", sd15 or den or net_ckpt, lambda _: v.load(
        "denoising_unet", [sd15, _find(root, "mm_sd_v15_v2.ckpt"), den,
                           net_parts.get("denoising_unet")], DENOISING_UNET_MISSING_OK))
    guider = _find(root, "pose_guider-*.pth")
    v.record("pose_guider", guider or net_ckpt, lambda _: v.load(
        "pose_guider", [guider, net_parts.get("pose_guider")]))
    proj = _find(root, "audio_proj*.pth")
    v.record("audio_proj", proj or net_ckpt, lambda _: v.load(
        "audio_proj", [proj, net_parts.get("audioproj")]))

    v.record("clip_vision", _find(root, "image_encoder/model.*", "image_encoder/pytorch_model.*"),
             lambda p: v.load("clip_vision", [p]))
    v.record("wav2vec2", _find(root, "wav2vec2-base-960h/pytorch_model.bin",
                               "wav2vec/*/pytorch_model.bin"),
             lambda p: v.load("wav2vec2", [p]))
    v.record("wavlm", _find(root, "wavlm/WavLM-Large.pt", "WavLM-Large.pt"),
             lambda p: v.load("wavlm", [p]))

    def smga_fn(p):
        # the checkpoint's condition width gives its feature type: 1059 =
        # wavlm (1024 + 35), 35 = baseline DSP (reference SMGA.py:66)
        sd = cv.load_smga_state_dict(str(p), ema=True)
        errs = []
        for ft in ("wavlm", "baseline"):
            with torch.device("meta"):
                smga = SMGA(feature_type=ft)
                if tiny:
                    smga.model = tiny_models()["smga"](smga.cond_dim)
            model = smga.model
            if v.device.type != "meta":
                model.to_empty(device=v.device)
            try:
                rep = cv.load_checkpoint(model, [sd])
            except (KeyError, ValueError) as e:
                errs.append(f"{ft}: {e}")
                continue
            return model.eval().requires_grad_(False), rep, {"feature_type": ft}
        raise KeyError("; ".join(errs)[:400])

    v.record("smga", _find(root, "smga*.pt*", "a2p*.pt*", "train-*.pt"), smga_fn)

    def dwpose_fn(name, p):
        model = v.build(name)
        return model, cv.load_dwpose_weights(str(p), model), {}

    v.record("dwpose_yolox", _find(root, "DWPose/yolox_l.onnx", "yolox_l.onnx"),
             lambda p: dwpose_fn("dwpose_yolox", p))
    v.record("dwpose_rtmpose", _find(root, "DWPose/dw-ll_ucoco_384.onnx", "dw-ll_ucoco_384.onnx"),
             lambda p: dwpose_fn("dwpose_rtmpose", p))

    def separator_fn(p):
        """Parse the MDX graph and check every node op is executable."""
        inits, nodes, _, _ = parse_onnx_model(Path(p).read_bytes())
        missing = unsupported_ops(nodes)
        if missing:
            raise NotImplementedError(f"graph uses unsupported ops: {missing}")
        return inits, {"missing": [], "unexpected": []}, {
            "n_nodes": len(nodes), "ops_used": sorted({n["op_type"] for n in nodes})}

    v.record("separator_mdx", _find(root, "Kim_Vocal_2.onnx", "*/Kim_Vocal_2.onnx",
                                    "audio_separator/*.onnx"), separator_fn)
    return v.report, v.failed, v.loaded


@torch.no_grad()
def forward_all(loaded: Dict[str, nn.Module], separator: Optional[str], device) -> Dict[str, tuple]:
    """Run each loaded net once on a small input (zeros in the net's dtype)
    on `device`; returns {name: output shapes}; raises if an output is not
    finite."""
    dt = torch.bfloat16
    z = lambda *s: torch.zeros(*s, device=device)  # noqa: E731
    zb = lambda *s: torch.zeros(*s, device=device, dtype=dt)  # noqa: E731
    t0 = torch.zeros((1,), dtype=torch.long, device=device)
    ctx = zb(1, 1, 768)
    runs = {
        "vae": lambda m: m.decode(zb(1, 8, 8, 4)),
        "pose_guider": lambda m: m(zb(1, 2, 64, 64, 3)),
        "audio_proj": lambda m: m(zb(1, 2, 5, 12, 768)),
        "clip_vision": lambda m: m(zb(1, 224, 224, 3)),
        "wav2vec2": lambda m: m(z(1, 16000), 25),
        "wavlm": lambda m: m(z(1, 16000)),
        "smga": lambda m: m(z(1, 80, 402), z(1, 402), z(1, 80, m.cond_projection.in_features),
                            t0),
        "dwpose_yolox": lambda m: m(z(1, 3, 640, 640)),
        "dwpose_rtmpose": lambda m: m(z(1, 3, 384, 288)),
    }
    shapes = {}

    def check(name, out):
        outs = out if isinstance(out, (tuple, list)) else [out]
        for o in outs:
            if isinstance(o, torch.Tensor) and not bool(torch.isfinite(o).all()):
                raise FloatingPointError(f"{name}: output not finite")
        shapes[name] = tuple(tuple(o.shape) for o in outs if isinstance(o, torch.Tensor))
        print(f"{name} forward: ok {shapes[name]}")

    for name, model in loaded.items():
        if name in runs:
            check(name, runs[name](model))
    if "reference_unet" in loaded:
        out, banks = loaded["reference_unet"](zb(1, 8, 8, 4), t0, ctx)
        check("reference_unet", [out] + list(banks))
        if "denoising_unet" in loaded:
            masks = [tuple(zb(1, 2, (8 >> lv) ** 2) + 1 for _ in range(3)) for lv in range(3)]
            den = loaded["denoising_unet"]
            check("denoising_unet", den(
                zb(1, 2, 8, 8, 4), t0, ctx, zb(1, 2, 32, 768),
                zb(1, 2, 8, 8, den.block_out_channels[0]), masks, banks=banks))
    if separator is not None:
        from mmgt_tpu_torch.utils.onnx_exec import OnnxRunner

        runner = OnnxRunner.from_file(separator, device)
        check("separator_mdx", list(runner(np.zeros((1, 4, 3072, 256), np.float32)).values()))
    return shapes


def main(argv=None) -> int:
    args = parse_args(argv)
    from mmgt_tpu_torch.device import disable_tf32, resolve_device

    device = resolve_device(args.device)
    disable_tf32()
    report, failed, loaded = verify(args.weights_dir, device if args.forward else None,
                                    args.tiny)
    if args.forward and not failed:
        print("forwarding the loaded nets...")
        sep = report.get("separator_mdx", {})
        try:
            report["forward"] = forward_all(
                loaded, sep.get("file") if sep.get("status") == "ok" else None, device)
        except Exception as e:  # noqa: BLE001 - a net that does not run fails the check
            report["forward"] = {"status": "failed", "error": f"{type(e).__name__}: {e}"}
            failed.append("forward")
            print(f"[FAILED ] forward: {type(e).__name__}: {e}")
            traceback.print_exc(limit=3)
    if args.json:
        Path(args.json).write_text(json.dumps(report, indent=2, default=str))
        print(f"wrote {args.json}")
    entries = [e for k, e in report.items() if k != "forward"]
    n_ok = sum(1 for e in entries if e.get("status") == "ok")
    n_abs = sum(1 for e in entries if e.get("status") == "absent")
    print(f"== {n_ok} ok / {n_abs} absent / {len(failed)} failed ==")
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main())
