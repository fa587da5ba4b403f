"""Stage-1 dataset preparation: the port's counterpart of
`tools/prepare_stage1.py` (replacing the reference's
data/create_dataset.py:10-31 + data/slice.py + data/audio_extraction/*):
(keypoint tracks + wavs) -> aligned 3.2 s clips of keypoints and audio
features.

    python -m mmgt_tpu_torch.scripts.prepare_stage1 --src SRC --out OUT \\
        [--wavlm_ckpt WavLM-Large.pt] [--fps 25] [--device cuda]

Inputs:
  SRC/wavs/{name}.wav
  SRC/keypoints/{name}.npy      (T, 402) absolute coords at --fps
    (from `mmgt_tpu_torch.data.dwpose_infer.DWPoseDetector` or any pose
     tracker emitting the 134-keypoint layout)
Outputs:
  OUT/keypoints/{name}_sN.npy       (80, 402) in [0, 1] of the -200..800
                                    range the SMGA trainer expects
  OUT/baseline_feats/{name}_sN.npy  (80, 35)
  OUT/wavlm_feats/{name}_sN.npy     (80, 1059)  [with --wavlm_ckpt]

The audio is sliced into 3.2 s windows and the keypoints into the
matching 80-frame windows. The baseline features are host DSP (numpy);
with --wavlm_ckpt the port's WavLM Large runs on the card (f32, TF32 off)
from that checkpoint.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from mmgt_tpu_torch.data.audio import (SAMPLE_RATE, WavLMFeatureExtractor, slice_audio,
                                       stage1_condition)
from mmgt_tpu_torch.data.conditioning import KP_MAX, KP_MIN, mask_leg
from mmgt_tpu_torch.data.dsp import load_wav
from mmgt_tpu_torch.device import disable_tf32, resolve_device
from mmgt_tpu_torch.models.wavlm import WavLMModel
from mmgt_tpu_torch.utils.convert import load_checkpoint, load_torch_state_dict


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--wavlm_ckpt", default=None,
                    help="WavLM-Large checkpoint for wavlm features")
    ap.add_argument("--fps", type=int, default=25)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def build(wavlm_ckpt: Optional[str] = None, device=None):
    """The WavLM feature extractor of `wavlm_ckpt` on `device` (the card
    unless the caller asks for the CPU): the port's f32 WavLM Large loaded
    strictly by the checkpoint's own keys; None without a checkpoint."""
    dev = resolve_device(device)
    if wavlm_ckpt is None:
        return None
    with torch.device("meta"):
        model = WavLMModel()
    model.to_empty(device=dev)
    report = load_checkpoint(model, [load_torch_state_dict(wavlm_ckpt)])
    if report["unexpected"]:
        print(f"[warn] wavlm: {len(report['unexpected'])} checkpoint keys unused",
              file=sys.stderr)
    return WavLMFeatureExtractor(model.eval().requires_grad_(False))


def run(src: str, out: str, wavlm_ext=None, fps: int = 25) -> int:
    """Write the aligned clips of every `src/wavs/*.wav` that has a
    keypoint track; returns how many were written."""
    src, out = Path(src), Path(out)
    horizon = int(3.2 * fps)
    for d in ("keypoints", "baseline_feats") + (("wavlm_feats",) if wavlm_ext else ()):
        (out / d).mkdir(parents=True, exist_ok=True)

    n_out = 0
    for wav_path in sorted((src / "wavs").glob("*.wav")):
        name = wav_path.stem
        kp_path = src / "keypoints" / f"{name}.npy"
        if not kp_path.exists():
            print(f"[skip] {name}: no keypoints", file=sys.stderr)
            continue
        wav = load_wav(str(wav_path), SAMPLE_RATE)
        kps = mask_leg(torch.from_numpy(np.load(kp_path).astype(np.float32))).numpy()
        kps01 = (kps - KP_MIN) / (KP_MAX - KP_MIN)  # [0,1]; trainer maps to [-1,1]

        for si, sl in enumerate(slice_audio(wav)):
            k0 = si * horizon
            kp_slice = kps01[k0 : k0 + horizon]
            if len(kp_slice) < horizon:
                break
            feats = stage1_condition(sl, wavlm_ext, "wavlm" if wavlm_ext else "baseline")
            tag = f"{name}_s{si}"
            np.save(out / "keypoints" / f"{tag}.npy", kp_slice)
            if wavlm_ext:
                np.save(out / "wavlm_feats" / f"{tag}.npy", feats)
                np.save(out / "baseline_feats" / f"{tag}.npy", feats[:, 1024:])
            else:
                np.save(out / "baseline_feats" / f"{tag}.npy", feats)
            n_out += 1
    return n_out


def main(argv=None) -> int:
    args = parse_args(argv)
    disable_tf32()
    n_out = run(args.src, args.out, build(args.wavlm_ckpt, args.device), args.fps)
    print(f"wrote {n_out} aligned clips to {args.out}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
