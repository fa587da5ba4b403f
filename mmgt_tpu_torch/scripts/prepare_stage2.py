"""Stage-2 dataset preparation: the port's counterpart of
`tools/prepare_stage2.py` (replacing the reference's tool/ meta builders
and its decord reads at train time, tool/extract_meta_info_stage2_move_mask.py,
src/dataset/talk_video.py): raw clips -> packed .npz training records +
meta.json. Every mp4 is decoded once here; training reads dense arrays.

    python -m mmgt_tpu_torch.scripts.prepare_stage2 --src SRC --out OUT \\
        [--size 512] [--from_keypoints] [--device cuda]

Inputs per clip (the reference preprocessing's layout):
  videos/{name}.mp4          target video
  dwpose/{name}.mp4          pose skeleton video
  face/{name}.mp4 lips/{name}.mp4 [hands/{name}.mp4]   mask videos
  audio_emb/{name}.npy       (T, 12, 768) wav2vec embeddings
Or, with --from_keypoints: keypoints/{name}.npy (T, 402), rasterized here
on the card (`data/conditioning.prepare_conditioning_from_keypoints`).
The 64^2 attention masks are blurred and normalised on the card
(`data/conditioning._blur_norm`).

Output: OUT/records/{name}.npz + OUT/meta.json listing them. A clip whose
input files are missing or unreadable is skipped with a message; any
other error (from torch or CUDA among them) stops the run.
"""
from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path
from typing import List

import numpy as np
import torch

from mmgt_tpu_torch.data.conditioning import _blur_norm, prepare_conditioning_from_keypoints
from mmgt_tpu_torch.device import resolve_device
from mmgt_tpu_torch.utils.media import read_frames

# what a missing or unreadable input raises (np.load, cv2 through
# utils/media.read_frames)
_INPUT_ERRORS = (FileNotFoundError, ValueError, OSError, EOFError)


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--from_keypoints", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def mask64(frames_gray, ksize: int, base: int, device) -> np.ndarray:
    """(T, H, W) masks in [0, 1] -> (T, base, base) uint8, blurred and
    per-frame min-max normalised on `device`."""
    x = torch.as_tensor(frames_gray, dtype=torch.float32, device=device)
    return (_blur_norm(x, ksize, base) * 255).cpu().numpy().astype(np.uint8)


def _resize_all(frames: np.ndarray, size: int) -> np.ndarray:
    import cv2

    return np.stack([cv2.resize(f, (size, size)) for f in frames])


def _read_inputs(src: Path, name: str, size: int, from_keypoints: bool) -> dict:
    """One clip's host inputs, decoded and resized. Raises one of
    _INPUT_ERRORS when a file is missing or unreadable."""
    frames = read_frames(src / "videos" / f"{name}.mp4")
    t = len(frames)
    got = dict(frames=_resize_all(frames, size),
               audio_emb=np.load(src / "audio_emb" / f"{name}.npy")[:t].astype(np.float16))
    if from_keypoints:
        got["keypoints"] = np.load(src / "keypoints" / f"{name}.npy")[:t]
        return got
    got["pose"] = _resize_all(read_frames(src / "dwpose" / f"{name}.mp4", t), size)
    for part in ("face", "lips"):
        got[part] = read_frames(src / part / f"{name}.mp4", t).mean(-1) / 255.0
    hands_p = src / "hands" / f"{name}.mp4"
    got["hands"] = read_frames(hands_p, t).mean(-1) / 255.0 if hands_p.exists() else None
    return got


def _record(inputs: dict, size: int, device) -> dict:
    """One clip's record arrays from its host inputs; the rasterizer and
    the mask blur run on `device`."""
    base = size // 8
    if "keypoints" in inputs:
        cond = prepare_conditioning_from_keypoints(
            torch.as_tensor(inputs["keypoints"], device=device), size, size)
        pose = (cond["pose_video"][0].cpu().numpy() * 255).astype(np.uint8)
        masks = cond["mask_videos"]
    else:
        pose, masks = inputs["pose"], inputs
    face = mask64(masks["face"], 31, base, device)
    lips = mask64(masks["lips"], 21, base, device)
    hands = (mask64(masks["hands"], 21, base, device) if masks["hands"] is not None
             else np.zeros_like(face))
    return dict(frames=inputs["frames"], pose=pose, face_mask=face, lips_mask=lips,
                hands_mask=hands, audio_emb=inputs["audio_emb"])


def run(src: str, out: str, size: int = 512, from_keypoints: bool = False,
        device=None) -> List[dict]:
    """Pack every `src/videos/*.mp4` into `out/records/{name}.npz` and list
    them in `out/meta.json`, the masks (and with `from_keypoints` the pose
    video) computed on `device` (the card unless the caller asks for the
    CPU). Returns the meta entries."""
    dev = resolve_device(device)
    src, out = Path(src), Path(out)
    (out / "records").mkdir(parents=True, exist_ok=True)
    records = []
    for vid in sorted((src / "videos").glob("*.mp4")):
        name = vid.stem
        try:
            inputs = _read_inputs(src, name, size, from_keypoints)
        except _INPUT_ERRORS as e:
            print(f"[skip] {name}: {type(e).__name__}: {e}", file=sys.stderr)
            continue
        arrays = _record(inputs, size, dev)
        rec = out / "records" / f"{name}.npz"
        np.savez_compressed(rec, **arrays)
        records.append({"record": str(rec)})
        print(f"{name}: {len(arrays['frames'])} frames -> {rec}")
    meta = out / "meta.json"
    meta.write_text(json.dumps(records, indent=1))
    print(f"wrote {meta} ({len(records)} records)")
    return records


def main(argv=None) -> int:
    args = parse_args(argv)
    run(args.src, args.out, args.size, args.from_keypoints, args.device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
