"""Stage-2 inference on the card: a reference image plus pose and mask
videos -> video, the port's counterpart of `scripts/pose2vid.py` (the
same arguments, plus `--device`). Audio conditioning is zeroed, as there.

    python -m mmgt_tpu_torch.scripts.pose2vid --ref_image face.png \\
        --pose_video pose.mp4 --face_mask face.mp4 --lips_mask lips.mp4 \\
        [--hands_mask hands.mp4] --out out.mp4 [--config cfg.yaml] \\
        [--weights_dir pretrained_weights] [--steps 30] [--cfg 3.5] [-L 80] \\
        [--seed 42] [--device cuda]

Without a weights directory (`--weights_dir`, or the config's
`weights_dir`) the models run with seeded random weights. `main` only
reads and writes files (`utils/media.py`, which needs cv2); `build` and
`run` take and return arrays. f32 work runs in full f32, not TF32.
`--device cpu` runs the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import sys
from typing import Optional

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref_image", required=True)
    ap.add_argument("--pose_video", required=True)
    ap.add_argument("--face_mask", required=True)
    ap.add_argument("--lips_mask", required=True)
    ap.add_argument("--hands_mask", default=None)
    ap.add_argument("--out", default="output/pose2vid.mp4")
    ap.add_argument("--config", default=None)
    ap.add_argument("--weights_dir", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--cfg", type=float, default=None)
    ap.add_argument("-L", "--length", type=int, default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def config_from_args(args):
    from mmgt_tpu_torch.config import InferenceConfig, load_config

    overrides = {k: v for k, v in (
        ("num_inference_steps", args.steps), ("guidance_scale", args.cfg),
        ("video_length", args.length), ("weights_dir", args.weights_dir)) if v is not None}
    return load_config(InferenceConfig, args.config, **overrides)


def build(cfg, device=None, seed: int = 42):
    """The Stage-2 pipeline in bf16 on `device` (the card unless the caller
    asks for the CPU): the checkpoints of `cfg.weights_dir` where it names
    one (`load_all_weights`), else seeded random weights."""
    import torch

    from mmgt_tpu_torch.diffusion import make_scheduler
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
    from mmgt_tpu_torch.training.stage1 import SMGA
    from mmgt_tpu_torch.utils.weights import load_all_weights

    pipe = Pose2VideoPipeline.build(
        torch.bfloat16, device, seed, scheduler=make_scheduler(cfg.scheduler),
        context_size=cfg.context_size, context_overlap=cfg.context_overlap,
        window_microbatch=cfg.window_microbatch)
    if cfg.weights_dir:
        with torch.device("meta"):
            smga = SMGA(feature_type=cfg.a2p_feature_type)
        smga.model.to_empty(device=pipe.device)
        load_all_weights(cfg.weights_dir, pipe, smga, pipe.device)
    else:
        print("[warn] random-initialized models", file=sys.stderr)
    return pipe


def run(pipe, ref_image: np.ndarray, pose: np.ndarray, face: np.ndarray, lips: np.ndarray,
        hands: Optional[np.ndarray] = None, cfg=None, seed: int = 42) -> np.ndarray:
    """ref_image (H, W, 3) and pose (T, H, W, 3) in [0, 1]; face, lips and
    hands mask videos (T, H, W) in [0, 1]. Returns (L, H, W, 3) f32 frames
    in [0, 1], L = min(T of each video, cfg.video_length)."""
    import torch

    from mmgt_tpu_torch.config import InferenceConfig
    from mmgt_tpu_torch.data.conditioning import masks_from_videos

    cfg = cfg or InferenceConfig()
    dev = pipe.device
    n = min(len(pose), len(face), len(lips), cfg.video_length)
    if hands is not None:
        n = min(n, len(hands))
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a[:n], np.float32)).to(dev)
    masks = masks_from_videos(as_t(face), as_t(lips), None if hands is None else as_t(hands),
                              base=cfg.height // 8)
    ref = torch.from_numpy(np.asarray(ref_image, np.float32))[None].to(dev) * 2 - 1
    frames = pipe(ref, as_t(pose)[None], torch.zeros((1, 1, 768), device=dev), masks, None,
                  num_inference_steps=cfg.num_inference_steps,
                  guidance_scale=cfg.guidance_scale, motion_scale=cfg.motion_scale,
                  generator=torch.Generator(device=dev).manual_seed(seed))
    return frames[0].float().cpu().numpy()


def main(argv=None) -> int:
    args = parse_args(argv)
    from mmgt_tpu_torch.device import disable_tf32
    from mmgt_tpu_torch.utils.media import load_image, read_frames, save_video

    cfg = config_from_args(args)
    disable_tf32()
    pipe = build(cfg, args.device, args.seed)
    ref = load_image(args.ref_image, cfg.height)
    pose = read_frames(args.pose_video, cfg.video_length).astype(np.float32) / 255.0
    mask = lambda p: read_frames(p, cfg.video_length).mean(-1) / 255.0
    hands = mask(args.hands_mask) if args.hands_mask else None
    frames = run(pipe, ref, pose, mask(args.face_mask), mask(args.lips_mask), hands, cfg,
                 args.seed)
    save_video(frames, args.out, fps=cfg.fps)
    print(f"wrote {args.out}: {frames.shape}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
