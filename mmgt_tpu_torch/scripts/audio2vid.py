"""Audio + portrait -> video on the card, the port's counterpart of
`scripts/audio2vid.py` (its arguments less `--weights_dir` and `--solver`).

    python -m mmgt_tpu_torch.scripts.audio2vid --ref_image face.png \\
        --audio speech.wav --out out.mp4 [--config cfg.yaml] [--steps 30] \\
        [--cfg 3.5] [--seed 42] [-W 512 -H 512 -L 80] [--use_motion_selection]

The models run with seeded random weights: the port cannot load the
reference's checkpoints yet (a `--config` that names a `weights_dir`
raises), and it samples with DDIM only. f32 work runs in full f32, not
TF32. `--device cpu` runs the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import sys


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref_image", required=True)
    ap.add_argument("--audio", required=True)
    ap.add_argument("--out", default="output/audio2vid.mp4")
    ap.add_argument("--config", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--cfg", type=float, default=None)
    ap.add_argument("-W", "--width", type=int, default=None)
    ap.add_argument("-H", "--height", type=int, default=None)
    ap.add_argument("-L", "--length", type=int, default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--use_motion_selection", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch

    from mmgt_tpu_torch.config import InferenceConfig, load_config
    from mmgt_tpu_torch.data.pose_init import portrait_keypoints
    from mmgt_tpu_torch.device import disable_tf32
    from mmgt_tpu_torch.pipelines.audio2vid import Audio2VideoPipeline
    from mmgt_tpu_torch.utils.media import load_image, save_video

    overrides = {k: v for k, v in (
        ("num_inference_steps", args.steps), ("guidance_scale", args.cfg),
        ("width", args.width), ("height", args.height), ("video_length", args.length))
        if v is not None}
    if args.use_motion_selection:
        overrides["use_motion_selection"] = True
    cfg = load_config(InferenceConfig, args.config, **overrides)
    if cfg.weights_dir:
        raise NotImplementedError("the port cannot load reference checkpoints yet")
    print("[warn] random-initialized models", file=sys.stderr)
    disable_tf32()
    pipe = Audio2VideoPipeline.build(torch.bfloat16, args.device, cfg.a2p_feature_type,
                                     seed=args.seed, config=cfg)
    ref = load_image(args.ref_image, cfg.height)
    init_kp = portrait_keypoints(ref, cfg.height, cfg.width)
    gen = torch.Generator(device=pipe.device).manual_seed(args.seed)
    out = pipe(args.audio, ref, init_kp, generator=gen)
    save_video(out["frames"], args.out, fps=cfg.fps, audio_wav=args.audio)
    print(f"wrote {args.out}: {out['frames'].shape}; "
          + " ".join(f"{k} {v:.3f}" for k, v in pipe.timings.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
