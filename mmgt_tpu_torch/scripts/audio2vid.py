"""Audio + portrait -> video on the card, the port's counterpart of
`scripts/audio2vid.py` (the same arguments, plus `--device`).

    python -m mmgt_tpu_torch.scripts.audio2vid --ref_image face.png \\
        --audio speech.wav --out out.mp4 [--config cfg.yaml] \\
        [--weights_dir pretrained_weights] [--solver {ddim,dpm++2m}] \\
        [--steps 30] [--cfg 3.5] [--seed 42] [-W 512 -H 512 -L 80] \\
        [--use_motion_selection] [--device cuda]

With a weights directory (`--weights_dir`, or the config's `weights_dir`)
the models load from the reference's checkpoints (`load_all_weights`); an
encoder whose file is absent is left out, as in the JAX CLI (zero CLIP
context, zero audio embeddings, zero WavLM features). Without one, every
model runs with seeded random weights. `--solver dpm++2m` samples Stage 2
with DPM-Solver++(2M) (pair it with `--steps 15`). `main` only reads and
writes files (`utils/media.py`, which needs cv2); `build` and `run` take
and return arrays. f32 work runs in full f32, not TF32. `--device cpu`
runs the plain PyTorch path.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

import numpy as np


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ref_image", required=True)
    ap.add_argument("--audio", required=True)
    ap.add_argument("--out", default="output/audio2vid.mp4")
    ap.add_argument("--config", default=None)
    ap.add_argument("--weights_dir", default=None)
    ap.add_argument("--steps", type=int, default=None)
    ap.add_argument("--cfg", type=float, default=None)
    ap.add_argument("-W", "--width", type=int, default=None)
    ap.add_argument("-H", "--height", type=int, default=None)
    ap.add_argument("-L", "--length", type=int, default=None)
    ap.add_argument("--seed", type=int, default=42)
    ap.add_argument("--use_motion_selection", action="store_true")
    ap.add_argument("--solver", default=None, choices=["ddim", "dpm++2m"],
                    help="ddim = reference parity; dpm++2m for few-step sampling "
                         "(pair with --steps 15)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def config_from_args(args):
    from mmgt_tpu_torch.config import InferenceConfig, load_config

    overrides = {k: v for k, v in (
        ("num_inference_steps", args.steps), ("guidance_scale", args.cfg),
        ("width", args.width), ("height", args.height), ("video_length", args.length),
        ("weights_dir", args.weights_dir)) if v is not None}
    if args.use_motion_selection:
        overrides["use_motion_selection"] = True
    cfg = load_config(InferenceConfig, args.config, **overrides)
    if args.solver is not None:
        cfg = dataclasses.replace(
            cfg, scheduler=dataclasses.replace(cfg.scheduler, solver=args.solver))
    return cfg


def build(cfg, device=None, seed: int = 42):
    """The audio2vid pipeline on `device` (the card unless the caller asks
    for the CPU): Stage 2 in bf16 with `cfg.scheduler`'s sampler, loaded
    from `cfg.weights_dir` where it names one, else every model with
    seeded random weights."""
    import torch

    from mmgt_tpu_torch.diffusion import make_scheduler
    from mmgt_tpu_torch.pipelines.audio2vid import Audio2VideoPipeline
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
    from mmgt_tpu_torch.training.stage1 import SMGA

    if not cfg.weights_dir:
        print("[warn] no weights_dir: random-initialized models", file=sys.stderr)
        return Audio2VideoPipeline.build(torch.bfloat16, device, cfg.a2p_feature_type,
                                         seed=seed, config=cfg)
    pose2vid = Pose2VideoPipeline.build(
        torch.bfloat16, device, seed, scheduler=make_scheduler(cfg.scheduler),
        context_size=cfg.context_size, context_overlap=cfg.context_overlap,
        window_microbatch=cfg.window_microbatch)
    with torch.device("meta"):
        smga = SMGA(feature_type=cfg.a2p_feature_type, guidance_weight=cfg.a2p_guidance_weight)
    smga.model.to_empty(device=pose2vid.device)
    return from_weights(cfg, pose2vid, smga)


def from_weights(cfg, pose2vid, smga):
    """The audio2vid pipeline around `pose2vid` and `smga` once
    `load_all_weights` has loaded `cfg.weights_dir` into them (on
    `pose2vid`'s device), with the encoders whose files it found."""
    from mmgt_tpu_torch.pipelines.audio2vid import Audio2VideoPipeline
    from mmgt_tpu_torch.utils.weights import load_all_weights

    w = load_all_weights(cfg.weights_dir, pose2vid, smga, pose2vid.device)
    return Audio2VideoPipeline(smga=w["smga"], pose2vid=pose2vid,
                               clip_model=w.get("clip_model"),
                               audio_processor=w.get("audio_processor"),
                               wavlm_extractor=w.get("wavlm"), config=cfg)


def run(pipe, wav_path: str, ref_image: np.ndarray, seed: int = 42) -> dict:
    """A wav file and a portrait (H, W, 3) in [0, 1] -> the pipeline's
    output dict ("frames" (T, H, W, 3) f32 in [0, 1], "keypoints", ...)."""
    import torch

    from mmgt_tpu_torch.data.pose_init import portrait_keypoints

    cfg = pipe.config
    init_kp = portrait_keypoints(ref_image, cfg.height, cfg.width)
    return pipe(wav_path, ref_image, init_kp,
                generator=torch.Generator(device=pipe.device).manual_seed(seed))


def main(argv=None) -> int:
    args = parse_args(argv)
    from mmgt_tpu_torch.device import disable_tf32
    from mmgt_tpu_torch.utils.media import load_image, save_video

    cfg = config_from_args(args)
    disable_tf32()
    pipe = build(cfg, args.device, args.seed)
    out = run(pipe, args.audio, load_image(args.ref_image, cfg.height), args.seed)
    save_video(out["frames"], args.out, fps=cfg.fps, audio_wav=args.audio)
    print(f"wrote {args.out}: {out['frames'].shape}; "
          + " ".join(f"{k} {v:.3f}" for k, v in pipe.timings.items()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
