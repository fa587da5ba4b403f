"""The one-command weights-day release check: the port's counterpart of
`tools/release_check.py`.

Stages, each timed and recorded in the report; a stage that fails skips
the ones that need it:
  1. synth_weights (`--synthetic`): a reference-layout directory of seeded
     values (`mmgt_tpu_torch.tools.synth_weights`), the drill of the
     converters, the loaders and this orchestration;
  2. verify_weights: `python -m mmgt_tpu_torch.scripts.verify_weights DIR
     --json`: exit 0 (every file found loads strictly into its module),
     with the Stage-2 models and the SMGA decoder among those found;
  3. generate: audio2vid on the directory (`load_all_weights`) at --size,
     --frames and --steps with --sampler, on a synthetic wav of the clip's
     length and a gray portrait with random keypoints (the reference's demo
     fixture is not in this repository), then an mp4 through
     `utils/media.py`: finite, non-zero frames and a non-empty mp4, with
     the phase seconds, the kernel launches and the peak device memory;
  4. fewstep_quality (`--fewstep`): `python -m
     mmgt_tpu_torch.tools.fewstep_quality` on the same weights.
It writes <out>/release_check.json (with verify.json, release_check.mp4,
synthetic.wav) and exits 0 only if every stage passed.

    # the drill, full widths on the card, synthetic weights
    python -m mmgt_tpu_torch.tools.release_check --synthetic --out rc
    # weights day
    python -m mmgt_tpu_torch.tools.release_check /path/to/pretrained_weights --out rc --fewstep
    # tiny widths on the CPU (`verify_weights.tiny_models`; no encoders)
    python -m mmgt_tpu_torch.tools.release_check --synthetic --tiny --device cpu \\
        --size 64 --frames 8 --steps 2 --out rc
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
import traceback
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parents[2]
# the entries the generate stage needs from the directory
REQUIRED = ("vae", "reference_unet", "denoising_unet", "pose_guider", "audio_proj", "smga")


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("weights_dir", nargs="?", default=None)
    ap.add_argument("--synthetic", action="store_true",
                    help="write synthetic reference-layout weights first")
    ap.add_argument("--out", default="release_check")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=80)
    ap.add_argument("--steps", type=int, default=15)
    ap.add_argument("--sampler", choices=("ddim", "dpm"), default="dpm")
    ap.add_argument("--microbatch", type=int, default=5)
    ap.add_argument("--fewstep", action="store_true",
                    help="also run fewstep_quality on these weights")
    ap.add_argument("--tiny", action="store_true",
                    help="tiny Stage-2 and SMGA widths (drills on the CPU)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)
    if not (args.weights_dir or args.synthetic):
        ap.error("weights_dir or --synthetic required")
    if args.fewstep and args.tiny:
        ap.error("--fewstep runs the full-width pipeline; it does not take --tiny")
    return args


def _module(name: str, *args: str):
    """Run `python -m name args` from the repository root; raise with the
    end of its output if it fails."""
    rc = subprocess.run([sys.executable, "-m", name, *args], cwd=REPO, capture_output=True,
                        text=True)
    if rc.returncode != 0:
        raise RuntimeError(f"{name} exit {rc.returncode}: {rc.stdout[-800:]} {rc.stderr[-1200:]}")
    return rc


def synthetic_wav(path: str, seconds: float, sr: int = 16000) -> str:
    """The JAX tool's synthetic clip: a 220 Hz tone under a 3 Hz envelope."""
    from mmgt_tpu_torch.data.dsp import save_wav

    t = np.arange(int(sr * seconds)) / sr
    save_wav(path, 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t)), sr)
    return path


def build_pipeline(args, weights: str, device: torch.device):
    """audio2vid loaded from `weights`: the CLI's `build`, or at the tiny
    widths of `verify_weights.tiny_models` with `--tiny`."""
    from mmgt_tpu_torch.config import InferenceConfig, SchedulerConfig
    from mmgt_tpu_torch.diffusion import make_scheduler
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline, materialize
    from mmgt_tpu_torch.scripts import audio2vid as cli
    from mmgt_tpu_torch.scripts.verify_weights import tiny_models
    from mmgt_tpu_torch.training.stage1 import SMGA

    cfg = InferenceConfig(
        width=args.size, height=args.size, video_length=args.frames,
        num_inference_steps=args.steps, window_microbatch=args.microbatch, weights_dir=weights,
        scheduler=SchedulerConfig(solver={"dpm": "dpm++2m", "ddim": "ddim"}[args.sampler]))
    if not args.tiny:
        return cli.build(cfg, device)
    shapes = tiny_models()
    with torch.device("meta"):
        stage2 = {n: shapes[n]() for n in Pose2VideoPipeline.MODEL_NAMES}
        smga = SMGA(feature_type=cfg.a2p_feature_type, guidance_weight=cfg.a2p_guidance_weight)
        smga.model = shapes["smga"](smga.cond_dim)
    pose2vid = Pose2VideoPipeline(
        **materialize(stage2, device, torch.bfloat16), scheduler=make_scheduler(cfg.scheduler),
        context_size=cfg.context_size, context_overlap=cfg.context_overlap,
        window_microbatch=cfg.window_microbatch)
    smga.model.to_empty(device=device)
    return cli.from_weights(cfg, pose2vid, smga)


def generate(args, weights: str, device: torch.device, out: Path) -> dict:
    from mmgt_tpu_torch.ops import launch_counts, reset_launch_counts
    from mmgt_tpu_torch.utils.media import save_video

    pipe = build_pipeline(args, weights, device)
    wav = synthetic_wav(str(out / "synthetic.wav"), args.frames / pipe.config.fps)
    ref = np.full((args.size, args.size, 3), 0.5, np.float32)
    rng = np.random.default_rng(0)
    kp = np.zeros((134, 3), np.float32)
    kp[:, 0] = rng.uniform(0.3 * args.size, 0.7 * args.size, 134)
    kp[:, 1] = rng.uniform(0.2 * args.size, 0.9 * args.size, 134)
    kp[:, 2] = 1.0
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    reset_launch_counts()
    t0 = time.perf_counter()
    res = pipe(wav, ref, kp.reshape(-1), video_length=args.frames,
               generator=torch.Generator(device=device).manual_seed(0))
    wall = time.perf_counter() - t0
    frames = res["frames"]
    if frames.shape != (args.frames, args.size, args.size, 3):
        raise ValueError(f"frames of shape {frames.shape}")
    if not np.isfinite(frames).all():
        raise FloatingPointError("non-finite frames")
    if not frames.any():
        raise ValueError("all-zero frames")
    mp4 = out / "release_check.mp4"
    save_video(frames, str(mp4), fps=pipe.config.fps)
    if mp4.stat().st_size == 0:
        raise OSError(f"{mp4} is empty")
    return {"source": "synthetic wav, gray portrait", "wall_s": wall, "timings": pipe.timings,
            "launches": launch_counts(), "frames": list(frames.shape), "mp4": str(mp4),
            "mp4_bytes": mp4.stat().st_size,
            "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
            "device": torch.cuda.get_device_name(device) if cuda else "cpu"}


def main(argv=None) -> int:
    args = parse_args(argv)
    from mmgt_tpu_torch.device import disable_tf32, resolve_device

    device = resolve_device(args.device)
    disable_tf32()
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    report = {"stages": {}, "ok": False}
    t_all = time.perf_counter()

    def stage(name, fn) -> bool:
        t0 = time.perf_counter()
        try:
            info = fn() or {}
        except Exception as e:  # noqa: BLE001 - recorded in the report; the check fails
            traceback.print_exc()
            report["stages"][name] = {"ok": False, "s": time.perf_counter() - t0,
                                      "error": f"{type(e).__name__}: {e}"}
            print(f"[FAILED] {name}: {e}", flush=True)
            return False
        report["stages"][name] = {"ok": True, "s": time.perf_counter() - t0, **info}
        print(f"[ok] {name} ({report['stages'][name]['s']:.1f} s)", flush=True)
        return True

    weights = args.weights_dir or str(out / "synth_weights")
    dev = ["--device", device.type]
    ok = True
    if args.synthetic:
        def synth():
            from mmgt_tpu_torch.tools.synth_weights import synth_weights

            info = synth_weights(weights, device, tiny=args.tiny)
            if device.type == "cuda":
                torch.cuda.empty_cache()
            return {"dir": weights, "bytes": info["bytes"], "files": info["files"]}

        ok = stage("synth_weights", synth)

    def verify():
        path = out / "verify.json"
        _module("mmgt_tpu_torch.scripts.verify_weights", weights, "--json", str(path), *dev,
                *(["--tiny"] if args.tiny else []))
        rep = json.loads(path.read_text())
        missing = [n for n in REQUIRED if rep.get(n, {}).get("status") != "ok"]
        if missing:
            raise FileNotFoundError(f"no loadable checkpoint for {missing}")
        return {"entries": {k: v.get("status") for k, v in rep.items()}}

    ok = ok and stage("verify_weights", verify)
    ok = ok and stage("generate", lambda: generate(args, weights, device, out))
    if ok and args.fewstep:
        stage("fewstep_quality", lambda: {"tail": _module(
            "mmgt_tpu_torch.tools.fewstep_quality", "--weights_dir", weights, "--out",
            str(out / "fewstep.json"), *dev).stdout[-600:]})

    report["ok"] = ok and all(s["ok"] for s in report["stages"].values())
    report["total_s"] = time.perf_counter() - t_all
    path = out / "release_check.json"
    path.write_text(json.dumps(report, indent=2, default=str))
    print(json.dumps({"ok": report["ok"], "total_s": report["total_s"], "report": str(path)}))
    return 0 if report["ok"] else 1


if __name__ == "__main__":
    sys.exit(main())
