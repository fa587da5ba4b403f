#!/usr/bin/env python3
"""Flagship benchmark of the PyTorch/CUDA port (`mmgt_tpu_torch`) on one
NVIDIA GPU: the counterpart of `bench.py`, with its rows and modes.

  audio2vid (the default): a synthetic 3.2 s wav, a gray 512x512 portrait
    and seeded keypoints -> an 80-frame clip through
    `Audio2VideoPipeline.build` (Stage 1: SMGA sampling, 50 steps x CFG
    (--stage1-steps), on the baseline 35-d DSP features; the rasterized
    conditioning; Stage 2: windowed CFG denoising, 25 DDIM steps, guidance
    3.5, 5 windows a UNet call; the VAE decode). Then, in the same process and each with its own
    untimed first call: long{3F} (3 x the frames from chained 3.2 s
    slices, motion selection over 3 candidates), fast{N} (DDIM at
    --fast-steps, 15) and dpm{N} (DPM-Solver++(2M) at --dpm-steps, 15).
    The train row runs first, in a subprocess, so that each row's peak
    memory is its own;
  pose2vid: `Pose2VideoPipeline` alone on bench.py's inputs (zero
    reference, pose, CLIP embedding and audio, all-ones masks);
  fixture: the flagship on the reference repository's demo clip
    (`--reference DIR`: its config/cases/oliver#103842_slice18.wav and
    .png); it raises when they are absent;
  long: the flagship at 240 frames (3 x 80) with motion selection;
  train_stage2: `Stage2Trainer` with remat, batch 1, 12 frames at size^2,
    a seeded random batch.

Weights are seeded random (`init_random_params`) from --seed, as every
input, or loaded from --weights DIR (after `verify_weights` passes in a
subprocess). A row makes one untimed first call, then --repeats timed
calls (the train row at least 2 steps), and reports the median seconds,
the samples, the median call's phase seconds and kernel launches, and the
peak device memory (its counter reset before the row). Every call's
frames must be finite and not all zero, every loss finite.

One JSON line per mode:

  {"metric": "audio2vid_e2e_80f_512px_25steps_1gpu", "value": s, "unit": "s",
   "components": {...}, "mfu": {...}, "setup": {...},
   "device": {"name": ..., "power_limit": ...}}

`components`: the flagship's phases (`Audio2VideoPipeline.timings`),
samples, launches by phase and peak GiB, and each secondary row's seconds,
samples, first call, phases and peak. `mfu`: useful FLOPs over the phase
seconds and 989 TFLOP/s (the H100 SXM's dense bf16 peak): Stage 2's
denoise steps and decode counted by `mmgt_tpu_torch/tools/mfu_audit.py`
(over fake tensors: counted, and executed by the kernels' tiles) and
bench.py's closed form, Stage 1's sampling likewise (`count_s`: the
count's host seconds). `setup`: the kernels' build seconds and whether the
build cache held them (the main process builds them first; the train
row's process then loads them), the seconds to build the models with their
weights, the first call's seconds and the train row's process seconds
(its start included). On the CPU the metric ends in `_cpu`, and `mfu`
holds the closed form alone, with no utilization.

--trace DIR: after a row's timed calls, one more call under
`utils/profiling.trace`, then a {"trace": ...} line: its device time by
kernel (top 20) and by family, the busy ms and the idle share of the
row's median seconds. Timed calls are never traced.

    python3 bench_torch.py                    # the flagship and its rows
    python3 bench_torch.py --mode pose2vid
    python3 bench_torch.py --frames 16 --steps 2 --fast-steps 2 --dpm-steps 2 \\
        --stage1-steps 10 --trace traces      # a cut depth
    python3 bench_torch.py --device cpu --tiny --size 64 --frames 8 --steps 2 \\
        --fast-steps 2 --dpm-steps 2 --stage1-steps 5 --no-train   # the tiny nets

A failing row, or no card without `--device cpu`, ends the run with exit
code 1 and no result line. Not ported from bench.py: the out-of-memory
microbatch ladder, the cool-down retry, the XLA cache statistics,
`vs_baseline` and the "failed: ..." strings.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time
import traceback
import wave

import numpy as np
import torch

from mmgt_tpu_torch import testing

REPO = os.path.dirname(os.path.abspath(__file__))

PEAK_FLOPS = 989e12      # H100 SXM dense bf16, FLOP/s
FPS, SR = 25, 16000
TRAIN_FRAMES = 12        # frames of the train row's clip
FIXTURE = "config/cases/oliver#103842_slice18"   # under the reference repository
TRAIN_TIMEOUT_S = 1500   # the train row's subprocess


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--mode", default="audio2vid",
                    choices=("audio2vid", "pose2vid", "fixture", "long", "train_stage2"))
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--frames", type=int, default=None, help="80 (240 with --mode long)")
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--microbatch", type=int, default=5, help="context windows a UNet call")
    ap.add_argument("--repeats", type=int, default=1, help="timed calls a row")
    ap.add_argument("--weights", default=None, metavar="DIR",
                    help="a reference-layout weights directory (verified first)")
    ap.add_argument("--fast-steps", type=int, default=15, help="DDIM steps of the fast row")
    ap.add_argument("--dpm-steps", type=int, default=15)
    ap.add_argument("--stage1-steps", type=int, default=50,
                    help="Stage-1 SMGA sampling steps (the reference's 50)")
    ap.add_argument("--no-long", dest="long", action="store_false", help="skip the long row")
    ap.add_argument("--no-dpm", dest="dpm", action="store_false", help="skip the dpm row")
    ap.add_argument("--no-train", dest="train", action="store_false",
                    help="skip the train row")
    ap.add_argument("--reference", default=None, metavar="DIR",
                    help="the reference repository (--mode fixture)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--tiny", action="store_true", help="the tiny nets (tests on the CPU)")
    ap.add_argument("--trace", default=None, metavar="DIR",
                    help="trace one more call of each row into DIR")
    args = ap.parse_args(argv)
    if args.frames is None:
        args.frames = 240 if args.mode == "long" else 80
    if args.tiny and args.weights:
        ap.error("--weights loads full-width models; it does not take --tiny")
    return args


# ---------------------------------------------------------------- inputs
def synthetic_wav(path: str, frames: int) -> str:
    """bench.py's clip: frames / 25 s of a 220 Hz tone under a 3 Hz
    envelope, 16-bit mono at 16 kHz."""
    t = np.arange(int(SR * frames / FPS)) / SR
    sig = 0.3 * np.sin(2 * np.pi * 220 * t) * (1 + 0.5 * np.sin(2 * np.pi * 3 * t))
    with wave.open(path, "w") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(SR)
        w.writeframes((sig * 32767).astype(np.int16).tobytes())
    return path


def portrait(size: int, seed: int):
    """bench.py's gray portrait and its (402,) keypoints, drawn from `seed`
    (no DWPose weights ship in the repository)."""
    rng = np.random.default_rng(seed)
    kp = np.zeros((134, 3), np.float32)
    kp[:, 0] = rng.uniform(0.3 * size, 0.7 * size, 134)
    kp[:, 1] = rng.uniform(0.2 * size, 0.9 * size, 134)
    kp[:, 2] = 1.0
    return np.full((size, size, 3), 0.5, np.float32), kp.reshape(-1)


def audio_shape(tiny: bool):
    """(windows, layers, channels) of a frame's audio embedding, as the
    audio projection takes it."""
    kw = testing.SMALL["audio_proj"] if tiny else {}
    return (5, kw.get("blocks", 12), kw.get("channels", 768))


def check_frames(frames, shape):
    frames = np.asarray(frames.float().cpu() if torch.is_tensor(frames) else frames, np.float32)
    if tuple(frames.shape) != tuple(shape):
        raise ValueError(f"frames of shape {frames.shape}, expected {tuple(shape)}")
    if not np.isfinite(frames).all():
        raise FloatingPointError("non-finite frames")
    if not frames.any():
        raise ValueError("all-zero frames")


# ---------------------------------------------------------------- models
def widths(tiny: bool) -> dict:
    """The nets' widths: the small ones of `mmgt_tpu_torch/testing.py`, or
    full width."""
    return testing.SMALL if tiny else {}


def smga_model(tiny: bool, cond_dim: int):
    from mmgt_tpu_torch.models.smga import NFEATS, GestureDecoder

    return GestureDecoder(NFEATS, cond_feature_dim=cond_dim, **widths(tiny).get("smga", {}))


def inference_config(args, frames: int):
    from mmgt_tpu_torch.config import InferenceConfig

    cfg = InferenceConfig(width=args.size, height=args.size, video_length=frames,
                          num_inference_steps=args.steps, window_microbatch=args.microbatch,
                          use_motion_selection=args.mode == "long", motion_candidates=3,
                          a2p_feature_type="baseline", a2p_sampling_steps=args.stage1_steps)
    if args.tiny:
        cfg = dataclasses.replace(cfg, context_size=6, context_overlap=2)
    return cfg


def tiny_stage2(cfg, device, seed: int, **kwargs):
    """A Pose2VideoPipeline of the tiny nets with seeded weights (built on
    `device` directly: the tiny nets are small)."""
    from mmgt_tpu_torch.diffusion import make_scheduler
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline

    with torch.device(device):
        models = testing.stage2_models(testing.SMALL)
    models = {n: m.to(torch.bfloat16) for n, m in models.items()}
    pipe = Pose2VideoPipeline(**models,
                              scheduler=make_scheduler(cfg.scheduler),
                              context_size=cfg.context_size,
                              context_overlap=cfg.context_overlap,
                              window_microbatch=cfg.window_microbatch, **kwargs)
    pipe.init_params(seed)
    return pipe


def tiny_a2v(cfg, device, seed: int):
    """audio2vid of the tiny nets (Stage 2 and CLIP in bf16, wav2vec2 and
    the SMGA decoder in f32), seeded weights, as `Audio2VideoPipeline.build`
    composes the full-width one."""
    from mmgt_tpu_torch.pipelines.pose2vid import init_random_params

    pipe = testing.small_audio2vid(tiny_stage2(cfg, device, seed, profile_phases=True), cfg,
                                   device, torch.bfloat16)
    gen = torch.Generator(device=device).manual_seed(seed + 1)
    for m in (pipe.smga.model, pipe.clip_model, pipe.audio_processor.model):
        init_random_params(m, gen)
    return pipe


def build_a2v(args, cfg, device):
    """The audio2vid pipeline: loaded from --weights after verify_weights
    passes, else seeded random weights (full width, or the tiny nets)."""
    from mmgt_tpu_torch.pipelines.audio2vid import Audio2VideoPipeline

    if args.tiny:
        return tiny_a2v(cfg, device, args.seed)
    if not args.weights:
        return Audio2VideoPipeline.build(torch.bfloat16, device, "baseline", seed=args.seed,
                                         config=cfg, profile_phases=True)
    from mmgt_tpu_torch.diffusion import make_scheduler
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
    from mmgt_tpu_torch.scripts.audio2vid import from_weights
    from mmgt_tpu_torch.training.stage1 import SMGA

    rc = subprocess.run([sys.executable, "-m", "mmgt_tpu_torch.scripts.verify_weights",
                         args.weights, "--device", device.type], cwd=REPO,
                        capture_output=True, text=True)
    print(f"# verify_weights exit {rc.returncode}\n{rc.stdout[-2000:]}", file=sys.stderr)
    if rc.returncode != 0:
        raise RuntimeError(f"verify_weights failed on {args.weights}: {rc.stderr[-2000:]}")
    pose2vid = Pose2VideoPipeline.build(
        torch.bfloat16, device, args.seed, scheduler=make_scheduler(cfg.scheduler),
        context_size=cfg.context_size, context_overlap=cfg.context_overlap,
        window_microbatch=cfg.window_microbatch, profile_phases=True)
    with torch.device("meta"):
        smga = SMGA(feature_type="baseline", guidance_weight=cfg.a2p_guidance_weight)
    smga.model.to_empty(device=device)
    return from_weights(dataclasses.replace(cfg, weights_dir=args.weights), pose2vid, smga)


# ---------------------------------------------------------------- timing
def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def timed(fn, device):
    sync(device)
    t0 = time.perf_counter()
    out = fn()
    sync(device)
    return time.perf_counter() - t0, out


def run_row(name: str, fn, device, repeats: int, check, info=dict, trace_dir=None):
    """fn() once untimed, then `repeats` timed calls, `check` on each
    output. Returns ({"s": the median, "samples_s", "first_s", "peak_gib",
    and info() after the median call}, the last output)."""
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    first, out = timed(fn, device)
    check(out)
    samples, infos = [], []
    for _ in range(repeats):
        out = None
        sec, out = timed(fn, device)
        check(out)
        samples.append(sec)
        infos.append(info())
    mid = sorted(range(len(samples)), key=samples.__getitem__)[len(samples) // 2]
    row = {"s": float(np.median(samples)), "samples_s": samples, "first_s": first,
           "peak_gib": torch.cuda.max_memory_allocated(device) / 2**30 if cuda else None,
           **infos[mid]}
    if trace_dir:
        trace_row(name, fn, device, os.path.join(trace_dir, name), row["s"])
    return row, out


def trace_row(name: str, fn, device, log_dir: str, wall_s: float):
    """One more call of fn under `utils/profiling.trace`; prints its
    device time by kernel and family, busy ms and idle share of wall_s."""
    from mmgt_tpu_torch.utils import device_trace, profiling

    with profiling.trace(log_dir) as path:
        with profiling.annotate(name):
            sec, _ = timed(fn, device)
    rows = device_trace.device_op_table(path)
    print(json.dumps({"trace": {"row": name, "path": path, "traced_wall_ms": sec * 1e3,
                                **device_trace.report(rows, wall_s * 1e3)}}), flush=True)


def build_kernels(device) -> dict:
    """Build the kernels (on the card): seconds, and whether every library
    was in the build cache already."""
    if device.type != "cuda":
        return {"kernel_build_s": None, "kernels_cached": None}
    from mmgt_tpu_torch.ops import _build

    cached = all(_build._lib_path(n).exists() for n in _build.SOURCES)
    t0 = time.perf_counter()
    _build.build()
    return {"kernel_build_s": time.perf_counter() - t0, "kernels_cached": cached}


def device_info(device) -> dict:
    if device.type != "cuda":
        return {"name": "cpu", "power_limit": None}
    line = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[device.index or 0]
    name, limit = line.rsplit(",", 1)
    return {"name": name.strip(), "power_limit": limit.strip()}


def metric_suffix(args, device) -> str:
    return ("_tiny" if args.tiny else "") + ("_1gpu" if device.type == "cuda" else "_cpu")


# ---------------------------------------------------------------- FLOPs
def useful_flops(steps: int, frames: int, size: int) -> dict:
    """bench.py's closed-form useful-FLOP estimates (`bench.py:useful_flops`),
    copied as is."""
    # SD1.5 UNet ~0.68 TFLOP per 64^2-latent frame eval; audio+motion+bank
    # modules add ~55% (PERF.md component table)
    unet = 0.68e12 * 1.55 * steps * 2 * int(frames * 1.5)
    vae = 1.24e12 * frames * (size / 512) ** 2      # decoder ~0.62 TMAC/frame
    smga = 2 * 50 * 2 * (80 * 512 * 512 * 2 * 10)   # 8 layers, rough
    return {"stage2": unet + vae, "stage1": float(smga)}


def counted_flops(args, cfg, frames: int, stage1_calls: int = 0, n_cand: int = 1,
                  cond_dim: int = 35) -> dict:
    """FLOPs counted by `mmgt_tpu_torch/tools/mfu_audit.py` over fake
    tensors: Stage 2 = steps x one denoise step at `frames` + frames x the
    VAE decode of a frame (counted, and executed by the kernels' tiles);
    Stage 1 (when stage1_calls) = stage1_calls x one CFG-doubled SMGA step
    at batch n_cand."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    from mmgt_tpu_torch.tools import mfu_audit as ma

    h8 = args.size // 8
    with FakeTensorMode():
        models = testing.stage2_models(widths(args.tiny), ("vae", "denoising_unet"))
        smga = smga_model(args.tiny, cond_dim)
        for m in (*models.values(), smga):
            m.eval().requires_grad_(False)
        pipe = ma.stage2_pipeline(models["denoising_unet"], cfg.window_microbatch,
                                  cfg.context_size, cfg.context_overlap)
        step = ma.count_step(pipe, frames, h8, cfg.num_inference_steps)
        vae = ma.count_vae_frame(models["vae"], h8)
        smga_step = ma.count_smga_step(smga, batch=n_cand, cond_dim=cond_dim)
    steps = cfg.num_inference_steps
    out = {"stage2_counted": steps * step["counted"] + frames * vae["counted"],
           "stage2_executed": steps * step["executed"] + frames * vae["executed"]}
    if stage1_calls:
        out["stage1_counted"] = stage1_calls * smga_step["counted"]
    return out


def utilization(device, seconds: dict, closed: dict, count) -> dict:
    """Useful FLOPs of each phase over its seconds and PEAK_FLOPS: bench.py's
    closed form and the port's own count (`count()`, `counted_flops`). On
    the CPU no utilization of the card's peak exists, and nothing is
    counted: the closed form stands alone."""
    flops = {f"{k}_closed_form": v for k, v in closed.items()}
    if device.type != "cuda":
        return {"peak_flops": PEAK_FLOPS, "flops": flops, **{k: None for k in flops}}
    t0 = time.perf_counter()
    flops.update(count())
    return {"peak_flops": PEAK_FLOPS, "flops": flops, "count_s": time.perf_counter() - t0,
            **{k: v / seconds[k.split("_")[0]] / PEAK_FLOPS for k, v in flops.items()}}


# ---------------------------------------------------------------- rows
def a2v_row(name, pipe, wav, ref, kp, frames, args, device):
    """One audio2vid row at the pipeline's current config."""
    def call():
        return pipe(wav, ref, kp, video_length=frames,
                    generator=torch.Generator(device=device).manual_seed(args.seed))

    return run_row(name, call, device, args.repeats,
                   lambda out: check_frames(out["frames"], (frames, args.size, args.size, 3)),
                   lambda: {"timings": dict(pipe.timings),
                            "phase_launches": dict(pipe.phase_launches)}, args.trace)


def secondary_rows(pipe, ref, kp, args, device, tmp: str) -> dict:
    """long{3F}, fast{N} and dpm{N} on the flagship's pipeline, each with its
    own untimed first call; the pipeline's config and sampler are restored
    after each."""
    from mmgt_tpu_torch.diffusion import make_scheduler

    cfg, sched = pipe.config, pipe.pose2vid.scheduler
    wav = os.path.join(tmp, "bench.wav")
    rows = {}
    if args.long:
        n = 3 * args.frames
        pipe.config = dataclasses.replace(cfg, video_length=n, use_motion_selection=True,
                                          motion_candidates=3)
        rows[f"audio2vid_long{n}"], _ = a2v_row(
            f"long{n}", pipe, synthetic_wav(os.path.join(tmp, "long.wav"), n), ref, kp, n,
            args, device)
    pipe.config = dataclasses.replace(cfg, num_inference_steps=args.fast_steps)
    rows[f"audio2vid_fast{args.fast_steps}"], _ = a2v_row(
        f"fast{args.fast_steps}", pipe, wav, ref, kp, args.frames, args, device)
    if args.dpm:
        pipe.config = dataclasses.replace(cfg, num_inference_steps=args.dpm_steps)
        pipe.pose2vid.scheduler = make_scheduler(
            dataclasses.replace(cfg.scheduler, solver="dpm++2m"))
        rows[f"audio2vid_dpm{args.dpm_steps}"], _ = a2v_row(
            f"dpm{args.dpm_steps}", pipe, wav, ref, kp, args.frames, args, device)
    pipe.config, pipe.pose2vid.scheduler = cfg, sched
    return rows


def bench_audio2vid(args, device, setup: dict):
    """The flagship (audio2vid, fixture or long) and, in audio2vid mode,
    its secondary rows. Returns (metric, seconds, components, mfu, the
    flagship's last output)."""
    from mmgt_tpu_torch.data.audio import slice_audio
    from mmgt_tpu_torch.data.dsp import load_wav

    cfg = inference_config(args, args.frames)
    ref, kp = portrait(args.size, args.seed)
    with tempfile.TemporaryDirectory() as tmp:
        if args.mode == "fixture":
            from mmgt_tpu_torch.utils.media import load_image

            if not args.reference:
                raise ValueError("--mode fixture needs --reference DIR")
            stem = os.path.join(args.reference, FIXTURE)
            for ext in (".wav", ".png"):
                if not os.path.exists(stem + ext):
                    raise FileNotFoundError(f"the fixture {stem + ext} is absent")
            wav, ref = stem + ".wav", load_image(stem + ".png", args.size)
        else:
            wav = synthetic_wav(os.path.join(tmp, "bench.wav"), args.frames)
        t0 = time.perf_counter()
        pipe = build_a2v(args, cfg, device)
        sync(device)
        setup["weights_init_s"] = time.perf_counter() - t0
        row, out = a2v_row(args.mode, pipe, wav, ref, kp, args.frames, args, device)
        setup["first_call_s"] = row["first_s"]
        secondary = (secondary_rows(pipe, ref, kp, args, device, tmp)
                     if args.mode == "audio2vid" else {})
        audio = load_wav(wav, SR)
        n_slices = len(slice_audio(audio)) if len(audio) / SR > 3.3 else 1  # as generate_pose
    t = row["timings"]
    comp = dict(t, samples_s=row["samples_s"], phase_launches=row["phase_launches"],
                peak_gib=row["peak_gib"], pose2vid_e2e_s=t["stage2_s"])
    for name, r in secondary.items():
        comp.update({f"{name}_s": r["s"], f"{name}_samples_s": r["samples_s"],
                     f"{name}_first_s": r["first_s"], f"{name}_peak_gib": r["peak_gib"],
                     f"{name}_phases_s": r["timings"]})
    n_cand = cfg.motion_candidates if cfg.use_motion_selection else 1
    mfu = utilization(device, {"stage2": t["stage2_s"], "stage1": t["stage1_s"]},
                      useful_flops(args.steps, args.frames, args.size),
                      lambda: counted_flops(args, cfg, args.frames,
                                            cfg.a2p_sampling_steps * n_slices, n_cand,
                                            pipe.smga.cond_dim))
    metric = f"audio2vid_e2e_{args.frames}f_{args.size}px_{args.steps}steps"
    metric += {"fixture": "_fixture", "long": "_long"}.get(args.mode, "")
    metric += "_realweights" if args.weights else ""
    return metric, row["s"], comp, mfu, out


def bench_pose2vid(args, device, setup: dict):
    """Pose2VideoPipeline alone on bench.py's inputs."""
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline

    cfg = inference_config(args, args.frames)
    t0 = time.perf_counter()
    if args.tiny:
        pipe = tiny_stage2(cfg, device, args.seed, profile_phases=True)
    else:
        pipe = Pose2VideoPipeline.build(torch.bfloat16, device, args.seed,
                                        window_microbatch=args.microbatch, profile_phases=True)
    sync(device)
    setup["weights_init_s"] = time.perf_counter() - t0
    f, s, h8 = args.frames, args.size, args.size // 8
    inputs = dict(
        ref_image=torch.zeros(1, s, s, 3), pose_video=torch.zeros(1, f, s, s, 3),
        clip_embed=torch.zeros(1, 1, 768),
        masks=[tuple(torch.ones(1, f, (h8 >> lv) ** 2) for _ in range(3)) for lv in range(3)],
        audio_embeds=torch.zeros(1, f, *audio_shape(args.tiny)))

    def call():
        return pipe(**inputs, num_inference_steps=args.steps, guidance_scale=3.5,
                    generator=torch.Generator(device=device).manual_seed(args.seed))

    row, out = run_row("pose2vid", call, device, args.repeats,
                       lambda out: check_frames(out[0], (f, s, s, 3)),
                       lambda: {"timings": dict(pipe.timings),
                                "phase_launches": dict(pipe.phase_launches)}, args.trace)
    setup["first_call_s"] = row["first_s"]
    comp = dict(row["timings"], samples_s=row["samples_s"],
                phase_launches=row["phase_launches"], peak_gib=row["peak_gib"])
    mfu = utilization(device, {"stage2": row["s"]},
                      {"stage2": useful_flops(args.steps, f, s)["stage2"]},
                      lambda: counted_flops(args, cfg, f))
    return f"pose2vid_e2e_{f}f_{s}px_{args.steps}steps", row["s"], comp, mfu, out


def bench_train(args, device, setup: dict):
    """Stage2Trainer steps: remat, batch 1, TRAIN_FRAMES frames at size^2."""
    from mmgt_tpu_torch.ops import launch_counts, reset_launch_counts
    from mmgt_tpu_torch.training.stage2 import Stage2Trainer

    t0 = time.perf_counter()
    if args.tiny:
        pipe = tiny_stage2(inference_config(args, TRAIN_FRAMES), device, args.seed)
        pipe.denoising_unet.remat = True
        trainer = Stage2Trainer(pipe)
    else:
        trainer = Stage2Trainer.build(torch.bfloat16, device, args.seed, remat=True)
    state = trainer.init_state()
    batch = testing.train_batch(1, TRAIN_FRAMES, args.size, args.seed + 1, device,
                                audio_shape(args.tiny))
    sync(device)
    setup["weights_init_s"] = time.perf_counter() - t0
    gen = torch.Generator(device=device).manual_seed(args.seed)

    def step():
        reset_launch_counts()
        return float(trainer.train_step(state, batch, generator=gen)["loss"])

    def check(loss):
        if not math.isfinite(loss):
            raise FloatingPointError(f"train loss {loss}")

    row, loss = run_row("train_stage2", step, device, max(args.repeats, 2), check,
                        lambda: {"launches": launch_counts()}, args.trace)
    setup["first_call_s"] = row["first_s"]
    comp = dict(samples_s=row["samples_s"], launches=row["launches"], peak_gib=row["peak_gib"],
                loss=loss, loss_finite=math.isfinite(loss))
    return f"train_stage2_step_{TRAIN_FRAMES}f_{args.size}px_bs1", row["s"], comp, None, None


def train_row_command(args) -> list:
    """The train row's command line: this file at --mode train_stage2."""
    cmd = [sys.executable, os.path.abspath(__file__), "--mode", "train_stage2",
           "--size", str(args.size), "--repeats", str(args.repeats), "--seed", str(args.seed)]
    cmd += ["--device", args.device] if args.device else []
    cmd += ["--tiny"] if args.tiny else []
    cmd += ["--trace", args.trace] if args.trace else []
    return cmd


def train_row_subprocess(args) -> dict:
    """The train row in a process of its own; its trace line passes
    through. Returns its result line."""
    cmd = train_row_command(args)
    rc = subprocess.run(cmd, stdout=subprocess.PIPE, text=True, timeout=TRAIN_TIMEOUT_S)
    if rc.returncode != 0:
        raise RuntimeError(f"the train row exited {rc.returncode}")
    line = None
    for text in rc.stdout.splitlines():
        if text.startswith('{"trace"'):
            print(text, flush=True)
        elif text.startswith("{"):
            line = json.loads(text)
    if line is None:
        raise RuntimeError("the train row printed no result")
    return line


def run(args):
    """Every row of args.mode. Returns (the result line, the main row's
    last output)."""
    from mmgt_tpu_torch.device import disable_tf32, resolve_device

    device = resolve_device(args.device)
    disable_tf32()
    setup = build_kernels(device)   # before the train row's process, which loads them
    train, t0 = None, time.perf_counter()
    if args.mode == "audio2vid" and args.train and not args.weights:
        train = train_row_subprocess(args)
    train_s = time.perf_counter() - t0
    bench = {"train_stage2": bench_train, "pose2vid": bench_pose2vid}.get(args.mode,
                                                                          bench_audio2vid)
    metric, value, comp, mfu, out = bench(args, device, setup)
    if train is not None:
        tc = train["components"]
        comp.update(train_stage2_step_s=train["value"], train_stage2_samples_s=tc["samples_s"],
                    train_stage2_first_s=train["setup"]["first_call_s"],
                    train_stage2_peak_gib=tc["peak_gib"], train_stage2_launches=tc["launches"],
                    train_loss_finite=tc["loss_finite"])
        setup["train_row_s"] = train_s
    line = {"metric": metric + metric_suffix(args, device), "value": value, "unit": "s",
            "components": comp, "setup": setup, "device": device_info(device)}
    if mfu is not None:
        line["mfu"] = mfu
    return line, out


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        line, _ = run(args)
    except Exception:  # noqa: BLE001 - any failing row ends the run without a result
        traceback.print_exc()
        print("bench_torch: a row failed; no result", file=sys.stderr)
        return 1
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
