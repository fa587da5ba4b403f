#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mmgt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, in order; any failure exits non-zero:
  1. build: compile the CUDA kernels (one nvcc per source, started
     together) and print the build seconds and the card's name and power
     limit;
  2. kernels: hold every kernel (K1-K5) against its plain PyTorch version
     on the card, in bf16, at the main path's per-row shapes; print each
     one's error and tolerance, its time (CUDA events), the plain version's
     time, one PyTorch library call's time where one computes the same
     function, and the bound (the larger of flops / 989 TFLOP/s and bytes /
     3.35 TB/s, each input read once and each output written once); K1 and
     K2 are also timed at the shapes of each JAX function they replace, K1
     at the level-1 and level-2 bank shapes and on its f32 route
     (`dot_product_attention`, (1, 600, 12, 64) f32 against the f32 plain
     version), K2 (with its plan) at a resident level-2 row, the streamed
     level-0 up-block concatenation, wav2vec2's conv 0 ((1, 12799, 512)
     f32, 512 groups of one channel) and a formerly over-limit plan
     ((1, 64, 768) f32, 768 groups; f32 rows within F32_REL_TOL of the
     largest output), K3 at the level-0 q/k/v,
     level-0 GEGLU and level-2 audio-q shapes and in its tiled regime
     (K >= 640) at the level-1 q/k/v, GEGLU and audio q, the level-2 GEGLU
     and K4's W_o + residual at levels 1 and 3, and K3's level-0 audio q
     and K4's level-0 W_o + residual (every row with gamma, beta and the
     biases in bf16 and in f32, two calls bitwise equal, the host's us a
     call), K1 at d = 192 and 264 (the d = 512 path, keys split), K4 at
     the rows of tools/k4_rows.py (levels 0-3 and the mid block, a tp = 2
     head shard; gamma and beta in bf16 and in f32, two calls bitwise
     equal), K5
     at the level-1, level-2 and mid bank-concat and level-0 audio
     self-attention shapes (every K5 shape timed against SDPA's backward);
     K1 (no LSE), K2 and K3 at pose2img's level 0 (2 rows of 4096 tokens),
     K1 with LSE, K2, K3 and K5 at the image pretrain's (4 rows of 1024:
     the denoiser's self keys + bank with kv_lens, the ReferenceNet's own
     self-attention); two K5 calls on the same inputs must be bitwise
     equal;
  3. gradients: the autograd Functions of K1-K4 on the card against
     autograd through their plain versions, at small shapes;
  4. main: Pose2VideoPipeline at full SD1.5 width, 512x512, 16 frames (two
     12-frame windows overlapping by 4), 3 DDIM steps, guidance 3.5, seeded
     random weights and inputs; the frames must be finite and every
     inference kernel's launch counter (K1-K4) must have risen during this
     phase, K5's not; launches per denoise step are the pipeline's own
     denoise-phase count / STEPS;
  5. small: a tiny pipeline (64x64, 8 frames, 2 steps, CFG) with one set of
     weights run three ways: f32 on the CPU (the reference), bf16 on the
     CPU (plain versions) and bf16 on the card (kernels); the card's mean
     error against the reference must stay within SMALL_ERR_FACTOR x the
     plain bf16 error, for the latents and the decoded frames;
  6. a2v: Audio2VideoPipeline.build at full width (Stage 2 and CLIP
     ViT-L/14 in bf16; wav2vec2-base, WavLM Large and the SMGA decoder in
     f32; seeded random weights) on a synthetic 4.0 s 16 kHz clip and a
     512x512 portrait: 80 frames, 3 Stage-2 DDIM steps, 50 Stage-1 steps,
     motion selection over 3 candidates; finite (80, 512, 512, 3) frames
     and finite keypoints, K1-K4 launched (K5 not), K2 launched in the
     audio encoding (wav2vec2 conv 0); the seconds, peak memory and
     launches of each phase. Every launch's signature (shapes, strides,
     dtypes, arguments) is recorded, and each distinct one replayed on
     seeded random inputs: the kernel over the whole tensor against its
     plain version on the first, middle and last batch rows (K3: row
     chunks), at the kernels phase's tolerances (Stage 2 carries 120 frame
     rows a UNet call here, against main's 48), with each one's time and
     bound and their sums over the call;
  7. a2v_small: a tiny audio2vid (64x64, 8 frames) with one set of
     weights and draws, three ways as in 5; the keypoints and the frames
     on the card within SMALL_ERR_FACTOR x the plain error against CPU
     f32;
  7a. bench: `bench_torch.py` (the counterpart of bench.py) in a process
     of its own at a cut depth (BENCH_ARGS: 16 frames, 2 DDIM steps, the
     fast and dpm rows at 2 steps, the long row at 48 frames, 5 Stage-1
     steps; the train row's first step and 2 timed ones) with --trace:
     exit 0, its result line parsed with every row's seconds, one trace
     line a row, K1-K4 launched in the flagship row (its launches by
     phase, counted from 0 in the call) and each in that row's traced
     device table, K5 in the train row's step and table; every launch
     signature of both processes recorded and replayed as in 6;
  7b. long240: the audio2vid of 6 on a LONG_SECONDS (9.6 s) clip: 3
     chained Stage-1 slices with motion selection over 3 candidates, 240
     frames, 30 context windows fused each Stage-2 step (the JAX bench's
     long240 row): finite (240, 512, 512, 3) frames and (240, 402)
     keypoints, the seam check of tests/test_long_video.py (the per-frame
     L1 step at frames 80 and 160 at most SEAM_FACTOR x the median step +
     1e-3), K1-K4 launched (K5 not), K2 in the audio encoding (wav2vec2's
     conv 0 at (1, 30719, 512) f32); the seconds, launches and peak memory
     of each phase;
  8. dpm: Pose2VideoPipeline as in 4 with DPM-Solver++(2M) from
     `make_scheduler` at DPM_STEPS (15) steps: finite frames, K1-K4
     launched (K5 not), the seconds per phase and the peak memory;
  9. dpm_small: the small pipeline of 5 sampling with DPM++ (4 steps),
     three ways as in 5, on the latents and the frames;
 10. pose2img: Pose2ImagePipeline at full width (a denoiser without audio
     or motion modules), one 512x512 image, 20 DDIM steps: a finite image
     in [0, 1], K1-K3 launched (K4 and K5 not); then pose2img_small, a
     tiny one three ways;
 11. lmks2vid: Lmks2VideoPipeline at full width (main's pipeline and two
     guiders), 16 frames, STEPS steps: finite frames, K1-K4 launched; then
     lmks2vid_small, a tiny one three ways;
 11b. fewstep: the few-step quality tool's `main`
     (`python -m mmgt_tpu_torch.tools.fewstep_quality`) in this process:
     full width, 512^2, 16 frames, DDIM-200 as the ground truth against
     DDIM-25/15 and DPM++-25/15/12 (relative latent error, PSNR, SSIM,
     flicker, CLIP drift, seconds): every row finite, each sampler's error
     falling as its steps rise, DPM++-15 below DDIM-15; K1-K4 launched;
 12. weights: a reference-layout weights directory written in fp16 from
     seeded full-width port modules by the synth_weights tool
     (`mmgt_tpu_torch/tools/synth_weights.py`; net-*.pth with the Net wrapper's
     prefixes, the SD VAE, an SMGA checkpoint with EMA weights, `module.`
     and packed q/k/v, CLIP, wav2vec2 and WavLM with weight-normed
     positional convs, WavLM in its {"model", "cfg"} wrapper), after a
     free-space check, loaded onto the card by `load_all_weights`: every
     tensor equal to what was written cast to its dtype, no model
     random-filled; the bytes and the write and load seconds; wav2vec2's
     embeddings with bf16 values against fp16 values; then the pose2vid
     CLI's `run` on the loaded pipeline (16 frames, STEPS steps): finite
     frames, K1-K4 launched; then the video and image training CLIs'
     `build` with the directory: their models equal to the loaded ones,
     a CLIP model returned.
     The directory stays for 12b, 12c and 12d;
 12b. preprocess: the preprocessing path at the published widths, f32
     with TF32 off: YOLOX-L and RTMPose-L (DW-LL) with seeded weights and
     BN statistics (the objectness head damped, PRE_OBJ_BIAS) as
     `DWPoseDetector.from_modules` over a PRE_FRAMES-frame 512^2 clip,
     one frame at a time: (134, 3) finite keypoints a frame, ms a frame
     for the detector, the pose net and the host pre/post, peak memory;
     one frame on the card against the CPU (raw (1, 8400, 85) and SimCC
     within PRE_REL_TOL of their largest |y|, the SimCC argmax equal
     where its top-two margin exceeds that); both nets exported to ONNX
     (torch's TorchScript exporter) into the weights directory's DWPose/,
     run through the port's OnnxRunner against the modules (F32_REL_TOL)
     and `DWPoseDetector.from_onnx` against the module-built detector,
     and loaded back by `load_dwpose_weights` bitwise; a TFC-TDF
     separator at Kim_Vocal_2's input geometry (1, 4, 3072, 256),
     exported as the directory's Kim_Vocal_2.onnx, through
     `MDXVocalSeparator` on a PRE_SEP_SECONDS clip, card against CPU;
     `EmbeddingNet` at (80, 402), card against CPU; the prepare_stage1
     CLI with the directory's WavLM checkpoint and prepare_stage2
     --from_keypoints on PRE_CLIPS clips; none of K1-K5 launched;
 12c. release: `python -m mmgt_tpu_torch.tools.release_check` on that
     directory in a process of its own, at its defaults (verify_weights,
     then audio2vid at 512^2, 80 frames, DPM++ 15 steps, and its mp4):
     exit 0, every stage ok, a non-empty mp4, K1-K4 launched (its
     report's counts); the stage seconds;
 12d. verify_weights: the verify CLI with --forward on that directory:
     all 13 entries [ok], 12 nets run on the card; then it is removed.
     Phases 7b, 8, 10, 11, 11b, 12's CLI run and 12d record their
     launches and replay each signature not replayed before, as 6 does;
 13. train: Stage2Trainer at full width, 512x512, 12 frames, batch 1,
     remat, TRAIN_STEPS steps on a seeded random batch: finite losses, the
     f32 masters of every trainable tensor moved, every frozen tensor
     bitwise unchanged, K5 launched EXPECTED_K5_PER_STEP times in every
     step and K1-K4 at least once (the counts include the checkpointed
     recompute), the seconds of the steps after the first and the peak
     memory; then train_cli: 2 more steps through the video CLI's `run`
     (`scripts/train_stage2.py`) on a synthetic TalkingVideoDataset, ending
     in its checkpoint, every launch signature (K5's included) replayed;
 14. train_small: a tiny trainer (the small pipeline's sizes, no remat) with
     one set of weights and draws, three ways as in 5; the loss and the
     flattened trainable gradients against CPU f32, the card's mean error
     within SMALL_ERR_FACTOR x the plain bf16 error;
 15. train_image: the Stage-2 image pretrain (`Stage2ImageTrainer`, the
     ReferenceNet trained through the bank) at full width through the
     image CLI's `run` (`scripts/train_stage2_image.py`): 256^2, batch 4,
     TRAIN_IMAGE_STEPS steps on a synthetic HumanDanceDataset, a seeded
     full-width CLIP: finite losses, every f32 master moved (the
     ReferenceNet's among them), every frozen tensor (the VAE, the
     ReferenceNet's up_blocks.3) bitwise unchanged, K1, K2, K3 and K5
     launched in every step (K5 EXPECTED_K5_PER_IMAGE_STEP times) and K4
     not; seconds per step, peak memory, launches per step; every launch
     signature replayed; the run's last checkpoint restored into a fresh
     state (every tensor bitwise equal) and one more step from it;
 16. train_image_small: a tiny image trainer three ways as in 14, the
     ReferenceNet's gradients compared on their own too;
 17. train_a2p: the SMGA trainer at the reference's widths, f32, batch
     A2P_BATCH, A2P_STEPS steps through the Stage-1 CLI's `run`
     (`scripts/train_a2p.py`) on a synthetic GestureDataset: finite
     losses, the EMA equal to d ema + (1 - d) params after each step, no
     kernel launched (its attention is 80 tokens, plain math); then one
     more step on the card against the same step on the CPU in f32
     (A2P_LOSS_TOL, A2P_GRAD_TOL).
 17b. soak: JAX's overfit tests (tests/test_training_soak.py) at full
     width. `Stage2Trainer.build(bf16, remat=True)` at SOAK_SIZE^2 (256;
     the resolution is the cut), 12 frames, batch 1, SOAK_STEPS (52) steps
     on one fixed jittered batch with 4 fixed (t, noise) draws in turn, lr
     2e-4, CFG dropout and noise offset off: every loss finite, each
     draw's loss lower at its last step than at its first, K5 launched in
     every step; the mean drop printed beside JAX's tiny-width 20 % (a
     prediction, not a gate); its launch signatures replayed. Then SMGA at
     the reference's widths, f32, batch 1, SMGA_SOAK_STEPS (120) steps, lr
     3e-4, no condition dropout, 4 fixed draws: the mean loss of the last 4
     steps below 1 / SMGA_SOAK_DROP of the first 4's, no kernel launched;
 18. mesh: the distributed layer (`mmgt_tpu_torch/parallel/`) on the one
     card. Single-process references first: main's pipeline call, the same
     call at one window a UNet call, and one full-width video train step
     (12 frames, batch 1, remat). Then MESH_WORLD (2) ranks spawned on
     cuda:0, gloo over CUDA tensors, a `file://` store in the temporary
     directory: main's pipeline call at (dp = 2, tp = 1), the windows split
     over the ranks, and at (dp = 1, tp = 2), K1/K3/K4 on 4 local heads;
     the frames of every rank within max(MESH_FRAME_FLOOR, 1.5 x the
     difference of the single-process runs at 2 and at 1 window a call)
     (mean |diff|) of the single-process frames, dp = 2's also of the
     one-window run, and bitwise equal across ranks; the latents after
     the first step likewise, within MESH_LATENT_FACTOR x that
     difference there; the small pipeline
     of 5 on each mesh, within SMALL_ERR_FACTOR x the plain bf16 error of
     the CPU f32 reference; then the train
     step at (dp = 1, tp = 2), K5 on the local heads: the loss within
     MESH_LOSS_RTOL, the clipped gradients within MESH_GRAD_RTOL (relative
     L2), every f32 master within MESH_MASTER_LR x lr of the single-process
     step. Each part's launches (counts set to 0 just
     before, read just after), seconds, peak memory per rank and
     all_reduce calls, bytes and seconds (through the host: nothing of
     NCCL between cards); every launch signature replayed as in 6. Then
     the video CLI's main at world 1 as torchrun starts it: an NCCL
     process group, one full-width step and its checkpoint. A failing
     rank fails the phase;
 19. mfu: the FLOP audit (`mmgt_tpu_torch/tools/mfu_audit.py`): one
     flagship denoise group through the full-width denoiser (MFU_MB = 5
     windows x CFG = 10 rows of MFU_FRAMES = 12 frames, 512^2, bf16),
     K1-K4 launched (counts set to 0 just before, read just after), its
     output finite, timed over MFU_ITERS calls, and one window's call (2
     rows) timed for 20; then the tool's counts over fake tensors (the
     group, main's 16-frame step, the 80-frame step, a VAE frame, an SMGA
     step): counted, executed by K1-K4's tiles, the JAX bench's closed
     form, and each one's utilization of 989 TFLOP/s at the group's time,
     main's step time and the a2v call's step time;
 20. budget: the n-card budget (`mmgt_tpu_torch/tools/budget_8chip.py`):
     its single-process reference, then 8 gloo ranks on cuda:0 at (dp 8,
     tp 1), full width, bf16, 32 frames of 128^2 in 8 windows (one a
     rank): each rank's shard shape at the denoiser's conv_in, the step's
     all_reduce calls and bytes equal to the gather's closed form, every
     rank's latents bitwise equal to the reference, K1-K4 launched on
     every rank, each rank's peak memory; every signature replayed as in
     6; the budget (its n-card figures projections) from 6's timings and
     19's window time.
Launch signatures are recorded by wrapping each kernel module's launch
function, K5's `_launch_bwd` included; a K5 signature is replayed with
o and lse from the plain forward on its seeded inputs, at 4 bf16 ulps.
Then the `kernels` JSON line, the card line, and the result line.

    python3 chip_smoke.py profile    # build, then profile a denoise step
                                     # and the train steps

profiles one full-width denoise step, the VAE decode chunk (8 frames,
64^2 latents to 512^2), one full-width train step, one image-pretrain
step and one SMGA step instead (device time by kernel family, idle share,
and the GroupNorm calls of each with K2's plans and their bytes bound)
and prints no `kernels` line.

    python3 chip_smoke.py mesh       # build, then phase 18 alone

runs the mesh phase and its replays only, and prints no `kernels` line.

    python3 chip_smoke.py mfu        # build, main, then phase 19
    python3 chip_smoke.py budget     # build, the a2v call, a window's
                                     # time, then phase 20

run main (for its step time) or the a2v call (for its timings) first,
then their phase and its replays only, and print no `kernels` line.

    python3 chip_smoke.py bench      # build, then phase 7a alone

The profile mode and the bench phase trace through
`mmgt_tpu_torch/utils/profiling.py` and read the trace with
`mmgt_tpu_torch/utils/device_trace.py`.
This script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

STEPS = 3
FRAMES = 16
SIZE = 512
GUIDANCE = 3.5
SEED = 0
PEAK_FLOPS = 989e12  # H100 SXM dense bf16
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# the small pipeline's card error may reach this multiple of plain bf16's
# (chip readings so far: 1.08x on the latents, 1.15x on the frames)
SMALL_ERR_FACTOR = 1.5
# an f32 kernel output against its f32 plain version (another summation
# order), relative to the largest output magnitude
F32_REL_TOL = 1e-4
# audio2vid: a 4.0 s clip (two 3.2 s slices), 80 frames, 50 Stage-1 steps
A2V_SR = 16000
A2V_SECONDS = 4.0
A2V_FRAMES = 80
A2V_STAGE1_STEPS = 50
A2V_KP_FLOOR = 1e-5
A2V_ROW_CHUNK = 4096  # K3 rows held against the plain version per chunk
TRAIN_STEPS = 3
TRAIN_FRAMES = 12
DPM_STEPS = 15  # the JAX bench's dpm15 row
POSE2IMG_STEPS = 20  # Pose2ImagePipeline's default
# the denoiser's 16 bank self-attentions less down_0_attn_0 (nothing
# upstream of it is trained), plus the 6 self-attentions of the trained
# audio blocks
EXPECTED_K5_PER_STEP = 21
# the image pretrain (reference config/train/stage1.yaml): 256^2, batch 4
TRAIN_IMAGE_STEPS = 3
TRAIN_IMAGE_SIZE = 256
IMAGE_TRAIN_KERNELS = ("flash_attention", "group_norm", "ln_projections", "flash_attention_bwd")
# the denoiser's 16 self-attentions (all trained) and 15 of the ReferenceNet's
# 16 (its up_blocks.3.attentions.2 only feeds the discarded output sample)
EXPECTED_K5_PER_IMAGE_STEP = 31
# preprocessing: the DWPose clip (one frame at a time, as the reference runs
# it), the prepare_stage2 clips, the separator's clip
PRE_FRAMES = 16
PRE_CLIPS = 3
PRE_SEP_SECONDS = 4.0
# the seeded YOLOX's objectness: random weights accept 500-1,700 boxes of
# overflowing size a frame (one pose crop each); with the objectness
# weights scaled by 1e-4 and the bias at -20 (-20.5, -21 on the coarser
# levels) none passes and the pose net takes the full-frame box, one crop
# a frame, as a one-speaker clip gives
PRE_OBJ_BIAS = -20.0
# f32 on the card (cuDNN's algorithms, TF32 off) against the CPU through
# ~100 layers, relative to the largest output magnitude
PRE_REL_TOL = 1e-3
# from_onnx against the module-built detector, both on the card: keypoint
# coordinates in pixels; 3 of 134 may differ more (a SimCC argmax between
# bins equal to rounding may flip)
PRE_KP_TOL = 1e-2
# long240: a 9.6 s clip, 3 chained Stage-1 slices, 240 frames (the JAX
# bench's long240 row); the seam check of tests/test_long_video.py
LONG_SECONDS = 9.6
LONG_FRAMES = 240
SEAM_FACTOR = 5.0
# soak: JAX's overfit tests (tests/test_training_soak.py) at full width;
# Stage 2 at 256^2 (the resolution is the cut, the widths are kept)
SOAK_SIZE = 256
SOAK_STEPS = 52
SOAK_LR = 2e-4
SOAK_DROP_PREDICTED = 0.20    # JAX's tiny-width criterion, printed, not a gate
SMGA_SOAK_STEPS = 120
SMGA_SOAK_LR = 3e-4
SMGA_SOAK_DROP = 4.0          # the SMGA loss falls by more than this factor
# SMGA training at the reference's batch; the card-vs-CPU step on fewer rows
A2P_BATCH = 128
A2P_STEPS = 3
A2P_CPU_ROWS = 32
# f32 on both sides, TF32 off; sums in another order through 8 layers and
# their backward: the loss relative, the gradients against the largest |g|
A2P_LOSS_TOL = 1e-5
A2P_GRAD_TOL = 1e-4


def log(*a):
    print(*a, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()
    return out[0]


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float):
    t_ops, t_bytes = flops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes else "bytes")


def nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts if t is not None)


def max_err(a, b) -> float:
    return (a.float() - b.float()).abs().max().item()


def ulp_tol(want, ulps: int = 2) -> float:
    """`ulps` bf16 units in the last place at the largest output magnitude:
    both sides round an f32 result to bf16, and a different f32 summation
    order may flip that rounding."""
    return ulps * 2.0 ** -7 * want.float().abs().max().item()


def require(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


# ---------------------------------------------------------------- kernels
def time_row(fn, plain, lib, flops, nb, shape, plain_iters=3):
    """Kernel, plain and library times and the bound of one call."""
    ms = time_ms(fn)
    plain_ms = time_ms(plain, iters=plain_iters, warmup=1)
    lib_ms = None if lib is None else time_ms(lib)
    bms, by = bound_ms(flops, nb)
    return dict(ms=ms, plain_ms=plain_ms, library_ms=lib_ms, bound_ms=bms, bound_by=by,
                shape=shape)


def check_k1(torch, A):
    """K1 against its plain version at every row of `tools/k1_rows.ROWS`
    (its d <= 160 rows and the f32 route) and at the d = 512 path's shapes;
    every timed row with its bound and SDPA."""
    from mmgt_tpu_torch.tools.k1_rows import ROWS, case

    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    tol_lse = 1e-3
    rec, rows = None, {}
    for row in ROWS:
        name, lse, f32 = f"{row[0]} {row[1]}", row[9], row[10]
        cs = case(torch, A, row, g)
        before = A.LAUNCHES
        got, want = cs["fn"](), cs["plain"]()
        require(A.LAUNCHES == before + 1, f"K1 {name}: the call did not launch K1")
        if lse:
            (got, got_lse), (want, want_lse) = got, want
            e_lse = max_err(got_lse, want_lse)
            require(e_lse <= tol_lse, f"K1 {name}: lse err {e_lse} > {tol_lse}")
        # the f32 route's error is the inputs' bf16 rounding, against the f32 plain version
        err, tol = max_err(got, want), ulp_tol(want)
        log(f"K1 {name}: max_abs_err {err:.3e} (tol {tol:.3e}, 2 bf16 ulps)")
        require(math.isfinite(err) and err <= tol, f"K1 {name}: err {err} > {tol}")
        row_ = time_row(cs["fn"], cs["plain"], cs["lib"], cs["flops"],
                        nbytes(*cs["inputs"], got, got_lse if lse else None),
                        f"{name}: {cs['label']}")
        row_["max_abs_err"] = err
        rows[name] = row_
        if rec is None:  # the hottest shape: the denoiser's level-0 bank attention
            rec = dict(row_, rows=rows)
        del cs, got, want
    cases = [  # (name, batch, q seq, self kv seq, heads, d, bank, kv_lens, lse, timed as)
        ("L3 bank", 2, 64, 64, 8, 160, True, [64, 128], False, None),
        ("VAE mid d=512", 1, 4096, 4096, 1, 512, False, None, False, "_flash_attention"),
        # the VAE's mid attention on the main path's decode (one 8-frame
        # chunk a launch) and the video train step's 12-frame encode
        ("VAE decode chunk d=512", 8, 4096, 4096, 1, 512, False, None, False,
         "VAE decode chunk (8, 4096, 1, 512)"),
        ("VAE train encode d=512", 12, 4096, 4096, 1, 512, False, None, False,
         "VAE train encode (12, 4096, 1, 512)"),
        # 160 < d < 512 runs the d = 512 path, the columns past d zero-filled;
        # both rows split their keys over blocks
        ("d=192 bank, key split", 2, 300, 300, 2, 192, True, [202, 400], True, None),
        ("d=264, key split", 2, 300, 300, 2, 264, False, None, False, None),
    ]
    for name, b, s, skv, h, d, bank, lens, lse, timed in cases:
        q, k, v = rnd(b, s, h, d), rnd(b, skv, h, d), rnd(b, skv, h, d)
        kb = rnd(1, s, h, d) if bank else None
        vb = rnd(1, s, h, d) if bank else None
        kl = torch.tensor(lens, dtype=torch.int32, device=dev) if lens else None
        got = A.flash_attention(q, k, v, kl, kb, vb, return_lse=lse)
        want = A.attention_plain(q, k, v, kl, kb, vb, return_lse=lse)
        if lse:
            (got, got_lse), (want, want_lse) = got, want
            e_lse = max_err(got_lse, want_lse)
            require(e_lse <= tol_lse, f"K1 {name}: lse err {e_lse} > {tol_lse}")
        err, tol = max_err(got, want), ulp_tol(want)
        log(f"K1 {name}: max_abs_err {err:.3e} (tol {tol:.3e}, 2 bf16 ulps)")
        require(math.isfinite(err) and err <= tol, f"K1 {name}: err {err} > {tol}")
        if d > 160:
            splits = A.wide_splits(b, h, s, skv + (s if bank else 0),
                                   torch.cuda.get_device_properties(0).multi_processor_count)
            require(d == 512 or splits > 1, f"K1 {name}: no key split")
        if d > 160 and not lse:  # the d > 160 path's LSE (and its key split's combine)
            _, got_lse = A.flash_attention(q, k, v, kl, kb, vb, return_lse=True)
            _, want_lse = A.attention_plain(q, k, v, kl, kb, vb, return_lse=True)
            e_lse = max_err(got_lse, want_lse)
            require(e_lse <= tol_lse, f"K1 {name}: lse err {e_lse} > {tol_lse}")
        if timed is None:
            continue
        kc = k if kb is None else torch.cat([k, kb.expand(b, -1, -1, -1)], 1)
        vc = v if vb is None else torch.cat([v, vb.expand(b, -1, -1, -1)], 1)
        qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        row = time_row(
            lambda: A.flash_attention(q, k, v, kl, kb, vb, return_lse=lse),
            lambda: A.attention_plain(q, k, v, kl, kb, vb, return_lse=lse),
            lambda: sdpa(qt, kt, vt), 4.0 * h * d * s * b * kc.shape[1],
            nbytes(q, k, v, kb, vb, got, got_lse if lse else None),
            f"{name}: q {tuple(q.shape)}, K/V {tuple(kc.shape)}")
        row["max_abs_err"] = err
        # the key split's worth: the same call in one split
        splits = A.wide_splits(b, h, s, skv, torch.cuda.get_device_properties(0)
                               .multi_processor_count)
        keep, A.wide_splits = A.wide_splits, lambda *a: 1
        try:
            row["ms_one_split"] = time_ms(
                lambda: A.flash_attention(q, k, v, kl, kb, vb, return_lse=lse))
        finally:
            A.wide_splits = keep
        row["key_splits"] = splits
        log(f"K1 {name}: {splits} key split(s) {row['ms']:.4f} ms, one split "
            f"{row['ms_one_split']:.4f} ms")
        rows[timed] = row
    return rec


def check_k2(torch, N):
    """K2 against its plain version in both regimes; each timed row with
    its plan (regime, cluster size or splits, slab bytes), bound and the
    library pair F.group_norm (+ F.silu) on the (N, C, L) view."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    F = torch.nn.functional
    rec, rows, errs = None, {}, []
    bf, f32 = torch.bfloat16, torch.float32
    for name, shape, groups, act, dtype, timed in [
        ("UNet L0 (48 rows)", (48, 4096, 320), 32, "silu", bf, "_group_norm_pallas"),
        ("UNet L3 no act", (48, 64, 1280), 32, None, bf, None),
        ("UNet L2 (resident, 48 rows)", (48, 256, 1280), 32, "silu", bf, "L2 (48, 256, 1280)"),
        ("UNet up-block concat L0 (streaming)", (48, 4096, 960), 32, "silu", bf,
         "up concat (48, 4096, 960)"),
        ("VAE decoder row", (8, 512 * 512, 128), 32, "silu", bf, "_group_norm_pallas_blocked"),
        # wav2vec2's conv 0 on a 4 s clip: 512 groups of one channel, f32
        ("wav2vec2 conv_0 (512 groups of 1, f32)", (1, 12799, 512), 512, None, f32,
         "wav2vec2 conv_0 (1, 12799, 512) f32"),
        # a plan that once asked for 233,488 bytes of shared memory (k = 16)
        ("768 groups of 1, f32 (formerly over the limit)", (1, 64, 768), 768, None, f32,
         "(1, 64, 768) f32, 768 groups"),
        ("pose2img L0 (2 rows)", (2, 4096, 320), 32, "silu", bf, "pose2img L0 (2, 4096, 320)"),
        ("train_image L0 (4 rows)", (4, 1024, 320), 32, "silu", bf,
         "train_image L0 (4, 1024, 320)"),
    ]:
        c = shape[-1]
        plan = N.gn_plan(*shape, groups, dtype)
        require(plan["smem"] <= N.SMEM_LIMIT, f"K2 {name}: plan over the shared-memory limit")
        plan_s = (f"{plan['regime']}, " + (f"k = {plan['k']} CTAs a cluster, slab "
                                          f"{plan['slab']} B, smem {plan['smem']} B"
                                          if plan["regime"] == "resident" else
                                          f"{plan['k']} splits of {plan['rows']} rows")
                  + f", {plan['threads']} threads")
        log(f"K2 {name}: x {shape}, plan: {plan_s}")
        # every group its own mean and every channel its own scale, so a
        # channel read into the wrong group's statistics is off by O(1)
        ch = torch.arange(c, device=dev)
        x = (torch.randn(*shape, generator=g, device=dev) * (1 + ch / c)
             + 3.0 * (ch // (c // groups))).to(dtype)
        w = torch.randn(c, generator=g, device=dev).to(dtype)
        b = torch.randn(c, generator=g, device=dev).to(dtype)
        got = N.group_norm(x, groups, w, b, 1e-6, act)
        want = N.group_norm_plain(x, groups, w, b, 1e-6, act)
        # f32: both sides keep f32 statistics, summed in another order
        err = max_err(got, want)
        tol, how = ((ulp_tol(want), "2 bf16 ulps") if dtype == bf else
                    (F32_REL_TOL * want.abs().max().item(), f"{F32_REL_TOL:g} of the largest |y|"))
        log(f"K2 {name}: max_abs_err {err:.3e} (tol {tol:.3e}, {how})")
        require(math.isfinite(err) and err <= tol, f"K2 {name}: err {err} > {tol}")
        errs.append(err)
        if timed is None:
            continue
        xt = x.transpose(1, 2)
        lib = (lambda: F.silu(F.group_norm(xt, groups, w, b, 1e-6))) if act else \
            (lambda: F.group_norm(xt, groups, w, b, 1e-6))
        row = time_row(
            lambda: N.group_norm(x, groups, w, b, 1e-6, act),
            lambda: N.group_norm_plain(x, groups, w, b, 1e-6, act),
            lib, 10.0 * x.numel(), nbytes(x, w, b, got), f"{name}: x {shape}; {plan_s}")
        row["max_abs_err"] = err
        rows[timed] = row
        if rec is None:
            rec = dict(row, rows=rows)
        del x, got, want
        torch.cuda.empty_cache()
    rec["max_abs_err"] = max(errs)
    return rec


def check_k3(torch, L):
    """K3 against its plain version at every row of `tools/k3_rows.ROWS`,
    with gamma, beta and the biases in bf16 (as the model holds them) and
    in f32; two calls bitwise equal in both regimes; every row timed with
    its bound and the library call (F.linear of F.layer_norm, or
    torch.addmm for K4's W_o rows), with the plan's regime, and the host's
    microseconds a call (the wrapper, its C entry, the bare ctypes call)."""
    from mmgt_tpu_torch.ops import _build
    from mmgt_tpu_torch.tools.k3_rows import ROWS, case, host_breakdown

    g = torch.Generator(device="cuda").manual_seed(SEED + 2)
    rec, rows, host = None, {}, {}
    for row in ROWS:
        name = f"{row[0]} {row[1]}"
        cs = case(torch, L, row, g)
        fn = cs["fn"]
        got, want = fn(), cs["plain"]()
        err = max(max_err(a, b_) for a, b_ in zip(got, want))
        tol = max(ulp_tol(w_) for w_ in want)
        plan = L.gemm_plan(cs["m"], cs["k"], cs["ns"])
        log(f"K3 {name}: max_abs_err {err:.3e} (tol {tol:.3e}, 2 bf16 ulps), {plan['regime']}")
        require(math.isfinite(err) and err <= tol, f"K3 {name}: err {err} > {tol}")
        again = fn()
        require(all(torch.equal(a, b_) for a, b_ in zip(got, again)),
                f"K3 {name}: two calls differ")
        del again
        f32, want32 = cs["fn_f32"](), cs["plain_f32"]()
        err32 = max(max_err(a, b_) for a, b_ in zip(f32, want32))
        tol32 = max(ulp_tol(w_) for w_ in want32)
        require(math.isfinite(err32) and err32 <= tol32,
                f"K3 {name}, f32 gamma/beta/bias: err {err32} > {tol32}")
        del f32, want32
        row = time_row(fn, cs["plain"], cs["lib"], cs["flops"], cs["in_bytes"] + nbytes(*got),
                       f"{name}: {cs['label']}; {plan['regime']}")
        row["max_abs_err"] = err
        rows[name] = row
        host[name] = {k: round(v, 1) for k, v in host_breakdown(torch, _build, fn).items()}
        if rec is None:
            rec = dict(row, rows=rows)
        del cs, fn, got, want
        torch.cuda.empty_cache()
    log("K3 host us a call (the wrapper, its C entry, the bare ctypes call): "
        + json.dumps(host))
    return rec


def check_k4(torch, M):
    """K4 against its plain version at every row of `tools/k4_rows.ROWS`
    (levels 0-3 and the mid block, a tp = 2 head shard), with gamma and
    beta in bf16 (as the model holds them) and in f32; two calls bitwise
    equal; every row timed with its bound (no single PyTorch call computes
    the function)."""
    from mmgt_tpu_torch.tools.k4_rows import ROWS, case

    g = torch.Generator(device="cuda").manual_seed(SEED + 3)
    rec, rows = None, {}
    for row in ROWS:
        name = f"{row[0]} {row[1]}"
        cs = case(torch, M, row, g)
        got, want = cs["fn"](), cs["plain"]()
        err, tol = max_err(got, want), ulp_tol(want)
        b, f, l, c = row[2]
        plan = M.attn_plan(f, l, c, row[3], c // row[4], b)
        log(f"K4 {name}: max_abs_err {err:.3e} (tol {tol:.3e}, 2 bf16 ulps), "
            f"{plan['regime']} regime")
        require(math.isfinite(err) and err <= tol, f"K4 {name}: err {err} > {tol}")
        require(torch.equal(got, cs["fn"]()), f"K4 {name}: two calls differ")
        del want
        got32, want32 = cs["fn_f32"](), cs["plain_f32"]()
        err32, tol32 = max_err(got32, want32), ulp_tol(want32)
        require(math.isfinite(err32) and err32 <= tol32,
                f"K4 {name}, f32 gamma/beta: err {err32} > {tol32}")
        del got32, want32
        row_ = time_row(cs["fn"], cs["plain"], None, cs["flops"], cs["in_bytes"] + nbytes(got),
                        f"{name}: {cs['label']}")
        row_["max_abs_err"] = err
        rows[name] = row_
        if rec is None:
            rec = dict(row_, rows=rows)
        del cs, got
        torch.cuda.empty_cache()
    return rec


def check_k5(torch, A):
    """K5 against `attention_bwd_plain` (2 rows per shape: at full batch the
    plain version's f32 P alone would take ~13 GB). Tolerance: 4 bf16 ulps
    at the largest |value| of each of dq, dk, dv: dk/dv sum thousands of
    queries in another order than the plain version, and P and dS are
    rounded to bf16 as product operands. Two calls on the same inputs must
    be bitwise equal. Every shape timed (the level-0, -1, -2 and mid
    bank-concat shapes, the level-0 audio self-attention, the image step's
    and the tp = 2 shard's); the library time is SDPA's forward + backward
    less its forward."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec, rows = None, {}
    for name, b, sq, skv, h, d, lens, timed in [  # (name, batch, q seq, kv seq, heads, d, kv_lens)
        ("L0 bank concat", 2, 4096, 8192, 8, 40, [4096, 8192], True),
        ("L1 bank concat", 2, 1024, 2048, 8, 80, [1024, 2048], True),
        ("L2 bank concat", 2, 256, 512, 8, 160, [256, 512], True),
        ("mid bank concat", 2, 64, 128, 8, 160, [64, 128], True),
        ("L0 audio self-attention", 2, 4096, 4096, 8, 40, None, True),
        ("train_image L0 concat", 4, 1024, 2048, 8, 40, [1024, 2048, 2048, 2048], True),
        ("train_image ReferenceNet self-attention", 4, 1024, 1024, 8, 40, None, True),
        ("tp2 L0 bank concat, 4 heads", 2, 4096, 8192, 4, 40, [4096, 8192], True),
    ]:
        q, k, v, do = rnd(b, sq, h, d), rnd(b, skv, h, d), rnd(b, skv, h, d), rnd(b, sq, h, d)
        kl = torch.tensor(lens, dtype=torch.int32, device=dev) if lens else None
        o, lse = A.flash_attention(q, k, v, kl, return_lse=True)
        got = A.flash_attention_bwd(q, k, v, o, do, lse, kl)
        again = A.flash_attention_bwd(q, k, v, o, do, lse, kl)
        require(all(torch.equal(x, y) for x, y in zip(got, again)),
                f"K5 {name}: two calls on the same inputs differ")
        del again
        want = A.attention_bwd_plain(q, k, v, o, do, lse, kl)
        err = 0.0
        for gname, gg, ww in zip(("dq", "dk", "dv"), got, want):
            e, tol = max_err(gg, ww), ulp_tol(ww, 4)
            log(f"K5 {name} {gname}: max_abs_err {e:.3e} (tol {tol:.3e}, 4 bf16 ulps)")
            require(math.isfinite(e) and e <= tol, f"K5 {name} {gname}: err {e} > {tol}")
            err = max(err, e)
        log(f"K5 {name}: two calls bitwise equal")
        del want
        if timed:
            qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_(True) for x in (q, k, v))
            dot = do.transpose(1, 2)
            mask = None
            if kl is not None:
                mask = (torch.arange(skv, device=dev)[None, :] < kl[:, None])[:, None, None, :]
            fwd = lambda: sdpa(qt, kt, vt, attn_mask=mask)
            fwd_ms = time_ms(fwd)
            fwd_bwd_ms = time_ms(lambda: torch.autograd.grad(fwd(), (qt, kt, vt), dot))
            valid = sum(lens) if lens else b * skv
            row = time_row(
                lambda: A.flash_attention_bwd(q, k, v, o, do, lse, kl),
                lambda: A.attention_bwd_plain(q, k, v, o, do, lse, kl), None,
                10.0 * h * d * sq * valid, nbytes(q, k, v, o, do, lse, *got),
                f"{name}: q {tuple(q.shape)}, K/V {tuple(k.shape)}, kv_lens {lens}",
                plain_iters=2)
            row.update(max_abs_err=err, library_ms=fwd_bwd_ms - fwd_ms)
            log(f"K5 SDPA at {row['shape']}: fwd+bwd {fwd_bwd_ms:.3f} ms, fwd {fwd_ms:.3f} ms")
            rows[name] = row
            if rec is None:  # the hottest shape: level 0 of the denoiser, bank concatenated
                rec = dict(row, rows=rows)
            del qt, kt, vt
        del q, k, v, do, o, lse, got
        torch.cuda.empty_cache()
    return rec


def check_grads(torch, ops, A, N, L, M):
    """Each of K1-K4 through its autograd Function on the card (the forward
    launches the kernel; K1's backward is K5) against autograd through its
    plain version, at small shapes; 4 bf16 ulps at each gradient's largest
    |value|."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 5)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device=dev) * scale).to(
        torch.bfloat16).requires_grad_(True)
    c = 320
    kl = torch.tensor([300, 557], dtype=torch.int32, device=dev)
    ws = [rnd(c, c, scale=1 / math.sqrt(c)) for _ in range(4)]
    pe = M.sinusoidal_positions(32, c, dev)[:12]
    gam, bet = rnd(c, scale=0.1), rnd(c, scale=0.1)
    cases = [  # (name, kernel counters, kernel call, plain call, inputs)
        ("K1 bank + kv_lens (bwd: K5)", ("flash_attention", "flash_attention_bwd"),
         lambda q, k, v, kb, vb: A.flash_attention(q, k, v, kl, kb, vb),
         lambda q, k, v, kb, vb: A.attention_plain(q, k, v, kl, kb, vb),
         [rnd(2, 300, 2, 40), rnd(2, 300, 2, 40), rnd(2, 300, 2, 40), rnd(1, 257, 2, 40),
          rnd(1, 257, 2, 40)]),
        ("K2 GroupNorm + SiLU", ("group_norm",),
         lambda x, w, b: N.group_norm(x, 32, w, b, 1e-6, "silu"),
         lambda x, w, b: N.group_norm_plain(x, 32, w, b, 1e-6, "silu"),
         [rnd(2, 500, c), rnd(c), rnd(c)]),
        ("K3 LN -> 3 projections", ("ln_projections",),
         lambda x, g_, b_, w0, w1, w2: L.ln_projections(x, g_, b_, [w0, w1, w2], [None] * 3),
         lambda x, g_, b_, w0, w1, w2: L.ln_projections_plain(x, g_, b_, [w0, w1, w2],
                                                               [None] * 3),
         [rnd(2, 333, c), gam, bet, *ws[:3]]),
        ("K4 motion attention", ("motion_attention",),
         lambda x, g_, b_, wq, wk, wv, wo, bo: M.motion_attention(x, g_, b_, pe, wq, wk, wv,
                                                                  wo, bo, 8),
         lambda x, g_, b_, wq, wk, wv, wo, bo: M.motion_attention_plain(x, g_, b_, pe, wq, wk,
                                                                        wv, wo, bo, 8),
         [rnd(2, 12, 200, c), gam, bet, *ws, rnd(c, scale=0.1)]),
    ]
    for name, counters, kernel, plain, inputs in cases:
        before = ops.launch_counts()
        outs = kernel(*inputs)
        outs = outs if isinstance(outs, tuple) else (outs,)
        cots = [torch.randn(o.shape, generator=g, device=dev).to(o.dtype) for o in outs]
        got = torch.autograd.grad(outs, inputs, cots)
        torch.cuda.synchronize()
        after = ops.launch_counts()
        for cn in counters:
            require(after[cn] > before[cn], f"{name}: {cn} did not launch")
        want_outs = plain(*inputs)
        want_outs = want_outs if isinstance(want_outs, tuple) else (want_outs,)
        want = torch.autograd.grad(want_outs, inputs, cots)
        errs = []
        for i, (a, b_) in enumerate(zip(got, want)):
            require(a is not None, f"{name}: input {i} has no gradient")
            e, tol = max_err(a, b_), ulp_tol(b_, 4)
            require(math.isfinite(e) and e <= tol, f"{name}: grad {i} err {e} > {tol}")
            errs.append(e / max(tol, 1e-30))
        log(f"grads {name}: {len(got)} gradients, worst err / tol {max(errs):.3f} "
            f"(tol: 4 bf16 ulps of each gradient)")


# ---------------------------------------------------------------- pipeline
def make_inputs(torch, frames: int, size: int, seed: int):
    g = torch.Generator().manual_seed(seed)
    h8 = size // 8
    masks = [tuple((torch.rand(1, frames, (h8 >> lv) ** 2, generator=g) > 0.4).float()
                   for _ in range(3)) for lv in range(3)]
    return dict(
        ref_image=torch.rand(1, size, size, 3, generator=g) * 2 - 1,
        pose_video=torch.rand(1, frames, size, size, 3, generator=g),
        clip_embed=torch.randn(1, 1, 768, generator=g),
        masks=masks,
        audio_embeds=torch.randn(1, frames, 5, 12, 768, generator=g),
    )


def run_main(torch, ops, Pose2VideoPipeline):
    t0 = time.perf_counter()
    pipe = Pose2VideoPipeline.build(torch.bfloat16, device="cuda", seed=SEED,
                                    profile_phases=True)
    torch.cuda.synchronize()
    log(f"main: build + init_params {time.perf_counter() - t0:.1f} s")
    inputs = make_inputs(torch, FRAMES, SIZE, SEED)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    frames = pipe(**inputs, num_inference_steps=STEPS, guidance_scale=GUIDANCE,
                  generator=torch.Generator(device="cuda").manual_seed(SEED))
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    log("main: launches " + json.dumps(counts))
    require(tuple(frames.shape) == (1, FRAMES, SIZE, SIZE, 3), f"frame shape {frames.shape}")
    require(bool(torch.isfinite(frames).all()), "frames are not finite")
    for name, n in counts.items():
        if name in INFERENCE_KERNELS:
            require(n > 0, f"kernel {name} was not launched on the main path")
        else:
            require(n == 0, f"kernel {name} launched under no_grad")
    t = pipe.timings
    log(f"main: prepare_s {t['prepare_s']:.3f} denoise_s {t['denoise_s']:.3f} "
        f"decode_s {t['decode_s']:.3f} max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB "
        f"frames mean {frames.mean().item():.4f} std {frames.std().item():.4f}")
    log("main: launches by phase " + json.dumps(pipe.phase_launches))
    for name, n in counts.items():
        require(sum(ph[name] for ph in pipe.phase_launches.values()) == n,
                f"{name}: the phases' launches do not add up to the run's")
    per_step = {k: n / STEPS for k, n in pipe.phase_launches["denoise"].items()}
    del pipe, frames
    torch.cuda.empty_cache()
    return counts, per_step, t


def run_profile(torch, Pose2VideoPipeline):
    """One full-width denoise step under torch.profiler: device time by
    kernel, the step's wall time (the median of 5 unprofiled steps) and the
    device's idle share. Not part of the default run (`python3
    chip_smoke.py profile`)."""
    from mmgt_tpu_torch.diffusion.solver import init_solver_carry, solver_tables_for
    from mmgt_tpu_torch.pipelines.context import compute_context_schedule

    pipe = Pose2VideoPipeline.build(torch.bfloat16, device="cuda", seed=SEED)
    inputs = make_inputs(torch, FRAMES, SIZE, SEED)
    d = {k: v.cuda() for k, v in inputs.items() if k != "masks"}
    d["masks"] = tuple(tuple(m.cuda() for m in lv) for lv in inputs["masks"])
    cond, lat = pipe._prepare(**d)
    tables = solver_tables_for(pipe.scheduler, STEPS)
    win = compute_context_schedule(STEPS, FRAMES, pipe.context_size, 1, pipe.context_overlap)

    def step():
        pipe._denoise_chunk(lat, init_solver_carry(lat), cond, tables, win[:1], GUIDANCE,
                            (1.0, 1.0, 1.0))
        torch.cuda.synchronize()

    step()
    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        step()
        walls.append((time.perf_counter() - t0) * 1e3)
    wall_ms = sorted(walls)[len(walls) // 2]
    log(f"denoise step wall ms, 5 unprofiled steps: {', '.join(f'{w:.2f}' for w in walls)} "
        f"(median {wall_ms:.2f})")
    report_profile(step, "one denoise step, 2 windows x CFG = 48 frame rows, 512x512", wall_ms)
    report_k2_calls(torch, step)
    report_k3_calls(torch, step)
    del cond
    # the VAE decode chunk (tools/profile_vae.py's subject): 8 frames of
    # 64^2 latents to 512^2
    lat8 = lat[:8].to(torch.bfloat16).contiguous()

    def decode():
        pipe.vae.decode_scaled(lat8)
        torch.cuda.synchronize()

    decode()
    t0 = time.perf_counter()
    decode()
    wall_ms = (time.perf_counter() - t0) * 1e3
    fams = report_profile(decode, "the VAE decode chunk: 8 frames, 64^2 latents -> 512x512",
                          wall_ms)
    log(f"profile: K1 (d = 512, the mid attention) in the VAE decode chunk: "
        f"{fams.get('K1 flash_fwd', 0.0):.3f} device ms of {wall_ms:.1f} ms")
    report_k2_calls(torch, decode)
    del pipe, lat, lat8
    torch.cuda.empty_cache()


def report_profile(fn, what: str, wall_ms: float):
    """fn() once under `utils/profiling.trace`: device time by kernel and
    family from its trace (`utils/device_trace.py`), and the idle share of
    `wall_ms`."""
    from mmgt_tpu_torch.utils import device_trace, profiling

    with tempfile.TemporaryDirectory() as d:
        with profiling.trace(d) as path:
            fn()
        rows = device_trace.device_op_table(path)
    rep = device_trace.report(rows, wall_ms)
    log(json.dumps({"profile": {"what": what, **rep}}))
    return rep["families_ms"]


def small_run(torch, pipe, dev):
    """The small pipeline's run (64x64, 8 frames, windows of 6 overlapping
    by 2, 2 DDIM steps, CFG) from fixed inputs and noise: (latents, frames)
    on the CPU in f32."""
    from mmgt_tpu_torch.diffusion.solver import init_solver_carry, solver_tables_for
    from mmgt_tpu_torch.pipelines.context import compute_context_schedule

    frames, size, steps = 8, 64, 2
    inputs = make_inputs(torch, frames, size, SEED + 7)
    g = torch.Generator().manual_seed(SEED + 8)
    lat0 = torch.randn(frames, size // 8, size // 8, 4, generator=g)
    tables = solver_tables_for(pipe.scheduler, steps)
    win = compute_context_schedule(steps, frames, 6, 1, 2)
    d = {k: v.to(dev) for k, v in inputs.items() if k != "masks"}
    d["masks"] = tuple(tuple(m.to(dev) for m in lv) for lv in inputs["masks"])
    with torch.no_grad():
        cond, _ = pipe._prepare(**d)
        lat = lat0.to(dev)
        lat, _ = pipe._denoise_chunk(lat, init_solver_carry(lat), cond, tables, win,
                                     GUIDANCE, (1.0, 1.0, 1.0))
        return lat.float().cpu(), pipe._decode(lat).float().cpu()


def run_small(torch, Pose2VideoPipeline):
    """Tiny pipeline: card (bf16, kernels) vs CPU (f32, plain versions)."""
    tiny = lambda dev, dtype: tiny_pipeline(torch, Pose2VideoPipeline, dev, dtype)
    ref = tiny("cpu", torch.float32)
    runs = {"cpu_f32": (ref, "cpu"), "cpu_bf16": (tiny("cpu", torch.bfloat16), "cpu"),
            "card_bf16": (tiny("cuda", torch.bfloat16), "cuda")}
    for tag, (pipe, _) in runs.items():  # every copy gets the f32 reference's weights
        if pipe is not ref:
            for name, m in ref.models().items():
                getattr(pipe, name).load_state_dict(m.state_dict())
    outs = {tag: small_run(torch, pipe, dev) for tag, (pipe, dev) in runs.items()}
    errs = {}
    for tag in ("cpu_bf16", "card_bf16"):
        errs[tag] = [(outs[tag][i] - outs["cpu_f32"][i]).abs().mean().item() for i in (0, 1)]
    log(f"small: mean abs err vs CPU f32 (latents, frames): plain bf16 on the CPU "
        f"{errs['cpu_bf16']}, kernels bf16 on the card {errs['card_bf16']} "
        f"(tol: {SMALL_ERR_FACTOR}x the plain bf16 error)")
    for i, what in enumerate(("latents", "frames")):
        require(all(math.isfinite(o[i].abs().max().item()) for o in outs.values()),
                f"small pipeline {what} are not finite")
        require(errs["card_bf16"][i] <= SMALL_ERR_FACTOR * errs["cpu_bf16"][i],
                f"small pipeline {what}: the card's error exceeds {SMALL_ERR_FACTOR}x "
                f"the plain bf16 error")


# ---------------------------------------------------------------- audio2vid
def synth_speech(seconds: float, seed: int):
    """A seeded, speech-like 16 kHz signal: harmonics of a wandering pitch
    under a syllable-rate envelope, plus a little noise."""
    import numpy as np

    rng = np.random.default_rng(seed)
    n = int(seconds * A2V_SR)
    tt = np.arange(n) / A2V_SR
    pitch = 140.0 + 30.0 * np.sin(2 * np.pi * 0.7 * tt)
    phase = 2 * np.pi * np.cumsum(pitch) / A2V_SR
    voice = sum(np.sin(k * phase) / k for k in range(1, 6))
    env = np.clip(np.sin(2 * np.pi * 3.5 * tt + rng.uniform(0, 6)), 0, None) ** 2
    return (0.3 * env * voice + 0.01 * rng.standard_normal(n)).astype(np.float32)


def write_wav(directory: str, seconds: float, seed: int) -> str:
    from mmgt_tpu_torch.data.dsp import save_wav

    path = os.path.join(directory, f"speech_{seed}.wav")
    save_wav(path, synth_speech(seconds, seed), A2V_SR)
    return path


def run_a2v(torch, ops, kernel_mods, tmp: str):
    """audio2vid at full width: Stage 2 and CLIP in bf16, wav2vec2, WavLM and
    SMGA in f32, a 4.0 s clip (two 3.2 s slices, the second zero-padded),
    a 512^2 portrait, 80 frames, 3 Stage-2 steps, 50 Stage-1 steps, motion
    selection over 3 candidates."""
    import numpy as np

    from mmgt_tpu_torch.config import InferenceConfig
    from mmgt_tpu_torch.data.pose_init import portrait_keypoints
    from mmgt_tpu_torch.pipelines.audio2vid import Audio2VideoPipeline

    cfg = InferenceConfig(video_length=A2V_FRAMES, num_inference_steps=STEPS,
                          a2p_sampling_steps=A2V_STAGE1_STEPS, use_motion_selection=True,
                          motion_candidates=3)
    t0 = time.perf_counter()
    pipe = Audio2VideoPipeline.build(torch.bfloat16, device="cuda", feature_type="wavlm",
                                     seed=SEED, config=cfg, profile_phases=True)
    torch.cuda.synchronize()
    log(f"a2v: build {time.perf_counter() - t0:.1f} s")
    wav = write_wav(tmp, A2V_SECONDS, SEED + 20)
    ref = np.random.default_rng(SEED + 21).uniform(size=(SIZE, SIZE, 3)).astype(np.float32)
    init_kp = portrait_keypoints(ref, SIZE, SIZE)
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    with LaunchRecorder(torch, kernel_mods) as rec:
        out = pipe(wav, ref, init_kp,
                   generator=torch.Generator(device="cuda").manual_seed(SEED))
        torch.cuda.synchronize()
    counts = ops.launch_counts()
    frames, kp = out["frames"], out["keypoints"]
    require(frames.shape == (A2V_FRAMES, SIZE, SIZE, 3), f"a2v frame shape {frames.shape}")
    require(bool(np.isfinite(frames).all()), "a2v frames are not finite")
    require(kp.shape == (A2V_FRAMES, 402) and bool(np.isfinite(kp).all()),
            f"a2v keypoints: shape {kp.shape} or not finite")
    for name, n in counts.items():
        if name in INFERENCE_KERNELS:
            require(n > 0, f"a2v: kernel {name} was not launched")
        else:
            require(n == 0, f"a2v: kernel {name} launched under no_grad")
    require(pipe.phase_launches["audio_clip"]["group_norm"] > 0,
            "a2v: K2 was not launched in the audio encoding (wav2vec2 conv 0)")
    log("a2v: seconds " + json.dumps({k: round(v, 3) for k, v in pipe.timings.items()})
        + f"; max_memory_allocated {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"frames mean {frames.mean():.4f} std {frames.std():.4f}; keypoints x range "
        f"[{kp[:, 0::3].min():.1f}, {kp[:, 0::3].max():.1f}]")
    log("a2v: launches " + json.dumps(counts))
    log("a2v: launches by phase " + json.dumps(pipe.phase_launches))
    for name, n in counts.items():
        require(sum(ph[name] for ph in pipe.phase_launches.values()) == n,
                f"a2v {name}: the phases' launches do not add up to the run's")
    for name, n in counts.items():
        require(sum(c for (k, _), (c, _) in rec.calls.items() if k == name) == n,
                f"a2v {name}: the recorded launches do not add up to the run's")
    timings = dict(pipe.timings)
    del pipe, out
    torch.cuda.empty_cache()
    return counts, rec.calls, timings


class LaunchRecorder:
    """Wraps each kernel module's launch function (`_launch`, the one place
    a kernel wrapper launches; K5's `_launch_bwd`) for the duration of a
    `with` block and records the layout of every launch: its signature
    (per tensor argument the shape, strides and dtype, every other argument
    as it is) with a count of calls, and the kv_lens values (K1's, K5's) of
    the first call of each signature. It adds no device work to the calls
    it records."""

    LAUNCH_FN = {"flash_attention_bwd": "_launch_bwd"}
    LENS_ARG = {"flash_attention": 3, "flash_attention_bwd": 6}

    def __init__(self, torch, mods):
        self.torch, self.mods, self.calls = torch, mods, {}

    def desc(self, a):
        if isinstance(a, self.torch.Tensor):
            return ("T", tuple(a.shape), tuple(a.stride()), a.dtype)
        if isinstance(a, (list, tuple)):
            return ("S", tuple(self.desc(e) for e in a))
        return ("V", a)

    def __enter__(self):
        self.saved = {name: getattr(mod, self.LAUNCH_FN.get(name, "_launch"))
                      for name, mod in self.mods.items()}
        for name, mod in self.mods.items():
            def rec(*args, _name=name, _plain=self.saved[name]):
                key = (_name, tuple(self.desc(a) for a in args))
                if key not in self.calls:
                    lens = args[self.LENS_ARG[_name]] if _name in self.LENS_ARG else None
                    self.calls[key] = [0, None if lens is None else lens.clone()]
                self.calls[key][0] += 1
                return _plain(*args)
            setattr(mod, self.LAUNCH_FN.get(name, "_launch"), rec)
        return self

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            setattr(mod, self.LAUNCH_FN.get(name, "_launch"), self.saved[name])


def check_a2v_calls(torch, calls, A, N, L, M, tag="a2v", checked=None):
    """Every launch signature a recorded call made, replayed on seeded
    random inputs of the same shapes, strides and dtypes (K1's kv_lens
    as recorded): the kernel over the whole tensor, held against its plain
    version on the first, middle and last batch rows (K3: the first,
    middle and last A2V_ROW_CHUNK rows of x), where an offset past 2^31
    bytes would show, at the kernels rows' tolerances. Each signature's
    kernel time and bound; summed over the call's launches, each kernel's
    device time and bound per call. `checked` maps the signatures an
    earlier call replayed to `replay_call`'s result: those are not
    replayed again."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 30)
    checked = {} if checked is None else checked

    def make(d, scale=1.0, shift=0.0):
        """A seeded random tensor of descriptor d's layout (None for None)."""
        if d[0] != "T":
            return None
        _, shape, stride, dtype = d
        t = torch.empty_strided(shape, stride, dtype=dtype, device=dev)
        t.copy_(torch.randn(shape, generator=g, device=dev) * scale + shift)
        return t

    def picks(n):
        return sorted({0, n // 2, n - 1})

    def tol_for(want):
        if want.dtype == torch.float32:
            return F32_REL_TOL * want.abs().max().item()
        return ulp_tol(want)

    per_kernel, worst, replayed = {}, 0.0, 0
    for (kern, sig), (count, lens) in sorted(calls.items(), key=lambda kv: str(kv[0])):
        key = (kern, sig, None if lens is None else tuple(lens.tolist()))
        if key not in checked:
            checked[key] = replay_call(torch, kern, sig, lens, make, picks, tol_for,
                                       A, N, L, M, tag)
            replayed += 1
            err, tol, ms, bms, what = checked[key]
            log(f"{tag}_calls {kern} x{count}: {what}: max_abs_err {err:.3e} (tol {tol:.3e}); "
                f"ms {ms:.3f} bound_ms {bms:.4f}")
        err, tol, ms, bms, what = checked[key]
        worst = max(worst, err / tol if tol else 0.0)
        k = per_kernel.setdefault(kern, dict(signatures=0, launches=0, ms=0.0, bound_ms=0.0))
        k["signatures"] += 1
        k["launches"] += count
        k["ms"] += count * ms
        k["bound_ms"] += count * bms
    log(json.dumps({f"{tag}_calls": {"per_kernel": per_kernel, "worst_err_over_tol": worst,
                                     "replayed": replayed, "signatures": len(calls)}}))
    return per_kernel


def replay_call(torch, kern, sig, lens, make, picks, tol_for, A, N, L, M, tag):
    """One recorded signature against its plain version: (err, tol, ms,
    bound_ms, what it was)."""
    dev = "cuda"
    if kern == "flash_attention":
        q, k, v, _, kb, vb = map(make, sig[:6])
        scale, lse = sig[6][1], sig[7][1]
        kl = None if lens is None else lens.to(dev)
        fn = lambda: A.flash_attention(q, k, v, kl, kb, vb, scale, lse)
        got = fn()
        got, got_lse = got if lse else (got, None)
        err, tol = 0.0, 0.0
        for i in picks(q.shape[0]):
            r = slice(i, i + 1)
            want = A.attention_plain(q[r], k[r], v[r], None if kl is None else kl[r], kb, vb,
                                     scale, lse)
            want, want_lse = want if lse else (want, None)
            if lse:
                require(max_err(got_lse[r], want_lse) <= 1e-3,
                        f"{tag} K1 {tuple(q.shape)} row {i}: lse err")
            err, tol = max(err, max_err(got[r], want)), max(tol, ulp_tol(want))
            del want, want_lse
        b, sq, h, d = q.shape
        valid = int(kl.sum().item()) if kl is not None else b * (k.shape[1] + (
            0 if kb is None else kb.shape[1]))
        flops, nb = 4.0 * h * d * sq * valid, nbytes(q, k, v, kb, vb, got, got_lse)
        what = (f"q {tuple(q.shape)} K/V {tuple(k.shape)}"
                + ("" if kb is None else f" + bank {tuple(kb.shape)}")
                + ("" if kl is None else " kv_lens") + (" lse" if lse else ""))
        inputs = (q, k, v, kb, vb)
    elif kern == "group_norm":
        x, w, bb = make(sig[0]), make(sig[2]), make(sig[3])
        groups, eps, act = sig[1][1], sig[4][1], sig[5][1]
        c = x.shape[-1]
        ch = torch.arange(c, device=dev)
        x.copy_((x.float() * (1 + ch / c) + 3.0 * (ch // (c // groups))).to(x.dtype))
        fn = lambda: N.group_norm(x, groups, w, bb, eps, act)
        got = fn()
        err, tol = 0.0, 0.0
        for i in picks(x.shape[0]):
            want = N.group_norm_plain(x[i:i + 1], groups, w, bb, eps, act)
            err, tol = max(err, max_err(got[i:i + 1], want)), max(tol, tol_for(want))
        flops, nb = 10.0 * x.numel(), nbytes(x, w, bb, got)
        plan = N.gn_plan(x.shape[0], x.numel() // (x.shape[0] * c), c, groups, x.dtype)
        what = (f"x {tuple(x.shape)} {str(x.dtype)[6:]}, {groups} groups"
                + (f", {act}" if act else "") + f", {plan['regime']} k = {plan['k']}")
        inputs = (x, w, bb)
    elif kern == "ln_projections":
        xd, gd, btd, wsd, bsd, eps = sig
        x = make(xd)
        c = x.shape[-1]
        gam, bet = make(gd, 0.1, 1.0), make(btd, 0.1)
        ws = [make(d_, 1 / math.sqrt(c)) for d_ in wsd[1]]
        bs = [make(d_, 0.1) if d_[0] == "T" else None for d_ in bsd[1]]
        eps = eps[1]
        fn = lambda: L.ln_projections(x, gam, bet, ws, bs, eps)
        got = fn()
        x2, m = x.reshape(-1, c), x.numel() // c
        err, tol = 0.0, 0.0
        for i in sorted({0, max(m - A2V_ROW_CHUNK, 0) // 2, max(m - A2V_ROW_CHUNK, 0)}):
            r = slice(i, min(i + A2V_ROW_CHUNK, m))
            want = L.ln_projections_plain(x2[r], gam, bet, ws, bs, eps)
            for o, w_ in zip(got, want):
                err = max(err, max_err(o.reshape(-1, o.shape[-1])[r], w_))
                tol = max(tol, ulp_tol(w_))
        flops = 2.0 * m * c * sum(w_.shape[0] for w_ in ws)
        nb = nbytes(x, gam, bet, *ws, *bs, *got)
        what = f"x {tuple(x.shape)}, W {[tuple(w_.shape) for w_ in ws]}" + (
            ", bias" if bs[0] is not None else "")
        inputs = (x, gam, bet, *ws, *bs)
    elif kern == "flash_attention_bwd":
        q, k, v, o, do, lse = map(make, sig[:6])
        scale = sig[7][1]
        kl = None if lens is None else lens.to(dev)
        # o and lse from the plain forward on these inputs, row by row (a
        # consistent (o, lse) pair is what the backward is defined on)
        for i in range(q.shape[0]):
            r = slice(i, i + 1)
            o_r, lse_r = A.attention_plain(q[r], k[r], v[r], None if kl is None else kl[r],
                                           scale=scale, return_lse=True)
            o[r].copy_(o_r)
            lse[r].copy_(lse_r)
            del o_r, lse_r
        fn = lambda: A.flash_attention_bwd(q, k, v, o, do, lse, kl, scale)
        got = fn()
        err, tol = 0.0, 0.0
        for i in picks(q.shape[0]):
            r = slice(i, i + 1)
            want = A.attention_bwd_plain(q[r], k[r], v[r], o[r], do[r], lse[r],
                                         None if kl is None else kl[r], scale)
            for gg, ww in zip(got, want):
                e, t_ = max_err(gg[r], ww), ulp_tol(ww, 4)
                require(e <= t_, f"{tag} K5 {tuple(q.shape)} row {i}: err {e} > {t_}")
                if t_ and e / t_ >= (err / tol if tol else 0.0):
                    err, tol = e, t_
            del want
        b, sq, h, d = q.shape
        valid = int(kl.sum().item()) if kl is not None else b * k.shape[1]
        flops, nb = 10.0 * h * d * sq * valid, nbytes(q, k, v, o, do, lse, *got)
        what = (f"q {tuple(q.shape)} K/V {tuple(k.shape)}" + ("" if kl is None else " kv_lens")
                + " (4 bf16 ulps)")
        inputs = (q, k, v, o, do, lse)
    else:
        xd, gd, btd, ped, *wd, bod, heads, eps, residual = sig
        x = make(xd)
        b, f, l, c = x.shape
        inner = wd[0][1][0]   # q/k/v rows: C, or a head shard's H_local d
        args = (x, make(gd, 0.1, 1.0), make(btd, 0.1), make(ped),
                *(make(d_, 1 / math.sqrt(c)) for d_ in wd[:3]), make(wd[3], 1 / math.sqrt(inner)),
                make(bod, 0.1), heads[1], eps[1], residual[1])
        fn = lambda: M.motion_attention(*args)
        got = fn()
        err, tol = 0.0, 0.0
        for i in picks(b):
            want = M.motion_attention_plain(x[i:i + 1], *args[1:])
            err, tol = max(err, max_err(got[i:i + 1], want)), max(tol, ulp_tol(want))
        flops = 2.0 * b * f * l * c * inner * 4 + 4.0 * b * l * f * f * inner
        nb = nbytes(*args[:9], got)
        what = f"x {tuple(x.shape)}, {heads[1]} heads" + (
            "" if inner == c else f" of a head shard (inner {inner}, no residual)")
        inputs = args[:9]
    require(math.isfinite(err) and err <= tol,
            f"{tag} {kern} at {what}: err {err} > {tol}")
    ms = time_ms(fn, iters=3, warmup=1)
    bms, _ = bound_ms(flops, nb)
    del got, inputs, fn
    torch.cuda.empty_cache()
    return err, tol, ms, bms, what


def tiny_a2v(torch, device, dtype):
    """The a2v_small pipeline (`small` with the audio stack of
    `mmgt_tpu_torch/testing.py`'s SMALL widths: a 2-layer CLIP, wav2vec2
    and WavLM of width 64, a 1-layer SMGA decoder) with the card's dtypes:
    Stage 2 and CLIP in `dtype`, the audio encoders and SMGA in f32 (all
    f32 when `dtype` is). Weights: seeded, copied from one set by the
    caller."""
    from mmgt_tpu_torch.config import InferenceConfig
    from mmgt_tpu_torch.models.audio_proj import AudioProjModel
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
    from mmgt_tpu_torch.testing import SMALL, small_audio2vid

    p2v = tiny_pipeline(torch, Pose2VideoPipeline, device, dtype)
    p2v.audio_proj = AudioProjModel(**SMALL["audio_proj"]).to(device, dtype)
    cfg = InferenceConfig(width=64, height=64, video_length=8, num_inference_steps=2,
                          a2p_sampling_steps=5, context_size=6, context_overlap=2,
                          window_microbatch=None)
    return small_audio2vid(p2v, cfg, device, dtype, feature_type="wavlm")


def a2v_models(pipe):
    return dict(pipe.pose2vid.models(), smga=pipe.smga.model, clip=pipe.clip_model,
                wav2vec2=pipe.audio_processor.model, wavlm=pipe.wavlm_extractor.model)


def run_a2v_small(torch, tmp: str):
    """Tiny audio2vid, one set of weights and draws, three ways: f32 on the
    CPU (the reference), the card's dtypes on the CPU (plain versions) and
    on the card (kernels). The Stage-1 decoder's output layer is set to the
    default skeleton plus a small input-dependent part, so the poses stay in
    the 64^2 frame and the masks are not constant (random poses fill the
    frame with the face box, and a constant mask's min-max normalisation is
    rounding noise). Keypoints (normalised units, floored at 1e-5: both
    Stage-1 runs are f32) and frames: the card's mean error against the
    reference within SMALL_ERR_FACTOR x the plain run's."""
    import numpy as np

    from mmgt_tpu_torch.data.conditioning import normalize_keypoints
    from mmgt_tpu_torch.data.pose_init import default_skeleton
    from mmgt_tpu_torch.diffusion.gesture import GestureDiffusionSchedule
    from mmgt_tpu_torch.pipelines.pose2vid import init_random_params

    ref_pipe = tiny_a2v(torch, "cpu", torch.float32)
    gen = torch.Generator().manual_seed(SEED + 22)
    for name, m in a2v_models(ref_pipe).items():
        if name not in ref_pipe.pose2vid.models():
            init_random_params(m, gen, 0.05)
    init_random_params(ref_pipe.pose2vid.audio_proj, gen, 0.05)
    with torch.no_grad():
        fl = ref_pipe.smga.model.final_layer
        fl.weight.mul_(1e-3)
        fl.bias.copy_(torch.from_numpy(normalize_keypoints(default_skeleton(64, 64))))
    runs = {"cpu_f32": ref_pipe, "cpu_bf16": tiny_a2v(torch, "cpu", torch.bfloat16),
            "card_bf16": tiny_a2v(torch, "cuda", torch.bfloat16)}
    for tag, pipe in runs.items():
        if pipe is not ref_pipe:
            for name, m in a2v_models(ref_pipe).items():
                a2v_models(pipe)[name].load_state_dict(m.state_dict())
    wav = write_wav(tmp, A2V_SECONDS, SEED + 23)
    image = np.random.default_rng(SEED + 24).uniform(size=(64, 64, 3)).astype(np.float32)
    init_kp = default_skeleton(64, 64)
    g = torch.Generator().manual_seed(SEED + 25)
    draws = {"pose": [GestureDiffusionSchedule.draws((1, 80, 402), 5, g) for _ in range(2)],
             "latents": torch.randn(8, 8, 8, 4, generator=g)}
    outs = {}
    for tag, pipe in runs.items():
        out = pipe(wav, image, init_kp, draws=draws)
        outs[tag] = (normalize_keypoints(out["keypoints"]), out["frames"])
    errs = {tag: [float(np.abs(outs[tag][i] - outs["cpu_f32"][i]).mean()) for i in (0, 1)]
            for tag in ("cpu_bf16", "card_bf16")}
    log(f"a2v_small: mean abs err vs CPU f32 (keypoints in normalised units, frames): plain "
        f"on the CPU {errs['cpu_bf16']}, kernels on the card {errs['card_bf16']} (tol: "
        f"{SMALL_ERR_FACTOR}x the plain error; keypoints floored at {A2V_KP_FLOOR:g})")
    for i, what in enumerate(("keypoints", "frames")):
        require(all(np.isfinite(o[i]).all() for o in outs.values()),
                f"a2v_small {what} are not finite")
        floor = A2V_KP_FLOOR if i == 0 else 0.0
        require(errs["card_bf16"][i] <= SMALL_ERR_FACTOR * max(errs["cpu_bf16"][i], floor),
                f"a2v_small {what}: the card's error exceeds {SMALL_ERR_FACTOR}x the plain error")


def run_long240(torch, ops, kernel_mods, tmp: str):
    """audio2vid as in `run_a2v` on a LONG_SECONDS (9.6 s) clip: 3 chained
    Stage-1 slices with motion selection over 3 candidates, 240 frames, 30
    context windows fused each Stage-2 step (window_microbatch 5: 120 frame
    rows a UNet call). Finite frames and keypoints, the seam check of
    tests/test_long_video.py at frames 80 and 160, K1-K4 launched (K5 not),
    K2 in the audio encoding; seconds, launches and peak memory per phase."""
    import numpy as np

    from mmgt_tpu_torch.config import InferenceConfig
    from mmgt_tpu_torch.data.pose_init import portrait_keypoints
    from mmgt_tpu_torch.pipelines.audio2vid import Audio2VideoPipeline

    cfg = InferenceConfig(video_length=LONG_FRAMES, num_inference_steps=STEPS,
                          a2p_sampling_steps=A2V_STAGE1_STEPS, use_motion_selection=True,
                          motion_candidates=3)
    t0 = time.perf_counter()
    pipe = Audio2VideoPipeline.build(torch.bfloat16, device="cuda", feature_type="wavlm",
                                     seed=SEED, config=cfg, profile_phases=True)
    torch.cuda.synchronize()
    log(f"long240: build {time.perf_counter() - t0:.1f} s")
    wav = write_wav(tmp, LONG_SECONDS, SEED + 90)
    ref = np.random.default_rng(SEED + 91).uniform(size=(SIZE, SIZE, 3)).astype(np.float32)
    init_kp = portrait_keypoints(ref, SIZE, SIZE)
    out, counts, calls, sec, peak = record_call(torch, ops, kernel_mods, lambda: pipe(
        wav, ref, init_kp, generator=torch.Generator(device="cuda").manual_seed(SEED)))
    frames, kp = out["frames"], out["keypoints"]
    require(frames.shape == (LONG_FRAMES, SIZE, SIZE, 3), f"long240 frame shape {frames.shape}")
    require(bool(np.isfinite(frames).all()), "long240 frames are not finite")
    require(kp.shape == (LONG_FRAMES, 402) and bool(np.isfinite(kp).all()),
            f"long240 keypoints: shape {kp.shape} or not finite")
    require_launches("long240", counts, INFERENCE_KERNELS)
    require(pipe.phase_launches["audio_clip"]["group_norm"] > 0,
            "long240: K2 was not launched in the audio encoding (wav2vec2 conv 0)")
    step_l1 = np.abs(np.diff(kp, axis=0)).mean(axis=1)
    med = float(np.median(step_l1))
    seams = {s_: float(step_l1[s_ - 1]) for s_ in (80, 160)}
    log(f"long240: per-frame L1 step at the seams {seams}, median {med:.4f} (limit "
        f"{SEAM_FACTOR}x the median + 1e-3)")
    for s_, v in seams.items():
        require(v <= SEAM_FACTOR * med + 1e-3, f"long240: the step at seam {s_} is {v}")
    log(f"long240: {LONG_FRAMES} frames from a {LONG_SECONDS} s clip in {sec:.3f} s; seconds "
        + json.dumps({k: round(v, 3) for k, v in pipe.timings.items()})
        + f"; max_memory_allocated {peak:.2f} GiB; frames mean {frames.mean():.4f} std "
        f"{frames.std():.4f}")
    log("long240: launches " + json.dumps(counts))
    log("long240: launches by phase " + json.dumps(pipe.phase_launches))
    for name, n in counts.items():
        require(sum(ph[name] for ph in pipe.phase_launches.values()) == n,
                f"long240 {name}: the phases' launches do not add up to the run's")
    del pipe, out, frames
    torch.cuda.empty_cache()
    return counts, calls


# ----------------------------------------------- the rest of inference
def record_call(torch, ops, kernel_mods, fn):
    """fn() with every launch counter set to 0 just before and read just
    after, under the launch recorder; returns (result, counts, recorded
    calls, seconds, peak GiB)."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    with LaunchRecorder(torch, kernel_mods) as rec:
        out = fn()
        torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    counts = ops.launch_counts()
    for name, n in counts.items():
        require(sum(c for (k, _), (c, _) in rec.calls.items() if k == name) == n,
                f"{name}: the recorded launches do not add up to the run's")
    return out, counts, rec.calls, sec, torch.cuda.max_memory_allocated() / 2**30


def require_launches(tag: str, counts: dict, launched):
    """The kernels in `launched` ran during the phase; no other did."""
    for name, n in counts.items():
        if name in launched:
            require(n > 0, f"{tag}: kernel {name} was not launched")
        else:
            require(n == 0, f"{tag}: kernel {name} was launched")


def require_frames(torch, tag: str, frames, shape):
    require(tuple(frames.shape) == shape, f"{tag}: shape {tuple(frames.shape)} != {shape}")
    require(bool(torch.isfinite(frames).all()), f"{tag}: not finite")
    require(frames.min().item() >= 0.0 and frames.max().item() <= 1.0, f"{tag}: outside [0, 1]")


def run_dpm(torch, ops, kernel_mods):
    """Pose2VideoPipeline at main's full width with DPM-Solver++(2M) from
    `make_scheduler`, DPM_STEPS steps (the JAX bench's dpm15)."""
    from mmgt_tpu_torch.config import SchedulerConfig
    from mmgt_tpu_torch.diffusion import DPMSolverPlusPlus2M, make_scheduler
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline

    t0 = time.perf_counter()
    pipe = Pose2VideoPipeline.build(torch.bfloat16, device="cuda", seed=SEED, profile_phases=True,
                                    scheduler=make_scheduler(SchedulerConfig(solver="dpm++2m")))
    require(isinstance(pipe.scheduler, DPMSolverPlusPlus2M), "dpm: make_scheduler gave "
            f"{type(pipe.scheduler).__name__}")
    torch.cuda.synchronize()
    log(f"dpm: build {time.perf_counter() - t0:.1f} s")
    inputs = make_inputs(torch, FRAMES, SIZE, SEED)
    frames, counts, calls, sec, peak = record_call(torch, ops, kernel_mods, lambda: pipe(
        **inputs, num_inference_steps=DPM_STEPS, guidance_scale=GUIDANCE,
        generator=torch.Generator(device="cuda").manual_seed(SEED)))
    require_frames(torch, "dpm frames", frames, (1, FRAMES, SIZE, SIZE, 3))
    require_launches("dpm", counts, INFERENCE_KERNELS)
    t = pipe.timings
    log(f"dpm: {DPM_STEPS} steps, {sec:.3f} s: prepare_s {t['prepare_s']:.3f} denoise_s "
        f"{t['denoise_s']:.3f} ({t['denoise_s'] / DPM_STEPS:.4f} a step) decode_s "
        f"{t['decode_s']:.3f}; max_memory_allocated {peak:.2f} GiB; frames mean "
        f"{frames.mean().item():.4f} std {frames.std().item():.4f}; launches "
        + json.dumps(counts))
    del pipe, frames
    torch.cuda.empty_cache()
    return counts, calls


def run_pose2img(torch, ops, kernel_mods):
    """Pose2ImagePipeline at full width (no audio or motion modules), one
    512^2 image, its default 20 DDIM steps."""
    from mmgt_tpu_torch.pipelines.pose2img import Pose2ImagePipeline

    t0 = time.perf_counter()
    pipe = Pose2ImagePipeline.build(torch.bfloat16, device="cuda", seed=SEED)
    torch.cuda.synchronize()
    log(f"pose2img: build {time.perf_counter() - t0:.1f} s")
    g = torch.Generator().manual_seed(SEED + 50)
    ref = torch.rand(1, SIZE, SIZE, 3, generator=g) * 2 - 1
    pose, clip = torch.rand(1, SIZE, SIZE, 3, generator=g), torch.randn(1, 1, 768, generator=g)
    img, counts, calls, sec, peak = record_call(torch, ops, kernel_mods, lambda: pipe(
        ref, pose, clip, num_inference_steps=POSE2IMG_STEPS, guidance_scale=GUIDANCE,
        generator=torch.Generator(device="cuda").manual_seed(SEED)))
    require_frames(torch, "pose2img image", img, (1, SIZE, SIZE, 3))
    require_launches("pose2img", counts, ("flash_attention", "group_norm", "ln_projections"))
    log(f"pose2img: {POSE2IMG_STEPS} steps, {sec:.3f} s ({sec / POSE2IMG_STEPS:.4f} a step with "
        f"the encode and decode); max_memory_allocated {peak:.2f} GiB; image mean "
        f"{img.mean().item():.4f} std {img.std().item():.4f}; launches " + json.dumps(counts))
    del pipe, img
    torch.cuda.empty_cache()
    return counts, calls


def run_lmks2vid(torch, ops, kernel_mods):
    """Lmks2VideoPipeline at full width: two guiders summed into main's
    pipeline, 16 frames, STEPS DDIM steps."""
    from mmgt_tpu_torch.pipelines.lmks2vid import Lmks2VideoPipeline

    t0 = time.perf_counter()
    pipe = Lmks2VideoPipeline.build(torch.bfloat16, device="cuda", seed=SEED, profile_phases=True)
    torch.cuda.synchronize()
    log(f"lmks2vid: build {time.perf_counter() - t0:.1f} s")
    x = make_inputs(torch, FRAMES, SIZE, SEED)
    lmks_b = torch.rand(1, FRAMES, SIZE, SIZE, 3, generator=torch.Generator().manual_seed(SEED + 51))
    frames, counts, calls, sec, peak = record_call(torch, ops, kernel_mods, lambda: pipe(
        x["ref_image"], x["pose_video"], lmks_b, x["clip_embed"], x["masks"], x["audio_embeds"],
        num_inference_steps=STEPS, guidance_scale=GUIDANCE,
        generator=torch.Generator(device="cuda").manual_seed(SEED)))
    require_frames(torch, "lmks2vid frames", frames, (1, FRAMES, SIZE, SIZE, 3))
    require_launches("lmks2vid", counts, INFERENCE_KERNELS)
    t = pipe.base.timings
    log(f"lmks2vid: {sec:.3f} s: " + " ".join(f"{k} {v:.3f}" for k, v in t.items())
        + f"; max_memory_allocated {peak:.2f} GiB; launches " + json.dumps(counts))
    del pipe, frames
    torch.cuda.empty_cache()
    return counts, calls


def three_way(torch, tag: str, make, run, names):
    """One set of weights (the f32 CPU copy's) run three ways: f32 on the
    CPU (the reference), bf16 on the CPU (plain versions) and bf16 on the
    card (kernels); each output's mean error on the card within
    SMALL_ERR_FACTOR x the plain bf16 error. make(device, dtype) -> a
    pipeline with models(); run(pipeline, device) -> the outputs."""
    ref = make("cpu", torch.float32)
    runs = {"cpu_f32": (ref, "cpu"), "cpu_bf16": (make("cpu", torch.bfloat16), "cpu"),
            "card_bf16": (make("cuda", torch.bfloat16), "cuda")}
    for pipe, _ in runs.values():
        if pipe is not ref:
            for name, m in ref.models().items():
                pipe.models()[name].load_state_dict(m.state_dict())
    outs = {k: [o.float().cpu() for o in run(pipe, dev)] for k, (pipe, dev) in runs.items()}
    errs = {k: [(outs[k][i] - outs["cpu_f32"][i]).abs().mean().item() for i in range(len(names))]
            for k in ("cpu_bf16", "card_bf16")}
    log(f"{tag}: mean abs err vs CPU f32 ({', '.join(names)}): plain bf16 on the CPU "
        f"{errs['cpu_bf16']}, kernels bf16 on the card {errs['card_bf16']} "
        f"(tol: {SMALL_ERR_FACTOR}x the plain bf16 error)")
    for i, what in enumerate(names):
        require(all(bool(torch.isfinite(o[i]).all()) for o in outs.values()),
                f"{tag} {what} are not finite")
        require(errs["card_bf16"][i] <= SMALL_ERR_FACTOR * errs["cpu_bf16"][i],
                f"{tag} {what}: the card's error exceeds {SMALL_ERR_FACTOR}x the plain error")


def run_dpm_small(torch, Pose2VideoPipeline):
    """The small pipeline of `run_small` sampling with DPM-Solver++(2M), 4
    steps, three ways."""
    from mmgt_tpu_torch.diffusion import DPMSolverPlusPlus2M
    from mmgt_tpu_torch.pipelines.context import compute_context_schedule

    frames, size, steps = 8, 64, 4
    inputs = make_inputs(torch, frames, size, SEED + 12)
    lat0 = torch.randn(frames, size // 8, size // 8, 4, generator=torch.Generator().manual_seed(
        SEED + 13))
    win = compute_context_schedule(steps, frames, 6, 1, 2)

    def make(dev, dtype):
        pipe = tiny_pipeline(torch, Pose2VideoPipeline, dev, dtype)
        pipe.scheduler = DPMSolverPlusPlus2M()
        return pipe

    def run(pipe, dev):
        d = {k: v.to(dev) for k, v in inputs.items() if k != "masks"}
        d["masks"] = tuple(tuple(m.to(dev) for m in lv) for lv in inputs["masks"])
        cond, _ = pipe._prepare(**d)
        state = pipe.sampler_state(steps)
        lat = lat0.to(dev)
        lat, _ = pipe._denoise_chunk(lat, pipe.init_aux(state, lat), cond, state, win, GUIDANCE,
                                     (1.0, 1.0, 1.0))
        return lat, pipe._decode(lat)

    three_way(torch, "dpm_small", make, run, ("latents", "frames"))


def tiny_pose2img(torch, device, dtype):
    """The small pipeline's widths, no audio or motion modules."""
    from mmgt_tpu_torch.pipelines.pose2img import Pose2ImagePipeline
    from mmgt_tpu_torch.testing import SMALL, stage2_model

    torch.manual_seed(SEED)
    pipe = Pose2ImagePipeline(
        vae=stage2_model(SMALL, "vae"), reference_unet=stage2_model(SMALL, "reference_unet"),
        denoising_unet=stage2_model(SMALL, "denoising_unet", use_audio_module=False,
                                    use_motion_module=False),
        pose_guider=stage2_model(SMALL, "pose_guider"))
    for m in pipe.models().values():
        m.to(device=device, dtype=dtype)
    pipe.init_params(SEED, std=0.05)
    return pipe


def run_pose2img_small(torch):
    """Tiny pose2img, a batch of 2 at 64^2, 3 steps, three ways."""
    g = torch.Generator().manual_seed(SEED + 52)
    ref, pose = torch.rand(2, 64, 64, 3, generator=g) * 2 - 1, torch.rand(2, 64, 64, 3, generator=g)
    clip, lat0 = torch.randn(2, 1, 768, generator=g), torch.randn(2, 8, 8, 4, generator=g)
    three_way(torch, "pose2img_small", lambda dev, dt: tiny_pose2img(torch, dev, dt),
              lambda pipe, dev: (pipe(ref, pose, clip, num_inference_steps=3,
                                      guidance_scale=GUIDANCE, latents=lat0),), ("image",))


def run_lmks2vid_small(torch, Pose2VideoPipeline):
    """Tiny lmks2vid (the small pipeline plus two small guiders), 8 frames,
    2 steps, three ways."""
    from mmgt_tpu_torch.models.pose_guider import PoseGuider
    from mmgt_tpu_torch.pipelines.lmks2vid import Lmks2VideoPipeline
    from mmgt_tpu_torch.pipelines.pose2vid import init_random_params

    def make(dev, dtype):
        gen = torch.Generator(device=dev).manual_seed(SEED + 53)
        guiders = {n: init_random_params(PoseGuider(64, (8, 16, 16, 32)).to(dev, dtype), gen,
                                         0.05) for n in ("guider_a", "guider_b")}
        return Lmks2VideoPipeline(tiny_pipeline(torch, Pose2VideoPipeline, dev, dtype), **guiders)

    x = make_inputs(torch, 8, 64, SEED + 54)
    g = torch.Generator().manual_seed(SEED + 55)
    lmks_b, lat0 = torch.rand(1, 8, 64, 64, 3, generator=g), torch.randn(8, 8, 8, 4, generator=g)
    three_way(torch, "lmks2vid_small", make,
              lambda pipe, dev: (pipe(x["ref_image"], x["pose_video"], lmks_b, x["clip_embed"],
                                      x["masks"], x["audio_embeds"], num_inference_steps=2,
                                      guidance_scale=GUIDANCE, latents=lat0),), ("frames",))


def run_fewstep(torch, ops, kernel_mods, tmp: str):
    """The few-step quality tool's `main` in this process
    (`mmgt_tpu_torch/tools/fewstep_quality.py`: full width, 512^2, 16
    frames, DDIM-200 as the ground truth): every row finite; within each
    sampler the latent error falls as the steps rise; DPM++-15 below
    DDIM-15. K1-K4 launched (K5 not)."""
    from mmgt_tpu_torch.tools import fewstep_quality

    res, counts, calls, sec, peak = record_call(torch, ops, kernel_mods, lambda: (
        fewstep_quality.main(["--out", os.path.join(tmp, "fewstep.json")])))
    rows = {(r["sampler"], r["steps"]): r for r in res["rows"]}
    for r in res["rows"]:
        log("fewstep: " + json.dumps(r))
        require(all(math.isfinite(v) for v in r.values() if isinstance(v, float)),
                f"fewstep: a value of {r['sampler']}-{r['steps']} is not finite")
    err = lambda name, n: rows[(name, n)]["rel_latent_err"]  # noqa: E731
    require(err("ddim", 15) > err("ddim", 25), "fewstep: DDIM-25 is not below DDIM-15")
    require(err("dpm++2m", 12) > err("dpm++2m", 15) > err("dpm++2m", 25),
            "fewstep: DPM++'s error does not fall as the steps rise")
    require(err("dpm++2m", 15) < err("ddim", 15), "fewstep: DPM++-15 is not below DDIM-15")
    require_launches("fewstep", counts, INFERENCE_KERNELS)
    log(f"fewstep: {sec:.1f} s (the ground truth {res['protocol']['ref_wall_s']:.1f} s), "
        f"max_memory_allocated {peak:.2f} GiB; protocol " + json.dumps(res["protocol"])
        + "; launches " + json.dumps(counts))
    torch.cuda.empty_cache()
    return counts, calls


def run_weights(torch, ops, kernel_mods, tmp: str):
    """A reference-layout weights directory at full width, written in fp16
    from seeded port modules by the synth_weights tool
    (`mmgt_tpu_torch/tools/synth_weights.py`), loaded back by `load_all_weights` onto the
    card: every tensor equal to what was written, cast to its target
    dtype (wav2vec2 and WavLM: f32 modules holding bf16 values), no model
    random-filled; then the pose2vid CLI's `run` on the loaded pipeline.
    The directory stays for the preprocess phase (its WavLM checkpoint)
    and verify_weights, which removes it."""
    import numpy as np

    from mmgt_tpu_torch.config import InferenceConfig
    from mmgt_tpu_torch.data.audio import AudioProcessor
    from mmgt_tpu_torch.models.wav2vec2 import Wav2Vec2Model
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline, materialize
    from mmgt_tpu_torch.scripts import pose2vid as cli
    from mmgt_tpu_torch.tools.synth_weights import synth_weights
    from mmgt_tpu_torch.training.stage1 import SMGA
    from mmgt_tpu_torch.utils import convert as PC
    from mmgt_tpu_torch.utils.weights import load_all_weights

    dev, bf16, f32 = torch.device("cuda"), torch.bfloat16, torch.float32
    root = os.path.join(tmp, "weights")
    t0 = time.perf_counter()
    info = synth_weights(root, "cuda", SEED + 40)
    expected = info["expected"]  # the values each model must hold, before the cast to its dtype
    torch.cuda.empty_cache()
    need, write_s, on_disk = info["tensor_bytes"], info["write_s"], info["bytes"]
    log(f"weights: source models and files {time.perf_counter() - t0:.1f} s (the synth_weights "
        f"tool, {len(info['files'])} files)")

    t0 = time.perf_counter()
    pipe = Pose2VideoPipeline.build(bf16, device="cuda", seed=SEED + 42)
    with torch.device("meta"):
        smga = SMGA(feature_type="wavlm")
    smga.model.to_empty(device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    out = load_all_weights(root, pipe, smga, "cuda")
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    require(out["random_fill"] == [], f"weights: random-filled {out['random_fill']}")
    require(out["smga"] is smga and out["smga_feature_type"] == "wavlm", "weights: smga")
    models = dict(pipe.models(), smga=smga.model, clip=out["clip_model"],
                  wav2vec2=out["audio_processor"].model, wavlm=out["wavlm"].model)
    n_tensors = 0
    for name, m in models.items():
        sd = m.state_dict()
        require(set(sd) == set(expected[name]), f"weights: {name} keys differ")
        for k, v in sd.items():
            want = expected[name][k].to(dev)
            if name in ("wav2vec2", "wavlm"):
                require(v.dtype == f32, f"weights: {name}.{k} is {v.dtype}")
                want = want.to(bf16)
            require(torch.equal(v, want.to(v.dtype)),
                    f"weights: {name}.{k} is not what was written")
            n_tensors += 1
    log(f"weights: wrote {on_disk} bytes ({need} of tensors, fp16) in {write_s:.1f} s; "
        f"built the destination in {build_s:.1f} s, loaded it in {load_s:.1f} s; "
        f"{n_tensors} tensors of {len(models)} models equal what was written, cast to "
        "their dtypes; reports " + json.dumps(
            {n: {k: len(v) for k, v in r.items()} for n, r in out["reports"].items()}))

    # the pipeline dtype's values in an f32 wav2vec2 (as the JAX package
    # computes) against the file's own values
    with torch.device("meta"):
        w2v = Wav2Vec2Model()
    w2v = materialize({"w": w2v}, dev, f32)["w"].eval()
    PC.load_checkpoint(w2v, [PC.load_torch_state_dict(
        os.path.join(root, "wav2vec2-base-960h/pytorch_model.bin"))])
    wav = write_wav(tmp, A2V_SECONDS, SEED + 43)
    got, _ = out["audio_processor"].preprocess(wav)
    ref, _ = AudioProcessor(w2v).preprocess(wav)
    log(f"weights: wav2vec2 embeddings {tuple(got.shape)}, bf16-valued against fp16-valued "
        f"weights, both computed in f32: max abs err {max_err(got, ref):.3e}, mean "
        f"{(got - ref).abs().mean().item():.3e} (largest |y| {ref.abs().max().item():.3e})")
    del w2v, got, ref, out, models

    cfg = InferenceConfig(width=SIZE, height=SIZE, video_length=FRAMES, num_inference_steps=STEPS)
    rng = np.random.default_rng(SEED + 44)
    image = rng.uniform(size=(SIZE, SIZE, 3)).astype(np.float32)
    pose = rng.uniform(size=(FRAMES, SIZE, SIZE, 3)).astype(np.float32)
    face, lips = ((rng.uniform(size=(FRAMES, SIZE, SIZE)) > 0.7).astype(np.float32)
                  for _ in range(2))
    frames, counts, calls, sec, peak = record_call(
        torch, ops, kernel_mods, lambda: cli.run(pipe, image, pose, face, lips, None, cfg, SEED))
    require(frames.shape == (FRAMES, SIZE, SIZE, 3) and bool(np.isfinite(frames).all()),
            f"weights: the CLI's frames {frames.shape} are not finite")
    require_launches("weights: CLI run", counts, INFERENCE_KERNELS)
    log(f"weights: pose2vid CLI run on the loaded pipeline, {FRAMES} frames, {STEPS} steps: "
        f"{sec:.3f} s, max_memory_allocated {peak:.2f} GiB, frames mean {frames.mean():.4f}; "
        f"launches " + json.dumps(counts))
    del frames

    # the training CLIs' --weights_dir: their models as load_all_weights
    # loaded them above (the image CLI's denoiser stays seeded, as in JAX)
    from mmgt_tpu_torch.config import Stage2ImageTrainConfig, Stage2TrainConfig
    from mmgt_tpu_torch.scripts import train_stage2, train_stage2_image

    for tag, mod, tcfg, names in (
            ("train_stage2", train_stage2, Stage2TrainConfig(), tuple(pipe.models())),
            ("train_stage2_image", train_stage2_image, Stage2ImageTrainConfig(),
             ("vae", "reference_unet", "pose_guider"))):
        t0 = time.perf_counter()
        trainer, clip = mod.build(tcfg, "cuda", SEED + 1, root)
        torch.cuda.synchronize()
        require(clip is not None, f"weights: {tag}.build found no CLIP")
        for name in names:
            got_sd = getattr(trainer.pipeline, name).state_dict()
            for k, v in getattr(pipe, name).state_dict().items():
                require(torch.equal(got_sd[k], v), f"weights: {tag} {name}.{k} differs")
        log(f"weights: {tag}.build(weights_dir) in {time.perf_counter() - t0:.1f} s: "
            f"{', '.join(names)} equal to load_all_weights' and a CLIP model")
        del trainer, clip, got_sd
        torch.cuda.empty_cache()
    del pipe, smga
    torch.cuda.empty_cache()
    return counts, calls


# ----------------------------------------------------------- preprocessing
def timed(fn, acc):
    """fn with each call's host-clock seconds appended to acc (the nets'
    wrappers copy their outputs to the host, which waits for the card)."""
    def run(x):
        t0 = time.perf_counter()
        out = fn(x)
        acc.append(time.perf_counter() - t0)
        return out
    return run


def export_onnx(torch, model, example, path: str, inputs, outputs):
    """torch's TorchScript ONNX exporter, without the `onnx` package (it
    imports `onnx` only to add onnxscript functions, which a plain module
    has none of), with constant folding and the eval-mode Conv+BN fusion
    off so that every initializer keeps its module name."""
    from torch.onnx._internal.torchscript_exporter import onnx_proto_utils

    orig = onnx_proto_utils._add_onnxscript_fn
    onnx_proto_utils._add_onnxscript_fn = lambda b, c: b
    try:
        torch.onnx.export(model, (example,), path, opset_version=13, dynamo=False,
                          do_constant_folding=False, training=torch.onnx.TrainingMode.PRESERVE,
                          input_names=list(inputs), output_names=list(outputs))
    finally:
        onnx_proto_utils._add_onnxscript_fn = orig


def tfc_tdf_net(torch, dim_f: int, seed: int, g: int = 4, n: int = 2, k: int = 3, bn: int = 2):
    """A TFC-TDF separator shaped like `tests/test_separator_mdx_arch.py`'s
    MiniConvTDFNetTrim (the kuielab MDX-Net v2 architecture that
    Kim_Vocal_2 belongs to): a 1x1 stem, n strided down/up scales with
    BatchNorm, multiplicative skips, a TDF block (conv + GroupNorm + ReLU,
    and a frequency-bottleneck MLP) at each scale, a 1x1 head back to 4
    re/im channels; f32 on the CPU, seeded weights and BN statistics."""
    nn = torch.nn

    class ConvTDF(nn.Module):
        def __init__(self, c, f):
            super().__init__()
            self.h = nn.Sequential(nn.Conv2d(c, c, k, padding=k // 2), nn.GroupNorm(2, c),
                                   nn.ReLU())
            self.tdf = nn.Sequential(nn.Linear(f, f // bn), nn.GroupNorm(2, c), nn.ReLU(),
                                     nn.Linear(f // bn, f), nn.GroupNorm(2, c), nn.ReLU())

        def forward(self, x):
            x = self.h(x)
            return x + self.tdf(x)

    class Net(nn.Module):
        def __init__(self):
            super().__init__()
            self.first_conv = nn.Sequential(nn.Conv2d(4, g, 1), nn.BatchNorm2d(g), nn.ReLU())
            c, f = g, dim_f
            self.ds_dense, self.ds = nn.ModuleList(), nn.ModuleList()
            for _ in range(n):
                self.ds_dense.append(ConvTDF(c, f))
                self.ds.append(nn.Sequential(nn.Conv2d(c, c + g, 2, stride=2),
                                             nn.BatchNorm2d(c + g), nn.ReLU()))
                c, f = c + g, f // 2
            self.mid_dense = ConvTDF(c, f)
            self.us, self.us_dense = nn.ModuleList(), nn.ModuleList()
            for _ in range(n):
                self.us.append(nn.Sequential(nn.ConvTranspose2d(c, c - g, 2, stride=2),
                                             nn.BatchNorm2d(c - g), nn.ReLU()))
                c, f = c - g, f * 2
                self.us_dense.append(ConvTDF(c, f))
            self.final_conv = nn.Conv2d(c, 4, 1)

        def forward(self, x):
            x = self.first_conv(x).transpose(-1, -2)  # (B, C, T, F): the MLPs act on F
            skips = []
            for i in range(n):
                x = self.ds_dense[i](x)
                skips.append(x)
                x = self.ds[i](x)
            x = self.mid_dense(x)
            for i in range(n):
                x = self.us_dense[i](self.us[i](x) * skips[-i - 1])
            return self.final_conv(x.transpose(-1, -2))

    net = Net().eval().requires_grad_(False)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in net.modules():
            if isinstance(mod, (nn.Conv2d, nn.ConvTranspose2d, nn.Linear)):
                fan_in = mod.weight[0].numel() if not isinstance(mod, nn.ConvTranspose2d) \
                    else mod.weight.shape[0] * mod.weight[0, 0].numel()
                mod.weight.copy_(torch.randn(mod.weight.shape, generator=gen) / fan_in ** 0.5)
                mod.bias.copy_(torch.randn(mod.bias.shape, generator=gen) * 0.1)
            elif isinstance(mod, nn.BatchNorm2d):
                mod.running_mean.copy_(torch.randn(mod.num_features, generator=gen) * 0.1)
                mod.running_var.copy_(torch.rand(mod.num_features, generator=gen) + 0.5)
    return net


def simcc_agreement(simcc_a, simcc_b, tol: float):
    """(equal, compared): SimCC argmaxes of two runs that agree, over the
    rows whose top-two margin in b exceeds tol (elsewhere either argmax is
    right within tol)."""
    top2 = simcc_b.topk(2, dim=-1).values
    settled = (top2[..., 0] - top2[..., 1]) > tol
    same = simcc_a.argmax(-1) == simcc_b.argmax(-1)
    return int((same & settled).sum()), int(settled.sum())


def run_preprocess(torch, ops, tmp: str):
    """The preprocessing path at the published widths on the card: DWPose
    (YOLOX-L + RTMPose-L DW-LL, f32, TF32 off, seeded weights and BN
    statistics) over a PRE_FRAMES-frame 512^2 clip one frame at a time;
    one frame card against CPU; the nets exported to ONNX and run through
    the port's OnnxRunner and DWPoseDetector.from_onnx against the modules,
    and loaded back by load_dwpose_weights bitwise; a TFC-TDF separator at
    Kim_Vocal_2's input geometry through MDXVocalSeparator, card against
    CPU; EmbeddingNet card against CPU; the prepare_stage1 (WavLM from the
    weights phase's checkpoint) and prepare_stage2 --from_keypoints CLIs.
    None of K1-K5 may launch. The ONNX files land in the weights phase's
    directory for verify_weights. Returns the phase's launches (none)."""
    import copy

    import numpy as np

    from mmgt_tpu_torch.data import dwpose_infer as DI
    from mmgt_tpu_torch.data.pose_init import default_skeleton
    from mmgt_tpu_torch.data.separator import MDXVocalSeparator
    from mmgt_tpu_torch.models.dwpose import RTMPose, YOLOXL
    from mmgt_tpu_torch.models.motion_autoencoder import EmbeddingNet
    from mmgt_tpu_torch.scripts import prepare_stage1, prepare_stage2
    from mmgt_tpu_torch.utils.convert import load_dwpose_weights
    from mmgt_tpu_torch.utils.media import save_video
    from mmgt_tpu_torch.utils.onnx_exec import OnnxRunner

    root = os.path.join(tmp, "preprocess")
    weights = os.path.join(tmp, "weights")
    os.makedirs(os.path.join(weights, "DWPose"))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t_phase = time.perf_counter()

    # ---- DWPose at the published widths, one frame at a time
    t0 = time.perf_counter()
    yolox, rtm = YOLOXL.build("cuda", SEED + 80), RTMPose.build("cuda", SEED + 81)
    with torch.no_grad():
        for i, conv in enumerate(yolox.bbox_head.multi_level_conv_obj):
            conv.weight.mul_(1e-4)
            conv.bias.fill_(PRE_OBJ_BIAS - 0.5 * i)  # distinct: the export keeps all three
    det = DI.DWPoseDetector.from_modules(yolox, rtm)
    acc = {"det": [], "pose": []}
    det.det_fn, det.pose_fn = timed(det.det_fn, acc["det"]), timed(det.pose_fn, acc["pose"])
    torch.cuda.synchronize()
    log(f"preprocess: DWPose nets built in {time.perf_counter() - t0:.1f} s: YOLOX-L "
        f"{sum(p.numel() for p in yolox.parameters())} and RTMPose-L "
        f"{sum(p.numel() for p in rtm.parameters())} parameters")
    rng = np.random.default_rng(SEED + 82)
    yy, xx = np.mgrid[:SIZE, :SIZE] / SIZE
    clip = []
    for i in range(PRE_FRAMES):  # a moving bright blob on a gradient, plus noise
        blob = np.exp(-((xx - 0.4 - 0.01 * i) ** 2 + (yy - 0.5) ** 2) / 0.02)
        img = np.stack([yy, xx, blob], -1) * 200 + rng.uniform(0, 40, (SIZE, SIZE, 3))
        clip.append(np.clip(img, 0, 255).astype(np.uint8))
    totals, kps = [], []
    for img in clip:
        t0 = time.perf_counter()
        kp = det(img)
        totals.append(time.perf_counter() - t0)
        require(kp.shape == (134, 3) and bool(np.isfinite(kp).all()),
                f"preprocess: keypoints {kp.shape} not (134, 3) finite")
        kps.append(kp)
    steady = slice(1, None)
    ms = {k: 1e3 * float(np.mean(v[steady])) for k, v in
          (("frame", totals), ("det", acc["det"]), ("pose", acc["pose"]))}
    ms["host"] = ms["frame"] - ms["det"] - ms["pose"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"preprocess: DWPoseDetector on {PRE_FRAMES} frames of {SIZE}^2, one at a time: first "
        f"frame {1e3 * totals[0]:.1f} ms, then per frame {ms['frame']:.2f} ms: detector "
        f"{ms['det']:.2f}, pose net {ms['pose']:.2f}, host pre/post {ms['host']:.2f}; "
        f"{len(acc['pose']) // PRE_FRAMES} crop(s) a frame; max_memory_allocated {peak:.2f} GiB")

    # ---- one frame, card against CPU
    padded, ratio = DI.yolox_preprocess(clip[0])
    x = torch.from_numpy(padded[None]).permute(0, 3, 1, 2).contiguous()
    crop, _ = DI.crop_affine(clip[0], *DI.bbox_xyxy2cs(np.asarray([0, 0, SIZE, SIZE], np.float32)))
    c = torch.from_numpy(((crop - DI.POSE_MEAN) / DI.POSE_STD)[None].astype(np.float32))
    c = c.permute(0, 3, 1, 2).contiguous()
    with torch.no_grad():
        raw_gpu, simcc_gpu = yolox(x.cuda()).cpu(), [s.cpu() for s in rtm(c.cuda())]
        raw_cpu = copy.deepcopy(yolox).cpu()(x)
        simcc_cpu = copy.deepcopy(rtm).cpu()(c)
    for what, g, w in (("boxes", raw_gpu[..., :4], raw_cpu[..., :4]),
                       ("scores", raw_gpu[..., 4:], raw_cpu[..., 4:]),
                       ("simcc_x", simcc_gpu[0], simcc_cpu[0]),
                       ("simcc_y", simcc_gpu[1], simcc_cpu[1])):
        err, scale = max_err(g, w), w.abs().max().item()
        require(bool(torch.isfinite(g).all()) and err <= PRE_REL_TOL * scale,
                f"preprocess: card {what} off the CPU's by {err:.3e} (largest |y| {scale:.3e})")
        log(f"preprocess: card vs CPU {what} {tuple(g.shape)}: max abs err {err:.3e}, "
            f"{err / scale:.2e} of the largest |y| {scale:.3e} (tol {PRE_REL_TOL:g})")
    for i, what in enumerate(("x", "y")):
        tol = PRE_REL_TOL * simcc_cpu[i].abs().max().item()
        same, settled = simcc_agreement(simcc_gpu[i], simcc_cpu[i], tol)
        require(same == settled and settled >= 133 // 2,
                f"preprocess: keypoint {what}: {same} of {settled} settled argmaxes agree")
        log(f"preprocess: keypoint {what}: card argmax equal to the CPU's on {same} of the "
            f"{settled} keypoints whose margin exceeds {tol:.3e}")

    # ---- ONNX: export, the port's runner and from_onnx against the modules
    t0 = time.perf_counter()
    yp = os.path.join(weights, "DWPose", "yolox_l.onnx")
    rp = os.path.join(weights, "DWPose", "dw-ll_ucoco_384.onnx")
    export_onnx(torch, yolox, x.cuda(), yp, ["img"], ["dets"])
    export_onnx(torch, rtm, c.cuda(), rp, ["crop"], ["simcc_x", "simcc_y"])
    log(f"preprocess: YOLOX-L and RTMPose-L exported in {time.perf_counter() - t0:.1f} s "
        f"({os.path.getsize(yp)} and {os.path.getsize(rp)} bytes)")
    for path, model, inp, names in ((yp, yolox, x, ("dets",)),
                                    (rp, rtm, c, ("simcc_x", "simcc_y"))):
        runner = OnnxRunner.from_file(path, "cuda")
        with torch.no_grad():
            want = model(inp.cuda())
        got = runner(inp.numpy())
        want = want if isinstance(want, tuple) else (want,)
        n_ms = time_ms(lambda: runner(inp.numpy()), iters=3, warmup=1)
        m_ms = time_ms(lambda: model(inp.cuda()), iters=3, warmup=1)
        for name, w in zip(names, want):
            err, scale = max_err(got[name], w), w.abs().max().item()
            require(err <= F32_REL_TOL * scale,
                    f"preprocess: OnnxRunner {name} off the module by {err:.3e} ({scale:.3e})")
            log(f"preprocess: OnnxRunner {os.path.basename(path)} {name} "
                f"{tuple(got[name].shape)}: max abs err {err:.3e} against the module "
                f"(largest |y| {scale:.3e}, tol {F32_REL_TOL:g})")
        log(f"preprocess: {os.path.basename(path)}: {len(runner.nodes)} nodes, runner "
            f"{n_ms:.2f} ms a call against the module's {m_ms:.2f} ms")
        with torch.device("meta"):
            fresh = type(model)()
        fresh.to_empty(device="cuda")
        rep = load_dwpose_weights(path, fresh)
        sd = model.state_dict()
        require(not rep["missing"] and not rep["unexpected"], f"preprocess: {rep}")
        require(all(torch.equal(t, sd[k]) for k, t in fresh.state_dict().items()),
                f"preprocess: load_dwpose_weights({os.path.basename(path)}) is not bitwise")
        log(f"preprocess: load_dwpose_weights({os.path.basename(path)}): "
            f"{len(sd)} tensors bitwise equal to the module's")
        del runner, fresh
    onnx_det = DI.DWPoseDetector.from_onnx(yp, rp, device="cuda")
    t0 = time.perf_counter()
    kp_onnx = onnx_det(clip[0])
    sec_onnx = time.perf_counter() - t0
    require(kp_onnx.shape == (134, 3), f"preprocess: from_onnx keypoints {kp_onnx.shape}")
    n_close = int((np.abs(kp_onnx[:, :2] - kps[0][:, :2]).max(-1) <= PRE_KP_TOL).sum())
    score_err = float(np.abs(kp_onnx[:, 2] - kps[0][:, 2]).max())
    require(n_close >= 131 and score_err <= F32_REL_TOL * np.abs(kps[0][:, 2]).max(),
            f"preprocess: from_onnx keypoints: {n_close} of 134 within {PRE_KP_TOL} px, "
            f"scores off by {score_err:.3e}")
    log(f"preprocess: DWPoseDetector.from_onnx on frame 0 in {1e3 * sec_onnx:.1f} ms: "
        f"{n_close} of 134 keypoints within {PRE_KP_TOL:g} px of the module-built detector's, "
        f"scores within {score_err:.3e}")
    del det, onnx_det, yolox, rtm
    torch.cuda.empty_cache()

    # ---- the vocal separator at Kim_Vocal_2's input geometry
    sep_path = os.path.join(weights, "Kim_Vocal_2.onnx")
    net = tfc_tdf_net(torch, 3072, SEED + 83)
    export_onnx(torch, net, torch.zeros(1, 4, 3072, 256), sep_path, ["spec"], ["out"])
    wav = synth_speech(PRE_SEP_SECONDS, SEED + 84)
    sep_gpu = MDXVocalSeparator(sep_path, device="cuda")
    sep_gpu(wav)
    t0 = time.perf_counter()
    v_gpu = sep_gpu(wav)
    sec_sep = time.perf_counter() - t0
    t0 = time.perf_counter()
    v_cpu = MDXVocalSeparator(sep_path, device="cpu")(wav)
    sec_cpu = time.perf_counter() - t0
    err, scale = float(np.abs(v_gpu - v_cpu).max()), float(np.abs(v_cpu).max())
    require(v_gpu.shape == wav.shape and bool(np.isfinite(v_gpu).all())
            and err <= PRE_REL_TOL * scale, f"preprocess: separator off the CPU's by {err:.3e}")
    log(f"preprocess: MDXVocalSeparator (TFC-TDF, (1, 4, 3072, 256) chunks, "
        f"{sum(p.numel() for p in net.parameters())} parameters) on {PRE_SEP_SECONDS} s: "
        f"{sec_sep:.3f} s on the card (second call), {sec_cpu:.3f} s on the CPU; max abs err "
        f"{err:.3e} of the largest |y| {scale:.3e} (tol {PRE_REL_TOL:g})")

    # ---- EmbeddingNet
    emb = EmbeddingNet.build("cuda", SEED + 85)
    poses = torch.randn(4, 80, 402, generator=torch.Generator().manual_seed(SEED + 86))
    with torch.no_grad():
        got = emb(poses.cuda())
        want = copy.deepcopy(emb).cpu()(poses)
    for what, g, w in zip(("recon", "mu", "logvar"), got, want):
        err, scale = max_err(g.cpu(), w), w.abs().max().item()
        require(err <= F32_REL_TOL * scale, f"preprocess: EmbeddingNet {what} off by {err:.3e}")
    log(f"preprocess: EmbeddingNet (4, 80, 402) card against CPU: recon, mu, logvar within "
        f"{F32_REL_TOL:g} of their largest |y|")

    # ---- the dataset-prep CLIs
    src1 = os.path.join(root, "stage1_src")
    os.makedirs(os.path.join(src1, "wavs"))
    os.makedirs(os.path.join(src1, "keypoints"))
    from mmgt_tpu_torch.data.dsp import save_wav
    for i in range(2):
        save_wav(os.path.join(src1, "wavs", f"s{i}.wav"), synth_speech(7.0, SEED + 87 + i), A2V_SR)
        kp = default_skeleton(SIZE, SIZE)[None] + rng.normal(0, 4, (175, 402))
        np.save(os.path.join(src1, "keypoints", f"s{i}.npy"), kp.astype(np.float32))
    out1 = os.path.join(root, "stage1_out")
    t0 = time.perf_counter()
    require(prepare_stage1.main(["--src", src1, "--out", out1, "--wavlm_ckpt",
                                 os.path.join(weights, "wavlm", "WavLM-Large.pt")]) == 0,
            "preprocess: prepare_stage1 failed")
    sec1 = time.perf_counter() - t0
    feats = sorted(os.listdir(os.path.join(out1, "wavlm_feats")))
    require(len(feats) == 4, f"preprocess: prepare_stage1 wrote {feats}")
    for f in feats:
        w = np.load(os.path.join(out1, "wavlm_feats", f))
        b = np.load(os.path.join(out1, "baseline_feats", f))
        require(w.shape == (80, 1059) and bool(np.isfinite(w).all())
                and np.array_equal(w[:, 1024:], b), f"preprocess: prepare_stage1 {f}")
    log(f"preprocess: prepare_stage1 --wavlm_ckpt (WavLM Large from the weights phase's fp16 "
        f"checkpoint, f32 on the card): 2 wavs of 7 s -> {len(feats)} clips of (80, 1059) in "
        f"{sec1:.1f} s")
    src2 = os.path.join(root, "stage2_src")
    for d in ("videos", "keypoints", "audio_emb"):
        os.makedirs(os.path.join(src2, d))
    for i in range(PRE_CLIPS):
        save_video(rng.integers(0, 255, (PRE_FRAMES, SIZE, SIZE, 3)).astype(np.uint8),
                   os.path.join(src2, "videos", f"c{i}.mp4"))
        kp = default_skeleton(SIZE, SIZE)[None] + rng.normal(0, 4, (PRE_FRAMES, 402))
        np.save(os.path.join(src2, "keypoints", f"c{i}.npy"), kp.astype(np.float32))
        np.save(os.path.join(src2, "audio_emb", f"c{i}.npy"),
                rng.standard_normal((PRE_FRAMES, 12, 768)).astype(np.float32))
    out2 = os.path.join(root, "stage2_out")
    t0 = time.perf_counter()
    require(prepare_stage2.main(["--src", src2, "--out", out2, "--from_keypoints"]) == 0,
            "preprocess: prepare_stage2 failed")
    sec2 = time.perf_counter() - t0
    with open(os.path.join(out2, "meta.json")) as f:
        recs = json.load(f)
    require(len(recs) == PRE_CLIPS, f"preprocess: prepare_stage2 wrote {len(recs)} records")
    rec = np.load(recs[0]["record"])
    require(rec["pose"].shape == (PRE_FRAMES, SIZE, SIZE, 3) and rec["pose"].dtype == np.uint8
            and rec["face_mask"].shape == (PRE_FRAMES, SIZE // 8, SIZE // 8)
            and rec["pose"].max() > 0, "preprocess: prepare_stage2 record")
    log(f"preprocess: prepare_stage2 --from_keypoints: {PRE_CLIPS} clips of {PRE_FRAMES} frames "
        f"at {SIZE}^2 in {sec2:.1f} s")

    torch.cuda.synchronize()
    counts = ops.launch_counts()
    require_launches("preprocess", counts, ())
    log(f"preprocess: {time.perf_counter() - t_phase:.1f} s; max_memory_allocated "
        f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; launches " + json.dumps(counts))
    import shutil
    shutil.rmtree(root)
    return counts, {}


def run_release(torch, tmp: str) -> dict:
    """`python -m mmgt_tpu_torch.tools.release_check` in a process of its
    own on the weights phase's directory, at its defaults (512^2, 80
    frames, DPM++ 15 steps): exit 0, every stage ok, a non-empty mp4, K1-K4
    launched in its generate stage (K5 not). Returns those launches."""
    out = os.path.join(tmp, "release_check")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-m", "mmgt_tpu_torch.tools.release_check",
                           os.path.join(tmp, "weights"), "--out", out],
                          cwd=os.path.dirname(os.path.abspath(__file__)), capture_output=True,
                          text=True, timeout=600)
    sec = time.perf_counter() - t0
    require(proc.returncode == 0, f"release: exit {proc.returncode}: {proc.stdout[-1500:]} "
            f"{proc.stderr[-2500:]}")
    with open(os.path.join(out, "release_check.json")) as f:
        rep = json.load(f)
    stages = rep["stages"]
    require(rep["ok"] and list(stages) == ["verify_weights", "generate"]
            and all(v["ok"] for v in stages.values()), "release: " + json.dumps(stages)[:2000])
    gen = stages["generate"]
    require(gen["mp4_bytes"] > 0 and os.path.getsize(gen["mp4"]) == gen["mp4_bytes"],
            "release: no mp4")
    require_launches("release", gen["launches"], INFERENCE_KERNELS)
    log(f"release: {sec:.1f} s in its own process; stage seconds "
        + json.dumps({k: round(v["s"], 3) for k, v in stages.items()})
        + f"; generate {gen['frames']} in {gen['wall_s']:.3f} s, seconds "
        + json.dumps({k: round(v, 3) for k, v in gen["timings"].items()})
        + f", max_memory_allocated {gen['peak_gib']:.2f} GiB, mp4 {gen['mp4_bytes']} bytes; "
        "verify " + json.dumps(stages["verify_weights"]["entries"])
        + "; launches " + json.dumps(gen["launches"]))
    return gen["launches"]


def run_verify_weights(torch, ops, kernel_mods, tmp: str):
    """`python -m mmgt_tpu_torch.scripts.verify_weights` with --forward on
    the weights phase's directory, which now also holds the preprocess
    phase's DWPose and separator graphs: every entry [ok], every net run
    on the card (the Stage-2 UNets at an 8x8 latent launch K1-K4); then
    the directory is removed."""
    import shutil

    from mmgt_tpu_torch.scripts import verify_weights

    weights = os.path.join(tmp, "weights")
    report = os.path.join(tmp, "verify.json")
    rc, counts, calls, sec, peak = record_call(torch, ops, kernel_mods, lambda: verify_weights.main(
        [weights, "--forward", "--json", report]))
    with open(report) as f:
        rep = json.load(f)
    entries = {k: v for k, v in rep.items() if k != "forward"}
    require(rc == 0 and len(entries) == 13 and all(v.get("status") == "ok" for v in entries.values()),
            "verify_weights: " + json.dumps({k: v.get("status") for k, v in entries.items()}))
    require(len(rep["forward"]) == 12, f"verify_weights: forwarded {sorted(rep['forward'])}")
    log(f"verify_weights: {len(entries)} entries ok, {len(rep['forward'])} nets run on the card, "
        f"{sec:.1f} s, max_memory_allocated {peak:.2f} GiB; launches " + json.dumps(counts))
    shutil.rmtree(weights)
    return counts, calls


# ---------------------------------------------------------------- training
def make_train_batch(torch, b: int, frames: int, size: int, seed: int, device="cpu"):
    """A seeded random Stage-2 batch (`mmgt_tpu_torch/testing.py`), so that
    the loss is not trivially 0."""
    from mmgt_tpu_torch.testing import train_batch

    return train_batch(b, frames, size, seed, device)


def run_train(torch, ops, Stage2Trainer, kernel_mods, tmp: str):
    """Full-width Stage-2 training steps on the card, then 2 more through
    the video CLI's `run` (`run_train_cli`). Returns (launches, launches
    per step, the CLI run's launches, its recorded calls)."""
    t0 = time.perf_counter()
    trainer = Stage2Trainer.build(torch.bfloat16, device="cuda", seed=SEED, remat=True)
    state = trainer.init_state()
    from mmgt_tpu_torch.training.stage2 import partition_params

    _, frozen = partition_params(trainer.pipeline)
    n_train = sum(p.numel() for p in state.trainable.values())
    n_frozen = sum(p.numel() for p in frozen.values())
    torch.cuda.synchronize()
    log(f"train: build + init_params + init_state {time.perf_counter() - t0:.1f} s; "
        f"{len(state.trainable)} trainable tensors ({n_train / 1e6:.1f} M), "
        f"{len(frozen)} frozen ({n_frozen / 1e6:.1f} M)")
    batch = make_train_batch(torch, 1, TRAIN_FRAMES, SIZE, SEED + 9, "cuda")
    frozen0 = {n: p.detach().clone() for n, p in frozen.items()}
    masters0 = {n: m.clone() for n, m in state.masters.items()}
    working0 = {n: p.detach().clone() for n, p in state.trainable.items()}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    torch.cuda.reset_peak_memory_stats()
    steps, per_step = [], []
    for i in range(TRAIN_STEPS):
        ops.reset_launch_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        metrics = trainer.train_step(state, batch, generator=gen)
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        counts = ops.launch_counts()
        loss, mse = float(metrics["loss"]), float(metrics["mse"])
        log(f"train: step {i} loss {loss:.6f} mse {mse:.6f} {sec:.3f} s launches "
            + json.dumps(counts))
        require(math.isfinite(loss) and math.isfinite(mse), f"train step {i}: loss not finite")
        require(counts["flash_attention_bwd"] == EXPECTED_K5_PER_STEP,
                f"train step {i}: K5 launched {counts['flash_attention_bwd']} times, "
                f"expected {EXPECTED_K5_PER_STEP}")
        for name in INFERENCE_KERNELS:
            require(counts[name] > 0, f"train step {i}: {name} was not launched")
        steps.append(sec)
        per_step.append(counts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    moved = [n for n, m in state.masters.items() if not torch.equal(m, masters0[n])]
    require(len(moved) == len(state.masters),
            f"{len(state.masters) - len(moved)} trainable f32 masters did not move")
    w_moved = sum(not torch.equal(p, working0[n]) for n, p in state.trainable.items())
    require(w_moved > 0, "no bf16 working weight changed")
    changed = [n for n, p in frozen.items() if not torch.equal(p, frozen0[n])]
    require(not changed, f"frozen tensors changed: {changed[:3]}")
    later = steps[1:]
    log(f"train: seconds per step after the first {later} (mean "
        f"{sum(later) / len(later):.3f}); first {steps[0]:.3f}; max_memory_allocated "
        f"{peak:.2f} GiB; f32 masters moved {len(moved)}/{len(state.masters)}, bf16 working "
        f"tensors changed {w_moved}/{len(state.trainable)}, frozen tensors unchanged "
        f"{len(frozen)}/{len(frozen)}")
    total = {k: sum(c[k] for c in per_step) for k in per_step[0]}
    del frozen, frozen0, masters0, working0, batch
    torch.cuda.empty_cache()
    cli_counts, cli_calls = run_train_cli(torch, ops, kernel_mods, trainer, state, tmp)
    del trainer, state
    torch.cuda.empty_cache()
    return total, {k: n / TRAIN_STEPS for k, n in total.items()}, cli_counts, cli_calls


def tiny_pipeline(torch, Pose2VideoPipeline, device, dtype):
    """The small pipeline's models (`mmgt_tpu_torch/testing.py`'s SMALL
    widths; its audio projection takes full-width (5, 12, 768) audio
    embeddings) with seeded weights."""
    from mmgt_tpu_torch.models.audio_proj import AudioProjModel
    from mmgt_tpu_torch.testing import SMALL, stage2_models

    torch.manual_seed(SEED)
    models = stage2_models(SMALL)
    models["audio_proj"] = AudioProjModel(
        intermediate_dim=SMALL["audio_proj"]["intermediate_dim"])
    pipe = Pose2VideoPipeline(**models, context_size=6, context_overlap=2)
    for m in pipe.models().values():
        m.to(device=device, dtype=dtype)
    pipe.init_params(SEED, std=0.05)
    return pipe


def run_train_small(torch, Pose2VideoPipeline, Stage2Trainer):
    """Tiny trainer, no remat (K3's and K4's Functions carry the gradients
    directly): card (bf16, kernels) vs CPU (f32, plain versions)."""
    ref = tiny_pipeline(torch, Pose2VideoPipeline, "cpu", torch.float32)
    runs = {"cpu_f32": ref, "cpu_bf16": tiny_pipeline(torch, Pose2VideoPipeline, "cpu",
                                                      torch.bfloat16),
            "card_bf16": tiny_pipeline(torch, Pose2VideoPipeline, "cuda", torch.bfloat16)}
    for pipe in runs.values():
        if pipe is not ref:
            for name, m in ref.models().items():
                getattr(pipe, name).load_state_dict(m.state_dict())
    b, frames, size = 2, 4, 64
    batch = make_train_batch(torch, b, frames, size, SEED + 10)
    draws = Stage2Trainer(ref).draws(b, frames, size // 8, size // 8,
                                     torch.Generator().manual_seed(SEED + 11))
    draws["keep_img"] = torch.tensor([True, False])   # one row without the bank
    draws["keep_aud"] = torch.tensor([False, True])   # one row without audio
    out = {}
    for tag, pipe in runs.items():
        trainer = Stage2Trainer(pipe)
        state = trainer.init_state()
        loss, _ = trainer.loss_fn(batch, draws)
        grads = torch.autograd.grad(loss, list(state.trainable.values()))
        out[tag] = (loss.item(), torch.cat([g.float().cpu().reshape(-1) for g in grads]))
    f32_loss, f32_g = out["cpu_f32"]
    errs = {tag: (abs(out[tag][0] - f32_loss), (out[tag][1] - f32_g).abs().mean().item())
            for tag in ("cpu_bf16", "card_bf16")}
    log(f"train_small: loss cpu_f32 {f32_loss:.6f} cpu_bf16 {out['cpu_bf16'][0]:.6f} "
        f"card_bf16 {out['card_bf16'][0]:.6f}; |loss err|, mean |grad err| vs CPU f32 "
        f"(mean |grad| {f32_g.abs().mean().item():.3e}): plain bf16 on the CPU "
        f"{errs['cpu_bf16']}, kernels bf16 on the card {errs['card_bf16']} "
        f"(tol: {SMALL_ERR_FACTOR}x the plain bf16 error; the loss's floored at one bf16 "
        f"ulp of the loss)")
    require(all(math.isfinite(v[0]) and bool(torch.isfinite(v[1]).all()) for v in out.values()),
            "train_small: loss or gradients not finite")
    loss_floor = max(errs["cpu_bf16"][0], 2.0 ** -8 * abs(f32_loss))
    require(errs["card_bf16"][0] <= SMALL_ERR_FACTOR * loss_floor,
            "train_small: the card's loss error exceeds the bound")
    require(errs["card_bf16"][1] <= SMALL_ERR_FACTOR * errs["cpu_bf16"][1],
            "train_small: the card's gradient error exceeds "
            f"{SMALL_ERR_FACTOR}x the plain bf16 error")


def write_clip_records(root: str, n: int, frames: int, size: int, seed: int) -> str:
    """n packed .npz clip records (seeded frames, pose maps, 64-level
    masks and f16 audio embeddings, as `tools/prepare_stage2.py` packs
    them) under `root` and their meta JSON; returns the meta's path."""
    import numpy as np

    os.makedirs(root, exist_ok=True)
    rng = np.random.default_rng(seed)
    h8 = size // 8
    recs = []
    for i in range(n):
        path = os.path.join(root, f"clip{i}.npz")
        np.savez(path, frames=rng.integers(0, 256, (frames, size, size, 3), dtype=np.uint8),
                 pose=rng.integers(0, 256, (frames, size, size, 3), dtype=np.uint8),
                 face_mask=rng.integers(0, 256, (frames, h8, h8), dtype=np.uint8),
                 lips_mask=rng.integers(0, 256, (frames, h8, h8), dtype=np.uint8),
                 audio_emb=rng.standard_normal((frames, 12, 768)).astype(np.float16))
        recs.append({"record": path})
    meta = os.path.join(root, "meta.json")
    with open(meta, "w") as f:
        json.dump(recs, f)
    return meta


def seeded_clip(torch, seed: int):
    """CLIP ViT-L/14 at full width in bf16 on the card, seeded weights."""
    from mmgt_tpu_torch.models.clip_vision import CLIPVisionModel
    from mmgt_tpu_torch.pipelines.pose2vid import init_random_params

    with torch.device("meta"):
        clip = CLIPVisionModel()
    clip.to_empty(device="cuda").to(torch.bfloat16)
    return init_random_params(clip, torch.Generator(device="cuda").manual_seed(seed))


def require_disk(tmp: str, need: int, tag: str):
    import shutil

    free = shutil.disk_usage(tmp).free
    log(f"{tag}: {need} bytes to write, {free} free in the temporary directory")
    require(free > need + 2**30, f"{tag}: {need} bytes to write, {free} free")


def tree_bytes(tree) -> int:
    return sum(v.numel() * v.element_size() for v in tree.values() if hasattr(v, "numel"))


def run_train_cli(torch, ops, kernel_mods, trainer, state, tmp: str):
    """The video CLI's `run` for 2 more steps on the train phase's trainer
    and state, on a synthetic TalkingVideoDataset (2 records of 20 frames
    at 512^2), ending in its checkpoint; returns (launches, calls)."""
    import shutil

    from mmgt_tpu_torch.config import Stage2TrainConfig
    from mmgt_tpu_torch.data.datasets import TalkingVideoDataset
    from mmgt_tpu_torch.scripts import train_stage2 as cli

    root = os.path.join(tmp, "train_cli")
    cfg = Stage2TrainConfig(meta_paths=[write_clip_records(root, 2, 20, SIZE, SEED + 61)],
                            max_train_steps=state.step + 2, seed=SEED,
                            checkpoint_dir=os.path.join(root, "ckpt"))
    require_disk(tmp, tree_bytes(trainer.checkpoint_tree(state)), "train_cli")
    ds = TalkingVideoDataset(cfg.meta_paths, cfg.n_sample_frames, cfg.audio_margin)
    losses = []
    state_out, counts, calls, sec, peak = record_call(torch, ops, kernel_mods, lambda: cli.run(
        trainer, ds, cfg, state=state, on_step=lambda step, m: losses.append(float(m["loss"]))))
    require(state_out.step == cfg.max_train_steps, f"train_cli: stopped at {state_out.step}")
    require(all(math.isfinite(x) for x in losses), f"train_cli: losses {losses}")
    require(counts["flash_attention_bwd"] == 2 * EXPECTED_K5_PER_STEP,
            f"train_cli: K5 launched {counts['flash_attention_bwd']} times in 2 steps")
    ckpt = os.path.join(cfg.checkpoint_dir, f"ckpt-{state_out.step}.ckpt")
    log(f"train_cli: 2 steps through the video CLI's run, {sec:.3f} s with its checkpoint "
        f"({os.path.getsize(ckpt)} bytes); losses {losses}; max_memory_allocated {peak:.2f} "
        f"GiB; launches " + json.dumps(counts))
    shutil.rmtree(root)
    return counts, calls


def run_train_image(torch, ops, kernel_mods, tmp: str):
    """The image pretrain at full width through the image CLI's `run`:
    256^2, batch 4, TRAIN_IMAGE_STEPS steps on a synthetic
    HumanDanceDataset with a seeded full-width CLIP; then the run's last
    checkpoint restored into a fresh state and one more step from it.
    Returns (launches, launches per step, recorded calls)."""
    import shutil

    from mmgt_tpu_torch.config import Stage2ImageTrainConfig
    from mmgt_tpu_torch.data.datasets import HumanDanceDataset
    from mmgt_tpu_torch.scripts import train_stage2_image as cli
    from mmgt_tpu_torch.training.loop import step_generator
    from mmgt_tpu_torch.training.stage2 import encode_clip_batch
    from mmgt_tpu_torch.utils.checkpoint import CheckpointManager

    root = os.path.join(tmp, "train_image")
    cfg = Stage2ImageTrainConfig(
        meta_paths=[write_clip_records(root, 2, 40, TRAIN_IMAGE_SIZE, SEED + 60)],
        max_train_steps=TRAIN_IMAGE_STEPS, seed=SEED, checkpoint_dir=os.path.join(root, "ckpt"))
    require((cfg.train_height, cfg.batch_size) == (TRAIN_IMAGE_SIZE, 4), "train_image: config")
    t0 = time.perf_counter()
    trainer, _ = cli.build(cfg, "cuda", SEED)
    clip = seeded_clip(torch, SEED + 62)
    state = trainer.init_state()
    torch.cuda.synchronize()
    n_train = sum(p.numel() for p in state.trainable.values())
    n_ref = sum(p.numel() for n, p in state.trainable.items() if n.startswith("reference_unet."))
    n_frozen = sum(p.numel() for p in state.frozen.values())
    log(f"train_image: build + init_state {time.perf_counter() - t0:.1f} s; "
        f"{len(state.trainable)} trainable tensors, {n_train} parameters ({n_ref} of them the "
        f"ReferenceNet's), {len(state.frozen)} frozen ({n_frozen})")
    require_disk(tmp, tree_bytes(trainer.checkpoint_tree(state)), "train_image")
    masters0 = {n: m.cpu() for n, m in state.masters.items()}
    frozen0 = {n: p.detach().cpu() for n, p in state.frozen.items()}
    ds = HumanDanceDataset(cfg.meta_paths, cfg.sample_margin)
    steps, per_step, losses = [], [], []
    last = {}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now, counts = time.perf_counter(), ops.launch_counts()
        per_step.append({k: counts[k] - last["counts"][k] for k in counts})
        steps.append(now - last["t"])
        losses.append(float(metrics["loss"]))
        last.update(t=now, counts=counts)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    last.update(t=time.perf_counter(), counts=ops.launch_counts())
    with LaunchRecorder(torch, kernel_mods) as rec:
        cli.run(trainer, ds, cfg, clip, state=state, on_step=on_step)
        torch.cuda.synchronize()
    save_s = time.perf_counter() - last["t"]
    peak = torch.cuda.max_memory_allocated() / 2**30
    counts = ops.launch_counts()
    for name, n in counts.items():
        require(sum(c for (k, _), (c, _) in rec.calls.items() if k == name) == n,
                f"train_image {name}: the recorded launches do not add up to the run's")
    for i, (c, loss) in enumerate(zip(per_step, losses)):
        log(f"train_image: step {i} loss {loss:.6f} {steps[i]:.3f} s launches " + json.dumps(c))
        require(math.isfinite(loss), f"train_image step {i}: loss not finite")
        require_launches(f"train_image step {i}", c, IMAGE_TRAIN_KERNELS)
        require(c["flash_attention_bwd"] == EXPECTED_K5_PER_IMAGE_STEP,
                f"train_image step {i}: K5 launched {c['flash_attention_bwd']} times, expected "
                f"{EXPECTED_K5_PER_IMAGE_STEP}")
    require(len(steps) == TRAIN_IMAGE_STEPS, f"train_image: {len(steps)} steps")
    moved = [n for n, m in state.masters.items() if not torch.equal(m.cpu(), masters0[n])]
    require(len(moved) == len(masters0),
            f"train_image: {len(masters0) - len(moved)} f32 masters did not move")
    changed = [n for n, p in state.frozen.items() if not torch.equal(p.detach().cpu(), frozen0[n])]
    require(not changed, f"train_image: frozen tensors changed: {changed[:3]}")
    require(any(n.startswith("vae.") for n in frozen0)
            and any(n.startswith("reference_unet.up_blocks.3.") for n in frozen0),
            "train_image: the VAE and the ReferenceNet's up_blocks.3 are not frozen")
    del masters0, frozen0
    later = steps[1:]
    log(f"train_image: seconds per step after the first {later} (mean "
        f"{sum(later) / len(later):.3f}); first {steps[0]:.3f}; max_memory_allocated {peak:.2f} "
        f"GiB; f32 masters moved {len(moved)}/{len(moved)} (ReferenceNet's among them), frozen "
        f"tensors unchanged {len(state.frozen)}/{len(state.frozen)}")

    # the run's last checkpoint into a fresh state of other seeded weights
    mgr = CheckpointManager(cfg.checkpoint_dir)
    require(mgr.all_steps() == [TRAIN_IMAGE_STEPS], f"train_image: checkpoints {mgr.all_steps()}")
    ckpt_bytes = os.path.getsize(mgr.path(TRAIN_IMAGE_STEPS))
    fresh, _ = cli.build(cfg, "cuda", SEED + 1)
    fresh_state = fresh.init_state()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    require(fresh.restore(fresh_state, mgr) == TRAIN_IMAGE_STEPS, "train_image: restored step")
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    a, b = trainer.checkpoint_tree(state), fresh.checkpoint_tree(fresh_state)
    require(set(a) == set(b), "train_image: the restored tree has other names")
    differ = [k for k in a if (not torch.equal(a[k], b[k]) if isinstance(a[k], torch.Tensor)
                               else a[k] != b[k])]
    require(not differ, f"train_image: restored tensors differ: {differ[:3]}")
    n_tensors = sum(isinstance(v, torch.Tensor) for v in a.values())
    del a, b, trainer, state
    torch.cuda.empty_cache()
    raw = next(ds.batches(cfg.batch_size, cfg.seed + fresh_state.step))
    batch = {k: torch.from_numpy(raw[k]).cuda() for k in ("tgt_image", "ref_image", "tgt_pose")}
    batch["clip_embed"] = encode_clip_batch(clip, torch.from_numpy(raw["clip_image"]).cuda())
    m = fresh.train_step(fresh_state, batch,
                         generator=step_generator("cuda", cfg.seed, fresh_state.step))
    loss = float(m["loss"])
    require(math.isfinite(loss) and fresh_state.step == TRAIN_IMAGE_STEPS + 1,
            f"train_image: the step after the restore gave loss {loss}")
    log(f"train_image: checkpoint at step {TRAIN_IMAGE_STEPS}, {ckpt_bytes} bytes, written in "
        f"{save_s:.3f} s (the run's last save), restored into a fresh state in {restore_s:.3f} s: "
        f"{n_tensors} tensors and the step bitwise equal; one more step from it: loss "
        f"{loss:.6f}")
    total = {k: sum(c[k] for c in per_step) for k in per_step[0]}
    calls = rec.calls
    del fresh, fresh_state, clip, batch
    torch.cuda.empty_cache()
    shutil.rmtree(root)
    return total, {k: n / TRAIN_IMAGE_STEPS for k, n in total.items()}, calls


def run_train_image_small(torch):
    """A tiny image trainer (the small pipeline's widths, no audio or
    motion modules) at 64^2, batch 2 (row 1 drops its reference) three
    ways as `train_small`: the loss and the flattened trainable gradients,
    the ReferenceNet's among them, against CPU f32."""
    from mmgt_tpu_torch.training.stage2_image import Stage2ImageTrainer

    ref = tiny_pose2img(torch, "cpu", torch.float32)
    runs = {"cpu_f32": ref, "cpu_bf16": tiny_pose2img(torch, "cpu", torch.bfloat16),
            "card_bf16": tiny_pose2img(torch, "cuda", torch.bfloat16)}
    for pipe in runs.values():
        if pipe is not ref:
            for name, m in ref.models().items():
                getattr(pipe, name).load_state_dict(m.state_dict())
    g = torch.Generator().manual_seed(SEED + 63)
    b, size = 2, 64
    batch = {"tgt_image": torch.rand(b, size, size, 3, generator=g) * 2 - 1,
             "ref_image": torch.rand(b, size, size, 3, generator=g) * 2 - 1,
             "tgt_pose": torch.rand(b, size, size, 3, generator=g),
             "clip_embed": torch.randn(b, 1, 768, generator=g)}
    draws = Stage2ImageTrainer(ref).draws(b, size // 8, size // 8, g)
    draws["keep"] = torch.tensor([True, False])  # one row without its reference
    out = {}
    for tag, pipe in runs.items():
        trainer = Stage2ImageTrainer(pipe)
        state = trainer.init_state()
        loss, _ = trainer.loss_fn(batch, draws)
        names = list(state.trainable)
        grads = torch.autograd.grad(loss, [state.trainable[n] for n in names], allow_unused=True)
        flat = torch.cat([(torch.zeros_like(state.trainable[n]) if gr is None else gr)
                          .float().cpu().reshape(-1) for n, gr in zip(names, grads)])
        ref_g = torch.cat([gr.float().cpu().reshape(-1) for n, gr in zip(names, grads)
                           if gr is not None and n.startswith("reference_unet.")])
        out[tag] = (loss.item(), flat, ref_g)
    f32_loss, f32_g, f32_ref = out["cpu_f32"]
    require(f32_ref.abs().max().item() > 0, "train_image_small: no ReferenceNet gradient")
    errs = {tag: (abs(out[tag][0] - f32_loss), (out[tag][1] - f32_g).abs().mean().item(),
                  (out[tag][2] - f32_ref).abs().mean().item())
            for tag in ("cpu_bf16", "card_bf16")}
    log(f"train_image_small: loss cpu_f32 {f32_loss:.6f} cpu_bf16 {out['cpu_bf16'][0]:.6f} "
        f"card_bf16 {out['card_bf16'][0]:.6f}; |loss err|, mean |grad err| (all trainable; "
        f"the ReferenceNet's) vs CPU f32 (mean |grad| {f32_g.abs().mean().item():.3e}, the "
        f"ReferenceNet's {f32_ref.abs().mean().item():.3e}): plain bf16 on the CPU "
        f"{errs['cpu_bf16']}, kernels bf16 on the card {errs['card_bf16']} (tol: "
        f"{SMALL_ERR_FACTOR}x the plain bf16 error; the loss's floored at one bf16 ulp)")
    require(all(math.isfinite(v[0]) and bool(torch.isfinite(v[1]).all()) for v in out.values()),
            "train_image_small: loss or gradients not finite")
    loss_floor = max(errs["cpu_bf16"][0], 2.0 ** -8 * abs(f32_loss))
    require(errs["card_bf16"][0] <= SMALL_ERR_FACTOR * loss_floor,
            "train_image_small: the card's loss error exceeds the bound")
    for i, what in ((1, "gradient"), (2, "ReferenceNet gradient")):
        require(errs["card_bf16"][i] <= SMALL_ERR_FACTOR * errs["cpu_bf16"][i],
                f"train_image_small: the card's {what} error exceeds {SMALL_ERR_FACTOR}x the "
                f"plain bf16 error")


def write_gesture_dir(root: str, n: int, seed: int) -> str:
    """n aligned Stage-1 items: keypoints (80, 402) in [0, 1] and WavLM +
    baseline features (80, 1059), seeded."""
    import numpy as np

    rng = np.random.default_rng(seed)
    for sub in ("keypoints", "wavlm_feats"):
        os.makedirs(os.path.join(root, sub), exist_ok=True)
    for i in range(n):
        np.save(os.path.join(root, "keypoints", f"c{i}.npy"),
                rng.uniform(0, 1, (80, 402)).astype(np.float32))
        np.save(os.path.join(root, "wavlm_feats", f"c{i}.npy"),
                rng.standard_normal((80, 1059)).astype(np.float32))
    return root


def run_train_a2p(torch, ops, tmp: str):
    """The SMGA trainer at the reference's widths (8 x 512, ff 1024, a
    1059-d condition), f32, TF32 off, batch A2P_BATCH, A2P_STEPS steps
    through the Stage-1 CLI's `run`; the EMA held to d ema + (1 - d) params
    after each step; then one more step on the card against the same step
    on the CPU in f32. Returns its launches (none: no kernel here)."""
    import shutil

    from mmgt_tpu_torch.config import Stage1TrainConfig
    from mmgt_tpu_torch.data.datasets import GestureDataset
    from mmgt_tpu_torch.scripts import train_a2p as cli
    from mmgt_tpu_torch.training.adan import Adan
    from mmgt_tpu_torch.training.stage1 import SMGA

    root = os.path.join(tmp, "train_a2p")
    cfg = Stage1TrainConfig(data_dir=write_gesture_dir(os.path.join(root, "data"), A2P_BATCH,
                                                       SEED + 70),
                            epochs=A2P_STEPS, checkpoint_dir=os.path.join(root, "ckpt"), seed=SEED)
    require(cfg.batch_size == A2P_BATCH and cfg.feature_type == "wavlm", "train_a2p: config")
    smga = cli.build(cfg, "cuda", SEED)
    state = smga.init_state()
    n_params = sum(p.numel() for p in state.params.values())
    require(all(torch.equal(state.ema[n], p) for n, p in state.params.items()),
            "train_a2p: the EMA does not start equal to the parameters")
    ds = GestureDataset(cfg.data_dir, cfg.feature_type)
    d = smga.ema_decay
    prev = {n: e.clone() for n, e in state.ema.items()}
    steps, losses, ema_errs = [], [], []
    last = {}

    def on_step(step, metrics):
        torch.cuda.synchronize()
        now = time.perf_counter()
        steps.append(now - last["t"])
        losses.append(float(metrics["loss"]))
        worst = 0.0
        for n, p in state.params.items():
            want = prev[n] * d + p.detach() * (1.0 - d)
            worst = max(worst, (state.ema[n] - want).abs().max().item()
                        / max(want.abs().max().item(), 1e-30))
            prev[n].copy_(state.ema[n])
        ema_errs.append(worst)
        last["t"] = time.perf_counter()

    ops.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    last["t"] = time.perf_counter()
    cli.run(smga, ds, cfg, state=state, on_step=on_step)
    torch.cuda.synchronize()
    counts = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated() / 2**30
    require(len(steps) == A2P_STEPS and all(math.isfinite(x) for x in losses),
            f"train_a2p: losses {losses}")
    # e d + p (1 - d) on either side: each product rounds once, the sum once
    require(max(ema_errs) <= 2.0 ** -23, f"train_a2p: EMA off by {max(ema_errs)} (relative)")
    require(not any(counts.values()), "train_a2p: a kernel was launched " + json.dumps(counts))
    later = steps[1:]
    log(f"train_a2p: {n_params} parameters, batch {A2P_BATCH} x 80 frames, f32: losses "
        f"{losses}; seconds per step after the first {later} (mean {sum(later) / len(later):.3f}),"
        f" first {steps[0]:.3f}; max_memory_allocated {peak:.2f} GiB; EMA against d ema + "
        f"(1 - d) params after each step, largest relative error {ema_errs}")

    # one more step on the card and the same step on the CPU (f32)
    cpu = SMGA(feature_type=cfg.feature_type)
    cpu.model.load_state_dict(smga.model.state_dict())
    cs = cpu.init_state()
    for n in cs.ema:
        cs.ema[n].copy_(state.ema[n].cpu())
    for k in Adan.BUFFERS:
        for dst, src in zip(cs.opt.buffers[k], state.opt.buffers[k]):
            dst.copy_(src.cpu())
    cs.opt.step_count, cs.step = state.opt.step_count, state.step
    raw = next(ds.batches(A2P_CPU_ROWS, SEED + 72))
    batch = {k: torch.from_numpy(v) for k, v in raw.items()}
    draws = cpu.draws(A2P_CPU_ROWS, torch.Generator().manual_seed(SEED + 73))
    g_prev = [g.clone() for g in cs.opt.buffers["prev_grad"]]
    card_m = smga.train_step(state, {k: v.cuda() for k, v in batch.items()},
                             {k: v.cuda() for k, v in draws.items()})
    t0 = time.perf_counter()
    cpu_m = cpu.train_step(cs, batch, draws)
    cpu_s = time.perf_counter() - t0
    loss_err = abs(float(card_m["loss"]) - float(cpu_m["loss"])) / abs(float(cpu_m["loss"]))
    g_card = [g.cpu() for g in state.opt.buffers["prev_grad"]]
    g_cpu = cs.opt.buffers["prev_grad"]
    g_max = max(g.abs().max().item() for g in g_cpu)
    g_err = max((a - b).abs().max().item() for a, b in zip(g_card, g_cpu)) / g_max
    lr = smga.learning_rate
    p_max = max(p.abs().max().item() for p in cs.params.values())
    held = total = 0
    worst = {"params": 0.0, "ema": 0.0}
    for i, n in enumerate(cs.params):
        # Adan divides by |g + (1 - b2)(g - g_prev)|: held where that is 10 x
        # the gradients' largest card-vs-CPU difference away from 0, so the
        # difference moves the ratio by under 10 %
        nx = g_cpu[i] + 0.92 * (g_cpu[i] - g_prev[i])
        settled = nx.abs() > 10 * g_err * g_max
        for what, card_t, cpu_t in (("params", state.params[n].detach(), cs.params[n].detach()),
                                    ("ema", state.ema[n], cs.ema[n])):
            err = (card_t.cpu() - cpu_t).abs()[settled]
            worst[what] = max(worst[what], err.max().item() if err.numel() else 0.0)
        held, total = held + int(settled.sum()), total + settled.numel()
    p_tol = 1e-6 * p_max + 0.1 * lr
    log(f"train_a2p_card_vs_cpu: one step of {A2P_CPU_ROWS} rows (CPU {cpu_s:.1f} s): loss "
        f"{float(card_m['loss']):.6f} vs {float(cpu_m['loss']):.6f} (relative err {loss_err:.3e},"
        f" tol {A2P_LOSS_TOL:g}); gradients' max err / max |g| {g_err:.3e} (tol "
        f"{A2P_GRAD_TOL:g}); weights and EMA where Adan's denominator is settled "
        f"({held}/{total} = {held / total:.4f} of them): max err {worst} (tol {p_tol:.3e} = "
        f"1e-6 max|p| + 0.1 lr)")
    require(loss_err <= A2P_LOSS_TOL, "train_a2p_card_vs_cpu: loss")
    require(g_err <= A2P_GRAD_TOL, "train_a2p_card_vs_cpu: gradients")
    require(max(worst.values()) <= p_tol, "train_a2p_card_vs_cpu: weights or EMA")
    require(held >= 0.8 * total, "train_a2p_card_vs_cpu: too few settled weights to hold")
    del smga, state, cpu, cs
    torch.cuda.empty_cache()
    shutil.rmtree(root)
    return counts


def run_soak(torch, ops, kernel_mods):
    """JAX's overfit tests (tests/test_training_soak.py:54, :165) at full
    width. Stage 2: `Stage2Trainer.build(bf16, remat=True)`, SOAK_SIZE^2,
    12 frames, batch 1, SOAK_STEPS steps on one fixed jittered batch with 4
    fixed (t, noise) draws in turn, lr SOAK_LR, CFG dropout and noise
    offset off: every loss finite, each draw's loss ends lower than it
    started, K5 launched in every step; the mean drop is printed against
    JAX's tiny-width SOAK_DROP_PREDICTED. Then SMGA at the reference's
    widths, f32, batch 1, SMGA_SOAK_STEPS steps, lr SMGA_SOAK_LR, no
    condition dropout, 4 fixed draws: the mean loss falls by more than
    SMGA_SOAK_DROP x, no kernel launched. Returns (launches, calls) of the
    Stage-2 steps."""
    from mmgt_tpu_torch.training.stage1 import SMGA
    from mmgt_tpu_torch.training.stage2 import Stage2Trainer

    t0 = time.perf_counter()
    trainer = Stage2Trainer.build(torch.bfloat16, device="cuda", seed=SEED, remat=True,
                                  learning_rate=SOAK_LR, uncond_img_ratio=0.0,
                                  uncond_audio_ratio=0.0, noise_offset=0.0)
    state = trainer.init_state()
    torch.cuda.synchronize()
    log(f"soak: build + init_state {time.perf_counter() - t0:.1f} s")
    batch = trainer.make_example_batch(1, TRAIN_FRAMES, SOAK_SIZE, SOAK_SIZE)
    g = torch.Generator(device="cuda").manual_seed(SEED + 100)
    jitter = lambda x: x + 0.3 * torch.randn(x.shape, generator=g, device="cuda")  # noqa: E731
    for k in ("pixel_values", "ref_image", "audio_embeds"):
        batch[k] = jitter(batch[k])
    batch["pose_video"] = jitter(batch["pose_video"]).abs()
    h8 = SOAK_SIZE // 8
    draws = [trainer.draws(1, TRAIN_FRAMES, h8, h8, torch.Generator(device="cuda").manual_seed(
        SEED + 101 + i)) for i in range(4)]
    losses, k5, secs = [], [], []

    def steps():
        for i in range(SOAK_STEPS):
            before = ops.launch_counts()["flash_attention_bwd"]
            t1 = time.perf_counter()
            losses.append(float(trainer.train_step(state, batch, draws[i % 4])["loss"]))
            secs.append(time.perf_counter() - t1)
            k5.append(ops.launch_counts()["flash_attention_bwd"] - before)

    _, counts, calls, sec, peak = record_call(torch, ops, kernel_mods, steps)
    require(all(math.isfinite(x) for x in losses), f"soak: losses {losses}")
    require(all(n > 0 for n in k5), f"soak: K5 launches per step {k5}")
    for name in INFERENCE_KERNELS:
        require(counts[name] > 0, f"soak: {name} was not launched")
    cycles = [losses[j::4] for j in range(4)]
    first, last = sum(losses[:4]) / 4, sum(losses[-4:]) / 4
    log(f"soak: Stage 2, {SOAK_STEPS} steps at {SOAK_SIZE}^2 in {sec:.1f} s ({sum(secs[1:]) / (len(secs) - 1):.3f} s "
        f"a step after the first), max_memory_allocated {peak:.2f} GiB, K5 {k5[0]} a step; "
        f"each draw's first and last loss {[(c[0], c[-1]) for c in cycles]}; mean of the first "
        f"4 {first:.6f}, of the last 4 {last:.6f}: a drop of {1 - last / first:.3f} (JAX's "
        f"tiny-width criterion, a prediction here: {SOAK_DROP_PREDICTED}); launches "
        + json.dumps(counts))
    for j, c in enumerate(cycles):
        require(c[-1] < c[0], f"soak: draw {j}'s loss did not fall: {c}")
    del trainer, state, batch, draws
    torch.cuda.empty_cache()

    smga = SMGA.build("cuda", SEED, feature_type="baseline", learning_rate=SMGA_SOAK_LR,
                      cond_drop_prob=0.0)
    sstate = smga.init_state()
    gs = torch.Generator(device="cuda").manual_seed(SEED + 110)
    sbatch = {"keypoints": torch.cumsum(0.02 * torch.randn(1, 80, 402, generator=gs,
                                                           device="cuda"), 1),
              "cond_frame": torch.randn(1, 402, generator=gs, device="cuda"),
              "audio_features": torch.randn(1, 80, 35, generator=gs, device="cuda")}
    sdraws = [smga.draws(1, torch.Generator(device="cuda").manual_seed(SEED + 111 + i))
              for i in range(4)]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    slosses = [float(smga.train_step(sstate, sbatch, sdraws[i % 4])["loss"])
               for i in range(SMGA_SOAK_STEPS)]
    ssec = time.perf_counter() - t0
    require(not any(ops.launch_counts().values()), "soak: SMGA launched a kernel")
    sfirst, slast = sum(slosses[:4]) / 4, sum(slosses[-4:]) / 4
    log(f"soak: SMGA, {SMGA_SOAK_STEPS} steps in {ssec:.1f} s; losses every 20 steps "
        f"{slosses[::20]}; mean of the first 4 {sfirst:.6f}, of the last 4 {slast:.6f}: "
        f"{sfirst / slast:.2f}x (limit > {SMGA_SOAK_DROP}x)")
    require(all(math.isfinite(x) for x in slosses), "soak: SMGA losses not finite")
    require(slast * SMGA_SOAK_DROP < sfirst, "soak: the SMGA loss did not fall 4x")
    del smga, sstate
    torch.cuda.empty_cache()
    return counts, calls


def run_profile_train(torch, Stage2Trainer):
    """One full-width train step under torch.profiler (after a warm-up
    step): device time by kernel family and the idle share."""
    trainer = Stage2Trainer.build(torch.bfloat16, device="cuda", seed=SEED, remat=True)
    state = trainer.init_state()
    batch = make_train_batch(torch, 1, TRAIN_FRAMES, SIZE, SEED + 9, "cuda")
    gen = torch.Generator(device="cuda").manual_seed(SEED)

    def step():
        trainer.train_step(state, batch, generator=gen)
        torch.cuda.synchronize()

    step()
    t0 = time.perf_counter()
    step()
    wall_ms = (time.perf_counter() - t0) * 1e3
    report_profile(step, "one train step: 12 frames, bs 1, 512x512, remat", wall_ms)
    report_k2_calls(torch, step)


def run_profile_train_image(torch):
    """One full-width image-pretrain step (256^2, batch 4, random batch)
    under torch.profiler after a warm-up step; then one SMGA step at
    A2P_BATCH likewise."""
    from mmgt_tpu_torch.training.stage1 import SMGA
    from mmgt_tpu_torch.training.stage2_image import Stage2ImageTrainer

    def profiled(step, what):
        step()
        t0 = time.perf_counter()
        step()
        wall_ms = (time.perf_counter() - t0) * 1e3
        report_profile(step, what, wall_ms)

    trainer = Stage2ImageTrainer.build(torch.bfloat16, device="cuda", seed=SEED)
    state = trainer.init_state()
    g = torch.Generator(device="cuda").manual_seed(SEED + 80)
    b, size = 4, TRAIN_IMAGE_SIZE
    batch = {"tgt_image": torch.rand(b, size, size, 3, generator=g, device="cuda") * 2 - 1,
             "ref_image": torch.rand(b, size, size, 3, generator=g, device="cuda") * 2 - 1,
             "tgt_pose": torch.rand(b, size, size, 3, generator=g, device="cuda"),
             "clip_embed": torch.randn(b, 1, 768, generator=g, device="cuda")}

    def image_step():
        trainer.train_step(state, batch, generator=g)
        torch.cuda.synchronize()

    profiled(image_step, "one image-pretrain step: 256x256, bs 4, no remat")
    del trainer, state, batch
    torch.cuda.empty_cache()
    smga = SMGA.build("cuda", SEED)
    sstate = smga.init_state()
    sbatch = {"keypoints": torch.rand(A2P_BATCH, 80, 402, generator=g, device="cuda"),
              "cond_frame": torch.rand(A2P_BATCH, 402, generator=g, device="cuda"),
              "audio_features": torch.randn(A2P_BATCH, 80, 1059, generator=g, device="cuda")}

    def smga_step():
        smga.train_step(sstate, sbatch, generator=g)
        torch.cuda.synchronize()

    profiled(smga_step, f"one SMGA step: batch {A2P_BATCH} x 80 frames, f32")


def report_k2_calls(torch, step):
    """The GroupNorm calls of one more `step`: their count, K2's regimes
    and the bytes bound of all of them (each input read once, each output
    written once, at 3.35 TB/s)."""
    from mmgt_tpu_torch.nn import layers
    from mmgt_tpu_torch.ops import norms as N

    calls, plain = [], layers.group_norm

    def recording(x, num_groups, *args, **kwargs):
        calls.append((tuple(x.shape), num_groups, x.dtype, x.element_size()))
        return plain(x, num_groups, *args, **kwargs)

    layers.group_norm = recording
    try:
        step()
    finally:
        layers.group_norm = plain
    regimes = {}
    for shape, groups, dtype, _ in calls:
        n, c = shape[0], shape[-1]
        plan = N.gn_plan(n, math.prod(shape) // (n * c), c, groups, dtype)
        key = plan["regime"] if plan["regime"] == "streaming" else f"resident k={plan['k']}"
        regimes[key] = regimes.get(key, 0) + 1
    moved = sum(2 * math.prod(shape) * es for shape, _, _, es in calls)
    log(json.dumps({"k2_calls": {"calls": len(calls), "bytes_moved": moved,
                                 "bound_ms": moved / PEAK_BYTES * 1e3, "plans": regimes}}))


def report_k3_calls(torch, step):
    """K3's launches in one more `step` (`ln_gemm`, K4's W_o included):
    each distinct (M, K, weight columns, LayerNorm, bias, residual) with its
    count, regime and bound (each input read once, each output written
    once)."""
    from mmgt_tpu_torch.ops import fused_ln as L
    from mmgt_tpu_torch.ops import motion_attention as M

    calls, plain = {}, L.ln_gemm

    def recording(x2, gamma, beta, ws, bs, eps=1e-5, res=None):
        m, k = x2.shape
        ns = tuple(w.shape[0] for w in ws)
        key = (m, k, ns, gamma is not None, any(b is not None for b in bs), res is not None)
        calls[key] = calls.get(key, 0) + 1
        return plain(x2, gamma, beta, ws, bs, eps, res=res)

    L.ln_gemm = M.ln_gemm = recording
    try:
        step()
    finally:
        L.ln_gemm = M.ln_gemm = plain
    rows = []
    by_size = sorted(calls.items(), key=lambda kv: -kv[0][0] * sum(kv[0][2]))
    for (m, k, ns, ln, bias, res), n in by_size:
        moved = 2 * (m * k + k * sum(ns) + m * sum(ns) * (2 if res else 1)
                     + (2 * k if ln else 0) + (sum(ns) if bias else 0))
        bms, by = bound_ms(2.0 * m * k * sum(ns), moved)
        rows.append({"m": m, "k": k, "ns": list(ns), "layernorm": ln, "bias": bias,
                     "residual": res, "launches": n,
                     "regime": L.gemm_plan(m, k, list(ns))["regime"], "bound_ms": bms,
                     "bound_by": by})
    by_regime = {}
    for r in rows:
        by_regime[r["regime"]] = by_regime.get(r["regime"], 0) + r["launches"]
    log(json.dumps({"k3_calls": {"launches": by_regime, "rows": rows}}))


# ------------------------------------------------------------------- mesh
MESH_WORLD = 2           # ranks of the mesh phase, all on cuda:0
MESH_TIMEOUT_S = 600     # a collective that waits longer raises
# The frames of a mesh run against the single-process run's, mean |diff|:
# at most SMALL_ERR_FACTOR x what two single-process runs of the same call
# differ by when only the windows' grouping into UNet calls changes (2 or
# 1 windows a call: the same math, rounded to bf16 in other places), and
# never less than one level of the 8-bit video. tp = 2 only rounds each
# row-parallel partial sum once more; dp = 2 runs one window a call on
# each rank. With seeded random weights at full width, 3 steps at guidance
# 3.5 carry bf16 rounding to ~1e-2 of the frames (the tiny three-way check,
# run on each mesh too, holds the card to the CPU f32 reference).
MESH_FRAME_FLOOR = 1.0 / 255
# The latents after the first denoising step of main's call (before the
# later steps at guidance 3.5 carry bf16 rounding across the frames), mean
# |diff| against the single-process run's: at most MESH_LATENT_FACTOR x
# what the single-process runs at 2 and at 1 window a call differ by there.
# On the H100 a sound tp = 2 reads 1.30x; a row-parallel bias added on
# every rank before the reduce reads 3.29x (PERF.md).
MESH_LATENT_FACTOR = 1.5
# The tp = 2 train step against the single-process step. The loss within
# MESH_LOSS_RTOL (sound 1.2e-4; the doubled row bias 2.9e-3). The
# clipped gradients within MESH_GRAD_RTOL in relative L2 norm over each
# rank's elements, read from AdamW's first moment, which after one step is
# 0.1 x the clipped gradient (sound 4.5e-3; the doubled row bias 0.13;
# `copy_to_tp` without its backward all_reduce 0.72). A first step moves
# every weight by about lr whatever its gradient, so the masters cannot
# tell a wrong gradient from a right one: held within MESH_MASTER_LR x lr,
# they only guard against values that are not finite or not updated alike.
MESH_LOSS_RTOL = 1e-3
MESH_GRAD_RTOL = 2e-2
MESH_MASTER_LR = 2.05


def first_step_latents(torch, pipe, inputs):
    """The latents after the first denoising step of main's call (its
    inputs, noise and windows), f32 on the CPU."""
    from mmgt_tpu_torch.pipelines.context import compute_context_schedule

    dev = pipe.device
    d = {k: v.to(dev) for k, v in inputs.items() if k != "masks"}
    d["masks"] = tuple(tuple(m.to(dev) for m in lv) for lv in inputs["masks"])
    tables = pipe.sampler_state(STEPS)
    windows = compute_context_schedule(STEPS, d["pose_video"].shape[1], pipe.context_size, 1,
                                       pipe.context_overlap)
    with torch.no_grad():
        cond, lat = pipe._prepare(**d, generator=torch.Generator(device=dev).manual_seed(SEED))
        lat, _ = pipe._denoise_chunk(lat, pipe.init_aux(tables, lat), cond, tables, windows[:1],
                                     GUIDANCE, (1.0, 1.0, 1.0))
    return lat.float().cpu()


def mesh_rank(margs, tmp: str):
    """One rank of the mesh phase (2 gloo ranks on cuda:0): the full-width
    pipeline at (dp = 2, tp = 1) and at (dp = 1, tp = 2), then one
    full-width video train step at (dp = 1, tp = 2); each part's launch
    counts (set to 0 just before, read just after), recorded signatures,
    seconds, peak memory and all_reduce time, and the step's masters held
    to the single-process step's, into rank<r>.pt."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mmgt_tpu_torch import ops
    from mmgt_tpu_torch.device import disable_tf32
    from mmgt_tpu_torch.ops import attention as A
    from mmgt_tpu_torch.ops import fused_ln as L
    from mmgt_tpu_torch.ops import motion_attention as M
    from mmgt_tpu_torch.ops import norms as N
    from mmgt_tpu_torch.parallel import collectives as C
    from mmgt_tpu_torch.parallel.mesh import create_mesh, destroy, local_slice
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
    from mmgt_tpu_torch.training.stage2 import Stage2Trainer

    disable_tf32()
    kernel_mods = {"flash_attention": A, "group_norm": N, "ln_projections": L,
                   "motion_attention": M, "flash_attention_bwd": A}
    kw = dict(device="cuda:0", backend="gloo", timeout_s=MESH_TIMEOUT_S, **margs)
    mesh_tp = create_mesh(dp=1, tp=MESH_WORLD, **kw)
    mesh_dp = create_mesh(dp=MESH_WORLD, tp=1, **kw)
    C.STATS["timed"] = True
    out = {}
    t0 = time.perf_counter()
    pipe = Pose2VideoPipeline.build(torch.bfloat16, device="cuda:0", seed=SEED)
    out["build_s"] = time.perf_counter() - t0
    inputs = make_inputs(torch, FRAMES, SIZE, SEED)

    def infer():
        return pipe(**inputs, num_inference_steps=STEPS, guidance_scale=GUIDANCE,
                    generator=torch.Generator(device="cuda").manual_seed(SEED))

    for tag, mesh in (("dp2", mesh_dp), ("tp2", mesh_tp)):
        pipe.shard_(mesh)
        lat1 = first_step_latents(torch, pipe, inputs)
        C.reset_stats()
        frames, counts, calls, sec, peak = record_call(torch, ops, kernel_mods, infer)
        out[tag] = dict(frames=frames.float().cpu(), lat1=lat1, counts=counts, s=sec,
                        peak_gib=peak,
                        allreduce=dict(C.STATS),
                        calls={k: [c, None if ln is None else ln.cpu()]
                               for k, (c, ln) in calls.items()})
        del frames
    out["q_rows"] = pipe.denoising_unet.down_blocks[0].attentions[0] \
        .transformer_blocks[0].attn1.to_q.weight.shape[0]
    weights = torch.load(os.path.join(tmp, "mesh_small.pt"))
    for tag, mesh in (("small_dp2", mesh_dp), ("small_tp2", mesh_tp)):
        small = tiny_pipeline(torch, Pose2VideoPipeline, "cuda:0", torch.bfloat16)
        for name, m in small.models().items():
            m.load_state_dict(weights[name])
        small.shard_(mesh)
        out[tag] = small_run(torch, small, "cuda:0")
        del small
    pipe.denoising_unet.remat = True
    trainer = Stage2Trainer(pipe)
    state = trainer.init_state()
    batch = make_train_batch(torch, 1, TRAIN_FRAMES, SIZE, SEED + 9, "cuda")
    draws = trainer.batch_draws(batch, torch.Generator(device="cuda").manual_seed(SEED))
    C.reset_stats()
    metrics, counts, calls, sec, peak = record_call(
        torch, ops, kernel_mods, lambda: trainer.train_step(state, batch, draws))
    ref = torch.load(os.path.join(tmp, "mesh_ref_step.pt"), mmap=True)
    specs, lr = trainer.specs(), trainer.learning_rate
    worst, near, total, d2, r2, worst_rel = 0.0, 0, 0, 0.0, 0.0, (0.0, "")
    for i, (n, m) in enumerate(state.masters.items()):
        want = local_slice(ref["masters"][n].to(m.device), specs[n], mesh_tp)
        require(want.shape == m.shape, f"mesh train: {n} shard {tuple(m.shape)}")
        err = (m - want).abs()
        worst = max(worst, err.max().item() / lr)
        near += int((err <= 0.1 * lr).sum())
        total += err.numel()
        g, g_ref = state.optimizer.m[i], local_slice(ref["m"][n].to(m.device), specs[n], mesh_tp)
        dd, rr = (g - g_ref).double().pow(2).sum().item(), g_ref.double().pow(2).sum().item()
        d2, r2 = d2 + dd, r2 + rr
        if rr > 0 and math.sqrt(dd / rr) > worst_rel[0]:
            worst_rel = (math.sqrt(dd / rr), n)
    out["train"] = dict(loss=float(metrics["loss"]), counts=counts, s=sec, peak_gib=peak,
                        allreduce=dict(C.STATS), worst_over_lr=worst, near_share=near / total,
                        grad_rel=math.sqrt(d2 / r2), grad_worst_rel=worst_rel,
                        sharded=sum(specs[n] is not None for n in state.masters),
                        masters=len(state.masters),
                        calls={k: [c, None if ln is None else ln.cpu()]
                               for k, (c, ln) in calls.items()})
    torch.save(out, os.path.join(tmp, f"mesh_rank{mesh_tp.rank}.pt"))
    destroy(mesh_tp)


def nccl_cli_rank(margs, tmp: str, meta: str, port: int):
    """The video CLI's main at world 1 as torchrun starts it (RANK,
    WORLD_SIZE, MASTER_ADDR/PORT set): its mesh joins an NCCL process
    group, one full-width step, the checkpoint written and the barrier
    after it an NCCL all_reduce."""
    import torch.distributed as dist

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mmgt_tpu_torch.parallel import mesh as pmesh
    from mmgt_tpu_torch.scripts import train_stage2 as cli

    os.environ.update(RANK="0", LOCAL_RANK="0", WORLD_SIZE="1", MASTER_ADDR="127.0.0.1",
                      MASTER_PORT=str(port))
    made = {}
    create = pmesh.create_mesh

    def recording(*a, **k):
        m = create(*a, **k)
        made.update(backend=dist.get_backend(), world=m.world, groups=m.world_group is not None)
        return m
    pmesh.create_mesh = recording
    ckpt = os.path.join(tmp, "nccl_ckpt")
    t0 = time.perf_counter()
    rc = cli.main(["--meta", meta, "--max_steps", "1", "--size", str(SIZE), "--batch_size", "1",
                   "--checkpoint_dir", ckpt])
    made.update(rc=rc, s=time.perf_counter() - t0,
                ckpts=sorted(f for f in os.listdir(ckpt) if f.endswith(".ckpt"))
                if os.path.isdir(ckpt) else [])
    with open(os.path.join(tmp, "nccl_cli.json"), "w") as f:
        json.dump(made, f)


def run_mesh(torch, ops, tmp: str):
    """The distributed layer on the one card: the single-process
    references here, then MESH_WORLD gloo ranks on cuda:0 (`mesh_rank`),
    then the video CLI at world 1 through NCCL (`nccl_cli_rank`). Returns
    {part: (launches, recorded calls)} for the replay."""
    import shutil
    import socket

    from mmgt_tpu_torch.parallel.launch import spawn
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
    from mmgt_tpu_torch.training.stage2 import Stage2Trainer

    t_phase = time.perf_counter()
    small_ref = tiny_pipeline(torch, Pose2VideoPipeline, "cpu", torch.float32)
    small_bf16 = tiny_pipeline(torch, Pose2VideoPipeline, "cpu", torch.bfloat16)
    for name, m in small_ref.models().items():
        getattr(small_bf16, name).load_state_dict(m.state_dict())
    small = {"cpu_f32": small_run(torch, small_ref, "cpu"),
             "cpu_bf16": small_run(torch, small_bf16, "cpu")}
    torch.save({n: m.state_dict() for n, m in small_ref.models().items()},
               os.path.join(tmp, "mesh_small.pt"))
    del small_ref, small_bf16
    inputs = make_inputs(torch, FRAMES, SIZE, SEED)
    pipe = Pose2VideoPipeline.build(torch.bfloat16, device="cuda", seed=SEED)

    def infer():
        return pipe(**inputs, num_inference_steps=STEPS, guidance_scale=GUIDANCE,
                    generator=torch.Generator(device="cuda").manual_seed(SEED)).float().cpu()

    t0 = time.perf_counter()
    ref, lat = infer(), first_step_latents(torch, pipe, inputs)
    pipe.window_microbatch = 1   # one window a UNet call: what each dp rank runs
    ref1, lat1 = infer(), first_step_latents(torch, pipe, inputs)
    del pipe
    trainer = Stage2Trainer.build(torch.bfloat16, device="cuda", seed=SEED, remat=True)
    state = trainer.init_state()
    batch = make_train_batch(torch, 1, TRAIN_FRAMES, SIZE, SEED + 9, "cuda")
    draws = trainer.batch_draws(batch, torch.Generator(device="cuda").manual_seed(SEED))
    ref_loss = float(trainer.train_step(state, batch, draws)["loss"])
    torch.save({"masters": {n: m.cpu() for n, m in state.masters.items()},
                "m": {n: m.cpu() for n, m in zip(state.masters, state.optimizer.m)}},
               os.path.join(tmp, "mesh_ref_step.pt"))
    del trainer, state, batch, draws
    torch.cuda.empty_cache()
    log(f"mesh: single-process references (2 pipeline calls, 1 train step) "
        f"{time.perf_counter() - t0:.1f} s; train loss {ref_loss:.6f}")
    t0 = time.perf_counter()
    spawn(mesh_rank, MESH_WORLD, tmp, tmp)
    log(f"mesh: {MESH_WORLD} gloo ranks on cuda:0, {time.perf_counter() - t0:.1f} s in all "
        "(start, build, the parts below)")
    ranks = [torch.load(os.path.join(tmp, f"mesh_rank{r}.pt")) for r in range(MESH_WORLD)]
    os.remove(os.path.join(tmp, "mesh_ref_step.pt"))
    os.remove(os.path.join(tmp, "mesh_small.pt"))
    parts, fails = {}, []

    def check(ok: bool, what: str):
        if not ok:
            fails.append(what)

    diff = lambda a, b: ((a - b).abs().mean().item(), (a - b).abs().max().item())
    floor = diff(ref, ref1)
    tol = max(MESH_FRAME_FLOOR, SMALL_ERR_FACTOR * floor[0])
    log(f"mesh: the single-process runs of 2 and of 1 window a UNet call differ by mean "
        f"{floor[0]:.3e}, max {floor[1]:.3e}; frame tolerance {tol:.3e} (mean |diff|)")
    lat_floor = diff(lat, lat1)
    lat_tol = MESH_LATENT_FACTOR * lat_floor[0]
    log(f"mesh: after the first step their latents differ by mean {lat_floor[0]:.3e}, max "
        f"{lat_floor[1]:.3e} (mean |latent| {lat.abs().mean().item():.3e}); latent tolerance "
        f"{lat_tol:.3e} (mean |diff|)")
    for tag, what in (("dp2", "(dp = 2, tp = 1)"), ("tp2", "(dp = 1, tp = 2)")):
        for r, res in enumerate(ranks):
            got = res[tag]
            require_frames(torch, f"mesh {tag} rank {r}", got["frames"],
                           (1, FRAMES, SIZE, SIZE, 3))
            require_launches(f"mesh {tag} rank {r}", got["counts"], INFERENCE_KERNELS)
            d, d1 = diff(got["frames"], ref), diff(got["frames"], ref1)
            check(d[0] <= tol, f"mesh {tag} rank {r}: frames mean |diff| {d[0]} > {tol}")
            dl, dl1 = diff(got["lat1"], lat), diff(got["lat1"], lat1)
            check(dl[0] <= lat_tol, f"mesh {tag} rank {r}: first-step latents mean |diff| "
                  f"{dl[0]} > {lat_tol}")
            check(torch.equal(got["lat1"], ranks[0][tag]["lat1"]),
                  f"mesh {tag}: rank {r}'s first-step latents differ from rank 0's")
            if tag == "dp2":  # each rank runs what the one-window-a-call run does
                check(d1[0] <= tol, f"mesh dp2 rank {r}: frames mean |diff| {d1[0]} > {tol} "
                      "against one window a call")
            check(torch.equal(got["frames"], ranks[0][tag]["frames"]),
                  f"mesh {tag}: rank {r}'s frames differ from rank 0's")
            ar = got["allreduce"]
            log(f"mesh {tag} {what} rank {r}: {got['s']:.3f} s; frames against the "
                f"single-process run mean |diff| {d[0]:.3e} (tol {tol:.3e}), max "
                f"{d[1]:.3e}; against one window a call mean {d1[0]:.3e}, max {d1[1]:.3e} "
                f"(bitwise: {d1[1] == 0.0}); first-step latents against the single-process "
                f"run mean |diff| {dl[0]:.3e} (tol {lat_tol:.3e}), max {dl[1]:.3e}, against "
                f"one window a call mean {dl1[0]:.3e}; "
                f"peak {got['peak_gib']:.2f} GiB; all_reduce {ar['calls']} calls, "
                f"{ar['bytes']} bytes, {ar['seconds']:.3f} s; launches "
                + json.dumps(got["counts"]))
        parts[f"mesh_{tag}"] = (ranks[0][tag]["counts"], ranks[0][tag]["calls"])
    check(ranks[0]["q_rows"] == 160, f"mesh tp2: to_q holds {ranks[0]['q_rows']} rows")
    errs = lambda o: [(o[i] - small["cpu_f32"][i]).abs().mean().item() for i in (0, 1)]
    plain = errs(small["cpu_bf16"])
    for tag in ("small_dp2", "small_tp2"):
        for r, res in enumerate(ranks):
            got = errs(res[tag])
            log(f"mesh {tag} rank {r}: mean abs err vs CPU f32 (latents, frames) {got}; plain "
                f"bf16 on the CPU {plain} (tol: {SMALL_ERR_FACTOR}x the plain bf16 error)")
            for i, what in enumerate(("latents", "frames")):
                check(math.isfinite(got[i]) and got[i] <= SMALL_ERR_FACTOR * plain[i],
                      f"mesh {tag} rank {r} {what}: the card's error exceeds "
                      f"{SMALL_ERR_FACTOR}x the plain bf16 error")
    for r, res in enumerate(ranks):
        tr = res["train"]
        rel = abs(tr["loss"] - ref_loss) / abs(ref_loss)
        check(math.isfinite(tr["loss"]) and rel <= MESH_LOSS_RTOL,
              f"mesh train rank {r}: loss {tr['loss']} against {ref_loss}")
        check(tr["grad_rel"] <= MESH_GRAD_RTOL,
              f"mesh train rank {r}: clipped gradients {tr['grad_rel']} (relative L2) from "
              "the reference")
        check(tr["worst_over_lr"] <= MESH_MASTER_LR,
              f"mesh train rank {r}: a master {tr['worst_over_lr']} lr from the reference")
        check(tr["counts"]["flash_attention_bwd"] == EXPECTED_K5_PER_STEP,
              f"mesh train rank {r}: K5 launched {tr['counts']['flash_attention_bwd']} times")
        for name in INFERENCE_KERNELS:
            check(tr["counts"][name] > 0, f"mesh train rank {r}: {name} was not launched")
        ar = tr["allreduce"]
        log(f"mesh train (dp = 1, tp = 2) rank {r}: {tr['s']:.3f} s; loss {tr['loss']:.6f} "
            f"(single process {ref_loss:.6f}, rel {rel:.2e}, tol {MESH_LOSS_RTOL}); clipped "
            f"gradients relative L2 {tr['grad_rel']:.3e} from the single-process step (tol "
            f"{MESH_GRAD_RTOL}), worst tensor {tr['grad_worst_rel'][0]:.3e} "
            f"({tr['grad_worst_rel'][1]}); f32 masters "
            f"{tr['sharded']}/{tr['masters']} sharded, worst {tr['worst_over_lr']:.3f} lr from "
            f"the single-process step (tol {MESH_MASTER_LR}), {100 * tr['near_share']:.2f} % "
            f"within 0.1 lr; peak {tr['peak_gib']:.2f} GiB; all_reduce {ar['calls']} calls, "
            f"{ar['bytes']} bytes, {ar['seconds']:.3f} s; launches " + json.dumps(tr["counts"]))
    parts["mesh_train_tp2"] = (ranks[0]["train"]["counts"], ranks[0]["train"]["calls"])
    require(not fails, "; ".join(fails))
    log("mesh: gloo reduces CUDA tensors through the host, so these all_reduce times say "
        "nothing of NCCL between cards")
    del ranks
    # world 1 through NCCL: the video CLI as torchrun starts it
    root = os.path.join(tmp, "nccl_cli")
    meta = write_clip_records(root, 1, 20, SIZE, SEED + 71)
    require_disk(tmp, 12 * 10**9, "mesh nccl_cli")
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        port = sk.getsockname()[1]
    t0 = time.perf_counter()
    spawn(nccl_cli_rank, 1, root, root, meta, port)
    with open(os.path.join(root, "nccl_cli.json")) as f:
        made = json.load(f)
    require(made.get("backend") == "nccl" and made.get("groups") and made.get("rc") == 0
            and made.get("ckpts") == ["ckpt-1.ckpt"], f"mesh nccl_cli: {made}")
    log(f"mesh nccl_cli: the video CLI at world 1 under the torchrun environment, backend "
        f"{made['backend']}, one step and its checkpoint in {made['s']:.1f} s "
        f"({time.perf_counter() - t0:.1f} s with the process start)")
    shutil.rmtree(root)
    log(f"mesh: {time.perf_counter() - t_phase:.1f} s")
    return parts


# ---------------------------------------------------------------- mfu, budget
MFU_MB = 5          # the flagship group: 5 windows x CFG = 10 UNet rows
MFU_FRAMES = 12     # frames a window
MFU_ITERS = 3       # timed calls of the group (after one warm-up call)


def run_mfu(torch, ops, kernel_mods, card: str, main_timings=None, a2v_timings=None):
    """The FLOP audit (`mmgt_tpu_torch/tools/mfu_audit.py`) against the card:
    one flagship denoise group (MFU_MB windows x CFG, MFU_FRAMES frames,
    512^2, bf16, full width, seeded weights and inputs) through the
    denoiser, its launches (counts set to 0 just before, read just after;
    K1-K4 must launch, K5 not) and signatures recorded, then timed
    (CUDA events, MFU_ITERS calls); one window's call (2 rows) timed for
    the budget; the counts over fake tensors, and their utilization at the
    group's time, main's step (16 frames) and the a2v call's step (80
    frames). Returns (launches, recorded calls, the window's seconds)."""
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
    from mmgt_tpu_torch.tools import mfu_audit as MA

    h8 = SIZE // 8
    pipe = Pose2VideoPipeline.build(torch.bfloat16, device="cuda", seed=SEED)
    gen = torch.Generator(device="cuda").manual_seed(SEED + 40)
    args, kw = MA.group_inputs(pipe, MFU_MB, MFU_FRAMES, h8, gen)
    unet = pipe.denoising_unet
    with torch.no_grad():
        out, counts, calls, sec, peak = record_call(torch, ops, kernel_mods,
                                                    lambda: unet(*args, **kw))
        require(tuple(out.shape) == (2 * MFU_MB, MFU_FRAMES, h8, h8, 4)
                and bool(torch.isfinite(out).all()), "mfu: the group's output")
        require_launches("mfu group", counts, INFERENCE_KERNELS)
        group_s = MA.time_call(lambda: unet(*args, **kw), iters=MFU_ITERS)
        wargs, wkw = MA.group_inputs(pipe, 1, MFU_FRAMES, h8, gen)
        window_s = MA.time_call(lambda: unet(*wargs, **wkw), iters=MFU_ITERS)
    log(f"mfu: one group ({MFU_MB} windows x CFG = {2 * MFU_MB} rows x {MFU_FRAMES} frames, "
        f"{SIZE}^2, bf16) {group_s:.4f} s (first call {sec:.3f} s, peak {peak:.2f} GiB); one "
        f"window (2 rows) {window_s:.4f} s; launches " + json.dumps(counts) + f"; card {card}")
    del pipe, args, kw, wargs, wkw, out
    torch.cuda.empty_cache()
    timed = []
    if main_timings:
        timed.append((FRAMES, main_timings["denoise_s"] / STEPS))
    if a2v_timings:
        timed.append((A2V_FRAMES, a2v_timings["stage2_denoise_s"] / STEPS))
    t0 = time.perf_counter()
    cnt = MA.counts(MFU_MB, MFU_FRAMES, SIZE, A2V_FRAMES, [f for f, _ in timed])
    rep = MA.report(cnt, group_s, timed)
    for line in MA.text(rep).splitlines():
        log("mfu: " + line)
    log(f"mfu: counted over fake tensors in {time.perf_counter() - t0:.1f} s (CPU)")
    log(json.dumps({"mfu": rep, "card": card}))
    require(rep["group"]["utilization"]["executed"] <= 1.0, "mfu: above the peak")
    return counts, calls, window_s


def budget_rank(margs, layout, out_dir: str):
    """One rank of the budget phase: the tool's rank (`budget_8chip.
    rank_setup` / `rank_step`) with its step's kernel launches recorded;
    its result and signatures into rank<r>.pt."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mmgt_tpu_torch.device import disable_tf32
    from mmgt_tpu_torch.ops import attention as A
    from mmgt_tpu_torch.ops import fused_ln as L
    from mmgt_tpu_torch.ops import motion_attention as M
    from mmgt_tpu_torch.ops import norms as N
    from mmgt_tpu_torch.parallel.mesh import destroy
    from mmgt_tpu_torch.tools import budget_8chip as B

    disable_tf32()
    ctx = B.rank_setup(margs, layout)
    rec = LaunchRecorder(torch, {"flash_attention": A, "group_norm": N, "ln_projections": L,
                                 "motion_attention": M, "flash_attention_bwd": A})
    res = B.rank_step(ctx, B.windows(layout), layout, around=rec)
    for name, n in res["launches"].items():
        require(sum(c for (k, _), (c, _) in rec.calls.items() if k == name) == n,
                f"budget rank {ctx['mesh'].rank} {name}: the recorded launches do not add up")
    res["calls"] = {k: [c, None if ln is None else ln.cpu()] for k, (c, ln) in rec.calls.items()}
    torch.save(res, os.path.join(out_dir, f"rank{ctx['mesh'].rank}.pt"))
    destroy(ctx["mesh"])


def run_budget(torch, tmp: str, card: str, a2v_timings, window_s: float):
    """The n-card budget (`mmgt_tpu_torch/tools/budget_8chip.py`): its
    single-process reference here, then its 8 gloo ranks on cuda:0 at
    (dp 8, tp 1), full width, bf16, 16 x 16 latents, 32 frames in 8
    windows (`budget_rank`); the tool's three checks (each rank's shard
    shape, the step's all_reduce calls and bytes against the closed form,
    the latents bitwise equal to one process at one window a call), K1-K4
    launched on every rank; then the budget from the a2v call's timings
    and main's window time. Returns (rank 0's launches, every rank's
    signatures)."""
    import shutil

    from mmgt_tpu_torch.tools import budget_8chip as B

    layout = B.default_layout(device="cuda:0")
    store = os.path.join(tmp, "budget")
    os.makedirs(store, exist_ok=True)
    t0 = time.perf_counter()
    results, ref, fails = B.run(layout, rank_fn=budget_rank, store=store)
    log(f"budget: the reference and {layout['devices']} gloo ranks on cuda:0, "
        f"{time.perf_counter() - t0:.1f} s in all; closed form " +
        json.dumps(B.gather_closed_form(layout)))
    calls = {}
    for res in results:
        log(f"budget rank {res['rank']}: conv_in {res['shapes']}; all_reduce {res['stats']}; "
            f"step {res['s']:.3f} s; peak {res['peak_gib']:.2f} GiB; latents bitwise equal to "
            f"one process: {torch.equal(res['latents'], ref)}; launches "
            + json.dumps(res["launches"]) + f"; card {card}")
        require_launches(f"budget rank {res['rank']}", res["launches"], INFERENCE_KERNELS)
        for key, (c, lens) in res["calls"].items():
            calls.setdefault(key, [0, lens])[0] += c
    require(not fails, "budget: " + "; ".join(fails))
    out = B.budget(layout["devices"], results[0]["stats"], layout, window_s, a2v_timings)
    log(json.dumps({"budget": out, "projection": f"{layout['devices']} cards from one card's "
                    "measurements", "card": card}))
    shutil.rmtree(store, ignore_errors=True)
    return results[0]["launches"], calls


# ------------------------------------------------------------------ bench
# bench_torch.py at a cut depth: 16 frames, 2 steps, fast and dpm at 2
# steps, long at 3 x 16 frames (one Stage-1 slice; a2v and long240 chain
# slices), 5 Stage-1 steps (each traced call's trace is ~250 MB at 50,
# most of it Stage 1's small ops, which launch no kernel of the port),
# the train row's first step and 2 timed
BENCH_ARGS = ("--frames", "16", "--steps", "2", "--fast-steps", "2", "--dpm-steps", "2",
              "--stage1-steps", "5")
BENCH_ROWS = ("audio2vid", "long48", "fast2", "dpm2", "train_stage2")
BENCH_TIMEOUT_S = 300
BENCH_CHILD = "bench-child"   # argv[1] of the recording child (`bench_child`)
# a kernel name of each kernel's family in a device table
KERNEL_TRACE_NAMES = {"flash_attention": "flash_fwd", "group_norm": "gn_resident",
                      "ln_projections": "ln_gemm", "motion_attention": "motion_fused",
                      "flash_attention_bwd": "bwd_dq"}


def bench_child(out_dir: str, argv) -> int:
    """`bench_torch.main(argv)` under the launch recorder, its signatures
    into out_dir/calls.pt; its train row's process is such a child too
    (into out_dir/train)."""
    import torch

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import bench_torch
    from mmgt_tpu_torch.ops import attention as A
    from mmgt_tpu_torch.ops import fused_ln as L
    from mmgt_tpu_torch.ops import motion_attention as M
    from mmgt_tpu_torch.ops import norms as N

    command = bench_torch.train_row_command
    bench_torch.train_row_command = lambda a: [
        sys.executable, os.path.abspath(__file__), BENCH_CHILD, os.path.join(out_dir, "train"),
        *command(a)[2:]]
    os.makedirs(out_dir, exist_ok=True)
    with LaunchRecorder(torch, {"flash_attention": A, "group_norm": N, "ln_projections": L,
                                "motion_attention": M, "flash_attention_bwd": A}) as rec:
        rc = bench_torch.main(list(argv))
    torch.save({k: [c, None if ln is None else ln.cpu()] for k, (c, ln) in rec.calls.items()},
               os.path.join(out_dir, "calls.pt"))
    return rc


def run_bench(tmp: str, card: str):
    """bench_torch.py in a process of its own (`bench_child`) at BENCH_ARGS
    with --trace: exit 0, its result line parsed with every row's seconds,
    a trace line for each of BENCH_ROWS; K1-K4 launched in the flagship row
    (its launches by phase, counted from 0 in the call) and each in that
    row's traced device table; K5 launched in the train row's step and in
    its table. Returns (the flagship's launches, K5 the train step's; the
    signatures every row launched, the train row's process included)."""
    import torch

    from mmgt_tpu_torch.utils.device_trace import categorize

    rec_dir = os.path.join(tmp, "bench_calls")
    cmd = [sys.executable, os.path.abspath(__file__), BENCH_CHILD, rec_dir, *BENCH_ARGS,
           "--trace", os.path.join(tmp, "bench_traces")]
    t0 = time.perf_counter()
    rc = subprocess.run(cmd, capture_output=True, text=True, timeout=BENCH_TIMEOUT_S)
    sec = time.perf_counter() - t0
    require(rc.returncode == 0, f"bench: exit {rc.returncode}: {rc.stderr[-3000:]}")
    lines = [json.loads(t) for t in rc.stdout.splitlines() if t.startswith("{")]
    results = [x for x in lines if "metric" in x]
    traces = {x["trace"]["row"]: x["trace"] for x in lines if "trace" in x}
    require(len(results) == 1, f"bench: {len(results)} result lines")
    line, comp = results[0], results[0]["components"]
    require(set(traces) == set(BENCH_ROWS), f"bench: traced rows {sorted(traces)}")
    rows = ("audio2vid_long48_s", "audio2vid_fast2_s", "audio2vid_dpm2_s", "train_stage2_step_s")
    for key in rows:
        require(math.isfinite(comp[key]) and comp[key] > 0, f"bench: {key} {comp[key]}")
    require(math.isfinite(line["value"]) and comp["train_loss_finite"], "bench: not finite")
    launches = {k: sum(ph[k] for ph in comp["phase_launches"].values())
                for k in KERNEL_TRACE_NAMES}
    launches["flash_attention_bwd"] = comp["train_stage2_launches"]["flash_attention_bwd"]
    for name, kernel in KERNEL_TRACE_NAMES.items():
        row = "train_stage2" if name == "flash_attention_bwd" else "audio2vid"
        family = categorize(kernel)
        require(launches[name] > 0, f"bench: {name} was not launched in {row}")
        require(traces[row]["families_ms"].get(family, 0.0) > 0,
                f"bench: {family} is not in {row}'s device table")
    calls = {}
    for part in ("calls.pt", os.path.join("train", "calls.pt")):
        for key, (c, lens) in torch.load(os.path.join(rec_dir, part),
                                         weights_only=False).items():
            calls.setdefault(key, [0, lens])[0] += c
    for name in KERNEL_TRACE_NAMES:
        require(any(k == name for k, _ in calls), f"bench: no signature of {name} recorded")
    log(f"bench: bench_torch.py {' '.join(BENCH_ARGS)} --trace in {sec:.1f} s; "
        f"{line['metric']} {line['value']:.3f} s, peak {comp['peak_gib']:.2f} GiB; "
        + ", ".join(f"{k} {comp[k]:.3f} s" for k in rows)
        + f"; setup {json.dumps(line['setup'])}; mfu " + json.dumps(
            {k: v for k, v in line["mfu"].items() if k != "flops"})
        + f"; {len(calls)} signatures recorded; card {card}")
    for row, tr in traces.items():
        log(f"bench: {row} traced: busy {tr['device_busy_ms']:.1f} ms of "
            f"{tr['wall_ms_unprofiled']:.1f}, idle {tr['idle_share']:.3f}; "
            + json.dumps(tr["families_ms"]))
    log(json.dumps({"bench": line}))
    return launches, calls


INFERENCE_KERNELS = ("flash_attention", "group_norm", "ln_projections", "motion_attention")
KERNEL_META = {
    "flash_attention": ("K1 flash attention (two-segment, kv_lens, LSE)", "cuda",
                        "mmgt_tpu_torch/csrc/flash_attn.cu",
                        "mmgt_tpu/ops/attention.py:764 _flash_attention_packed_2seg_fwd "
                        "(also :107, :320, :539)"),
    "group_norm": ("K2 GroupNorm (+SiLU)", "cuda", "mmgt_tpu_torch/csrc/group_norm.cu",
                   "mmgt_tpu/ops/norms.py:219 _group_norm_pallas (also :158 blocked)"),
    "ln_projections": ("K3 LayerNorm -> 1-3 projections", "cuda",
                       "mmgt_tpu_torch/csrc/ln_proj.cu",
                       "mmgt_tpu/ops/fused_ln.py:62 _ln_proj_fwd"),
    "motion_attention": ("K4 motion (frame) attention", "cuda",
                         "mmgt_tpu_torch/csrc/motion_attn.cu",
                         "mmgt_tpu/ops/motion_attention.py:122 _motion_fwd"),
    "flash_attention_bwd": ("K5 flash attention backward (dq, dk/dv)", "cuda",
                            "mmgt_tpu_torch/csrc/flash_attn_bwd.cu",
                            "mmgt_tpu/ops/attention.py:376 _flash_attention_bwd "
                            "(pallas_call :411 dq, :434 dk/dv)"),
}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mmgt_tpu_torch import ops
    from mmgt_tpu_torch.device import disable_tf32
    from mmgt_tpu_torch.ops import _build
    from mmgt_tpu_torch.ops import attention as A
    from mmgt_tpu_torch.ops import fused_ln as L
    from mmgt_tpu_torch.ops import motion_attention as M
    from mmgt_tpu_torch.ops import norms as N
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
    from mmgt_tpu_torch.training.stage2 import Stage2Trainer

    if argv not in ([], ["profile"], ["mesh"], ["mfu"], ["budget"], ["bench"]):
        print("usage: python3 chip_smoke.py [profile | mesh | mfu | budget | bench]",
              file=sys.stderr)
        return 2
    disable_tf32()

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(_build.SOURCES)}")
    card = card_line()
    log(f"card: {card}")

    if argv == ["profile"]:
        run_profile(torch, Pose2VideoPipeline)
        run_profile_train(torch, Stage2Trainer)
        run_profile_train_image(torch)
    elif argv == ["mesh"]:
        kernel_mods = {"flash_attention": A, "group_norm": N, "ln_projections": L,
                       "motion_attention": M, "flash_attention_bwd": A}
        with tempfile.TemporaryDirectory() as tmp:
            for tag, (counts_, calls_) in run_mesh(torch, ops, tmp).items():
                check_a2v_calls(torch, calls_, A, N, L, M, tag, {})
    elif argv == ["mfu"]:  # main first, for its step time
        kernel_mods = {"flash_attention": A, "group_norm": N, "ln_projections": L,
                       "motion_attention": M, "flash_attention_bwd": A}
        _, _, main_timings = run_main(torch, ops, Pose2VideoPipeline)
        _, calls_, _ = run_mfu(torch, ops, kernel_mods, card, main_timings)
        check_a2v_calls(torch, calls_, A, N, L, M, "mfu", {})
    elif argv == ["budget"]:  # the a2v call first, for its timings
        from mmgt_tpu_torch.tools.mfu_audit import time_group

        kernel_mods = {"flash_attention": A, "group_norm": N, "ln_projections": L,
                       "motion_attention": M, "flash_attention_bwd": A}
        with tempfile.TemporaryDirectory() as tmp:
            _, _, a2v_timings = run_a2v(torch, ops, kernel_mods, tmp)
            window_s = time_group(torch.device("cuda"), 1, MFU_FRAMES, SIZE, SEED)
            log(f"budget: one window (2 rows x {MFU_FRAMES} frames, {SIZE}^2) {window_s:.4f} s")
            torch.cuda.empty_cache()
            _, calls_ = run_budget(torch, tmp, card, a2v_timings, window_s)
            check_a2v_calls(torch, calls_, A, N, L, M, "budget", {})
    elif argv == ["bench"]:
        with tempfile.TemporaryDirectory() as tmp:
            _, calls_ = run_bench(tmp, card)
            check_a2v_calls(torch, calls_, A, N, L, M, "bench", {})
    else:
        kernel_mods = {"flash_attention": A, "group_norm": N, "ln_projections": L,
                       "motion_attention": M, "flash_attention_bwd": A}
        t0 = time.perf_counter()
        recs = {"flash_attention": check_k1(torch, A), "group_norm": check_k2(torch, N),
                "ln_projections": check_k3(torch, L), "motion_attention": check_k4(torch, M),
                "flash_attention_bwd": check_k5(torch, A)}
        for name, r in recs.items():
            for row_name, row in (r.get("rows") or {name: r}).items():
                log(f"{name} ({row_name}): ms {row['ms']:.3f} plain_ms {row['plain_ms']:.3f} "
                    f"library_ms {row['library_ms'] if row['library_ms'] is None else round(row['library_ms'], 3)} "
                    f"bound_ms {row['bound_ms']:.4f} ({row['bound_by']}) at {row['shape']}")
        check_grads(torch, ops, A, N, L, M)
        log(f"kernels + gradients: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        counts, per_step, main_timings = run_main(torch, ops, Pose2VideoPipeline)
        run_small(torch, Pose2VideoPipeline)
        log(f"main + small: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        checked = {}
        with tempfile.TemporaryDirectory() as tmp:
            a2v_counts, a2v_calls, a2v_timings = run_a2v(torch, ops, kernel_mods, tmp)
            a2v_per_kernel = check_a2v_calls(torch, a2v_calls, A, N, L, M, "a2v", checked)
            run_a2v_small(torch, tmp)
            log(f"a2v + a2v_small: {time.perf_counter() - t0:.1f} s")
            torch.cuda.empty_cache()
            t0 = time.perf_counter()
            counts_, calls_ = run_bench(tmp, card)
            paths = {"bench": dict(launches=counts_, calls=check_a2v_calls(
                torch, calls_, A, N, L, M, "bench", checked))}
            log(f"bench: {time.perf_counter() - t0:.1f} s")
            for tag, run in (("long240", lambda: run_long240(torch, ops, kernel_mods, tmp)),
                             ("dpm", lambda: run_dpm(torch, ops, kernel_mods)),
                             ("dpm_small", lambda: run_dpm_small(torch, Pose2VideoPipeline)),
                             ("pose2img", lambda: run_pose2img(torch, ops, kernel_mods)),
                             ("pose2img_small", lambda: run_pose2img_small(torch)),
                             ("lmks2vid", lambda: run_lmks2vid(torch, ops, kernel_mods)),
                             ("lmks2vid_small",
                              lambda: run_lmks2vid_small(torch, Pose2VideoPipeline)),
                             ("fewstep", lambda: run_fewstep(torch, ops, kernel_mods, tmp)),
                             ("weights", lambda: run_weights(torch, ops, kernel_mods, tmp)),
                             ("preprocess", lambda: run_preprocess(torch, ops, tmp)),
                             ("release", lambda: (run_release(torch, tmp), {})),
                             ("verify_weights",
                              lambda: run_verify_weights(torch, ops, kernel_mods, tmp))):
                t0 = time.perf_counter()
                got = run()
                if got is not None:
                    counts_, calls_ = got
                    paths[tag] = dict(launches=counts_, calls=check_a2v_calls(
                        torch, calls_, A, N, L, M, tag, checked))
                log(f"{tag}: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            train_counts, train_per_step, cli_counts, cli_calls = run_train(
                torch, ops, Stage2Trainer, kernel_mods, tmp)
            paths["train_cli"] = dict(launches=cli_counts, calls=check_a2v_calls(
                torch, cli_calls, A, N, L, M, "train_cli", checked))
            run_train_small(torch, Pose2VideoPipeline, Stage2Trainer)
            log(f"train + train_cli + train_small: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            image_counts, image_per_step, image_calls = run_train_image(torch, ops, kernel_mods,
                                                                        tmp)
            paths["train_image"] = dict(launches=image_counts, calls=check_a2v_calls(
                torch, image_calls, A, N, L, M, "train_image", checked))
            run_train_image_small(torch)
            log(f"train_image + train_image_small: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            paths["train_a2p"] = dict(launches=run_train_a2p(torch, ops, tmp), calls={})
            log(f"train_a2p: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            soak_counts, soak_calls = run_soak(torch, ops, kernel_mods)
            paths["soak"] = dict(launches=soak_counts, calls=check_a2v_calls(
                torch, soak_calls, A, N, L, M, "soak", checked))
            log(f"soak: {time.perf_counter() - t0:.1f} s")
            for tag, (counts_, calls_) in run_mesh(torch, ops, tmp).items():
                paths[tag] = dict(launches=counts_, calls=check_a2v_calls(
                    torch, calls_, A, N, L, M, tag, checked))
            t0 = time.perf_counter()
            counts_, calls_, window_s = run_mfu(torch, ops, kernel_mods, card, main_timings,
                                                a2v_timings)
            paths["mfu"] = dict(launches=counts_, calls=check_a2v_calls(
                torch, calls_, A, N, L, M, "mfu", checked))
            log(f"mfu: {time.perf_counter() - t0:.1f} s")
            t0 = time.perf_counter()
            counts_, calls_ = run_budget(torch, tmp, card, a2v_timings, window_s)
            paths["budget"] = dict(launches=counts_, calls=check_a2v_calls(
                torch, calls_, A, N, L, M, "budget", checked))
            log(f"budget: {time.perf_counter() - t0:.1f} s")
        kernels = []
        for name, r in recs.items():
            title, route, source, replaces = KERNEL_META[name]
            main_counts = train_counts if name == "flash_attention_bwd" else counts
            entry = dict(
                name=title, route=route, source=source, replaces=replaces,
                launches=main_counts[name], a2v_launches=a2v_counts[name],
                a2v_calls=a2v_per_kernel.get(name),
                launches_per_step=per_step[name],
                train_launches_per_step=train_per_step[name],
                train_image_launches_per_step=image_per_step[name],
                path_launches={tag: p["launches"][name] for tag, p in paths.items()},
                path_calls={tag: p["calls"].get(name) for tag, p in paths.items()},
                max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
                shape=r["shape"],
            )
            if r.get("rows"):
                entry["rows"] = {k: {f: v[f] for f in ("ms", "plain_ms", "library_ms",
                                                       "bound_ms", "bound_by", "shape")}
                                 for k, v in r["rows"].items()}
            kernels.append(entry)
        print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == [BENCH_CHILD]:
        sys.exit(bench_child(sys.argv[2], sys.argv[3:]))
    sys.exit(main(sys.argv[1:]))
