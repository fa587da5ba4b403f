#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (mmgt_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # every phase, one card

Phases, in order; any failure exits non-zero:
  1. build: compile the CUDA kernels (one nvcc per source, started
     together) and print the build seconds and the card's name and power
     limit;
  2. kernels: hold every kernel (K1-K4) against its plain PyTorch version
     on the card, in bf16, at the main path's per-row shapes; print each
     one's error and tolerance, its time (CUDA events), the plain version's
     time, one PyTorch library call's time where one computes the same
     function, and the bound (the larger of flops / 989 TFLOP/s and bytes /
     3.35 TB/s, each input read once and each output written once);
  3. main: Pose2VideoPipeline at full SD1.5 width, 512x512, 16 frames (two
     12-frame windows overlapping by 4), 3 DDIM steps, guidance 3.5, seeded
     random weights and inputs; the frames must be finite and every
     kernel's launch counter must have risen during this phase; launches
     per denoise step are the pipeline's own denoise-phase count / STEPS;
  4. small: a tiny pipeline (64x64, 8 frames, 2 steps, CFG) with one set of
     weights run three ways: f32 on the CPU (the reference), bf16 on the
     CPU (plain versions) and bf16 on the card (kernels); the card's mean
     error against the reference must stay within SMALL_ERR_FACTOR x the
     plain bf16 error, for the latents and the decoded frames.
Then the `kernels` JSON line, the card line, and the result line.

    python3 chip_smoke.py profile    # build, then profile one denoise step

profiles one full-width denoise step instead (device time by kernel
family, idle share) and prints no `kernels` line.
This script imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
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
def check_k1(torch, A):
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    cases = [  # (name, batch, seq, heads, d, bank, kv_lens, lse)
        ("L0 bank mixed kv_lens + lse", 2, 4096, 8, 40, True, [4096, 8192], True),
        ("L0 self only (ReferenceNet)", 1, 4096, 8, 40, False, None, False),
        ("L1 bank", 2, 1024, 8, 80, True, [1024, 2048], False),
        ("L2 bank", 2, 256, 8, 160, True, [256, 512], True),
        ("L3 bank", 2, 64, 8, 160, True, [64, 128], False),
        ("VAE mid d=512", 1, 4096, 1, 512, False, None, False),
    ]
    tol_lse = 1e-3
    rec = None
    for name, b, s, h, d, bank, lens, lse in cases:
        q, k, v = rnd(b, s, h, d), rnd(b, s, h, d), rnd(b, s, h, d)
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
        if rec is None:  # time the hottest shape: the denoiser's level-0 bank attention
            ms = time_ms(lambda: A.flash_attention(q, k, v, kl, kb, vb, return_lse=lse))
            plain_ms = time_ms(lambda: A.attention_plain(q, k, v, kl, kb, vb, return_lse=lse),
                               iters=3, warmup=1)
            kc = torch.cat([k, kb.expand(b, -1, -1, -1)], 1).transpose(1, 2)
            vc = torch.cat([v, vb.expand(b, -1, -1, -1)], 1).transpose(1, 2)
            qt = q.transpose(1, 2)
            mask = (torch.arange(2 * s, device=dev)[None, :] < kl[:, None])[:, None, None, :]
            sdpa = torch.nn.functional.scaled_dot_product_attention
            lib_ms = time_ms(lambda: sdpa(qt, kc, vc, attn_mask=mask))
            valid = sum(lens)
            flops = 4.0 * h * d * s * valid
            bms, by = bound_ms(flops, nbytes(q, k, v, kb, vb, got, got_lse if lse else None))
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bms, bound_by=by, shape=f"{name}: q {tuple(q.shape)}")
    return rec


def check_k2(torch, N):
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    rec = None
    for name, shape, groups, act in [
        ("UNet L0 (48 rows)", (48, 4096, 320), 32, "silu"),
        ("UNet L3 no act", (48, 64, 1280), 32, None),
        ("VAE decoder row", (8, 512 * 512, 128), 32, "silu"),
    ]:
        c = shape[-1]
        # every group its own mean and every channel its own scale, so a
        # channel read into the wrong group's statistics is off by O(1)
        ch = torch.arange(c, device=dev)
        x = (torch.randn(*shape, generator=g, device=dev) * (1 + ch / c)
             + 3.0 * (ch // (c // groups))).to(torch.bfloat16)
        w = torch.randn(c, generator=g, device=dev).to(torch.bfloat16)
        b = torch.randn(c, generator=g, device=dev).to(torch.bfloat16)
        got = N.group_norm(x, groups, w, b, 1e-6, act)
        want = N.group_norm_plain(x, groups, w, b, 1e-6, act)
        err, tol = max_err(got, want), ulp_tol(want)
        log(f"K2 {name}: max_abs_err {err:.3e} (tol {tol:.3e}, 2 bf16 ulps)")
        require(math.isfinite(err) and err <= tol, f"K2 {name}: err {err} > {tol}")
        if rec is None:
            ms = time_ms(lambda: N.group_norm(x, groups, w, b, 1e-6, act))
            plain_ms = time_ms(lambda: N.group_norm_plain(x, groups, w, b, 1e-6, act), iters=3)
            xt = x.transpose(1, 2)
            F = torch.nn.functional
            lib_ms = time_ms(lambda: F.silu(F.group_norm(xt, groups, w, b, 1e-6)))
            bms, by = bound_ms(10.0 * x.numel(), nbytes(x, w, b, got))
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bms, bound_by=by, shape=f"{name}: x {shape}")
    return rec


def check_k3(torch, L):
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    rec = None
    for name, rows, l, c, outs, bias in [
        ("L0 q/k/v (48 rows)", 48, 4096, 320, [320, 320, 320], False),
        ("L0 GEGLU", 48, 4096, 320, [2560], True),
        ("L2 3 audio q", 24, 256, 1280, [1280, 1280, 1280], False),
    ]:
        x = torch.randn(rows, l, c, generator=g, device=dev).to(torch.bfloat16)
        gam = (1 + 0.1 * torch.randn(c, generator=g, device=dev)).to(torch.bfloat16)
        bet = (0.1 * torch.randn(c, generator=g, device=dev)).to(torch.bfloat16)
        ws = [(torch.randn(n, c, generator=g, device=dev) / math.sqrt(c)).to(torch.bfloat16)
              for n in outs]
        bs = [(torch.randn(n, generator=g, device=dev) * 0.1).to(torch.bfloat16) if bias
              else None for n in outs]
        got = L.ln_projections(x, gam, bet, ws, bs, 1e-5)
        want = L.ln_projections_plain(x, gam, bet, ws, bs, 1e-5)
        err = max(max_err(a, b_) for a, b_ in zip(got, want))
        tol = max(ulp_tol(w_) for w_ in want)
        log(f"K3 {name}: max_abs_err {err:.3e} (tol {tol:.3e}, 2 bf16 ulps)")
        require(math.isfinite(err) and err <= tol, f"K3 {name}: err {err} > {tol}")
        if rec is None:
            ms = time_ms(lambda: L.ln_projections(x, gam, bet, ws, bs, 1e-5))
            plain_ms = time_ms(lambda: L.ln_projections_plain(x, gam, bet, ws, bs, 1e-5),
                               iters=3)
            wcat = torch.cat(ws, 0)
            F = torch.nn.functional
            lib_ms = time_ms(lambda: F.linear(F.layer_norm(x, (c,), gam, bet, 1e-5), wcat))
            m = rows * l
            bms, by = bound_ms(2.0 * m * c * sum(outs), nbytes(x, gam, bet, *ws, *got))
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bms, bound_by=by, shape=f"{name}: x {tuple(x.shape)}")
    return rec


def check_k4(torch, M):
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    rec = None
    for name, shape in [("L0 (4 rows)", (4, 12, 4096, 320)), ("L1", (4, 12, 1024, 640)),
                        ("L3 / mid, 64 tokens", (4, 12, 64, 1280))]:
        b, f, l, c = shape
        x = torch.randn(*shape, generator=g, device=dev).to(torch.bfloat16)
        gam = (1 + 0.1 * torch.randn(c, generator=g, device=dev)).to(torch.bfloat16)
        bet = (0.1 * torch.randn(c, generator=g, device=dev)).to(torch.bfloat16)
        pe = M.sinusoidal_positions(32, c, dev)[:f]
        ws = [(torch.randn(c, c, generator=g, device=dev) / math.sqrt(c)).to(torch.bfloat16)
              for _ in range(4)]
        bo = (0.1 * torch.randn(c, generator=g, device=dev)).to(torch.bfloat16)
        args = (x, gam, bet, pe, *ws, bo, 8, 1e-5)
        got = M.motion_attention(*args)
        want = M.motion_attention_plain(*args)
        err, tol = max_err(got, want), ulp_tol(want)
        log(f"K4 {name}: max_abs_err {err:.3e} (tol {tol:.3e}, 2 bf16 ulps)")
        require(math.isfinite(err) and err <= tol, f"K4 {name}: err {err} > {tol}")
        if rec is None:
            ms = time_ms(lambda: M.motion_attention(*args))
            plain_ms = time_ms(lambda: M.motion_attention_plain(*args), iters=3)
            m = b * f * l
            flops = 2.0 * m * c * c * 4 + 4.0 * b * l * f * f * c
            bms, by = bound_ms(flops, nbytes(x, gam, bet, pe, *ws, bo, got))
            rec = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=None,
                       bound_ms=bms, bound_by=by, shape=f"{name}: x {shape}")
    return rec


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
        require(n > 0, f"kernel {name} was not launched on the main path")
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
    return counts, per_step


def run_profile(torch, Pose2VideoPipeline):
    """One full-width denoise step under torch.profiler: device time by
    kernel, the step's wall time and the device's idle share. Not part of
    the default run (`python3 chip_smoke.py profile`)."""
    from torch.profiler import ProfilerActivity, profile

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
    t0 = time.perf_counter()
    step()
    wall_ms = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
    from torch.autograd import DeviceType

    rows = []
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:  # device kernels only, no host ops
            continue
        dev_us = getattr(e, "self_device_time_total", None)
        if dev_us is None:
            dev_us = getattr(e, "self_cuda_time_total", 0.0)
        if dev_us > 0:
            rows.append((dev_us / 1e3, e.count, e.key))
    rows.sort(reverse=True)
    families = {}
    for ms, _, key in rows:
        fam = next((f for f, pats in PROFILE_FAMILIES if any(p in key for p in pats)), "other")
        families[fam] = families.get(fam, 0.0) + ms
    busy = sum(r[0] for r in rows)
    log(json.dumps({"profile": {
        "what": "one denoise step, 2 windows x CFG = 48 frame rows, 512x512",
        "wall_ms_unprofiled": wall_ms, "device_busy_ms": busy,
        "idle_share": max(0.0, 1.0 - busy / wall_ms),
        "families_ms": {k: round(v, 3) for k, v in sorted(families.items(), key=lambda x: -x[1])},
        "top": [{"ms": round(ms, 3), "count": n, "kernel": k[:90]} for ms, n, k in rows[:20]],
    }}))


PROFILE_FAMILIES = (
    ("K1 flash_fwd", ("flash_fwd",)),
    ("K2 gn_*", ("gn_partial", "gn_stats", "gn_apply")),
    ("K3/K4 ln_gemm + ln_stats", ("ln_gemm", "ln_stats")),
    ("K4 frame_attn", ("frame_attn",)),
    ("cuDNN convolution", ("fprop", "conv", "dgrad", "wgrad")),
    ("cuBLAS GEMM (Linear, einsum)", ("nvjet", "gemm", "cutlass", "Kernel2")),
)


def run_small(torch, Pose2VideoPipeline):
    """Tiny pipeline: card (bf16, kernels) vs CPU (f32, plain versions)."""
    from mmgt_tpu_torch.diffusion.solver import init_solver_carry, solver_tables_for
    from mmgt_tpu_torch.models.audio_proj import AudioProjModel
    from mmgt_tpu_torch.models.pose_guider import PoseGuider
    from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D
    from mmgt_tpu_torch.models.unet_ref import ReferenceUNet2D
    from mmgt_tpu_torch.models.vae import AutoencoderKL
    from mmgt_tpu_torch.pipelines.context import compute_context_schedule

    def tiny(device, dtype):
        torch.manual_seed(SEED)
        kw = dict(block_out_channels=(64, 128, 128, 128), heads=2)
        pipe = Pose2VideoPipeline(
            vae=AutoencoderKL(block_out_channels=(32, 32, 64, 64)),
            reference_unet=ReferenceUNet2D(**kw), denoising_unet=DenoisingUNet3D(**kw),
            pose_guider=PoseGuider(64, (8, 16, 16, 32)),
            audio_proj=AudioProjModel(intermediate_dim=64), context_size=6,
            context_overlap=2)
        for m in pipe.models().values():
            m.to(device=device, dtype=dtype)
        pipe.init_params(SEED, std=0.05)
        return pipe

    ref = tiny("cpu", torch.float32)
    runs = {"cpu_f32": (ref, "cpu"), "cpu_bf16": (tiny("cpu", torch.bfloat16), "cpu"),
            "card_bf16": (tiny("cuda", torch.bfloat16), "cuda")}
    for tag, (pipe, _) in runs.items():  # every copy gets the f32 reference's weights
        if pipe is not ref:
            for name, m in ref.models().items():
                getattr(pipe, name).load_state_dict(m.state_dict())
    frames, size, steps = 8, 64, 2
    inputs = make_inputs(torch, frames, size, SEED + 7)
    g = torch.Generator().manual_seed(SEED + 8)
    lat0 = torch.randn(frames, size // 8, size // 8, 4, generator=g)
    tables = solver_tables_for(ref.scheduler, steps)
    win = compute_context_schedule(steps, frames, 6, 1, 2)
    outs = {}
    for tag, (pipe, dev) in runs.items():
        d = {k: v.to(dev) for k, v in inputs.items() if k != "masks"}
        d["masks"] = tuple(tuple(m.to(dev) for m in lv) for lv in inputs["masks"])
        cond, _ = pipe._prepare(**d)
        lat = lat0.to(dev)
        lat, _ = pipe._denoise_chunk(lat, init_solver_carry(lat), cond, tables, win,
                                     GUIDANCE, (1.0, 1.0, 1.0))
        outs[tag] = (lat.float().cpu(), pipe._decode(lat).float().cpu())
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


KERNEL_META = {
    "flash_attention": ("K1 flash attention (two-segment, kv_lens, LSE)", "cuda",
                        "mmgt_tpu_torch/csrc/flash_attn.cu",
                        "mmgt_tpu/ops/attention.py:764 _flash_attention_packed_2seg_fwd "
                        "(also :107, :320, :539)"),
    "group_norm": ("K2 GroupNorm (+SiLU)", "triton", "mmgt_tpu_torch/ops/norms.py",
                   "mmgt_tpu/ops/norms.py:219 _group_norm_pallas (also :158 blocked)"),
    "ln_projections": ("K3 LayerNorm -> 1-3 projections", "cuda",
                       "mmgt_tpu_torch/csrc/ln_proj.cu",
                       "mmgt_tpu/ops/fused_ln.py:62 _ln_proj_fwd"),
    "motion_attention": ("K4 motion (frame) attention", "cuda",
                         "mmgt_tpu_torch/csrc/motion_attn.cu",
                         "mmgt_tpu/ops/motion_attention.py:122 _motion_fwd"),
}


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    from mmgt_tpu_torch import ops
    from mmgt_tpu_torch.ops import _build
    from mmgt_tpu_torch.ops import attention as A
    from mmgt_tpu_torch.ops import fused_ln as L
    from mmgt_tpu_torch.ops import motion_attention as M
    from mmgt_tpu_torch.ops import norms as N
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline

    if argv not in ([], ["profile"]):
        print("usage: python3 chip_smoke.py [profile]", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(_build.SOURCES)}")
    card = card_line()
    log(f"card: {card}")

    if argv:
        run_profile(torch, Pose2VideoPipeline)
    else:
        recs = {"flash_attention": check_k1(torch, A), "group_norm": check_k2(torch, N),
                "ln_projections": check_k3(torch, L), "motion_attention": check_k4(torch, M)}
        for name, r in recs.items():
            log(f"{name}: ms {r['ms']:.3f} plain_ms {r['plain_ms']:.3f} library_ms "
                f"{r['library_ms'] if r['library_ms'] is None else round(r['library_ms'], 3)} "
                f"bound_ms {r['bound_ms']:.3f} ({r['bound_by']}) at {r['shape']}")
        counts, per_step = run_main(torch, ops, Pose2VideoPipeline)
        run_small(torch, Pose2VideoPipeline)
        kernels = []
        for name, r in recs.items():
            title, route, source, replaces = KERNEL_META[name]
            kernels.append(dict(
                name=title, route=route, source=source, replaces=replaces,
                launches=counts[name], launches_per_step=per_step[name],
                max_abs_err=r["max_abs_err"], ms=r["ms"], plain_ms=r["plain_ms"],
                bound_ms=r["bound_ms"], bound_by=r["bound_by"], library_ms=r["library_ms"],
                shape=r["shape"],
            ))
        print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
