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
     level-0 GEGLU and level-2 audio-q shapes, K4 at levels 0, 1 and 3, K5
     at the level-1 bank-concat and level-0 audio self-attention shapes;
     two K5 calls on the same inputs must be bitwise equal;
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
  8. train: Stage2Trainer at full width, 512x512, 12 frames, batch 1,
     remat, TRAIN_STEPS steps on a seeded random batch: finite losses, the
     f32 masters of every trainable tensor moved, every frozen tensor
     bitwise unchanged, K5 launched EXPECTED_K5_PER_STEP times in every
     step and K1-K4 at least once (the counts include the checkpointed
     recompute), the seconds of the steps after the first and the peak
     memory;
  9. train_small: a tiny trainer (the small pipeline's sizes, no remat) with
     one set of weights and draws, three ways as in 5; the loss and the
     flattened trainable gradients against CPU f32, the card's mean error
     within SMALL_ERR_FACTOR x the plain bf16 error.
Then the `kernels` JSON line, the card line, and the result line.

    python3 chip_smoke.py profile    # build, then profile a denoise step
                                     # and a train step

profiles one full-width denoise step and one full-width train step
instead (device time by kernel family, idle share, and the GroupNorm
calls of each step with K2's plans and their bytes bound) and prints no
`kernels` line.
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
# the denoiser's 16 bank self-attentions less down_0_attn_0 (nothing
# upstream of it is trained), plus the 6 self-attentions of the trained
# audio blocks
EXPECTED_K5_PER_STEP = 21


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
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    cases = [  # (name, batch, q seq, self kv seq, heads, d, bank, kv_lens, lse, timed as)
        ("L0 bank mixed kv_lens + lse", 2, 4096, 4096, 8, 40, True, [4096, 8192], True,
         "_flash_attention_packed_2seg_fwd"),
        ("L0 self only (ReferenceNet)", 1, 4096, 4096, 8, 40, False, None, False,
         "_flash_attention_packed_fwd"),
        ("L0 concat + lse (training)", 2, 4096, 8192, 8, 40, False, [4096, 8192], True,
         "_flash_attention_fwd_lse"),
        ("L1 bank", 2, 1024, 1024, 8, 80, True, [1024, 2048], False, "L1 bank (d = 80)"),
        ("L2 bank", 2, 256, 256, 8, 160, True, [256, 512], True, "L2 bank (d = 160)"),
        ("L3 bank", 2, 64, 64, 8, 160, True, [64, 128], False, None),
        ("VAE mid d=512", 1, 4096, 4096, 1, 512, False, None, False, "_flash_attention"),
    ]
    tol_lse = 1e-3
    rec, rows = None, {}
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
        if timed is None:
            continue
        kc = k if kb is None else torch.cat([k, kb.expand(b, -1, -1, -1)], 1)
        vc = v if vb is None else torch.cat([v, vb.expand(b, -1, -1, -1)], 1)
        mask = None
        if kl is not None:
            mask = (torch.arange(kc.shape[1], device=dev)[None, :] < kl[:, None])[:, None, None, :]
        qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
        valid = sum(lens) if lens else b * kc.shape[1]
        row = time_row(
            lambda: A.flash_attention(q, k, v, kl, kb, vb, return_lse=lse),
            lambda: A.attention_plain(q, k, v, kl, kb, vb, return_lse=lse),
            lambda: sdpa(qt, kt, vt, attn_mask=mask), 4.0 * h * d * s * valid,
            nbytes(q, k, v, kb, vb, got, got_lse if lse else None),
            f"{name}: q {tuple(q.shape)}, K/V {tuple(kc.shape)}")
        row["max_abs_err"] = err
        rows[timed] = row
        if rec is None:  # the hottest shape: the denoiser's level-0 bank attention
            rec = dict(row, rows=rows)
    # the f32 route of dot_product_attention (wav2vec2 on audio over ~20 s):
    # K1 in bf16 between two casts, against the f32 plain version; its error
    # is the inputs' bf16 rounding
    name, shape = "f32 route (wav2vec2 >= 512 frames)", (1, 600, 12, 64)
    q, k, v = (torch.randn(*shape, generator=g, device=dev) for _ in range(3))
    before = A.LAUNCHES
    got = A.dot_product_attention(q, k, v)
    require(A.LAUNCHES == before + 1, "K1 f32 route: dot_product_attention did not launch K1")
    want = A.attention_plain(q, k, v)
    err, tol = max_err(got, want), ulp_tol(want)
    log(f"K1 {name}: max_abs_err {err:.3e} against the f32 plain version "
        f"(tol {tol:.3e}, 2 bf16 ulps; largest |o| {want.abs().max().item():.3e})")
    require(math.isfinite(err) and err <= tol, f"K1 {name}: err {err} > {tol}")
    b, s_len, h, d = shape
    row = time_row(lambda: A.dot_product_attention(q, k, v), lambda: A.attention_plain(q, k, v),
                   lambda: sdpa(q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)),
                   4.0 * h * d * s_len * s_len * b, nbytes(q, k, v, got),
                   f"{name}: q, K/V {shape} f32")
    row["max_abs_err"] = err
    rows["f32 route (1, 600, 12, 64)"] = row
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
    """K3 against its plain version; every case timed with its bound and
    the library pair F.linear(F.layer_norm(x), cat(W), cat(b))."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 2)
    F = torch.nn.functional
    rec, rows = None, {}
    for name, nrow, l, c, outs, bias in [
        ("L0 q/k/v (48 rows)", 48, 4096, 320, [320, 320, 320], False),
        ("L0 GEGLU", 48, 4096, 320, [2560], True),
        ("L2 3 audio q", 24, 256, 1280, [1280, 1280, 1280], False),
    ]:
        x = torch.randn(nrow, l, c, generator=g, device=dev).to(torch.bfloat16)
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
        wcat = torch.cat(ws, 0)
        bcat = torch.cat(bs, 0) if bias else None
        m = nrow * l
        row = time_row(
            lambda: L.ln_projections(x, gam, bet, ws, bs, 1e-5),
            lambda: L.ln_projections_plain(x, gam, bet, ws, bs, 1e-5),
            lambda: F.linear(F.layer_norm(x, (c,), gam, bet, 1e-5), wcat, bcat),
            2.0 * m * c * sum(outs), nbytes(x, gam, bet, *ws, *bs, *got),
            f"{name}: x {tuple(x.shape)}, W {[(n, c) for n in outs]}")
        row["max_abs_err"] = err
        rows[name] = row
        if rec is None:
            rec = dict(row, rows=rows)
        del x, got, want
        torch.cuda.empty_cache()
    return rec


def check_k4(torch, M):
    """K4 against its plain version, every case timed with its bound (no
    single PyTorch call computes the function)."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 3)
    rec, rows = None, {}
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
        m = b * f * l
        row = time_row(lambda: M.motion_attention(*args),
                       lambda: M.motion_attention_plain(*args), None,
                       2.0 * m * c * c * 4 + 4.0 * b * l * f * f * c,
                       nbytes(x, gam, bet, pe, *ws, bo, got), f"{name}: x {shape}, 8 heads")
        row["max_abs_err"] = err
        rows[name] = row
        if rec is None:
            rec = dict(row, rows=rows)
        del x, got, want
        torch.cuda.empty_cache()
    return rec


def check_k5(torch, A):
    """K5 against `attention_bwd_plain` (2 rows per shape: at full batch the
    plain version's f32 P alone would take ~13 GB). Tolerance: 4 bf16 ulps
    at the largest |value| of each of dq, dk, dv: dk/dv sum thousands of
    queries in another order than the plain version, and P and dS are
    rounded to bf16 as product operands. Two calls on the same inputs must
    be bitwise equal. Timed at the level-0 and level-1 bank-concat shapes
    and the level-0 audio self-attention; the library time is SDPA's
    forward + backward less its forward."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 4)
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(torch.bfloat16)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    rec, rows = None, {}
    for name, b, sq, skv, h, d, lens, timed in [  # (name, batch, q seq, kv seq, heads, d, kv_lens)
        ("L0 bank concat", 2, 4096, 8192, 8, 40, [4096, 8192], True),
        ("L1 bank concat", 2, 1024, 2048, 8, 80, [1024, 2048], True),
        ("L2 bank concat", 2, 256, 512, 8, 160, [256, 512], False),
        ("mid bank concat", 2, 64, 128, 8, 160, [64, 128], False),
        ("L0 audio self-attention", 2, 4096, 4096, 8, 40, None, True),
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
    report_profile(prof, "one denoise step, 2 windows x CFG = 48 frame rows, 512x512",
                   wall_ms)
    report_k2_calls(torch, step)
    del pipe, cond, lat
    torch.cuda.empty_cache()


def report_profile(prof, what: str, wall_ms: float):
    """Device time by kernel and family, and the idle share of `wall_ms`."""
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
        "what": what,
        "wall_ms_unprofiled": wall_ms, "device_busy_ms": busy,
        "idle_share": max(0.0, 1.0 - busy / wall_ms),
        "families_ms": {k: round(v, 3) for k, v in sorted(families.items(), key=lambda x: -x[1])},
        "top": [{"ms": round(ms, 3), "count": n, "kernel": k[:90]} for ms, n, k in rows[:20]],
    }}))


PROFILE_FAMILIES = (
    ("K1 flash_fwd", ("flash_fwd",)),
    ("K5 bwd_dsum + bwd_dq + bwd_dkv", ("bwd_dsum", "bwd_dq", "bwd_dkv")),
    ("K2 gn_resident + gn_stream_*", ("gn_resident", "gn_stream")),
    ("K3 and K4's W_o: ln_gemm", ("ln_gemm",)),
    ("K4 kernel A: motion_attn", ("motion_attn",)),
    ("K4 LayerNorm + pe: ln_pe", ("ln_pe",)),
    ("cuDNN convolution", ("fprop", "conv", "dgrad", "wgrad")),
    ("cuBLAS GEMM (Linear, einsum)", ("nvjet", "gemm", "cutlass", "Kernel2")),
)


def run_small(torch, Pose2VideoPipeline):
    """Tiny pipeline: card (bf16, kernels) vs CPU (f32, plain versions)."""
    from mmgt_tpu_torch.diffusion.solver import init_solver_carry, solver_tables_for
    from mmgt_tpu_torch.pipelines.context import compute_context_schedule

    tiny = lambda dev, dtype: tiny_pipeline(torch, Pose2VideoPipeline, dev, dtype)
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
    del pipe, out
    torch.cuda.empty_cache()
    return counts, rec.calls


class LaunchRecorder:
    """Wraps each kernel module's `_launch` (the one place a kernel wrapper
    launches) for the duration of a `with` block and records the layout of
    every launch: its signature (per tensor argument the shape, strides and
    dtype, every other argument as it is) with a count of calls, and K1's
    kv_lens values of the first call of each signature. It adds no device
    work to the calls it records."""

    def __init__(self, torch, mods):
        self.torch, self.mods, self.calls = torch, mods, {}

    def desc(self, a):
        if isinstance(a, self.torch.Tensor):
            return ("T", tuple(a.shape), tuple(a.stride()), a.dtype)
        if isinstance(a, (list, tuple)):
            return ("S", tuple(self.desc(e) for e in a))
        return ("V", a)

    def __enter__(self):
        self.saved = {name: mod._launch for name, mod in self.mods.items()}
        for name, mod in self.mods.items():
            def rec(*args, _name=name, _plain=self.saved[name]):
                key = (_name, tuple(self.desc(a) for a in args))
                if key not in self.calls:
                    lens = args[3] if _name == "flash_attention" else None
                    self.calls[key] = [0, None if lens is None else lens.clone()]
                self.calls[key][0] += 1
                return _plain(*args)
            mod._launch = rec
        return self

    def __exit__(self, *exc):
        for name, mod in self.mods.items():
            mod._launch = self.saved[name]


def check_a2v_calls(torch, calls, A, N, L, M):
    """Every launch signature the a2v call recorded, replayed on seeded
    random inputs of the same shapes, strides and dtypes (K1's kv_lens
    as recorded): the kernel over the whole tensor, held against its plain
    version on the first, middle and last batch rows (K3: the first,
    middle and last A2V_ROW_CHUNK rows of x), where an offset past 2^31
    bytes would show, at the kernels rows' tolerances. Each signature's
    kernel time and bound; summed over the call's launches, each kernel's
    device time and bound per a2v call."""
    dev = "cuda"
    g = torch.Generator(device=dev).manual_seed(SEED + 30)

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

    per_kernel, rows, worst = {}, [], 0.0
    for (kern, sig), (count, lens) in sorted(calls.items(), key=lambda kv: str(kv[0])):
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
                            f"a2v K1 {tuple(q.shape)} row {i}: lse err")
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
        else:
            xd, gd, btd, ped, *wd, bod, heads, eps = sig
            x = make(xd)
            b, f, l, c = x.shape
            args = (x, make(gd, 0.1, 1.0), make(btd, 0.1), make(ped),
                    *(make(d_, 1 / math.sqrt(c)) for d_ in wd), make(bod, 0.1),
                    heads[1], eps[1])
            fn = lambda: M.motion_attention(*args)
            got = fn()
            err, tol = 0.0, 0.0
            for i in picks(b):
                want = M.motion_attention_plain(x[i:i + 1], *args[1:])
                err, tol = max(err, max_err(got[i:i + 1], want)), max(tol, ulp_tol(want))
            flops = 2.0 * b * f * l * c * c * 4 + 4.0 * b * l * f * f * c
            nb = nbytes(*args[:9], got)
            what = f"x {tuple(x.shape)}, {heads[1]} heads"
            inputs = args[:9]
        require(math.isfinite(err) and err <= tol,
                f"a2v {kern} at {what}: err {err} > {tol}")
        worst = max(worst, err / tol if tol else 0.0)
        ms = time_ms(fn, iters=3, warmup=1)
        bms, _ = bound_ms(flops, nb)
        rows.append(dict(kernel=kern, at=what, calls=count, max_abs_err=err, tol=tol, ms=ms,
                         bound_ms=bms))
        log(f"a2v_calls {kern} x{count}: {what}: max_abs_err {err:.3e} (tol {tol:.3e}); "
            f"ms {ms:.3f} bound_ms {bms:.4f}")
        k = per_kernel.setdefault(kern, dict(signatures=0, launches=0, ms=0.0, bound_ms=0.0))
        k["signatures"] += 1
        k["launches"] += count
        k["ms"] += count * ms
        k["bound_ms"] += count * bms
        del got, inputs, fn
        torch.cuda.empty_cache()
    log(json.dumps({"a2v_calls": {"per_kernel": per_kernel, "worst_err_over_tol": worst}}))
    return per_kernel


def tiny_a2v(torch, device, dtype):
    """The a2v_small pipeline (64..128-channel Stage 2 as `small`, a 2-layer
    CLIP, wav2vec2 and WavLM of width 64, a 1-layer SMGA decoder) with the
    card's dtypes: Stage 2 and CLIP in `dtype`, the audio encoders and SMGA
    in f32 (all f32 when `dtype` is). Weights: seeded, copied from one set
    by the caller."""
    from mmgt_tpu_torch.config import InferenceConfig
    from mmgt_tpu_torch.data.audio import AudioProcessor, WavLMFeatureExtractor
    from mmgt_tpu_torch.models.audio_proj import AudioProjModel
    from mmgt_tpu_torch.models.clip_vision import CLIPVisionModel
    from mmgt_tpu_torch.models.smga import GestureDecoder
    from mmgt_tpu_torch.models.wav2vec2 import Wav2Vec2Model
    from mmgt_tpu_torch.models.wavlm import WavLMModel
    from mmgt_tpu_torch.pipelines.audio2vid import Audio2VideoPipeline
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
    from mmgt_tpu_torch.training.stage1 import SMGA

    p2v = tiny_pipeline(torch, Pose2VideoPipeline, device, dtype)
    p2v.audio_proj = AudioProjModel(blocks=2, channels=64, intermediate_dim=64).to(device, dtype)
    f32 = torch.float32
    enc = lambda m, dt: m.to(device, dt).eval()
    cfg = InferenceConfig(width=64, height=64, video_length=8, num_inference_steps=2,
                          a2p_sampling_steps=5, context_size=6, context_overlap=2,
                          window_microbatch=None)
    return Audio2VideoPipeline(
        smga=SMGA(feature_type="wavlm", model=enc(GestureDecoder(
            seq_len=80, latent_dim=64, ff_size=128, num_layers=1, num_heads=4,
            cond_feature_dim=64 + 35), f32)),
        pose2vid=p2v,
        clip_model=enc(CLIPVisionModel(hidden_dim=64, num_layers=2, heads=4), dtype),
        audio_processor=AudioProcessor(enc(Wav2Vec2Model(64, 2, 4, 128), f32)),
        wavlm_extractor=WavLMFeatureExtractor(enc(WavLMModel(64, 2, 4, 128), f32)),
        config=cfg)


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


# ---------------------------------------------------------------- training
def make_train_batch(torch, b: int, frames: int, size: int, seed: int, device="cpu"):
    """A seeded random Stage-2 batch, so that the loss is not trivially 0."""
    g = torch.Generator().manual_seed(seed)
    h8 = size // 8
    rand = lambda *s: torch.rand(*s, generator=g)
    batch = dict(
        pixel_values=rand(b, frames, size, size, 3) * 2 - 1,
        ref_image=rand(b, size, size, 3) * 2 - 1,
        clip_embed=torch.randn(b, 1, 768, generator=g),
        audio_embeds=torch.randn(b, frames, 5, 12, 768, generator=g),
        pose_video=rand(b, frames, size, size, 3),
        masks=[tuple((rand(b, frames, (h8 >> lv) ** 2) > 0.4).float() for _ in range(3))
               for lv in range(3)],
    )
    return {k: ([tuple(m.to(device) for m in lv) for lv in v] if k == "masks"
                else v.to(device)) for k, v in batch.items()}


def run_train(torch, ops, Stage2Trainer):
    """Full-width Stage-2 training steps on the card."""
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
    del trainer, state, frozen, frozen0, masters0, working0, batch
    torch.cuda.empty_cache()
    return total, {k: n / TRAIN_STEPS for k, n in total.items()}


def tiny_pipeline(torch, Pose2VideoPipeline, device, dtype):
    """The small pipeline's models (64..128 channels, 2 heads) with seeded
    weights."""
    from mmgt_tpu_torch.models.audio_proj import AudioProjModel
    from mmgt_tpu_torch.models.pose_guider import PoseGuider
    from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D
    from mmgt_tpu_torch.models.unet_ref import ReferenceUNet2D
    from mmgt_tpu_torch.models.vae import AutoencoderKL

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


def run_profile_train(torch, Stage2Trainer):
    """One full-width train step under torch.profiler (after a warm-up
    step): device time by kernel family and the idle share."""
    from torch.profiler import ProfilerActivity, profile

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
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        step()
    report_profile(prof, "one train step: 12 frames, bs 1, 512x512, remat", wall_ms)
    report_k2_calls(torch, step)


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

    if argv not in ([], ["profile"]):
        print("usage: python3 chip_smoke.py [profile]", file=sys.stderr)
        return 2
    disable_tf32()

    t0 = time.perf_counter()
    _build.build()
    log(f"build: {time.perf_counter() - t0:.1f} s for {', '.join(_build.SOURCES)}")
    card = card_line()
    log(f"card: {card}")

    if argv:
        run_profile(torch, Pose2VideoPipeline)
        run_profile_train(torch, Stage2Trainer)
    else:
        kernel_mods = {"flash_attention": A, "group_norm": N, "ln_projections": L,
                       "motion_attention": M}
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
        counts, per_step = run_main(torch, ops, Pose2VideoPipeline)
        run_small(torch, Pose2VideoPipeline)
        log(f"main + small: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        with tempfile.TemporaryDirectory() as tmp:
            a2v_counts, a2v_calls = run_a2v(torch, ops, kernel_mods, tmp)
            a2v_per_kernel = check_a2v_calls(torch, a2v_calls, A, N, L, M)
            run_a2v_small(torch, tmp)
        log(f"a2v + a2v_small: {time.perf_counter() - t0:.1f} s")
        t0 = time.perf_counter()
        train_counts, train_per_step = run_train(torch, ops, Stage2Trainer)
        run_train_small(torch, Pose2VideoPipeline, Stage2Trainer)
        log(f"train + train_small: {time.perf_counter() - t0:.1f} s")
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
    sys.exit(main(sys.argv[1:]))
