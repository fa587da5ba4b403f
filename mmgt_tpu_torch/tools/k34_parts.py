"""Where K3's and K4's time goes, part by part, on one card.

    python -m mmgt_tpu_torch.tools.k34_parts

K3 (csrc/ln_proj.cu) is timed at the main path's level-0 q/k/v, level-0
GEGLU and level-2 audio-q shapes twice: with its LayerNorm and without it
(gamma absent: the same GEMM on x as it is), so the difference is the cost
of normalising the resident stripe. K4 is timed at levels 0, 1 and 3 as
its three launches: the LayerNorm + pe pre-pass (`ln_pe`), kernel A
(`motion_attn`: q/k/v projections and the frame attention) and the W_o
GEMM with the residual, and as the whole call. CUDA events over 10
launches after 2 warm-up launches. It prints one JSON line with the card's
name and power limit.
"""
from __future__ import annotations

import json
import math
import subprocess

import torch

from mmgt_tpu_torch.ops import _build
from mmgt_tpu_torch.ops import fused_ln as L
from mmgt_tpu_torch.ops import motion_attention as M


def time_ms(fn, iters: int = 10, warmup: int = 2) -> float:
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


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k34_parts: no CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device="cuda") * scale).to(
        torch.bfloat16)
    out = {"k3": {}, "k4": {}}
    for name, shape, ns, bias in [("L0 q/k/v", (48 * 4096, 320), [320] * 3, False),
                                  ("L0 GEGLU", (48 * 4096, 320), [2560], True),
                                  ("L2 3 audio q", (24 * 256, 1280), [1280] * 3, False)]:
        m, k = shape
        x = rnd(m, k)
        gam, bet = torch.ones(k, device="cuda"), torch.zeros(k, device="cuda")
        ws = [rnd(n, k, scale=1 / math.sqrt(k)) for n in ns]
        bs = [rnd(n).float() if bias else None for n in ns]
        out["k3"][name] = {
            "plan": L.gemm_plan(m, k, ns),
            "ms": time_ms(lambda: L.ln_gemm(x, gam, bet, ws, bs)),
            "ms_without_layernorm": time_ms(lambda: L.ln_gemm(x, None, None, ws, bs)),
        }
    for name, shape in [("L0", (4, 12, 4096, 320)), ("L1", (4, 12, 1024, 640)),
                        ("L3", (4, 12, 64, 1280))]:
        b, f, l, c = shape
        x = rnd(*shape)
        x2 = x.reshape(-1, c)
        gam, bet = torch.ones(c, device="cuda"), torch.zeros(c, device="cuda")
        pe = M.sinusoidal_positions(32, c, "cuda")[:f].contiguous()
        ws = [rnd(c, c, scale=1 / math.sqrt(c)) for _ in range(4)]
        bo = torch.zeros(c, device="cuda")
        plan = M.attn_plan(f, l, c, 8)
        h = M.ln_pe(x, gam, bet, pe, 1e-5)
        o = torch.empty_like(x2)
        lib = _build.load("motion_attn")

        def kernel_a():
            rc = lib.mmgt_motion_attn(h.data_ptr(), ws[0].data_ptr(), ws[1].data_ptr(),
                                      ws[2].data_ptr(), o.data_ptr(), b, f, l, c, 8,
                                      1.0 / math.sqrt(c // 8), plan["rp"], plan["lt"],
                                      plan["stages"], plan["smem"], _build.stream_ptr(x))
            _build.check(lib, rc, "kernel A")

        out["k4"][name] = {
            "plan": plan,
            "ln_pe_ms": time_ms(lambda: M.ln_pe(x, gam, bet, pe, 1e-5)),
            "kernel_a_ms": time_ms(kernel_a),
            "w_o_gemm_ms": time_ms(lambda: L.ln_gemm(o, None, None, [ws[3]], [bo], res=[x2])),
            "whole_ms": time_ms(lambda: M.motion_attention(x, gam, bet, pe, *ws, bo, 8)),
        }
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"k34_parts": out, "card": card}))


if __name__ == "__main__":
    main()
