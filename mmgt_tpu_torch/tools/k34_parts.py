"""Where K3's time goes, part by part, on one card.

    python -m mmgt_tpu_torch.tools.k34_parts

K3 (csrc/ln_proj.cu) is timed at the main path's level-0 q/k/v, level-0
GEGLU and level-2 audio-q shapes twice: with its LayerNorm and without it
(gamma absent: the same GEMM on x as it is), so the difference is the cost
of normalising the resident stripe. CUDA events over 10 launches after 2
warm-up launches. It prints one JSON line with the card's name and power
limit. K4's rows and its kernels one by one: `tools/k4_rows.py`.
"""
from __future__ import annotations

import json
import math
import subprocess

import torch

from mmgt_tpu_torch.ops import fused_ln as L


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
    out = {"k3": {}}
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
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"k34_parts": out, "card": card}))


if __name__ == "__main__":
    main()
