"""K1's head-dim padding at d = 40, measured both ways on one card.

    python -m mmgt_tpu_torch.tools.k1_swizzle

K1 (csrc/flash_attn.cu) runs d <= 48 padded to 48 columns with a 32-byte
swizzle (three 16-column TMA boxes). The alternative pads to 64 columns
with a 128-byte swizzle (one box; a third more tensor-core work, wider
swizzle). This script builds the shipped source and a copy whose d <= 48
dispatch is changed to the 64-column variant, checks both against the
plain version, and times both at the d = 40 shapes of the main path, in
turns (shipped, variant, variant, shipped). It prints one JSON line with
the card's name and power limit. The variant is built only here; the
kernel itself has one design per head dim.
"""
from __future__ import annotations

import ctypes
import json
import subprocess

import torch

from mmgt_tpu_torch.ops import _build
from mmgt_tpu_torch.ops import attention as A

SHIPPED = "if (D <= 48) return launch_tma<48, 32, 128>(p, B, st);"
VARIANT = "if (D <= 48) return launch_tma<64, 128, 128>(p, B, st);"


def build_variant() -> ctypes.CDLL:
    src = (_build.CSRC / "flash_attn.cu").read_text()
    if SHIPPED not in src:
        raise RuntimeError("the d <= 48 dispatch line of flash_attn.cu has changed")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "flash_attn_pad64.cu"
    cu.write_text(src.replace(SHIPPED, VARIANT))
    out = _build.BUILD_DIR / "libflash_attn_pad64.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out),
                    str(cu)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.mmgt_error_string.restype = ctypes.c_char_p
    lib.mmgt_error_string.argtypes = [ctypes.c_int]
    for name, types in _build.SIGNATURES["flash_attn"].items():
        fn = getattr(lib, name)
        fn.restype, fn.argtypes = ctypes.c_int, types
    return lib


def time_ms(fn, iters=20) -> float:
    for _ in range(3):
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
    shipped = _build.load("flash_attn")
    variant = build_variant()
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
    cases = [  # (name, batch, q seq, self kv seq, bank, kv_lens)
        ("L0 bank", 2, 4096, 4096, True, [4096, 8192]),
        ("L0 self only", 1, 4096, 4096, False, None),
        ("L0 concat", 2, 4096, 8192, False, [4096, 8192]),
    ]
    rows = {}
    for name, b, s, skv, bank, lens in cases:
        q, k, v = rnd(b, s, 8, 40), rnd(b, skv, 8, 40), rnd(b, skv, 8, 40)
        kb, vb = (rnd(1, s, 8, 40), rnd(1, s, 8, 40)) if bank else (None, None)
        kl = torch.tensor(lens, dtype=torch.int32, device="cuda") if lens else None
        want = A.attention_plain(q, k, v, kl, kb, vb)
        tol = 2 * 2.0 ** -7 * want.float().abs().max().item()
        call = lambda: A.flash_attention(q, k, v, kl, kb, vb)
        times = {"pad48_sw32": [], "pad64_sw128": []}
        for tag in ("pad48_sw32", "pad64_sw128", "pad64_sw128", "pad48_sw32"):
            _build._LIBS["flash_attn"] = shipped if tag == "pad48_sw32" else variant
            err = (call().float() - want.float()).abs().max().item()
            if not err <= tol:
                raise AssertionError(f"{name} {tag}: err {err} > {tol}")
            times[tag].append(time_ms(call))
        _build._LIBS["flash_attn"] = shipped
        rows[name] = {k: sum(t) / len(t) for k, t in times.items()}
        rows[name]["runs"] = times
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"k1_swizzle_ms": rows, "card": card}))


if __name__ == "__main__":
    main()
