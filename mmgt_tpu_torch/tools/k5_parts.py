"""K5's launches timed apart, and its polynomial exponentials against the
SFU's, on one card.

    python -m mmgt_tpu_torch.tools.k5_parts

K5 (csrc/flash_attn_bwd.cu) is three launches: the statistics
(`bwd_dsum`), the dQ pass (`bwd_dq`) and the dK/dV pass (`bwd_dkv`). At
d <= 48 the dK/dV pass takes every third group of columns' 2^x by a
polynomial on the FMA pipe and the rest on the SFU. This script builds the
shipped source and a copy that takes every 2^x on the SFU, checks both
against the plain version (4 bf16 ulps at the largest |value|), and times
both at the d = 40 shapes of chip_smoke.py's K5 phase in turns (shipped,
variant, variant, shipped), then each launch of the shipped kernel alone
(device time under torch.profiler, 5 calls). It prints one JSON line with
the card's name and power limit. The variant is built only here.
"""
from __future__ import annotations

import ctypes
import json
import re
import subprocess

import torch

from mmgt_tpu_torch.ops import _build
from mmgt_tpu_torch.ops import attention as A

SHIPPED = "DP == 48 && c % 3 == 2 ? ex2_poly(x) : ex2(x)"
VARIANT = "ex2(x)"
CASES = [  # (name, batch, q seq, kv seq, heads, kv_lens): PERF.md rows 3, 3c-3f
    ("L0 bank concat", 2, 4096, 8192, 8, [4096, 8192]),
    ("L0 audio self-attention", 2, 4096, 4096, 8, None),
    ("train_image L0 concat", 4, 1024, 2048, 8, [1024, 2048, 2048, 2048]),
    ("train_image ReferenceNet self-attention", 4, 1024, 1024, 8, None),
    ("tp2 L0 bank concat, 4 heads", 2, 4096, 8192, 4, [4096, 8192]),
]


def build_variant() -> ctypes.CDLL:
    src = (_build.CSRC / "flash_attn_bwd.cu").read_text()
    if src.count(SHIPPED) != 1:
        raise RuntimeError("the dK/dV pass's exponential line of flash_attn_bwd.cu has changed")
    _build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = _build.BUILD_DIR / "flash_attn_bwd_sfu.cu"
    cu.write_text(src.replace(SHIPPED, VARIANT))
    out = _build.BUILD_DIR / "libflash_attn_bwd_sfu.so"
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC), "-o", str(out),
                    str(cu)], check=True)
    lib = ctypes.CDLL(str(out))
    lib.mmgt_error_string.restype = ctypes.c_char_p
    lib.mmgt_error_string.argtypes = [ctypes.c_int]
    for name, types in _build.SIGNATURES["flash_attn_bwd"].items():
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


def launch_ms(fn, calls=5) -> dict:
    """Device ms a call of each of K5's kernels, by name."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        m = re.search(r"bwd_d(sum|q|kv)", e.key)
        if m:
            out[m.group(0)] = out.get(m.group(0), 0.0) + e.device_time_total / calls / 1e3
    return out


def main() -> None:
    shipped = _build.load("flash_attn_bwd")
    variant = build_variant()
    g = torch.Generator(device="cuda").manual_seed(0)
    rnd = lambda *s: torch.randn(*s, generator=g, device="cuda").to(torch.bfloat16)
    rows = {}
    for name, b, sq, skv, h, lens in CASES:
        q, k, v, do = rnd(b, sq, h, 40), rnd(b, skv, h, 40), rnd(b, skv, h, 40), rnd(b, sq, h, 40)
        kl = torch.tensor(lens, dtype=torch.int32, device="cuda") if lens else None
        o, lse = A.flash_attention(q, k, v, kl, return_lse=True)
        r = slice(0, 1)  # one row against the plain version (its f32 P is large)
        want = A.attention_bwd_plain(q[r], k[r], v[r], o[r], do[r], lse[r],
                                     None if kl is None else kl[r])
        call = lambda: A.flash_attention_bwd(q, k, v, o, do, lse, kl)
        times = {"shipped": [], "sfu_only": []}
        for tag in ("shipped", "sfu_only", "sfu_only", "shipped"):
            _build._LIBS["flash_attn_bwd"] = shipped if tag == "shipped" else variant
            for gname, got, w in zip(("dq", "dk", "dv"), call(), want):
                err = (got[r].float() - w.float()).abs().max().item()
                tol = 4 * 2.0 ** -7 * w.float().abs().max().item()
                if not err <= tol:
                    raise AssertionError(f"{name} {tag} {gname}: err {err} > {tol}")
            times[tag].append(time_ms(call))
        _build._LIBS["flash_attn_bwd"] = shipped
        rows[name] = {t: sum(v) / len(v) for t, v in times.items()}
        rows[name]["runs"] = times
        rows[name]["launch_ms"] = launch_ms(call)
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(json.dumps({"k5_parts_ms": rows, "card": card}))


if __name__ == "__main__":
    main()
