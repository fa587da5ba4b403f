"""K3's rows of PERF.md's kernel table, timed on one card.

    python mmgt_tpu_torch/tools/k3_rows.py [--root DIR] [--rows 8,8b,...] [--json PATH]

`ROWS` is the one table of K3's rows: the main path's shapes, which
`chip_smoke.py`'s K3 phase also checks against the plain version. The
level-0 q/k/v, GEGLU, 3 audio q and K4's W_o + residual, pose2img's and
the image step's level-0 q/k/v and the tp shards (K = 320, the stripe
regime); the level-2 audio q, the level-1 q/k/v, GEGLU and audio q, the
level-2 GEGLU and K4's W_o + residual at levels 1 and 3 (K >= 640, the
tiled regime). `case` builds one row's inputs and its kernel, plain and
library calls, with gamma, beta and the biases in bf16 as the model
holds them, and the same calls with them in f32.

For each row this script prints the wall ms a call (CUDA events around
20 calls after 3 warm-up calls), the device ms a call (torch.profiler
over 5 calls: every kernel of the call, and K3's own, with their names
and count), one library call's ms (`F.linear(F.layer_norm(x), cat(W),
cat(b))`, or `torch.addmm` onto the residual and bias), the bound (the
larger of flops / 989 TFLOP/s and bytes / 3.35 TB/s), the plan, and the
host's time a call, each timed with the card held busy so that no call
waits for it: the whole wrapper, its C entry (the tensor maps and the
launch) and the ctypes call alone (the C entry called with M = 0, which
returns before any work); the wrapper's own checks and allocations are
the first less the second. It also gives the wall and device ms of the
same call with gamma, beta and the biases in f32 (`f32_ms`,
`f32_k3_device_ms`).

`--root DIR` imports `mmgt_tpu_torch` from DIR instead, so that an
unpacked older tree is timed by the same script (it uses only
`ln_projections`, `ln_projections_plain`, `ln_gemm` and the library cache
`_build._LIBS`, which every tree has, and the C entry's M as its fourth
argument); run each tree in a process of its own and compare within one
machine. `--rows` times only the named rows. It prints one JSON line with
the card's name and power limit.
"""
from __future__ import annotations

import argparse
import json
import math
import subprocess
import sys
import time
from pathlib import Path

PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
M_ARG = 3  # M's place among the C entry's arguments (x, gamma, beta, M, ...)

# (row, name, x shape, weight columns, bias, K4's W_o with a residual and no LayerNorm)
ROWS = [
    ("8", "L0 q/k/v", (48, 4096, 320), [320] * 3, False, False),
    ("8b", "L0 GEGLU", (48, 4096, 320), [2560], True, False),
    ("8c", "L2 3 audio q", (24, 256, 1280), [1280] * 3, False, False),
    ("8d", "pose2img L0 q/k/v", (2, 4096, 320), [320] * 3, False, False),
    ("8e", "train_image L0 q/k/v", (4, 1024, 320), [320] * 3, False, False),
    # the tp shards: q/k/v at tp = 2 and 4 (80 columns: a partial tile),
    # the GEGLU half-pairs at tp = 2
    ("8f", "tp2 L0 q/k/v", (48, 4096, 320), [160] * 3, False, False),
    ("8g", "tp4 L0 q/k/v", (48, 4096, 320), [80] * 3, False, False),
    ("8h", "tp2 L0 GEGLU half-pairs", (48, 4096, 320), [1280], True, False),
    ("8i", "L1 q/k/v", (48, 1024, 640), [640] * 3, False, False),
    ("8j", "L1 GEGLU", (48, 1024, 640), [5120], True, False),
    ("8k", "L1 3 audio q", (24, 1024, 640), [640] * 3, False, False),
    ("8l", "L2 GEGLU", (48, 256, 1280), [10240], True, False),
    ("8m", "L1 W_o + residual (K4)", (48, 1024, 640), [640], True, True),
    ("8n", "L3 W_o + residual (K4)", (48, 64, 1280), [1280], True, True),
    # the level-0 audio blocks' three q projections (conditional rows only)
    # and K4's level-0 W_o + residual (K = 320: the stripe regime)
    ("8o", "L0 3 audio q", (24, 4096, 320), [320] * 3, False, False),
    ("8p", "L0 W_o + residual (K4)", (48, 4096, 320), [320], True, True),
]


def case(torch, L, row, g) -> dict:
    """One row of ROWS on the card, its inputs drawn from generator `g`:
    fn (the kernel), plain (its plain version), lib (one library call),
    fn_f32 and plain_f32 (the same with gamma, beta and the biases in f32),
    the flops, the input bytes (each read once) and a label with the
    shape."""
    _, name, shape, ns, bias, w_o = row
    F = torch.nn.functional
    dev, c, m = g.device, shape[-1], math.prod(shape[:-1])
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device=dev) * scale).to(
        torch.bfloat16)
    x = rnd(*shape)
    gam, bet = 1 + rnd(c, scale=0.1), rnd(c, scale=0.1)
    ws = [rnd(n, c, scale=1 / math.sqrt(c)) for n in ns]
    bs = [rnd(n, scale=0.1) if bias else None for n in ns]
    bs32 = [None if b is None else b.float() for b in bs]
    wcat = torch.cat(ws, 0)
    bcat = torch.cat(bs, 0) if bias else None
    if w_o:
        x2, res = x.reshape(m, c), rnd(m, ns[0])
        res_b = res + bcat  # the library's one call: addmm onto residual + bias
        fn = lambda: L.ln_gemm(x2, None, None, ws, bs, res=[res])
        plain = lambda: [(x2.float() @ wcat.float().t() + bcat.float() + res.float())
                         .to(torch.bfloat16)]
        fn_f32 = lambda: L.ln_gemm(x2, None, None, ws, bs32, res=[res])
        plain_f32 = plain
        lib = lambda: torch.addmm(res_b, x2, wcat.t())
        inputs = [x, *ws, *bs, res]
    else:
        g32, b32 = gam.float(), bet.float()
        fn = lambda: L.ln_projections(x, gam, bet, ws, bs, 1e-5)
        plain = lambda: L.ln_projections_plain(x, gam, bet, ws, bs, 1e-5)
        fn_f32 = lambda: L.ln_projections(x, g32, b32, ws, bs32, 1e-5)
        plain_f32 = lambda: L.ln_projections_plain(x, g32, b32, ws, bs32, 1e-5)
        lib = lambda: F.linear(F.layer_norm(x, (c,), gam, bet, 1e-5), wcat, bcat)
        inputs = [x, gam, bet, *ws, *bs]
    return dict(fn=fn, plain=plain, lib=lib, fn_f32=fn_f32, plain_f32=plain_f32, m=m, k=c,
                ns=ns, flops=2.0 * m * c * sum(ns),
                in_bytes=sum(t.numel() * t.element_size() for t in inputs if t is not None),
                label=f"x {shape}, W {[(n, c) for n in ns]}"
                + (" + residual, no LayerNorm" if w_o else ""))


def time_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
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


def device_ms(torch, fn, calls: int = 5):
    """Device ms a call: every kernel, and K3's own (`ln_gemm*`); the
    kernels' names and launches a call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = k3 = 0.0
    names, launches = set(), 0
    for e in prof.key_averages():
        if e.device_time_total <= 0:
            continue
        t = e.device_time_total / calls / 1e3
        total += t
        launches += e.count
        names.add(e.key)
        if e.key.startswith("ln_gemm") or "::ln_gemm" in e.key:
            k3 += t
    return total, k3, sorted(names), launches / calls


def host_us(torch, fn, calls: int = 100) -> float:
    """Host microseconds a call while the card sleeps through all of them."""
    fn()
    torch.cuda.synchronize()
    torch.cuda._sleep(200_000_000)  # ~0.1 s of the card's clock
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    t = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return t


class _Timer:
    """Stands in for the loaded K3 library. Where `times` is set, the C
    entry's call first times the entry on the same arguments, and the bare
    ctypes call (M = 0), while the wrapper still holds every tensor they
    point to (its outputs and its scratch)."""

    def __init__(self, torch, lib):
        self.torch, self.lib, self.times = torch, lib, None

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def mmgt_ln_gemm(self, *args):
        if self.times is not None:
            empty = list(args)
            empty[M_ARG] = 0
            self.times.update(
                c_entry_us=host_us(self.torch, lambda: self.lib.mmgt_ln_gemm(*args)),
                ctypes_us=host_us(self.torch, lambda: self.lib.mmgt_ln_gemm(*empty)))
        return self.lib.mmgt_ln_gemm(*args)


def host_breakdown(torch, _build, fn) -> dict:
    """The host's microseconds a call of `fn` (one K3 call): the whole
    wrapper, its C entry alone and the bare ctypes call (the entry called
    with M = 0), both timed inside one call of `fn`."""
    timer = _Timer(torch, _build.load("ln_proj"))
    _build._LIBS["ln_proj"] = timer
    try:
        out = dict(host_us=host_us(torch, fn))
        timer.times = out
        fn()
    finally:
        _build._LIBS["ln_proj"] = timer.lib
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--root", help="import mmgt_tpu_torch from this directory")
    ap.add_argument("--rows", help="only these rows, comma-separated (default: all)")
    ap.add_argument("--json", help="also write the result here")
    args = ap.parse_args(argv)
    # the named tree's package (by default this one's), whatever was imported
    sys.path.insert(0, args.root or str(Path(__file__).resolve().parents[2]))
    for mod in [k for k in sys.modules if k.split(".")[0] == "mmgt_tpu_torch"]:
        del sys.modules[mod]
    import torch

    from mmgt_tpu_torch.ops import _build
    from mmgt_tpu_torch.ops import fused_ln as L

    if not torch.cuda.is_available():
        raise SystemExit("k3_rows: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for row in ROWS:
        if args.rows and row[0] not in args.rows.split(","):
            continue
        cs = case(torch, L, row, g)
        got = cs["fn"]()
        nbytes = cs["in_bytes"] + sum(o.numel() * o.element_size() for o in got)
        t_ops, t_bytes = cs["flops"] / PEAK_FLOPS, nbytes / PEAK_BYTES
        dev, k3, names, launches = device_ms(torch, cs["fn"])
        try:  # an older tree's plan takes no bias
            plan = L.gemm_plan(cs["m"], cs["k"], cs["ns"], row[4])
        except TypeError:
            plan = L.gemm_plan(cs["m"], cs["k"], cs["ns"])
        out[f"{row[0]} {row[1]}"] = dict(
            shape=cs["label"], ms=time_ms(torch, cs["fn"]), device_ms=dev, k3_device_ms=k3,
            kernels=names, launches=launches, library_ms=time_ms(torch, cs["lib"]),
            f32_ms=time_ms(torch, cs["fn_f32"]), f32_k3_device_ms=device_ms(torch, cs["fn_f32"])[1],
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            plan={k: v for k, v in plan.items() if isinstance(v, (int, str))},
            **host_breakdown(torch, _build, cs["fn"]))
        del cs, got
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    line = json.dumps({"k3_rows": out, "root": args.root or ".", "card": card})
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
