"""K4's rows of PERF.md's kernel table, timed on one card.

    python mmgt_tpu_torch/tools/k4_rows.py [--root DIR] [--rows 9,9b,...] [--json PATH]

`ROWS` is the one table of K4's rows: the main path's motion-module shapes
(x (B, F, L, C), 8 heads), which `chip_smoke.py`'s K4 phase also checks
against the plain version: level 0 (9), level 1 (9b), level 3 and the mid
block (9c), a tp = 2 head shard at level 0 (9d: 4 of the 8 heads, q/k/v
(160, 320), W_o (320, 160), no residual and no bias) and level 2 (9e).
`case` builds one row's inputs and its kernel and plain calls, with gamma
and beta in bf16 as the model holds them, and the same calls with them in
f32.

For each row this script prints the wall ms a call (CUDA events around 20
calls after 3 warm-up calls), the device ms a call (torch.profiler over 5
calls) and each kernel's device ms a call by name (the per-head regime's
`ln_pe`, `motion_attn` and K3's `ln_gemm*` for W_o, or the fused regime's
`motion_fused` and `ln_gemm*`; an older tree's casts too), the launches a
call, the bound (the larger of flops / 989
TFLOP/s and bytes / 3.35 TB/s: the four C x inner products and the frame
attention, x, the parameters and the output each moved once), the same
call's wall and device ms with gamma and beta in f32, the error against the
plain version, the host's microseconds a call with the card held busy
so that no call waits for it (the whole call, and each C entry it calls
alone: `host_breakdown`), and the bytes that the plan's attention
kernel pulls from L2 into the SMs a call (`l2_traffic`: the weights and
the rows of h or x, worked out from `attn_plan`; the LayerNorm pre-pass
and W_o not counted).

`--root DIR` imports `mmgt_tpu_torch` from DIR instead, so that an unpacked
older tree is timed by the same script (it uses only `motion_attention`,
`motion_attention_plain` and `sinusoidal_positions`, which every tree
has); run each tree in a process of its own and compare within one
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

# (row, name, x shape, heads, tp): at tp > 1 a rank's head shard of the 8
# heads, q/k/v (C / tp, C), W_o (C, C / tp), no residual and no bias
ROWS = [
    ("9", "L0", (4, 12, 4096, 320), 8, 1),
    ("9b", "L1", (4, 12, 1024, 640), 8, 1),
    ("9c", "L3 / mid", (4, 12, 64, 1280), 8, 1),
    ("9d", "tp2 L0, 4 local heads", (4, 12, 4096, 320), 4, 2),
    ("9e", "L2", (4, 12, 256, 1280), 8, 1),
]


def case(torch, M, row, g) -> dict:
    """One row of ROWS on the card, its inputs drawn from generator `g`:
    fn (the kernel) and plain (its plain version), fn_f32 and plain_f32
    (the same with gamma and beta in f32), the flops, the input bytes (each
    read once) and a label with the shape."""
    _, name, shape, heads, tp = row
    dev = g.device
    b, f, l, c = shape
    inner = c // tp
    rnd = lambda *s, scale=1.0: (torch.randn(*s, generator=g, device=dev) * scale).to(
        torch.bfloat16)
    x = rnd(*shape)
    gam, bet = 1 + rnd(c, scale=0.1), rnd(c, scale=0.1)
    g32, b32 = gam.float(), bet.float()
    pe = M.sinusoidal_positions(32, c, dev)[:f]
    ws = [rnd(inner, c, scale=1 / math.sqrt(c)) for _ in range(3)]
    ws.append(rnd(c, inner, scale=1 / math.sqrt(inner)))
    bo = rnd(c, scale=0.1) if tp == 1 else None
    tail = (bo, heads, 1e-5) if tp == 1 else (None, heads, 1e-5, False)
    args = (x, gam, bet, pe, *ws, *tail)
    args32 = (x, g32, b32, pe, *ws, *tail)
    m = b * f * l
    return dict(
        fn=lambda: M.motion_attention(*args), plain=lambda: M.motion_attention_plain(*args),
        fn_f32=lambda: M.motion_attention(*args32),
        plain_f32=lambda: M.motion_attention_plain(*args32),
        flops=2.0 * m * c * inner * 4 + 4.0 * b * l * f * f * inner,
        in_bytes=sum(t.numel() * t.element_size() for t in (x, gam, bet, pe, *ws, bo)
                     if t is not None),
        label=f"x {shape}, {heads} heads" + (
            "" if tp == 1 else f" (W_q/k/v {(inner, c)}, W_o {(c, inner)}, no residual)"))


def l2_traffic(M, row) -> dict:
    """Bytes a call that the attention kernel of row's plan pulls from L2
    into the SMs, from `attn_plan` (an older tree's too): each block, or
    each cluster, fetches its head's W_q, W_k and W_v once (a cluster
    multicasts them to its CTAs) and each CTA its rows of h (or of x in
    the fused regime, once for all the unit's heads). In GB."""
    _, _, (b, f, l, c), heads, tp = row
    inner = c // tp
    d = inner // heads
    plan = M.attn_plan(f, l, c, heads, inner, b)
    w = 3 * d * c * 2               # one head's W_q, W_k and W_v
    rows = b * f * l * c * 2        # every row of h (or x) once
    if plan["regime"] == "fused":   # a unit: its rows once, its hg heads' weights
        wb, hb = plan["units"] * plan["hg"] * w, plan["groups"] * rows
    elif plan["regime"] == "heads":  # a block: one head's weights, its rows
        wb, hb = heads * b * -(-l // plan["lt"]) * w, heads * rows
    else:                            # a cluster unit: one head's weights, its CTAs' rows
        wb, hb = plan["units"] * w, heads * rows
    return dict(regime=plan["regime"], weights_gb=wb / 1e9, rows_gb=hb / 1e9,
                l2_gb=(wb + hb) / 1e9)


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
    """Device ms a call, each kernel's device ms a call by name, and the
    launches a call."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total, kernels, launches = 0.0, {}, 0
    for e in prof.key_averages():
        if e.device_time_total <= 0:
            continue
        t = e.device_time_total / calls / 1e3
        total += t
        launches += e.count
        kernels[e.key[:120]] = round(t, 4)
    return total, kernels, launches / calls


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


class _EntryTimer:
    """Stands in for a loaded library. Where `times` is set, each C entry
    that the wrapper calls is first timed alone on the same arguments
    (`host_us`), while the wrapper still holds every tensor they point to."""

    def __init__(self, torch, lib, times):
        self.torch, self.lib, self.times = torch, lib, times

    def __getattr__(self, name):
        fn = getattr(self.lib, name)
        if not name.startswith("mmgt_") or name == "mmgt_error_string":
            return fn

        def timed(*args):
            self.times[name] = host_us(self.torch, lambda: fn(*args))
            return fn(*args)
        return timed


def host_breakdown(torch, _build, fn) -> dict:
    """The host's microseconds a call of `fn` (one K4 call), and each C
    entry of K4's and K3's libraries that it calls, timed alone inside one
    call of `fn` (an older tree's entries too)."""
    out = dict(host_us=host_us(torch, fn))
    entries = out["entry_us"] = {}
    libs = {name: _build.load(name) for name in ("motion_attn", "ln_proj")}
    try:
        for name, lib in libs.items():
            _build._LIBS[name] = _EntryTimer(torch, lib, entries)
        fn()
    finally:
        _build._LIBS.update(libs)
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
    from mmgt_tpu_torch.ops import motion_attention as M

    if not torch.cuda.is_available():
        raise SystemExit("k4_rows: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for row in ROWS:
        if args.rows and row[0] not in args.rows.split(","):
            continue
        cs = case(torch, M, row, g)
        got, want = cs["fn"](), cs["plain"]()
        err = (got.float() - want.float()).abs().max().item()
        nbytes = cs["in_bytes"] + got.numel() * got.element_size()
        t_ops, t_bytes = cs["flops"] / PEAK_FLOPS, nbytes / PEAK_BYTES
        del want
        dev, kernels, launches = device_ms(torch, cs["fn"])
        dev32, kernels32, _ = device_ms(torch, cs["fn_f32"])
        out[f"{row[0]} {row[1]}"] = dict(
            shape=cs["label"], ms=time_ms(torch, cs["fn"]), device_ms=dev, kernels=kernels,
            launches=launches, f32_ms=time_ms(torch, cs["fn_f32"]), f32_device_ms=dev32,
            f32_kernels=kernels32, bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes", max_abs_err=err,
            **host_breakdown(torch, _build, cs["fn"]), **l2_traffic(M, row))
        del cs, got
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    line = json.dumps({"k4_rows": out, "root": args.root or ".", "card": card})
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
