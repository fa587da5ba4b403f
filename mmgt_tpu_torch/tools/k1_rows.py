"""K1's d <= 160 rows of PERF.md's kernel table, timed on one card.

    python mmgt_tpu_torch/tools/k1_rows.py [--root DIR] [--rows 5,4,...] [--json PATH]

`ROWS` is the one table of K1's d <= 160 rows: the main path's shapes,
which `chip_smoke.py`'s K1 phase also checks against the plain version.
The level-0 bank form with its LSE (5) and the tp = 2 shard of it (5d),
the concatenated forms with the LSE for training (2, 2e) and without it
for pose2img (2b), the image step's level 0 (2c, 2d), the ReferenceNet's
self-attention (4), the level-1 and level-2 banks (5b at d = 80, 5c at
d = 160), and `dot_product_attention`'s f32 route (1b). `case` builds one
row's inputs and its kernel, plain and library calls.

For each row this script prints the wall ms a call (CUDA events around
20 calls after 3 warm-up calls), the device ms a call (torch.profiler
over 5 calls: every kernel of the call, and K1's own), one library call's
ms (`scaled_dot_product_attention` over the concatenated keys, with the
kv_lens mask), the bound (the larger of flops / 989 TFLOP/s and bytes /
3.35 TB/s), the exponential floor (one 2^x a valid score, H Sq
sum(kv_len), at the H100's 16 a clock on each of 132 SMs at the 1.83 GHz
that the 989 TFLOP/s assume: 3.86e12 a second), the error against the
plain version, and the host's time a call: the whole wrapper, its C
entry (the tensor maps and the launch) and the ctypes call alone (the C
entry called with B = 0, which returns before any work), each timed with
the card held busy so that no call waits for it.

`--root DIR` imports `mmgt_tpu_torch` from DIR instead, so that an
unpacked older tree is timed by the same script (it uses only
`flash_attention`, `dot_product_attention`, `attention_plain` and the
library cache `_build._LIBS`, which every tree has); run each tree in a
process of its own and compare within one machine. `--rows` times only
the named rows. It prints one JSON line with the card's name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12
EXP_RATE = 16 * 132 * PEAK_FLOPS / (132 * 4096)  # 2^x a second: 16 a clock an SM
B_ARG = 25  # the batch's place among the C entry's arguments (9 pointers, 16 strides)

# (row, name, batch, q seq, self kv seq, heads, d, bank of q seq keys, kv_lens, lse, f32 route)
ROWS = [
    ("5", "L0 bank + lse", 2, 4096, 4096, 8, 40, True, [4096, 8192], True, False),
    ("2", "L0 concat + lse (training)", 2, 4096, 8192, 8, 40, False, [4096, 8192], True, False),
    ("2b", "pose2img L0 concat, no lse", 2, 4096, 8192, 8, 40, False, [4096, 8192], False,
     False),
    ("2c", "image step L0 concat + lse", 4, 1024, 2048, 8, 40, False, [1024, 2048, 2048, 2048],
     True, False),
    ("2d", "image step ReferenceNet self + lse", 4, 1024, 1024, 8, 40, False, None, True, False),
    ("2e", "tp2 L0 concat + lse, 4 heads", 2, 4096, 8192, 4, 40, False, [4096, 8192], True,
     False),
    ("4", "ReferenceNet L0 self", 1, 4096, 4096, 8, 40, False, None, False, False),
    ("5b", "L1 bank (d = 80)", 2, 1024, 1024, 8, 80, True, [1024, 2048], False, False),
    ("5c", "L2 bank (d = 160) + lse", 2, 256, 256, 8, 160, True, [256, 512], True, False),
    ("5d", "tp2 L0 bank, 4 heads", 2, 4096, 4096, 4, 40, True, [4096, 8192], False, False),
    ("1b", "f32 route (wav2vec2 >= 512 frames)", 1, 600, 600, 12, 64, False, None, False, True),
]


def case(torch, A, row, g) -> dict:
    """One row of ROWS on the card, its inputs drawn from generator `g`:
    fn (the kernel's call), plain (its plain version), lib (one SDPA call),
    the flops, the valid scores, the input tensors and a label."""
    _, name, b, sq, skv, h, d, bank, lens, lse, f32 = row
    dev = g.device
    dt = torch.float32 if f32 else torch.bfloat16
    rnd = lambda *s: torch.randn(*s, generator=g, device=dev).to(dt)
    q, k, v = rnd(b, sq, h, d), rnd(b, skv, h, d), rnd(b, skv, h, d)
    kb, vb = (rnd(1, sq, h, d), rnd(1, sq, h, d)) if bank else (None, None)
    kl = torch.tensor(lens, dtype=torch.int32, device=dev) if lens else None
    if f32:  # bf16 K1 between two casts
        fn = lambda: A.dot_product_attention(q, k, v)
        plain = lambda: A.attention_plain(q, k, v)
    else:
        fn = lambda: A.flash_attention(q, k, v, kl, kb, vb, return_lse=lse)
        plain = lambda: A.attention_plain(q, k, v, kl, kb, vb, return_lse=lse)
    kc = k if kb is None else torch.cat([k, kb.expand(b, -1, -1, -1)], 1)
    vc = v if vb is None else torch.cat([v, vb.expand(b, -1, -1, -1)], 1)
    mask = None
    if kl is not None:
        mask = (torch.arange(kc.shape[1], device=dev)[None, :] < kl[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), kc.transpose(1, 2), vc.transpose(1, 2)
    sdpa = torch.nn.functional.scaled_dot_product_attention
    scores = h * sq * (sum(lens) if lens else b * kc.shape[1])
    return dict(fn=fn, plain=plain, lib=lambda: sdpa(qt, kt, vt, attn_mask=mask),
                flops=4.0 * d * scores, scores=scores, inputs=[q, k, v, kb, vb],
                label=f"q {tuple(q.shape)}, K/V {tuple(kc.shape)}"
                + (f", kv_lens {lens}" if lens else "") + (", lse" if lse else "")
                + (", f32" if f32 else ""))


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
    """Device ms a call: every kernel, and K1's own (`flash_fwd*`)."""
    fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    total = k1 = 0.0
    for e in prof.key_averages():
        t = e.device_time_total / calls / 1e3
        total += t
        if "flash_fwd" in e.key:
            k1 += t
    return total, k1


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


class _Recorder:
    """Stands in for the loaded K1 library and keeps the last C entry's arguments."""

    def __init__(self, lib):
        self.lib, self.args = lib, None

    def __getattr__(self, name):
        return getattr(self.lib, name)

    def mmgt_flash_attn(self, *args):
        self.args = args
        return self.lib.mmgt_flash_attn(*args)


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
    from mmgt_tpu_torch.ops import attention as A

    if not torch.cuda.is_available():
        raise SystemExit("k1_rows: no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    rec = _Recorder(_build.load("flash_attn"))
    _build._LIBS["flash_attn"] = rec
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for row in ROWS:
        if args.rows and row[0] not in args.rows.split(","):
            continue
        cs = case(torch, A, row, g)
        got, want = cs["fn"](), cs["plain"]()
        got, want = (got, want) if isinstance(got, tuple) else ((got,), (want,))
        err = max((a.float() - w.float()).abs().max().item() for a, w in zip(got, want))
        tol = 2 * 2.0 ** -7 * want[0].float().abs().max().item()
        err_lse = (got[1] - want[1]).abs().max().item() if len(got) > 1 else None
        nbytes = sum(t.numel() * t.element_size() for t in [*cs["inputs"], *got] if t is not None)
        t_ops, t_bytes = cs["flops"] / PEAK_FLOPS, nbytes / PEAK_BYTES
        dev, k1 = device_ms(torch, cs["fn"])
        ms, lib_ms = time_ms(torch, cs["fn"]), time_ms(torch, cs["lib"])
        host = host_us(torch, cs["fn"])
        keep = cs["fn"]()  # the recorded call's outputs stay allocated while it is replayed
        entry = rec.args
        empty = list(entry)
        empty[B_ARG] = 0
        out[f"{row[0]} {row[1]}"] = dict(
            shape=cs["label"], ms=ms, device_ms=dev, k1_device_ms=k1, library_ms=lib_ms,
            bound_ms=max(t_ops, t_bytes) * 1e3,
            bound_by="operations" if t_ops >= t_bytes else "bytes",
            exp_floor_ms=cs["scores"] / EXP_RATE * 1e3,
            max_abs_err=err, tol=tol, lse_err=err_lse,
            ok=err <= tol and (err_lse is None or err_lse <= 1e-3), host_us=host,
            c_entry_us=host_us(torch, lambda: rec.lib.mmgt_flash_attn(*entry)),
            ctypes_us=host_us(torch, lambda: rec.lib.mmgt_flash_attn(*empty)))
        del cs, got, want, keep
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    line = json.dumps({"k1_rows": out, "root": args.root or ".", "card": card})
    if args.json:
        with open(args.json, "w") as f:
            f.write(line + "\n")
    print(line)


if __name__ == "__main__":
    main()
