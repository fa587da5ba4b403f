"""Device time by kernel from a `torch.profiler` Chrome trace: the
counterpart of `mmgt_tpu/utils/xplane.py`, which reads an xprof
`.xplane.pb`.

`utils/profiling.trace` writes the trace; this module sums the duration of
every device event in it (kernels, memcpy and memset) by name, sorts the
port's kernel families out of the names, and gives the busy time and idle
share of a wall time.

    with profiling.trace("traces") as path:
        step()
    rows = device_op_table(path)          # [(kernel_name, total_ms, count)]
    print(summarize(rows))                # family -> ms
    print(report(rows, wall_ms=250.0))    # busy ms, idle share, top 20
"""
from __future__ import annotations

import glob
import json
import os
from typing import Dict, List, Tuple

# the Chrome trace's categories of device events
DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")

# family -> substrings of the kernel names in it; the first family that
# matches a name takes it
FAMILIES = (
    ("K1 flash_fwd", ("flash_fwd",)),
    ("K5 bwd_dsum + bwd_dq + bwd_dkv", ("bwd_dsum", "bwd_dq", "bwd_dkv")),
    ("K2 gn_resident + gn_stream_*", ("gn_resident", "gn_stream")),
    ("K3 and K4's W_o: ln_gemm", ("ln_gemm",)),
    ("K4 fused: motion_fused", ("motion_fused",)),
    ("K4 clusters: motion_cluster", ("motion_cluster",)),
    ("K4 LayerNorm + pe: ln_pe", ("ln_pe",)),
    ("cuDNN convolution", ("fprop", "conv", "dgrad", "wgrad")),
    ("cuBLAS GEMM (Linear, einsum)", ("nvjet", "gemm", "cutlass", "Kernel2")),
    ("copy (memcpy, memset, copy kernels)", ("Memcpy", "Memset", "copy", "Copy")),
    ("elementwise", ("elementwise",)),
)


def _find_trace(log_dir: str) -> str:
    hits = glob.glob(os.path.join(log_dir, "**", "*.json"), recursive=True)
    if not hits:
        raise FileNotFoundError(f"no *.json trace under {log_dir}")
    return max(hits, key=os.path.getmtime)


def device_op_table(path_or_dir: str) -> List[Tuple[str, float, int]]:
    """[(kernel_name, total_ms, count)] over the device events of a Chrome
    trace (a file, or the newest `*.json` under a directory), slowest
    first."""
    path = path_or_dir if os.path.isfile(path_or_dir) else _find_trace(path_or_dir)
    with open(path) as f:
        data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    agg: Dict[str, List[float]] = {}
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        cur = agg.setdefault(ev["name"], [0.0, 0])
        cur[0] += float(ev.get("dur", 0.0)) / 1e3  # us -> ms
        cur[1] += 1
    rows = [(name, ms, int(n)) for name, (ms, n) in agg.items()]
    rows.sort(key=lambda r: -r[1])
    return rows


def categorize(name: str) -> str:
    for family, pats in FAMILIES:
        if any(p in name for p in pats):
            return family
    return "other"


def summarize(rows: List[Tuple[str, float, int]]) -> Dict[str, float]:
    """family -> ms, largest first."""
    out: Dict[str, float] = {}
    for name, ms, _ in rows:
        fam = categorize(name)
        out[fam] = out.get(fam, 0.0) + ms
    return dict(sorted(out.items(), key=lambda kv: -kv[1]))


def report(rows: List[Tuple[str, float, int]], wall_ms: float, top: int = 20) -> Dict:
    """The device's busy ms (the sum of its events) and its idle share of
    `wall_ms`, the family sums and the `top` slowest kernels."""
    busy = sum(ms for _, ms, _ in rows)
    return {
        "wall_ms_unprofiled": wall_ms, "device_busy_ms": busy,
        "idle_share": max(0.0, 1.0 - busy / wall_ms),
        "families_ms": {k: round(v, 3) for k, v in summarize(rows).items()},
        "top": [{"ms": round(ms, 3), "count": n, "kernel": name[:90]}
                for name, ms, n in rows[:top]],
    }
