"""Where K2's time goes, regime by regime, on one card.

    python -m mmgt_tpu_torch.tools.k2_parts

K2 (csrc/group_norm.cu) at the main path's GroupNorm shapes (bf16, SiLU),
each timed
  * as `group_norm` is called (CUDA events over 20 launches after 10
    warm-up launches, the host's work per call included),
  * as the same 20 launches replayed from a CUDA graph (device time alone),
  * for a resident plan, also with one cluster a row instead of as many
    clusters as the card holds (`max_clusters`, which it prints; with one
    cluster a row no row's loads overlap another row's stores in the same
    CTA), and in the streaming regime (two launches, x read twice) on the
    same rows,
beside the bound (bytes: x read once and y written once, at 3.35 TB/s).
It prints one JSON line with the card's name and power limit.
"""
from __future__ import annotations

import json
import subprocess

import torch

from mmgt_tpu_torch.ops import _build
from mmgt_tpu_torch.ops import norms as N

ITERS = 20
SHAPES = [(48, 4096, 320), (48, 1024, 640), (48, 256, 1280), (48, 64, 1280), (48, 1024, 1280),
          (12, 4096, 320), (48, 4096, 960), (48, 1024, 1920), (8, 512 * 512, 128)]


def event_ms(fn) -> float:
    for _ in range(10):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(ITERS):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def graph_ms(fn) -> float:
    fn()
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    with torch.cuda.stream(stream), torch.cuda.graph(graph, stream=stream):
        for _ in range(ITERS):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / ITERS


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("k2_parts: no CUDA device")
    g = torch.Generator(device="cuda").manual_seed(0)
    out = {}
    for shape in SHAPES:
        n, l, c = shape
        x = torch.randn(*shape, generator=g, device="cuda").to(torch.bfloat16)
        w = torch.randn(c, generator=g, device="cuda").to(torch.bfloat16)
        b = torch.randn(c, generator=g, device="cuda").to(torch.bfloat16)
        plan = N.gn_plan(n, l, c, 32)
        row = {"plan": plan, "bound_ms": 4 * x.numel() / 3.35e12 * 1e3,
               "ms": event_ms(lambda: N.group_norm(x, 32, w, b, 1e-6, "silu")),
               "graph_ms": graph_ms(lambda: N.group_norm(x, 32, w, b, 1e-6, "silu"))}
        if plan["regime"] == "resident":
            row["max_clusters"] = N._max_clusters(_build.load("group_norm"), plan, False)
            stream = N.gn_stream_plan(n, l, c, 32, 2)
            row["graph_ms_one_cluster_a_row"] = graph_ms(
                lambda: N.run_plan(x, 32, w, b, 1e-6, "silu", plan, clusters=n))
            row["graph_ms_streaming"] = graph_ms(
                lambda: N.run_plan(x, 32, w, b, 1e-6, "silu", stream))
        out[str(shape)] = row
        del x
        torch.cuda.empty_cache()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(json.dumps({"k2_parts": out, "card": card}))


if __name__ == "__main__":
    main()
