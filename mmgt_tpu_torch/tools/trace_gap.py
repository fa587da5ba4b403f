"""Does `torch.profiler` record every kernel of a window that follows a
long idle gap? On a card, by hand:

    python mmgt_tpu_torch/tools/trace_gap.py [--gap 45] [--json PATH]

Each case runs in a fresh process: 100 bf16 matmuls under a first
profiler session, a gap of `--gap` seconds (2 for the control case), then
the same 100 matmuls under a second session. Per session it prints the
kernels recorded (kineto's device events, and those the profiler's
`key_averages` shows with device time) and, where CPU activity is on, the
first kernel's start and the last one's end relative to a host range
around the matmuls (ms; the profiler's own clock for both). Cases:

  * cuda, cuda_again: CUDA activity only (as the `gpu` tests' launch
    checks);
  * cpu_cuda: CPU and CUDA activity (as `utils/profiling.trace`);
  * control: CUDA only, a 2 s gap;
  * hold_end, hold_start: CUDA only, the second session held open 0.5 s
    after the matmuls (or before them);
  * no_first: CUDA only, no first session (the gap after CUDA's start);
  * busy_gap: CUDA only, one small kernel every 0.1 s through the gap
    (run alone after the others, which run together: the card is idle
    through their gaps).
"""
import argparse
import json
import subprocess
import sys
import time

CASES = ("cuda", "cuda_again", "cpu_cuda", "control", "hold_end", "hold_start", "no_first")


def session(torch, a, b, acts, hold_start=0.0, hold_end=0.0):
    from torch.autograd import DeviceType
    from torch.profiler import profile, record_function

    with profile(activities=acts) as prof:
        time.sleep(hold_start)
        with record_function("matmuls"):
            for _ in range(100):
                a @ b
            torch.cuda.synchronize()
        time.sleep(hold_end)
    raw = [e for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    shown = sum(e.count for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.device_time_total > 0)
    out = dict(kineto=len(raw), shown=shown)
    rng = [e for e in prof.profiler.kineto_results.events() if e.name() == "matmuls"]
    if rng and raw:
        t0, t1 = rng[0].start_ns(), rng[0].start_ns() + rng[0].duration_ns()
        out["first_kernel_ms"] = (min(e.start_ns() for e in raw) - t0) / 1e6
        out["last_kernel_ms"] = (max(e.start_ns() + e.duration_ns() for e in raw) - t1) / 1e6
    return out


def run_case(case: str, gap: float) -> dict:
    import torch
    from torch.profiler import ProfilerActivity

    acts = [ProfilerActivity.CUDA]
    if case == "cpu_cuda":
        acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    gen = torch.Generator(device="cuda").manual_seed(0)
    a = torch.randn(2048, 2048, generator=gen, device="cuda").to(torch.bfloat16)
    b = torch.randn(2048, 2048, generator=gen, device="cuda").to(torch.bfloat16)
    a @ b
    torch.cuda.synchronize()
    out = dict(case=case)
    if case != "no_first":
        out["first"] = session(torch, a, b, acts)
    wait = 2.0 if case == "control" else gap
    t = time.perf_counter()
    while time.perf_counter() - t < wait:
        if case == "busy_gap":
            a[:64, :64] @ b[:64, :64]
        time.sleep(0.1 if case == "busy_gap" else wait)
    out["gap_s"] = round(time.perf_counter() - t, 1)
    out["second"] = session(torch, a, b, acts, hold_start=0.5 if case == "hold_start" else 0.0,
                            hold_end=0.5 if case == "hold_end" else 0.0)
    return out


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--gap", type=float, default=45.0)
    ap.add_argument("--json", help="also write the cases' results here")
    ap.add_argument("--case", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.case:
        print(json.dumps(run_case(args.case, args.gap)), flush=True)
        return

    def start(case):
        return subprocess.Popen([sys.executable, __file__, "--case", case, "--gap", str(args.gap)],
                                stdout=subprocess.PIPE, text=True)

    results = []
    for group in (CASES, ("busy_gap",)):
        procs = [start(c) for c in group]
        for p in procs:
            out, _ = p.communicate()
            line = out.strip().splitlines()[-1] if out.strip() else "{}"
            results.append(json.loads(line))
            print(line, flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump(results, f, indent=1)


if __name__ == "__main__":
    main()
