"""The port's profiling helpers (`mmgt_tpu_torch/utils/profiling.py`) and
its trace reader (`utils/device_trace.py`) on the CPU: the StepTimer
against mmgt_tpu's on one scripted clock, device_time on the host clock,
the device table, families and report of a hand-written Chrome trace, and
a real trace of a tiny module."""
import json
import time

import pytest
import torch

from mmgt_tpu.utils import profiling as jax_profiling
from mmgt_tpu_torch.utils import device_trace, profiling


def scripted_clock(monkeypatch, ticks):
    it = iter(ticks)
    monkeypatch.setattr(time, "time", lambda: next(it))


def drive(timer):
    """Marks and laps of a short loop: data then step, three times, with a
    window of 2."""
    timer.mark("data")
    for _ in range(3):
        timer.lap("data")
        timer.mark("step")
        timer.lap("step")
        timer.mark("data")
    return timer.means()


def test_step_timer_matches_jax_on_a_scripted_clock(monkeypatch):
    ticks = [0.0, 0.013, 0.015, 0.2417, 0.25, 0.261, 0.262, 0.51, 0.52, 0.5321, 0.54, 0.7777,
             0.78]
    scripted_clock(monkeypatch, ticks)
    want = drive(jax_profiling.StepTimer(window=2))
    scripted_clock(monkeypatch, ticks)
    got = drive(profiling.StepTimer(window=2))
    assert set(got) == set(want) == {"data", "step"}
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-12)
    # the window of 2 keeps the last two data laps: 0.261 - 0.25, 0.5321 - 0.52
    assert got["data"] == pytest.approx((0.011 + 0.0121) / 2, abs=1e-12)


def test_device_time_on_the_cpu_uses_the_host_clock(monkeypatch):
    calls = []
    clock = iter([10.0, 10.5])
    monkeypatch.setattr(time, "perf_counter", lambda: next(clock))
    x = torch.ones(4)
    sec = profiling.device_time(lambda t: calls.append(1) or t * 2, x, iters=5)
    assert len(calls) == 6  # one untimed call, then five timed
    assert sec == pytest.approx(0.1)


def test_device_time_waits_for_the_card_on_the_host_clock(monkeypatch):
    """fn takes and returns CPU tensors but may launch work on a card: with
    a card present the host clock starts and stops after the card is
    done."""
    log = []
    clock = iter([10.0, 10.5])
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: log.append("sync"))
    monkeypatch.setattr(time, "perf_counter", lambda: log.append("clock") or next(clock))
    sec = profiling.device_time(lambda t: log.append("call") or t * 2, torch.ones(4), iters=5)
    assert log == ["call", "sync", "clock", *["call"] * 5, "sync", "clock"]
    assert sec == pytest.approx(0.1)


def write_trace(path):
    """Kernel, memcpy, memset, host-op, runtime and flow events with known
    durations (microseconds)."""
    ev = lambda name, cat, dur: {"ph": "X", "cat": cat, "name": name, "dur": dur,  # noqa: E731
                                 "ts": 0, "pid": 0, "tid": 7}
    events = [
        ev("flash_fwd_kernel<48, 128>", "kernel", 250.0),
        ev("flash_fwd_kernel<48, 128>", "kernel", 150.0),
        ev("gn_resident<16>", "kernel", 80.0),
        ev("ln_gemm_kernel", "kernel", 120.0),
        ev("motion_cluster<160>", "kernel", 60.0),
        ev("void at::native::vectorized_elementwise_kernel<4, at::native::AddFunctor<float>>",
           "kernel", 40.0),
        ev("sm90_xmma_gemm_bf16bf16_bf16f32", "kernel", 30.0),
        ev("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", 25.0),
        ev("Memset (Device)", "gpu_memset", 5.0),
        ev("aten::mm", "cpu_op", 1000.0),
        ev("cudaLaunchKernel", "cuda_runtime", 3.0),
        {"ph": "s", "cat": "ac2g", "name": "ac2g", "id": 1, "ts": 0, "pid": 0, "tid": 7},
    ]
    path.write_text(json.dumps({"schemaVersion": 1, "traceEvents": events}))
    return path


def test_device_op_table_families_and_report_of_a_written_trace(tmp_path):
    path = write_trace(tmp_path / "t.json")
    rows = device_trace.device_op_table(str(path))
    assert rows == [("flash_fwd_kernel<48, 128>", 0.4, 2), ("ln_gemm_kernel", 0.12, 1),
                    ("gn_resident<16>", 0.08, 1), ("motion_cluster<160>", 0.06, 1),
                    ("void at::native::vectorized_elementwise_kernel<4, "
                     "at::native::AddFunctor<float>>", 0.04, 1),
                    ("sm90_xmma_gemm_bf16bf16_bf16f32", 0.03, 1),
                    ("Memcpy HtoD (Pageable -> Device)", 0.025, 1), ("Memset (Device)", 0.005, 1)]
    assert device_trace.device_op_table(str(tmp_path)) == rows  # newest .json of a directory
    fams = device_trace.summarize(rows)
    assert fams == pytest.approx({
        "K1 flash_fwd": 0.4, "K3 and K4's W_o: ln_gemm": 0.12, "K2 gn_resident + gn_stream_*": 0.08,
        "K4 clusters: motion_cluster": 0.06, "elementwise": 0.04,
        "cuBLAS GEMM (Linear, einsum)": 0.03, "copy (memcpy, memset, copy kernels)": 0.03})
    assert device_trace.categorize("bwd_dq_kernel") == "K5 bwd_dsum + bwd_dq + bwd_dkv"
    assert device_trace.categorize("ln_pe_kernel") == "K4 LayerNorm + pe: ln_pe"
    assert device_trace.categorize("cudnn::fprop_implicit_gemm") == "cuDNN convolution"
    assert device_trace.categorize("some_reduce_kernel") == "other"
    rep = device_trace.report(rows, wall_ms=1.0, top=3)
    assert rep["device_busy_ms"] == pytest.approx(0.76)
    assert rep["idle_share"] == pytest.approx(0.24)
    assert [t["kernel"] for t in rep["top"]] == [r[0] for r in rows[:3]]
    assert device_trace.report(rows, wall_ms=0.5)["idle_share"] == 0.0


def test_trace_of_a_tiny_module_writes_a_chrome_trace(tmp_path):
    net = torch.nn.Sequential(torch.nn.Linear(8, 16), torch.nn.GELU(), torch.nn.Linear(16, 4))
    x = torch.randn(3, 8)
    with profiling.trace(str(tmp_path / "tr")) as path:
        with profiling.annotate("tiny_step"):
            net(x)
    data = json.loads(open(path).read())
    names = {e.get("name") for e in data["traceEvents"]}
    assert "tiny_step" in names and "aten::linear" in names
    assert device_trace.device_op_table(path) == []  # no device on the CPU
