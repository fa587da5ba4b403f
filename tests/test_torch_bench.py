"""bench_torch.py, the port's counterpart of bench.py, on the CPU: its copy
of bench.py's closed-form FLOPs, the audio2vid row at the tiny widths
(every key of its line; its frames bitwise those of a direct call of the
pipeline with the same seed and inputs), and a non-zero exit with no
result line when a row raises, when there is no card, or when the
fixture is absent."""
import importlib.util
import json
import os

import numpy as np
import pytest
import torch

import bench_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the flagship and the fast row (the long, dpm and train rows run on the
# card, in chip_smoke.py's bench phase)
TINY_ARGV = ["--device", "cpu", "--tiny", "--size", "64", "--frames", "8", "--steps", "2",
             "--fast-steps", "1", "--stage1-steps", "5", "--no-long", "--no-dpm", "--no-train"]


def load_bench(monkeypatch, steps: int, frames: int, size: int):
    """A fresh copy of bench.py read under these BENCH_* settings (the
    module named `bench` is left as it is)."""
    for k, v in (("BENCH_STEPS", steps), ("BENCH_FRAMES", frames), ("BENCH_SIZE", size),
                 ("BENCH_MODE", "audio2vid")):
        monkeypatch.setenv(k, str(v))
    spec = importlib.util.spec_from_file_location("bench_closed_form",
                                                  os.path.join(REPO, "bench.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("steps,frames,size", [(25, 80, 512), (15, 16, 256)])
def test_closed_form_flops_equal_bench_py(monkeypatch, steps, frames, size):
    want = load_bench(monkeypatch, steps, frames, size).useful_flops()
    assert bench_torch.useful_flops(steps, frames, size) == want


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread: the tiny nets' many small bf16 ops slow down by
    an order of magnitude when several test processes each run a full
    thread pool on the same cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def tiny_run(one_thread):
    """The tiny audio2vid row once: (its line, its last frames, the
    pipeline it built)."""
    built = []
    build = bench_torch.build_a2v
    mp = pytest.MonkeyPatch()
    mp.setattr(bench_torch, "build_a2v", lambda *a: built.append(build(*a)) or built[-1])
    try:
        args = bench_torch.parse_args(TINY_ARGV)
        line, out = bench_torch.run(args)
    finally:
        mp.undo()
    return args, line, out, built[0]


def test_tiny_audio2vid_line_has_every_key(tiny_run):
    _, line, _, _ = tiny_run
    json.dumps(line)  # the line is JSON
    assert set(line) == {"metric", "value", "unit", "components", "mfu", "setup", "device"}
    assert line["metric"] == "audio2vid_e2e_8f_64px_2steps_tiny_cpu"
    assert line["unit"] == "s" and line["value"] > 0
    comp = line["components"]
    phases = {"stage1_s", "conditioning_s", "audio_clip_s", "stage2_s", "stage2_prepare_s",
              "stage2_denoise_s", "stage2_decode_s"}
    assert phases <= set(comp)
    assert comp["samples_s"] and line["value"] == np.median(comp["samples_s"])
    assert set(comp["phase_launches"]) == {"stage1", "conditioning", "audio_clip", "stage2"}
    assert comp["pose2vid_e2e_s"] == comp["stage2_s"] and comp["peak_gib"] is None
    for suffix in ("_s", "_samples_s", "_first_s", "_peak_gib", "_phases_s"):
        assert "audio2vid_fast1" + suffix in comp, suffix
    assert set(comp["audio2vid_fast1_phases_s"]) == phases
    assert not any(k.startswith(("audio2vid_dpm", "audio2vid_long", "train")) for k in comp)
    assert set(line["setup"]) == {"kernel_build_s", "kernels_cached", "weights_init_s",
                                  "first_call_s"}
    assert line["device"] == {"name": "cpu", "power_limit": None}
    # the closed form alone, and no utilization of the card's peak from a
    # CPU run
    closed = bench_torch.useful_flops(2, 8, 64)
    assert line["mfu"] == {"peak_flops": 989e12,
                           "flops": {"stage2_closed_form": closed["stage2"],
                                     "stage1_closed_form": closed["stage1"]},
                           "stage2_closed_form": None, "stage1_closed_form": None}


def test_tiny_audio2vid_frames_equal_a_direct_call(tiny_run, tmp_path):
    """The bench adds nothing to the numerics: its frames are bitwise a
    direct call's on the same pipeline, seed and inputs."""
    args, _, out, pipe = tiny_run
    ref, kp = bench_torch.portrait(args.size, args.seed)
    wav = bench_torch.synthetic_wav(str(tmp_path / "clip.wav"), args.frames)
    direct = pipe(wav, ref, kp, video_length=args.frames,
                  generator=torch.Generator().manual_seed(args.seed))
    assert out["frames"].shape == (8, 64, 64, 3)
    np.testing.assert_array_equal(out["frames"], direct["frames"])


@pytest.mark.parametrize("case", ["row_raises", "no_card", "no_fixture"])
def test_failures_exit_non_zero_without_a_result(monkeypatch, capsys, tmp_path, case):
    argv = list(TINY_ARGV)
    if case == "row_raises":
        def boom(*a, **k):
            raise RuntimeError("a row failed")
        monkeypatch.setattr(bench_torch, "bench_audio2vid", boom)
    elif case == "no_card":
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        argv = argv[2:]  # no --device: the card
    else:
        argv += ["--mode", "fixture", "--reference", str(tmp_path)]
    assert bench_torch.main(argv) == 1
    out = capsys.readouterr()
    assert '"metric"' not in out.out
    assert {"row_raises": "a row failed", "no_card": "CUDA",
            "no_fixture": "oliver#103842_slice18.wav is absent"}[case] in out.err
