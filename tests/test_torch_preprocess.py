"""The port's motion autoencoder, dataset-prep CLIs and weights verifier
against mmgt_tpu's, on the CPU.

Tolerances:
  * `EmbeddingNet`: 1e-5 of the largest |output| (f32 on both sides);
  * `prepare_stage1` (baseline features): every file bitwise, against
    `tools/prepare_stage1.py` run unedited;
  * `prepare_stage2`: the frames and audio embeddings bitwise, against
    `tools/prepare_stage2.py` run unedited; the uint8 pose video and 64^2
    masks, which each package computes in f32 on its own device and
    truncates to uint8, within one grey level (a value on either side of
    an integer after another summation order);
  * `verify_weights`: the verdicts of `tests/test_verify_weights.py`'s CLI
    test ([ok] on a full-size PoseGuider checkpoint, [FAILED] and exit 1
    once a tensor's shape is corrupted), plus the DWPose and separator
    entries.
"""
import importlib.util
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_onnx_exec import _model_io, _node_a  # noqa: E402
from test_onnx_reader import _model, _tensor  # noqa: E402
from torch_port_util import init_noised, one_torch_thread  # noqa: E402,F401

from mmgt_tpu.data import audio as jaudio  # noqa: E402
from mmgt_tpu.models import motion_autoencoder as jma  # noqa: E402
from mmgt_tpu_torch.data.dsp import save_wav  # noqa: E402
from mmgt_tpu_torch.data.pose_init import default_skeleton  # noqa: E402
from mmgt_tpu_torch.models import motion_autoencoder as tma  # noqa: E402
from mmgt_tpu_torch.models.dwpose import RTMPose  # noqa: E402
from mmgt_tpu_torch.models.pose_guider import PoseGuider  # noqa: E402
from mmgt_tpu_torch.scripts import prepare_stage1, prepare_stage2, verify_weights  # noqa: E402
from mmgt_tpu_torch.utils.convert import load_jax_params, map_flax  # noqa: E402
from mmgt_tpu_torch.utils.media import save_video  # noqa: E402

REPO = Path(__file__).resolve().parents[1]
REL_TOL = 1e-5


def _rel(got, want, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, tol = np.abs(got - want).max(), REL_TOL * np.abs(want).max()
    assert err <= tol, (what, err, tol)


# --------------------------------------------------------- EmbeddingNet
@pytest.mark.parametrize("length", [80, 81])
def test_embedding_net_matches_jax(length):
    """80 frames (the stride-2 conv_1 pads (0, 1)) and an odd length ((1, 1))."""
    dim = 402
    jm = jma.EmbeddingNet(length=length, dim=dim)
    x = np.random.default_rng(length).standard_normal((3, length, dim)).astype(np.float32)
    tree = init_noised(jm, jnp.zeros(x.shape), seed=length)
    recon, mu, logvar = jm.apply(tree, x)
    tm = load_jax_params(tma.EmbeddingNet(length=length, dim=dim), tree, map_flax).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x))
        enc = tm.encode(torch.from_numpy(x))
    for g, w, what in zip(got, (recon, mu, logvar), ("recon", "mu", "logvar")):
        _rel(g.numpy(), w, what)
    _rel(enc.numpy(), jm.apply(tree, x, method=jma.EmbeddingNet.encode), "encode")


def test_embedding_net_draws_from_the_generator():
    tm = tma.EmbeddingNet.build("cpu", seed=3)
    x = torch.randn(2, 80, 402, generator=torch.Generator().manual_seed(0))
    recon, mu, logvar = tm(x, generator=torch.Generator().manual_seed(7))
    eps = torch.randn(mu.shape, generator=torch.Generator().manual_seed(7))
    torch.testing.assert_close(recon, tm.decoder(mu + torch.exp(0.5 * logvar) * eps))
    assert torch.equal(tm(x)[0], tm.decoder(mu))
    assert recon.shape == (2, 80, 402) and mu.shape == (2, 32)


# ---------------------------------------------------------------- tools
def _jax_tool(name: str, argv):
    """Run tools/<name>.py's main (unedited) in this process with `argv`."""
    spec = importlib.util.spec_from_file_location(f"jax_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    old = sys.argv
    sys.argv = [name] + list(argv)
    try:
        mod.main()
    finally:
        sys.argv = old


def _tree(root: Path):
    return sorted(p.relative_to(root).as_posix() for p in root.rglob("*") if p.is_file())


def _stage1_src(root: Path) -> Path:
    rng = np.random.default_rng(0)
    (root / "wavs").mkdir(parents=True)
    (root / "keypoints").mkdir()
    t = np.arange(int(7.0 * 16000)) / 16000
    for name, f0 in (("a", 180.0), ("b", 120.0), ("c", 150.0)):
        wav = (0.3 * np.sin(2 * np.pi * f0 * t * (1 + 0.1 * np.sin(t)))
               + 0.01 * rng.standard_normal(t.size))
        save_wav(str(root / "wavs" / f"{name}.wav"), wav.astype(np.float32), 16000)
    for name, frames in (("a", 200), ("b", 130)):  # b: one full 80-frame window
        kp = default_skeleton(512, 512)[None] + rng.normal(0, 5, (frames, 402))
        np.save(root / "keypoints" / f"{name}.npy", kp.astype(np.float32))
    return root  # c has no keypoints: skipped


def test_prepare_stage1_matches_the_jax_tool_bitwise(tmp_path):
    src = _stage1_src(tmp_path / "src")
    _jax_tool("prepare_stage1", ["--src", str(src), "--out", str(tmp_path / "jax")])
    n = prepare_stage1.main(["--src", str(src), "--out", str(tmp_path / "port"),
                             "--device", "cpu"])
    assert n == 0
    files = _tree(tmp_path / "jax")
    assert files == _tree(tmp_path / "port")
    assert len(files) == 2 * 3 and "keypoints/b_s0.npy" in files  # a: 2 slices, b: 1
    for f in files:
        want, got = np.load(tmp_path / "jax" / f), np.load(tmp_path / "port" / f)
        assert got.dtype == want.dtype and got.tobytes() == want.tobytes(), f


def test_prepare_stage1_wavlm_features(tmp_path):
    """With an extractor the wavlm and baseline files are JAX's
    `stage1_condition` of each slice and its last 35 columns."""

    class Stub:
        def extract(self, wav):
            return np.tile(wav[: 80 * 200].reshape(80, 200)[:, :1], (1, 1024)).astype(np.float32)

    src = _stage1_src(tmp_path / "src")
    n = prepare_stage1.run(str(src), str(tmp_path / "out"), Stub())
    assert n == 3
    wav = jaudio.load_wav(str(src / "wavs" / "a.wav"), jaudio.SAMPLE_RATE)
    want = jaudio.stage1_condition(jaudio.slice_audio(wav)[1], Stub(), "wavlm")
    got = np.load(tmp_path / "out" / "wavlm_feats" / "a_s1.npy")
    assert got.tobytes() == want.tobytes()
    base = np.load(tmp_path / "out" / "baseline_feats" / "a_s1.npy")
    assert base.tobytes() == np.ascontiguousarray(want[:, 1024:]).tobytes()


def _stage2_src(root: Path, size: int = 64, frames: int = 8) -> Path:
    rng = np.random.default_rng(1)
    for d in ("videos", "keypoints", "audio_emb", "dwpose", "face", "lips", "hands"):
        (root / d).mkdir(parents=True, exist_ok=True)
    for name in ("a", "b", "c"):
        vid = rng.integers(0, 255, (frames, 80, 96, 3)).astype(np.uint8)
        save_video(vid, str(root / "videos" / f"{name}.mp4"))
    for name in ("a", "b"):  # c: no keypoints, audio or masks -> skipped
        kp = default_skeleton(size, size)[None] + rng.normal(0, 1.5, (frames + 2, 402))
        np.save(root / "keypoints" / f"{name}.npy", kp.astype(np.float32))
        np.save(root / "audio_emb" / f"{name}.npy",
                rng.standard_normal((frames + 2, 3, 8)).astype(np.float32))
        save_video(rng.integers(0, 255, (frames, 64, 64, 3)).astype(np.uint8),
                   str(root / "dwpose" / f"{name}.mp4"))
        for part in ("face", "lips") + (("hands",) if name == "a" else ()):
            m = np.zeros((frames, 64, 64, 3), np.uint8)
            y0, x0 = rng.integers(5, 30, 2)
            m[:, y0:y0 + 20, x0:x0 + 25] = 255
            save_video(m, str(root / part / f"{name}.mp4"))
    return root


@pytest.mark.parametrize("from_keypoints", [True, False])
def test_prepare_stage2_matches_the_jax_tool(tmp_path, from_keypoints):
    src = _stage2_src(tmp_path / "src")
    flag = ["--from_keypoints"] if from_keypoints else []
    _jax_tool("prepare_stage2", ["--src", str(src), "--out", str(tmp_path / "jax"),
                                 "--size", "64"] + flag)
    assert prepare_stage2.main(["--src", str(src), "--out", str(tmp_path / "port"),
                                "--size", "64", "--device", "cpu"] + flag) == 0
    names = [Path(r["record"]).name
             for r in json.loads((tmp_path / "port" / "meta.json").read_text())]
    assert names == [Path(r["record"]).name
                     for r in json.loads((tmp_path / "jax" / "meta.json").read_text())]
    assert names == ["a.npz", "b.npz"]
    for name in names:
        want = np.load(tmp_path / "jax" / "records" / name)
        got = np.load(tmp_path / "port" / "records" / name)
        assert sorted(got.files) == sorted(want.files)
        for k in want.files:
            w, g = want[k], got[k]
            assert g.dtype == w.dtype and g.shape == w.shape, (name, k)
            if k in ("frames", "audio_emb") or not from_keypoints and k == "pose":
                assert g.tobytes() == w.tobytes(), (name, k)
            else:
                diff = np.abs(g.astype(np.int16) - w.astype(np.int16))
                assert diff.max() <= 1, (name, k, diff.max())
        assert got["face_mask"].shape == (8, 8, 8) and got["face_mask"].max() == 255


def test_prepare_stage2_propagates_device_errors(tmp_path, monkeypatch):
    """A clip with unreadable inputs is skipped; an error from the device
    side is not swallowed."""
    src = _stage2_src(tmp_path / "src")

    def boom(*a, **k):
        raise RuntimeError("device fault")

    monkeypatch.setattr(prepare_stage2, "prepare_conditioning_from_keypoints", boom)
    with pytest.raises(RuntimeError, match="device fault"):
        prepare_stage2.run(str(src), str(tmp_path / "out"), 64, True, "cpu")


# --------------------------------------------------------- verify_weights
def _verify(root: Path, *extra):
    return verify_weights.main([str(root), "--device", "cpu", "--json",
                                str(root / "r.json"), *extra])


def test_verify_weights_verdicts(tmp_path, capsys):
    """`tests/test_verify_weights.py`'s CLI test on the port: a full-size
    PoseGuider checkpoint is certified, everything else absent, exit 0;
    a shape-corrupted one fails with exit 1."""
    g = torch.Generator().manual_seed(0)
    sd = {k: torch.randn(v.shape, generator=g) for k, v in PoseGuider().state_dict().items()}
    torch.save(sd, tmp_path / "pose_guider-3.pth")
    assert _verify(tmp_path) == 0
    out = capsys.readouterr().out
    assert "[ok     ] pose_guider" in out and "[absent ] dwpose_yolox" in out
    report = json.loads((tmp_path / "r.json").read_text())
    assert report["pose_guider"]["n_params"] == len(sd)
    assert report["vae"]["status"] == "absent"

    assert _verify(tmp_path, "--forward") == 0
    assert "pose_guider forward: ok ((1, 2, 8, 8, 320),)" in capsys.readouterr().out

    bad = dict(sd)
    bad[next(iter(bad))] = torch.zeros(3, 3)
    torch.save(bad, tmp_path / "pose_guider-4.pth")
    assert _verify(tmp_path) == 1
    assert "[FAILED ] pose_guider" in capsys.readouterr().out


def test_verify_weights_onnx_entries(tmp_path, capsys):
    """RTMPose from an .onnx of the port module's own tensors: ok with
    every key covered; a separator graph with an op the executor lacks:
    FAILED, naming the op."""
    port = RTMPose()
    (tmp_path / "DWPose").mkdir()
    (tmp_path / "DWPose" / "dw-ll_ucoco_384.onnx").write_bytes(_model(
        [_tensor(k, v.numpy()) for k, v in port.state_dict().items()]))
    (tmp_path / "Kim_Vocal_2.onnx").write_bytes(_model_io(
        [], [_node_a("Relu", ["x"], ["h"]), _node_a("STFT", ["h"], ["y"])], ["x"], ["y"]))
    assert _verify(tmp_path) == 1
    out = capsys.readouterr().out
    assert "[ok     ] dwpose_rtmpose: 397 params covered, 0 allowed-missing, 0 ckpt keys unused" \
        in out
    assert "[FAILED ] separator_mdx: NotImplementedError: graph uses unsupported ops: ['STFT']" \
        in out
    (tmp_path / "Kim_Vocal_2.onnx").write_bytes(_model_io(
        [], [_node_a("Relu", ["x"], ["y"])], ["x"], ["y"]))
    assert _verify(tmp_path) == 0
    report = json.loads((tmp_path / "r.json").read_text())
    assert report["separator_mdx"]["ops_used"] == ["Relu"]
