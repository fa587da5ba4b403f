"""mmgt_tpu_torch stands alone: importing it and every module in it pulls
in no jax, flax, safetensors or mmgt_tpu (checked in a subprocess, since
this test process has imported jax already), `chip_smoke.py` and
`bench_torch.py` import none of them anywhere, and the port's entry points
refuse to run without a card unless the caller asks for the CPU."""
import ast
import os
import subprocess
import sys

import pytest
import torch

from mmgt_tpu_torch.device import resolve_device
from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHECK = r"""
import importlib, pkgutil, sys
import mmgt_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mmgt_tpu_torch.__path__, "mmgt_tpu_torch.")]
for n in names:
    importlib.import_module(n)
bad = sorted(k for k in sys.modules
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "safetensors", "mmgt_tpu"))
print(len(names), bad)
assert not bad, bad
assert len(names) >= 20, names
new = {"mmgt_tpu_torch.config", "mmgt_tpu_torch.data.dsp", "mmgt_tpu_torch.data.audio",
       "mmgt_tpu_torch.data.rasterize", "mmgt_tpu_torch.data.conditioning",
       "mmgt_tpu_torch.data.pose_init", "mmgt_tpu_torch.models.clip_vision",
       "mmgt_tpu_torch.models.wav2vec2", "mmgt_tpu_torch.models.wavlm",
       "mmgt_tpu_torch.models.smga", "mmgt_tpu_torch.ops.image",
       "mmgt_tpu_torch.diffusion.gesture", "mmgt_tpu_torch.training.stage1",
       "mmgt_tpu_torch.pipelines.audio2vid", "mmgt_tpu_torch.utils.media",
       "mmgt_tpu_torch.scripts.audio2vid", "mmgt_tpu_torch.diffusion.dpm",
       "mmgt_tpu_torch.pipelines.pose2img", "mmgt_tpu_torch.pipelines.lmks2vid",
       "mmgt_tpu_torch.pipelines.interp", "mmgt_tpu_torch.utils.weights",
       "mmgt_tpu_torch.scripts.pose2vid", "mmgt_tpu_torch.training.adan",
       "mmgt_tpu_torch.training.stage2_image", "mmgt_tpu_torch.training.loop",
       "mmgt_tpu_torch.utils.metrics", "mmgt_tpu_torch.utils.checkpoint",
       "mmgt_tpu_torch.data.datasets", "mmgt_tpu_torch.data.mmr",
       "mmgt_tpu_torch.scripts.train_stage2_image", "mmgt_tpu_torch.scripts.train_stage2",
       "mmgt_tpu_torch.scripts.train_a2p", "mmgt_tpu_torch.utils.onnx_reader",
       "mmgt_tpu_torch.utils.onnx_exec", "mmgt_tpu_torch.data.separator",
       "mmgt_tpu_torch.models.dwpose", "mmgt_tpu_torch.data.dwpose_infer",
       "mmgt_tpu_torch.models.motion_autoencoder", "mmgt_tpu_torch.scripts.prepare_stage1",
       "mmgt_tpu_torch.scripts.prepare_stage2", "mmgt_tpu_torch.scripts.verify_weights",
       "mmgt_tpu_torch.parallel", "mmgt_tpu_torch.parallel.mesh",
       "mmgt_tpu_torch.parallel.collectives", "mmgt_tpu_torch.parallel.launch",
       "mmgt_tpu_torch.tools.fewstep_quality", "mmgt_tpu_torch.tools.synth_weights",
       "mmgt_tpu_torch.tools.release_check", "mmgt_tpu_torch.tools.mfu_audit",
       "mmgt_tpu_torch.tools.budget_8chip", "mmgt_tpu_torch.utils.profiling",
       "mmgt_tpu_torch.utils.device_trace", "mmgt_tpu_torch.testing"}
assert new <= set(names), sorted(new - set(names))
"""


def test_port_imports_no_jax_flax_or_mmgt_tpu():
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def script_imports(name: str) -> set:
    """The modules of every import statement of a script at the root of the
    repository, inside functions too."""
    tree = ast.parse(open(os.path.join(REPO, name)).read())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    return mods


def test_chip_smoke_imports_no_jax_flax_safetensors_or_mmgt_tpu():
    """Every import statement of chip_smoke.py, inside functions too."""
    mods = script_imports("chip_smoke.py")
    assert "mmgt_tpu_torch" in {m.split(".")[0] for m in mods}
    bad = sorted(m for m in mods
                 if m.split(".")[0] in ("jax", "jaxlib", "flax", "safetensors", "mmgt_tpu"))
    assert not bad, bad


def test_bench_torch_imports_no_jax_flax_safetensors_or_mmgt_tpu():
    """Every import statement of bench_torch.py, inside functions too; it
    does not import bench.py either."""
    mods = script_imports("bench_torch.py")
    assert "mmgt_tpu_torch" in {m.split(".")[0] for m in mods}
    bad = sorted(m for m in mods if m.split(".")[0] in ("jax", "jaxlib", "flax", "safetensors",
                                                        "mmgt_tpu", "bench"))
    assert not bad, bad


def test_build_without_device_and_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Pose2VideoPipeline.build()
    with pytest.raises(RuntimeError, match="CUDA"):
        resolve_device("cuda")


def test_cpu_is_taken_only_when_asked():
    assert resolve_device("cpu") == torch.device("cpu")


def test_trainer_build_without_device_and_without_cuda_raises(monkeypatch):
    from mmgt_tpu_torch.training.stage2 import Stage2Trainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Stage2Trainer.build()


def test_audio2vid_build_without_device_and_without_cuda_raises(monkeypatch):
    from mmgt_tpu_torch.pipelines.audio2vid import Audio2VideoPipeline

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        Audio2VideoPipeline.build()


@pytest.mark.parametrize("entry", ["pose2img", "lmks2vid", "load_all_weights"])
def test_new_entry_points_without_cuda_raise(monkeypatch, entry):
    from mmgt_tpu_torch.pipelines.lmks2vid import Lmks2VideoPipeline
    from mmgt_tpu_torch.pipelines.pose2img import Pose2ImagePipeline
    from mmgt_tpu_torch.utils.weights import load_all_weights

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"pose2img": Pose2ImagePipeline.build, "lmks2vid": Lmks2VideoPipeline.build,
            "load_all_weights": lambda: load_all_weights("absent", None, None)}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


@pytest.mark.parametrize("entry", ["image_trainer", "smga", "train_stage2_image",
                                   "train_stage2", "train_a2p"])
def test_training_entry_points_without_cuda_raise(monkeypatch, entry):
    from mmgt_tpu_torch import config
    from mmgt_tpu_torch.scripts import train_a2p, train_stage2, train_stage2_image
    from mmgt_tpu_torch.training.stage1 import SMGA
    from mmgt_tpu_torch.training.stage2_image import Stage2ImageTrainer

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"image_trainer": Stage2ImageTrainer.build, "smga": SMGA.build,
            "train_stage2_image": lambda: train_stage2_image.build(
                config.Stage2ImageTrainConfig(), tiny=True),
            "train_stage2": lambda: train_stage2.build(config.Stage2TrainConfig()),
            "train_a2p": lambda: train_a2p.build(config.Stage1TrainConfig())}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


@pytest.mark.parametrize("entry", ["yolox", "rtmpose", "dwpose_from_onnx",
                                   "onnx_runner", "separator", "embedding_net",
                                   "prepare_stage1", "prepare_stage2", "verify_weights"])
def test_preprocessing_entry_points_without_cuda_raise(monkeypatch, tmp_path, entry):
    from mmgt_tpu_torch.data.dwpose_infer import DWPoseDetector
    from mmgt_tpu_torch.data.separator import MDXVocalSeparator
    from mmgt_tpu_torch.models.dwpose import RTMPose, YOLOXL
    from mmgt_tpu_torch.models.motion_autoencoder import EmbeddingNet
    from mmgt_tpu_torch.scripts import prepare_stage1, prepare_stage2, verify_weights
    from mmgt_tpu_torch.utils.onnx_exec import OnnxRunner

    graph = tmp_path / "empty.onnx"
    graph.write_bytes(b"\x3a\x00")  # a ModelProto whose graph (field 7) is empty
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"yolox": YOLOXL.build, "rtmpose": RTMPose.build,
            "dwpose_from_onnx": lambda: DWPoseDetector.from_onnx(str(graph), str(graph)),
            "onnx_runner": lambda: OnnxRunner.from_file(str(graph)),
            "separator": lambda: MDXVocalSeparator(str(graph)),
            "embedding_net": EmbeddingNet.build,
            "prepare_stage1": lambda: prepare_stage1.build(None),
            "prepare_stage2": lambda: prepare_stage2.run(str(tmp_path), str(tmp_path / "out")),
            "verify_weights": lambda: verify_weights.main([str(tmp_path)])}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()


@pytest.mark.parametrize("entry", ["fewstep_quality", "synth_weights", "release_check",
                                   "mfu_audit", "budget_8chip"])
def test_tool_entry_points_without_cuda_raise(monkeypatch, tmp_path, entry):
    from mmgt_tpu_torch.tools import (budget_8chip, fewstep_quality, mfu_audit, release_check,
                                      synth_weights)

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {"fewstep_quality": lambda: fewstep_quality.main(["--size", "64", "--frames", "4"]),
            "synth_weights": lambda: synth_weights.main([str(tmp_path / "w"), "--tiny"]),
            "release_check": lambda: release_check.main(
                ["--synthetic", "--tiny", "--out", str(tmp_path / "rc")]),
            "mfu_audit": lambda: mfu_audit.main([]),
            "budget_8chip": lambda: budget_8chip.main(["--tiny", "--devices", "2"])}[entry]
    with pytest.raises(RuntimeError, match="CUDA"):
        call()
