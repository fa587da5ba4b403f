"""mmgt_tpu_torch stands alone: importing it and every module in it pulls
in no jax, flax or mmgt_tpu (checked in a subprocess, since this test
process has imported jax already), and its entry points refuse to run
without a card unless the caller asks for the CPU."""
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
             if k.split(".")[0] in ("jax", "jaxlib", "flax", "mmgt_tpu"))
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
       "mmgt_tpu_torch.scripts.audio2vid"}
assert new <= set(names), sorted(new - set(names))
"""


def test_port_imports_no_jax_flax_or_mmgt_tpu():
    out = subprocess.run([sys.executable, "-c", _CHECK], cwd=REPO, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


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
