"""The port's tools beside the package, on the CPU: the few-step quality
tool's denoise path against the JAX tool's, the synthetic weights
directory read by both packages' loaders, and the release check end to end
at tiny widths.

  * `fewstep_quality.run_latents` for DDIM-3 and DPM-Solver++(2M)-3 on the
    tiny pipeline pair of tests/test_torch_audio2vid.py against
    `run_latents` of tools/fewstep_quality.py (imported unedited, its
    module FRAMES set here), the same inputs and initial noise: 1e-4
    relative and absolute (`NET`, f32);
  * `synth_weights --tiny`'s directory loaded by the port's and by
    mmgt_tpu's `load_all_weights`: bitwise equal (the JAX trees carried
    into fresh port modules by `load_jax_params`), and equal to what was
    written cast to bf16 (Stage 2) and f32 (SMGA);
  * `release_check --synthetic --tiny --device cpu`, 2 steps at 64^2:
    exit 0, every stage ok, a non-empty mp4.
"""
import importlib.util
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgt_tpu.diffusion.dpm import DPMSolverPlusPlus2M as JDPM
from mmgt_tpu.models.audio_proj import AudioProjModel as JAudioProj
from mmgt_tpu.models.pose_guider import PoseGuider as JPoseGuider
from mmgt_tpu.models.smga import GestureDecoder as JGestureDecoder
from mmgt_tpu.models.unet3d import DenoisingUNet3D as JUNet3D
from mmgt_tpu.models.unet_ref import ReferenceUNet2D as JUNet2D
from mmgt_tpu.models.vae import AutoencoderKL as JVAE
from mmgt_tpu.pipelines.pose2vid import Pose2VideoPipeline as JPipeline
from mmgt_tpu.training.stage1 import SMGA as JSMGA
from mmgt_tpu.utils import weights as JW
from mmgt_tpu_torch.diffusion import DPMSolverPlusPlus2M
from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline, materialize
from mmgt_tpu_torch.scripts.verify_weights import tiny_models
from mmgt_tpu_torch.tools import fewstep_quality as fsq
from mmgt_tpu_torch.tools import release_check, synth_weights
from mmgt_tpu_torch.training.stage1 import SMGA
from mmgt_tpu_torch.utils.convert import ENCODER_MAPPERS, PIPELINE_MAPPERS, load_jax_params
from mmgt_tpu_torch.utils.weights import load_all_weights
from test_torch_audio2vid import NET, SIZE, _pose2vid_pair
from torch_port_util import close, one_torch_thread, t  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
FRAMES = 6


def _jax_tool():
    spec = importlib.util.spec_from_file_location("jax_fewstep_quality",
                                                  REPO / "tools" / "fewstep_quality.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    mod.FRAMES = FRAMES
    return mod


@pytest.fixture(scope="module")
def pipelines():
    return _pose2vid_pair()


@pytest.mark.parametrize("sampler", ["ddim", "dpm++2m"])
def test_fewstep_run_latents_matches_the_jax_tool(pipelines, sampler):
    jp, params, pp = pipelines
    jtool = _jax_tool()
    inputs = fsq.make_inputs(SIZE, FRAMES)
    rng = jax.random.PRNGKey(7)
    j_inputs = (rng, *(jnp.asarray(inputs[k].numpy()) for k in
                       ("ref_image", "pose_video", "clip_embed")),
                tuple(tuple(jnp.asarray(m.numpy()) for m in lv) for lv in inputs["masks"]),
                jnp.asarray(inputs["audio_embeds"].numpy()))
    noise = t(jax.random.normal(jax.random.split(rng)[1], (FRAMES, SIZE // 8, SIZE // 8, 4)))
    j_sched, p_sched = jp.scheduler, pp.scheduler
    if sampler == "dpm++2m":  # one pipeline each, the scheduler swapped as the tools do
        jp.scheduler, pp.scheduler = JDPM(), DPMSolverPlusPlus2M()
    try:
        want = jtool.run_latents(jp, params, 3, j_inputs)
        got = fsq.run_latents(pp, 3, inputs, noise)
    finally:
        jp.scheduler, pp.scheduler = j_sched, p_sched
    assert got.shape == (FRAMES, SIZE // 8, SIZE // 8, 4)
    close(got, want, **NET)


def _jax_tiny(dtype):
    unet = dict(block_out_channels=(16, 32, 32, 32), heads=4, dtype=dtype)
    pipe = JPipeline(
        vae=JVAE(block_out_channels=(16, 16, 32, 32), dtype=dtype),
        reference_unet=JUNet2D(**unet), denoising_unet=JUNet3D(**unet),
        pose_guider=JPoseGuider(embedding_channels=16, block_out_channels=(4, 8, 8, 16),
                                dtype=dtype),
        audio_proj=JAudioProj(intermediate_dim=32, dtype=dtype))
    smga = JSMGA(feature_type="wavlm")
    smga.model = JGestureDecoder(latent_dim=64, ff_size=64, num_layers=1, num_heads=4,
                                 cond_feature_dim=smga.cond_dim)
    return pipe, smga


def _port_tiny():
    shapes = tiny_models()
    with torch.device("meta"):
        stage2 = {n: shapes[n]() for n in Pose2VideoPipeline.MODEL_NAMES}
        smga = SMGA(feature_type="wavlm")
        smga.model = shapes["smga"](smga.cond_dim)
    smga.model.to_empty(device="cpu")
    return Pose2VideoPipeline(**materialize(stage2, torch.device("cpu"), torch.bfloat16)), smga


def test_synth_weights_tiny_read_by_both_loaders(tmp_path):
    info = synth_weights.synth_weights(str(tmp_path), "cpu", seed=4, tiny=True)
    assert info["files"] == [synth_weights.STAGE2_FILE, "sd-vae-ft-mse/diffusion_pytorch_model.bin",
                             "smga.pt"]
    pipe, smga = _port_tiny()
    out = load_all_weights(str(tmp_path), pipe, smga, device="cpu")
    assert out["random_fill"] == [] and out["smga"] is smga
    jpipe, jsmga = _jax_tiny(jnp.bfloat16)
    want = JW.load_all_weights(str(tmp_path), jpipe, jsmga)
    to_f32 = lambda tree: jax.tree_util.tree_map(lambda a: np.asarray(a, np.float32), tree)
    fresh, _ = _port_tiny()
    for name, model in pipe.models().items():
        ref = load_jax_params(fresh.models()[name], to_f32(want["pose2vid"][name]),
                              PIPELINE_MAPPERS[name]).state_dict()
        written = info["expected"][name]
        for k, v in model.state_dict().items():
            assert torch.equal(v, ref[k]), (name, k)
            assert torch.equal(v, written[k].to(torch.bfloat16)), (name, k)
    ref = load_jax_params(_port_tiny()[1].model, to_f32(want["smga"]),
                          ENCODER_MAPPERS["smga"]).state_dict()
    for k, v in smga.model.state_dict().items():
        assert torch.equal(v, ref[k]), k
        assert torch.equal(v, info["expected"]["smga"][k].float()), k


def test_release_check_tiny_on_the_cpu(tmp_path):
    rc = release_check.main(["--synthetic", "--tiny", "--device", "cpu", "--size", "64",
                             "--frames", "8", "--steps", "2", "--out", str(tmp_path)])
    report = json.loads((tmp_path / "release_check.json").read_text())
    assert rc == 0 and report["ok"], report
    assert list(report["stages"]) == ["synth_weights", "verify_weights", "generate"]
    assert all(s["ok"] for s in report["stages"].values())
    gen = report["stages"]["generate"]
    assert gen["frames"] == [8, 64, 64, 3] and gen["mp4_bytes"] > 0
    assert (tmp_path / "release_check.mp4").stat().st_size == gen["mp4_bytes"]
