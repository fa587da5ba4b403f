"""The port's side pipelines against mmgt_tpu's, on the CPU at the tiny
widths of `test_torch_pipeline` with the same noised parameters and
inputs: `Pose2ImagePipeline` (a denoiser without audio or motion modules,
fed JAX's latent draw), `Lmks2VideoPipeline` (two guiders summed into the
base pipeline, 2 steps) and `slerp` / `interpolate_latents`.

Tolerances: 2e-3 (relative and absolute) for generated images and frames
(guidance 3.5 over 2-3 steps, as the latents of
`test_pose2vid_slice_matches_jax`), 1e-5 for slerp.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgt_tpu.models.pose_guider import PoseGuider as JPoseGuider
from mmgt_tpu.models.unet3d import DenoisingUNet3D as JUNet3D
from mmgt_tpu.pipelines import interp as JI
from mmgt_tpu.pipelines.lmks2vid import Lmks2VideoPipeline as JLmks
from mmgt_tpu.pipelines.pose2img import Pose2ImagePipeline as JPose2Img
from mmgt_tpu_torch.models.pose_guider import PoseGuider
from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D
from mmgt_tpu_torch.models.unet_ref import ReferenceUNet2D
from mmgt_tpu_torch.models.vae import AutoencoderKL
from mmgt_tpu_torch.pipelines import interp as PI
from mmgt_tpu_torch.pipelines.lmks2vid import Lmks2VideoPipeline
from mmgt_tpu_torch.pipelines.pose2img import Pose2ImagePipeline
from mmgt_tpu_torch.utils.convert import PIPELINE_MAPPERS, load_jax_params, map_pose_guider
from test_torch_pipeline import (
    CHANS,
    F,
    H,
    HEADS,
    VAE_CHANS,
    _inputs,
    _jax_pipeline,
    _port_pipeline,
)
from torch_port_util import close, noise_params, t

TOL = dict(rtol=2e-3, atol=2e-3)
GUIDER = dict(embedding_channels=CHANS[0], block_out_channels=(4, 8, 8, 16))


def _flag_off_unet_params():
    """JAX params of the tiny pipeline whose denoiser has no audio or
    motion modules (noised)."""
    jp = dataclasses.replace(_jax_pipeline(), denoising_unet=JUNet3D(
        block_out_channels=CHANS, heads=HEADS, use_audio_module=False,
        use_motion_module=False))
    shapes = jax.eval_shape(lambda: jp.init_params(jax.random.PRNGKey(0), H, H))
    return jp, noise_params(shapes, seed=11)


def test_flag_off_unet_loads_jax_params_exactly():
    """No audio or motion module is built: the flag-off port UNet takes
    the flag-off JAX tree with no key left over on either side (the
    loader raises otherwise), and none of its keys names such a module."""
    _, params = _flag_off_unet_params()
    unet = DenoisingUNet3D(CHANS, heads=HEADS, use_audio_module=False, use_motion_module=False)
    load_jax_params(unet, params["denoising_unet"], PIPELINE_MAPPERS["denoising_unet"])
    keys = list(unet.state_dict())
    assert not [k for k in keys if "audio_modules" in k or "motion_modules" in k]
    full = DenoisingUNet3D(CHANS, heads=HEADS)
    assert set(keys) < set(full.state_dict())
    assert len(unet.bank_attentions()) == len(full.bank_attentions()) == 16


@torch.no_grad()
def test_pose2img_matches_jax():
    jp, params = _flag_off_unet_params()
    jpipe = JPose2Img(vae=jp.vae, reference_unet=jp.reference_unet,
                      denoising_unet=jp.denoising_unet, pose_guider=jp.pose_guider)
    models = dict(vae=AutoencoderKL(VAE_CHANS), reference_unet=ReferenceUNet2D(CHANS, heads=HEADS),
                  denoising_unet=DenoisingUNet3D(CHANS, heads=HEADS, use_audio_module=False,
                                                 use_motion_module=False),
                  pose_guider=PoseGuider(CHANS[0], (4, 8, 8, 16)))
    for name, m in models.items():
        load_jax_params(m, params[name], PIPELINE_MAPPERS[name]).eval()
    pipe = Pose2ImagePipeline(**models)
    assert pipe.scheduler == type(pipe.scheduler)(beta_schedule="scaled_linear")
    b, steps = 2, 3
    rng = np.random.default_rng(12)
    ref = rng.uniform(-1, 1, (b, H, H, 3)).astype(np.float32)
    pose = rng.uniform(0, 1, (b, H, H, 3)).astype(np.float32)
    clip = rng.standard_normal((b, 1, 768)).astype(np.float32)
    key = jax.random.PRNGKey(13)
    want = jpipe._generate(params, key, jnp.asarray(ref), jnp.asarray(pose), jnp.asarray(clip),
                           jpipe.scheduler.init(steps), 3.5)
    _, nkey = jax.random.split(key)  # _generate's latent draw
    lat0 = jax.random.normal(nkey, (b, H // 8, H // 8, 4), jnp.float32)
    got = pipe(t(ref), t(pose), t(clip), num_inference_steps=steps, guidance_scale=3.5,
               latents=t(lat0))
    assert got.shape == (b, H, H, 3) and got.min() >= 0 and got.max() <= 1
    close(got, want, **TOL, msg="pose2img image")


@torch.no_grad()
def test_lmks2vid_matches_jax():
    jbase = _jax_pipeline()
    jpipe = JLmks(base=jbase, guider_a=JPoseGuider(**GUIDER), guider_b=JPoseGuider(**GUIDER))
    shapes = jax.eval_shape(lambda: jpipe.init_params(jax.random.PRNGKey(0), H, H))
    params = noise_params(shapes, seed=14)
    guiders = {n: load_jax_params(PoseGuider(CHANS[0], (4, 8, 8, 16)), params[n],
                                  map_pose_guider).eval() for n in ("guider_a", "guider_b")}
    pipe = Lmks2VideoPipeline(_port_pipeline(params), **guiders)
    assert set(pipe.models()) == set(params)
    x = _inputs(seed=15)
    lmks_b = np.random.default_rng(16).uniform(0, 1, x["pose_video"].shape).astype(np.float32)
    key = jax.random.PRNGKey(17)
    want = jpipe(params, key, jnp.asarray(x["ref_image"]), jnp.asarray(x["pose_video"]),
                 jnp.asarray(lmks_b), jnp.asarray(x["clip_embed"]),
                 tuple(tuple(map(jnp.asarray, lv)) for lv in x["masks"]),
                 jnp.asarray(x["audio_embeds"]), num_inference_steps=2)
    _, nkey = jax.random.split(key)  # the base _prepare's latent draw
    lat0 = jax.random.normal(nkey, (F, H // 8, H // 8, 4), jnp.float32)
    got = pipe(t(x["ref_image"]), t(x["pose_video"]), t(lmks_b), t(x["clip_embed"]),
               tuple(tuple(map(t, lv)) for lv in x["masks"]), t(x["audio_embeds"]),
               num_inference_steps=2, latents=t(lat0))
    assert got.shape == (1, F, H, H, 3)
    close(got, want, **TOL, msg="lmks2vid frames")


@pytest.mark.parametrize("case", ["parallel", "orthogonal", "interpolate"])
def test_slerp_matches_jax(case):
    """The cases of tests/test_misc.py::test_slerp_interpolation."""
    if case == "parallel":
        a = np.ones((2, 2, 2), np.float32)
        got, want = PI.slerp(t(a), t(3 * a), 0.5), JI.slerp(jnp.asarray(a), 3 * jnp.asarray(a), 0.5)
        close(got, 2.0, rtol=1e-5, atol=0)
    elif case == "orthogonal":
        v0, v1 = np.array([1.0, 0.0], np.float32), np.array([0.0, 1.0], np.float32)
        got, want = PI.slerp(t(v0), t(v1), 0.5), JI.slerp(jnp.asarray(v0), jnp.asarray(v1), 0.5)
        close(got, [0.7071, 0.7071], rtol=0, atol=1e-3)
    else:
        lat = np.random.default_rng(18).standard_normal((3, 2, 2, 4)).astype(np.float32)
        got, want = PI.interpolate_latents(t(lat), 3), JI.interpolate_latents(jnp.asarray(lat), 3)
        assert got.shape == (7, 2, 2, 4)
        close(got[::3], lat, rtol=0, atol=0)
        close(PI.interpolate_latents(t(lat), 1), lat, rtol=0, atol=0)
    close(got, want, rtol=1e-5, atol=1e-5)


# ------------------------------------------------------- the pose2vid CLI
def test_pose2vid_cli_parses_the_reference_arguments(tmp_path):
    from mmgt_tpu_torch.scripts import pose2vid as cli

    args = cli.parse_args(["--ref_image", "r.png", "--pose_video", "p.mp4", "--face_mask",
                           "f.mp4", "--lips_mask", "l.mp4", "--hands_mask", "h.mp4", "--steps",
                           "3", "--cfg", "2.5", "-L", "16", "--weights_dir", "w", "--device",
                           "cpu", "--seed", "7"])
    assert (args.hands_mask, args.steps, args.cfg, args.length, args.weights_dir, args.device,
            args.seed) == ("h.mp4", 3, 2.5, 16, "w", "cpu", 7)
    c = cli.config_from_args(args)
    assert (c.num_inference_steps, c.guidance_scale, c.video_length, c.weights_dir) == (
        3, 2.5, 16, "w")
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"weights_dir": "w3", "num_inference_steps": 5}')
    c = cli.config_from_args(cli.parse_args(["--ref_image", "r", "--pose_video", "p",
                                             "--face_mask", "f", "--lips_mask", "l",
                                             "--config", str(cfg)]))
    assert (c.weights_dir, c.num_inference_steps) == ("w3", 5)


@pytest.mark.parametrize("hands", [False, True])
def test_masks_from_videos_matches_jax(hands):
    from mmgt_tpu.data.conditioning import masks_from_videos as j_masks
    from mmgt_tpu_torch.data.conditioning import masks_from_videos

    rng = np.random.default_rng(19)
    vids = [(rng.uniform(size=(3, 64, 64)) > 0.7).astype(np.float32) for _ in range(3)]
    got = masks_from_videos(t(vids[0]), t(vids[1]), t(vids[2]) if hands else None, base=8)
    want = j_masks(*map(jnp.asarray, vids[:2]), jnp.asarray(vids[2]) if hands else None,
                   base=8)
    for lv, (g, w) in enumerate(zip(got, want)):
        for a, b in zip(g, w):
            assert a.shape == (1, 3, (8 >> lv) ** 2)
            close(a, b, rtol=1e-5, atol=1e-5, msg=f"level {lv}")


@torch.no_grad()
def test_pose2vid_cli_run_on_cpu():
    """`run` on arrays at tiny width: (L, H, W, 3) finite frames in [0, 1],
    L cut to the shortest video."""
    from mmgt_tpu_torch.config import InferenceConfig
    from mmgt_tpu_torch.scripts import pose2vid as cli
    from test_torch_pipeline import _random_port_pipeline

    pipe = _random_port_pipeline()
    rng = np.random.default_rng(20)
    cfg = InferenceConfig(width=H, height=H, video_length=F, num_inference_steps=2)
    ref = rng.uniform(size=(H, H, 3)).astype(np.float32)
    pose = rng.uniform(size=(F + 2, H, H, 3)).astype(np.float32)
    face, lips, hands = ((rng.uniform(size=(n, H, H)) > 0.6).astype(np.float32)
                         for n in (F + 1, F, F + 3))
    frames = cli.run(pipe, ref, pose, face, lips, hands, cfg, seed=3)
    assert frames.shape == (F, H, H, 3) and frames.dtype == np.float32
    assert np.isfinite(frames).all() and frames.min() >= 0 and frames.max() <= 1
