"""The pose->video slice end to end: mmgt_tpu_torch's Pose2VideoPipeline
(CPU, f32, plain versions) against mmgt_tpu's, with the same noised
parameters and inputs.

The JAX `_prepare` supplies the initial latents; both sides then run 2
steps of `_denoise_chunk` over 2 overlapping windows with CFG, and decode
the same latents. Tolerance 1e-3 (relative and absolute) for the
conditioning tensors and the frames; 2e-3 for the latents after 2 steps,
where guidance 3.5 scales the (cond - uncond) difference of two UNet
passes.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgt_tpu.diffusion.ddim import DDIMScheduler as JDDIM
from mmgt_tpu.diffusion.solver import init_solver_carry as j_init_carry
from mmgt_tpu.diffusion.solver import solver_tables_for as j_tables
from mmgt_tpu.models.audio_proj import AudioProjModel as JAudioProj
from mmgt_tpu.models.pose_guider import PoseGuider as JPoseGuider
from mmgt_tpu.models.unet3d import DenoisingUNet3D as JUNet3D
from mmgt_tpu.models.unet_ref import ReferenceUNet2D as JUNet2D
from mmgt_tpu.models.vae import AutoencoderKL as JVAE
from mmgt_tpu.pipelines.context import compute_context_schedule as j_schedule
from mmgt_tpu.pipelines.pose2vid import Pose2VideoPipeline as JPipeline
from mmgt_tpu_torch.diffusion.ddim import DDIMScheduler
from mmgt_tpu_torch.diffusion.solver import init_solver_carry, solver_tables_for
from mmgt_tpu_torch.models.audio_proj import AudioProjModel
from mmgt_tpu_torch.models.pose_guider import PoseGuider
from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D
from mmgt_tpu_torch.models.unet_ref import ReferenceUNet2D
from mmgt_tpu_torch.models.vae import AutoencoderKL
from mmgt_tpu_torch.pipelines.context import compute_context_schedule
from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
from mmgt_tpu_torch.utils.convert import PIPELINE_MAPPERS, load_jax_params
from torch_port_util import close, noise_params, t

CHANS = (32, 64, 64, 64)
VAE_CHANS = (32, 32, 64, 64)
HEADS = 8
F, H = 8, 64          # 8 frames, windows of 6 overlapping by 2 -> 2 windows
STEPS = 2
TOL = dict(rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("steps", [2, 3, 25, 30])
def test_ddim_solver_tables_match(steps):
    want = j_tables(JDDIM(), steps)
    got = solver_tables_for(DDIMScheduler(), steps)
    for name, g, w in zip(got._fields, got, want):
        np.testing.assert_allclose(g, np.asarray(w), rtol=1e-6, atol=0, err_msg=name)


@pytest.mark.parametrize("steps", [3, 25])
def test_ddim_init_matches(steps):
    want = JDDIM().init(steps)
    got = DDIMScheduler().init(steps)
    np.testing.assert_array_equal(got.timesteps, np.asarray(want.timesteps))
    np.testing.assert_allclose(got.alpha_prod, np.asarray(want.alpha_prod), rtol=1e-7)
    np.testing.assert_allclose(got.alpha_prod_prev, np.asarray(want.alpha_prod_prev), rtol=1e-7)


@pytest.mark.parametrize("steps,frames,size,overlap", [
    (3, 16, 12, 4), (30, 80, 12, 4), (5, 8, 6, 2), (4, 10, 12, 4)])
def test_context_schedule_matches(steps, frames, size, overlap):
    np.testing.assert_array_equal(
        compute_context_schedule(steps, frames, size, 1, overlap),
        j_schedule(steps, frames, size, 1, overlap))


def _jax_pipeline():
    tiny = dict(block_out_channels=CHANS, heads=HEADS)
    return JPipeline(
        vae=JVAE(block_out_channels=VAE_CHANS), reference_unet=JUNet2D(**tiny),
        denoising_unet=JUNet3D(**tiny),
        pose_guider=JPoseGuider(embedding_channels=CHANS[0], block_out_channels=(4, 8, 8, 16)),
        audio_proj=JAudioProj(intermediate_dim=32), context_size=6, context_overlap=2)


def _port_pipeline(params):
    tiny = dict(block_out_channels=CHANS, heads=HEADS)
    pipe = Pose2VideoPipeline(
        vae=AutoencoderKL(VAE_CHANS), reference_unet=ReferenceUNet2D(**tiny),
        denoising_unet=DenoisingUNet3D(**tiny), pose_guider=PoseGuider(CHANS[0], (4, 8, 8, 16)),
        audio_proj=AudioProjModel(intermediate_dim=32), context_size=6, context_overlap=2)
    for name, model in pipe.models().items():
        load_jax_params(model, params[name], PIPELINE_MAPPERS[name]).eval()
    return pipe


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    h8 = H // 8
    return dict(
        ref_image=rng.uniform(-1, 1, (1, H, H, 3)).astype(np.float32),
        pose_video=rng.uniform(0, 1, (1, F, H, H, 3)).astype(np.float32),
        clip_embed=rng.standard_normal((1, 1, 768)).astype(np.float32),
        masks=tuple(tuple((rng.uniform(size=(1, F, (h8 >> lv) ** 2)) > 0.4).astype(np.float32)
                          for _ in range(3)) for lv in range(3)),
        audio_embeds=rng.standard_normal((1, F, 5, 12, 768)).astype(np.float32),
    )


@torch.no_grad()
def test_pose2vid_slice_matches_jax():
    jp = _jax_pipeline()
    shapes = jax.eval_shape(lambda: jp.init_params(jax.random.PRNGKey(0), H, H))
    params = noise_params(shapes, seed=1)
    pp = _port_pipeline(params)
    assert pp._bank_shapes(H // 8, H // 8) == jp._bank_shapes(H // 8, H // 8)

    x = _inputs()
    jmasks = tuple(tuple(map(jnp.asarray, lv)) for lv in x["masks"])
    jcond, jlat = jp._prepare(params, jax.random.PRNGKey(2), jnp.asarray(x["ref_image"]),
                              jnp.asarray(x["pose_video"]), jnp.asarray(x["clip_embed"]),
                              jmasks, jnp.asarray(x["audio_embeds"]))
    pcond, _ = pp._prepare(t(x["ref_image"]), t(x["pose_video"]), t(x["clip_embed"]),
                           tuple(tuple(map(t, lv)) for lv in x["masks"]), t(x["audio_embeds"]))
    assert len(pcond["banks"]) == len(jcond["banks"]) == 16
    for i, (g, w) in enumerate(zip(pcond["banks"], jcond["banks"])):
        close(g, np.asarray(w)[:1], **TOL, msg=f"bank {i}")
    for key in ("pose_feat", "audio_tokens", "ctx_cfg"):
        close(pcond[key], jcond[key], **TOL, msg=key)

    windows = j_schedule(STEPS, F, 6, 1, 2)
    assert windows.shape[1] == 2
    jtab = j_tables(jp.scheduler, STEPS)
    jlat2, _ = jp._denoise_chunk(params, jlat, j_init_carry(jlat), jcond, jtab,
                                 jnp.asarray(windows), 3.5, (1.0, 1.0, 1.0),
                                 prediction_type="v_prediction")
    lat = t(jlat)
    plat2, _ = pp._denoise_chunk(lat, init_solver_carry(lat), pcond,
                                 solver_tables_for(pp.scheduler, STEPS), windows, 3.5,
                                 (1.0, 1.0, 1.0))
    close(plat2, jlat2, rtol=2e-3, atol=2e-3, msg="latents after 2 steps")

    jframes = jp._decode(params, jlat2)
    pframes = pp._decode(t(jlat2))
    assert pframes.shape == (1, F, H, H, 3)
    close(pframes, jframes, **TOL, msg="frames")


def _random_port_pipeline(**kw):
    tiny = dict(block_out_channels=CHANS, heads=HEADS)
    torch.manual_seed(0)
    pipe = Pose2VideoPipeline(
        vae=AutoencoderKL(VAE_CHANS), reference_unet=ReferenceUNet2D(**tiny),
        denoising_unet=DenoisingUNet3D(**tiny), pose_guider=PoseGuider(CHANS[0], (4, 8, 8, 16)),
        audio_proj=AudioProjModel(intermediate_dim=32), context_size=6, context_overlap=2, **kw)
    pipe.init_params(seed=3, std=0.05)
    return pipe


def _torch_inputs():
    x = _inputs(seed=4)
    x["masks"] = tuple(tuple(map(t, lv)) for lv in x["masks"])
    return {k: (v if k == "masks" else t(v)) for k, v in x.items()}


@torch.no_grad()
def test_window_microbatch_splits_the_same_work():
    """window_microbatch=1 (two UNet calls per step) gives the latents of
    one call over both windows. One step, in float64: at this tiny size the
    1x1 level-3 GroupNorm sees 2 values per group and turns f32
    summation-order noise (~1e-5) into ~1e-2 per step."""
    windows = compute_context_schedule(1, F, 6, 1, 2)
    outs = []
    for mb in (None, 1):
        pipe = _random_port_pipeline(window_microbatch=mb)
        for m in pipe.models().values():
            m.double()
        cond, _ = pipe._prepare(**{k: (v if k == "masks" else v.double())
                                   for k, v in _torch_inputs().items()})
        lat = torch.from_numpy(np.random.default_rng(5).standard_normal((F, 8, 8, 4)).astype(np.float32))
        out, _ = pipe._denoise_chunk(lat, init_solver_carry(lat), cond,
                                     solver_tables_for(pipe.scheduler, 1), windows, 3.5,
                                     (1.0, 1.0, 1.0))
        outs.append(out)
    close(outs[1], outs[0], rtol=1e-5, atol=1e-5)  # the f32 step after the f64 UNet


@torch.no_grad()
def test_pipeline_call_on_cpu_returns_frames():
    """The public entry point, asked for the CPU: (1, F, H, W, 3) frames in
    [0, 1], or uint8, the phase timings, and no kernel launch (CPU tensors
    take the plain versions)."""
    pipe = _random_port_pipeline(profile_phases=True)
    gen = torch.Generator().manual_seed(0)
    frames = pipe(**_torch_inputs(), num_inference_steps=2, generator=gen)
    assert frames.shape == (1, F, H, H, 3) and frames.dtype == torch.float32
    assert torch.isfinite(frames).all() and frames.min() >= 0 and frames.max() <= 1
    assert set(pipe.timings) == {"prepare_s", "denoise_s", "decode_s"}
    assert set(pipe.phase_launches) == {"prepare", "denoise", "decode"}
    assert all(n == 0 for d in pipe.phase_launches.values() for n in d.values())
    pipe.output_uint8 = True
    frames8 = pipe(**_torch_inputs(), num_inference_steps=2,
                   generator=torch.Generator().manual_seed(0))
    assert frames8.dtype == torch.uint8
    assert (frames8.float() - torch.round(frames * 255)).abs().max() <= 1
