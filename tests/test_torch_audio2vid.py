"""The audio2vid slice: mmgt_tpu_torch's DSP features, Stage-1 condition,
rasterizer, conditioning, SMGA decoder, gesture DDIM, Stage-1 sampling and
the whole `Audio2VideoPipeline.__call__` (CPU, f32, plain versions)
against mmgt_tpu's, with the same noised parameters and the same random
numbers (the JAX key splits' normals handed to the port as `draws`).

Tolerances: the DSP copy is exact; the rasterizer's pose map and masks
are exact at these inputs (1e-6 allowed); masks after the blur and
resizes 1e-5; networks and sampled poses 1e-4 relative and absolute (a
few f32 roundings a layer); poses sampled on the unnormalised baseline
features 5e-3 of the normalised [-1, 1] range (inputs in the hundreds);
the whole path's keypoints 0.05 px, frames 1e-4.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgt_tpu.config import InferenceConfig as JConfig
from mmgt_tpu.data import dsp as jdsp
from mmgt_tpu.data.audio import WavLMFeatureExtractor as JWavLMFE
from mmgt_tpu.data.audio import slice_audio as j_slice_audio
from mmgt_tpu.data.audio import stage1_condition as j_stage1_condition
from mmgt_tpu.data.conditioning import mask_leg as j_mask_leg
from mmgt_tpu.data.conditioning import prepare_conditioning_from_keypoints as j_prepare
from mmgt_tpu.data.pose_init import default_skeleton as j_default_skeleton
from mmgt_tpu.data.pose_init import portrait_keypoints as j_portrait_keypoints
from mmgt_tpu.data.rasterize import rasterize_clip as j_rasterize_clip
from mmgt_tpu.models.audio_proj import AudioProjModel as JAudioProj
from mmgt_tpu.models.pose_guider import PoseGuider as JPoseGuider
from mmgt_tpu.models.smga import GestureDecoder as JGestureDecoder
from mmgt_tpu.models.unet3d import DenoisingUNet3D as JUNet3D
from mmgt_tpu.models.unet_ref import ReferenceUNet2D as JUNet2D
from mmgt_tpu.models.vae import AutoencoderKL as JVAE
from mmgt_tpu.models.wavlm import WavLMModel as JWavLM
from mmgt_tpu.pipelines import audio2vid as ja2v
from mmgt_tpu.pipelines.pose2vid import Pose2VideoPipeline as JPose2Video
from mmgt_tpu.training.stage1 import SMGA as JSMGA
from mmgt_tpu_torch.config import InferenceConfig
from mmgt_tpu_torch.data import dsp
from mmgt_tpu_torch.data.audio import WavLMFeatureExtractor, slice_audio, stage1_condition
from mmgt_tpu_torch.data.conditioning import (
    denormalize_keypoints,
    mask_leg,
    normalize_keypoints,
    prepare_conditioning_from_keypoints,
)
from mmgt_tpu_torch.data.pose_init import portrait_keypoints
from mmgt_tpu_torch.data.rasterize import rasterize_clip, rasterize_frame
from mmgt_tpu_torch.models.audio_proj import AudioProjModel
from mmgt_tpu_torch.models.pose_guider import PoseGuider
from mmgt_tpu_torch.models.smga import GestureDecoder
from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D
from mmgt_tpu_torch.models.unet_ref import ReferenceUNet2D
from mmgt_tpu_torch.models.vae import AutoencoderKL
from mmgt_tpu_torch.models.wavlm import WavLMModel
from mmgt_tpu_torch.pipelines import audio2vid as pa2v
from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
from mmgt_tpu_torch.scripts import audio2vid as cli
from mmgt_tpu_torch.training.stage1 import SMGA
from mmgt_tpu_torch.utils.convert import ENCODER_MAPPERS, PIPELINE_MAPPERS, load_jax_params
from torch_port_util import close, init_noised, noise_params, t

NET = dict(rtol=1e-4, atol=1e-4)
SMGA_KW = dict(seq_len=80, latent_dim=64, ff_size=64, num_layers=1, num_heads=4,
               cond_feature_dim=35)
SIZE = 64


def _wav(seconds: float, freq: float = 800.0) -> np.ndarray:
    n = int(seconds * 16000)
    return (0.1 * np.sin(np.linspace(0, freq * seconds, n))
            + 0.02 * np.random.default_rng(0).standard_normal(n)).astype(np.float32)


def _skeleton_frames(n: int, seed: int = 0) -> np.ndarray:
    """n jittered copies of the default skeleton at SIZE^2, scores in [0, 1]
    (some below the 0.3 visibility threshold)."""
    rng = np.random.default_rng(seed)
    base = j_default_skeleton(SIZE, SIZE)
    kp = np.stack([base + rng.normal(0, 1.5, base.shape).astype(np.float32) for _ in range(n)])
    kp.reshape(n, 134, 3)[..., 2] = rng.uniform(0, 1, (n, 134))
    return kp


def _smga_pair(seed: int, skeleton_bias: bool = False):
    """A tiny JAX SMGA (baseline features) with noised parameters and the
    port's copy. `skeleton_bias`: the final layer outputs the default
    skeleton plus a small input-dependent part, so sampled poses stay
    inside a SIZE^2 image (random weights otherwise spread them over the
    whole [-200, 800] range, and the face and lips boxes cover the image:
    the blurred masks are then constant and their min-max normalisation
    returns f32 rounding noise, on both sides)."""
    jsmga = JSMGA(feature_type="baseline")
    jsmga.model = JGestureDecoder(**SMGA_KW)
    params = noise_params(jax.eval_shape(
        lambda: jsmga.init_state(jax.random.PRNGKey(0), batch_size=1).ema_params), seed=seed)
    if skeleton_bias:
        fl = params["params"]["final_layer"]
        fl["kernel"] = fl["kernel"] * 1e-3
        fl["bias"] = np.asarray(normalize_keypoints(j_default_skeleton(SIZE, SIZE)), np.float32)
    port = load_jax_params(GestureDecoder(**SMGA_KW), params, ENCODER_MAPPERS["smga"]).eval()
    return jsmga, params, SMGA(feature_type="baseline", model=port)


def _jax_slice_draws(key, shape, steps):
    """The normals `GestureDiffusionSchedule.ddim_sample` draws from `key`."""
    rng, init_rng = jax.random.split(key)
    noise = [np.asarray(jax.random.normal(k, shape, jnp.float32))
             for k in jax.random.split(rng, steps)]
    return {"x": t(jax.random.normal(init_rng, shape, jnp.float32)), "noise": t(np.stack(noise))}


def _jax_pose_keys(rng, n_slices):
    """generate_pose's per-slice keys (the slice axis padded to a power of 2)."""
    keys = []
    for _ in range(1 << (n_slices - 1).bit_length()):
        rng, r = jax.random.split(rng)
        keys.append(r)
    return keys[:n_slices]


# ----------------------------------------------------------------- host
def test_dsp_baseline_features_match(tmp_path):
    """The copied DSP module: wav round trip and the 35-d Stage-1 features
    of a 3.2 s slice, bit for bit."""
    wav = _wav(3.2)
    path = str(tmp_path / "a.wav")
    dsp.save_wav(path, wav, 16000)
    np.testing.assert_array_equal(dsp.load_wav(path, 16000), jdsp.load_wav(path, 16000))
    got = dsp.baseline_features(wav)
    assert got.shape == (80, 35)
    np.testing.assert_array_equal(got, jdsp.baseline_features(wav))


def test_slice_audio_matches():
    wav = _wav(7.0)
    got, want = slice_audio(wav), j_slice_audio(wav)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("feature_type", ["baseline", "wavlm"])
def test_stage1_condition_matches(feature_type):
    """Baseline features alone, or a (tiny) WavLM's features at 25 fps
    concatenated before them."""
    wav = _wav(3.2)
    jx, px = None, None
    if feature_type == "wavlm":
        kw = dict(hidden_dim=32, num_layers=2, heads=4, ff_dim=64, num_buckets=32,
                  max_distance=40)
        jm = JWavLM(**kw)
        params = init_noised(jm, jnp.zeros((1, 16000)), seed=3)
        jx = JWavLMFE(jm, params)
        px = WavLMFeatureExtractor(load_jax_params(WavLMModel(**kw), params,
                                                   ENCODER_MAPPERS["wavlm"]))
    got = stage1_condition(wav, px, feature_type)
    assert got.shape == ((80, 35) if feature_type == "baseline" else (80, 67))
    close(got, j_stage1_condition(wav, jx, feature_type), **NET)


# ------------------------------------------------------------- rasterizer
def test_rasterize_clip_matches():
    """Pose map (limb ellipses, dimming, joints, hand edges and dots, face
    dots) and the bbox masks over 3 frames; rasterize_frame is one frame."""
    kp = _skeleton_frames(3)
    kp_norm = kp.reshape(3, 134, 3).copy()
    kp_norm[..., :2] /= SIZE
    got = rasterize_clip(t(kp_norm), SIZE, SIZE)
    want = j_rasterize_clip(jnp.asarray(kp_norm), SIZE, SIZE)
    assert got["pose"].shape == (3, SIZE, SIZE, 3) and got["pose"].max() > 0
    for name in ("pose", "hands_mask", "lips_mask", "face_mask"):
        close(got[name], want[name], rtol=0, atol=1e-6, msg=name)
    one = rasterize_frame(t(kp_norm[1]), SIZE, SIZE)
    close(one["pose"], got["pose"][1], rtol=0, atol=0)


def test_prepare_conditioning_matches():
    """Keypoints -> pose video, the blurred min-max-normalised 64^2 masks
    (here 8^2, height / 8) and their 3-level pyramids."""
    kp = _skeleton_frames(2, seed=1)
    got = prepare_conditioning_from_keypoints(t(kp), SIZE, SIZE)
    want = j_prepare(jnp.asarray(kp), SIZE, SIZE)
    close(got["pose_video"], want["pose_video"], rtol=0, atol=1e-6)
    assert len(got["masks"]) == 3
    for lv in range(3):
        for j in range(3):
            assert got["masks"][lv][j].shape == (1, 2, (SIZE // 8 >> lv) ** 2)
            close(got["masks"][lv][j], want["masks"][lv][j], rtol=0, atol=1e-5,
                  msg=f"level {lv} mask {j}")
    for name in want["mask_videos"]:
        close(got["mask_videos"][name], want["mask_videos"][name], rtol=0, atol=0)


def test_prepare_cond_chunked_matches_one_pass():
    """Rasterizing 10 frames 4 at a time (the last chunk short) and joining
    the chunks gives the one-pass conditioning exactly: every step is per
    frame."""
    kp = torch.from_numpy(_skeleton_frames(10, seed=3))
    pipe = pa2v.Audio2VideoPipeline(smga=None, pose2vid=None,
                                    config=InferenceConfig(width=SIZE, height=SIZE),
                                    raster_chunk=4)
    got = pipe._prepare_cond_chunked(kp)
    want = prepare_conditioning_from_keypoints(kp, SIZE, SIZE)
    close(got["pose_video"], want["pose_video"], rtol=0, atol=0)
    for lv in range(3):
        for j in range(3):
            close(got["masks"][lv][j], want["masks"][lv][j], rtol=0, atol=0)
    for name in want["mask_videos"]:
        close(got["mask_videos"][name], want["mask_videos"][name], rtol=0, atol=0)


def test_keypoint_helpers_match():
    kp = _skeleton_frames(2, seed=2)
    np.testing.assert_array_equal(mask_leg(t(kp)).numpy(), np.asarray(j_mask_leg(jnp.asarray(kp))))
    close(denormalize_keypoints(normalize_keypoints(kp)), kp, rtol=1e-6, atol=1e-4)
    np.testing.assert_array_equal(portrait_keypoints(None, SIZE, SIZE),
                                  j_portrait_keypoints(None, SIZE, SIZE))


# ----------------------------------------------------------------- Stage 1
def test_guided_forward_matches():
    jsmga, params, smga = _smga_pair(4)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 80, 402)).astype(np.float32)
    cf = rng.standard_normal((2, 402)).astype(np.float32)
    cond = rng.standard_normal((2, 80, 35)).astype(np.float32)
    tt = np.array([5, 700], np.int32)
    want = jsmga.model.apply(params, jnp.asarray(x), jnp.asarray(cf), jnp.asarray(cond),
                             jnp.asarray(tt), 1.7, method=JGestureDecoder.guided_forward)
    with torch.no_grad():
        got = smga.model.guided_forward(t(x), t(cf), t(cond), torch.from_numpy(tt).long(), 1.7)
    close(got, want, **NET)


def test_ddim_sample_with_jax_draws():
    """Four DDIM(eta = 1) steps of the gesture sampler: guidance clipped
    near the end, x0 clipped to [-1, 1], the last step returning x0."""
    jsmga, params, smga = _smga_pair(6)
    rng = np.random.default_rng(7)
    cf = rng.standard_normal((2, 402)).astype(np.float32)
    cond = rng.standard_normal((2, 80, 35)).astype(np.float32)
    key = jax.random.PRNGKey(8)
    want = jsmga.sample(params, key, jnp.asarray(cf), jnp.asarray(cond), 4)
    got = smga.sample(t(cf), t(cond), 4, draws=_jax_slice_draws(key, (2, 80, 402), 4))
    close(got, want, **NET)


@pytest.mark.parametrize("n_cand", [1, 3])
def test_generate_pose_matches(n_cand):
    """Two slices of a 4 s wav, chained by the last frame; with 3
    candidates the second slice keeps the best continuation (chosen by
    `candidate_scores` on each side)."""
    jsmga, params, smga = _smga_pair(9)
    cfg = dict(a2p_sampling_steps=2, use_motion_selection=n_cand > 1, motion_candidates=n_cand)
    jpipe = ja2v.Audio2VideoPipeline(smga=jsmga, smga_params=params, pose2vid=None,
                                     pose2vid_params=None, config=JConfig(**cfg))
    ppipe = pa2v.Audio2VideoPipeline(smga=smga, pose2vid=None, config=InferenceConfig(**cfg))
    wav = _wav(4.0)
    init_kp = j_portrait_keypoints(None, 512, 512)
    rng = jax.random.PRNGKey(10)
    want = jpipe.generate_pose(rng, wav, init_kp)
    draws = [_jax_slice_draws(k, (n_cand, 80, 402), 2) for k in _jax_pose_keys(rng, 2)]
    got = ppipe.generate_pose(wav, init_kp, draws=draws)
    assert got.shape == want.shape == (160, 402)
    # the baseline features (MFCCs in dB, magnitudes in the hundreds) feed
    # the noised decoder: its f32 roundings reach ~2e-3 of the [-1, 1] range
    close(normalize_keypoints(got), normalize_keypoints(want), rtol=0, atol=5e-3)


def test_candidate_scores_match():
    rng = np.random.default_rng(11)
    for _ in range(4):
        prev = rng.normal(0, 0.3, (80, 402)).astype(np.float32)
        cands = rng.normal(0, 0.3, (4, 80, 402)).astype(np.float32)
        got = pa2v.candidate_scores(t(cands), t(prev[-6:]))
        close(got, ja2v.candidate_scores(jnp.asarray(cands), jnp.asarray(prev[-6:])),
              rtol=1e-5, atol=1e-4)
        best = pa2v.find_best_slice(list(cands), prev)
        np.testing.assert_array_equal(best, ja2v.find_best_slice(list(cands), prev))
        np.testing.assert_array_equal(cands[int(torch.argmin(got))], best)


def test_smooth_seams_matches():
    seq = np.random.default_rng(12).normal(0, 0.2, (240, 402)).astype(np.float32)
    seq[80:] += 1.0
    seq[160:] -= 2.0
    got = pa2v.smooth_seams(seq)
    np.testing.assert_array_equal(got, ja2v.smooth_seams(seq))
    assert np.abs(np.diff(got[:, 0])).max() < np.abs(np.diff(seq[:, 0])).max()


# ------------------------------------------------------------ whole path
def _pose2vid_pair():
    """The tiny Stage-2 pipeline of tests/test_audio2vid.py's end-to-end
    test, with noised parameters, and the port's copy."""
    tiny = dict(block_out_channels=(16, 32, 32, 32), heads=4)
    jp = JPose2Video(
        vae=JVAE(block_out_channels=(16, 16, 32, 32)), reference_unet=JUNet2D(**tiny),
        denoising_unet=JUNet3D(**tiny),
        pose_guider=JPoseGuider(embedding_channels=16, block_out_channels=(4, 8, 8, 16)),
        audio_proj=JAudioProj(intermediate_dim=32), context_size=4, context_overlap=2)
    params = noise_params(jax.eval_shape(
        lambda: jp.init_params(jax.random.PRNGKey(0), SIZE, SIZE)), seed=13)
    pp = Pose2VideoPipeline(
        vae=AutoencoderKL((16, 16, 32, 32)), reference_unet=ReferenceUNet2D(**tiny),
        denoising_unet=DenoisingUNet3D(**tiny), pose_guider=PoseGuider(16, (4, 8, 8, 16)),
        audio_proj=AudioProjModel(intermediate_dim=32), context_size=4, context_overlap=2)
    for name, model in pp.models().items():
        load_jax_params(model, params[name], PIPELINE_MAPPERS[name]).eval()
    return jp, params, pp


def test_audio2vid_call_matches_jax(tmp_path):
    """`Audio2VideoPipeline.__call__` end to end at 64^2, 6 frames, 2
    Stage-2 steps and 3 Stage-1 steps (no CLIP, wav2vec2 or WavLM: zero
    embeddings and baseline features, as the JAX end-to-end test): the
    keypoints, the rasterized pose video and the frames, with the JAX key
    splits' normals as the port's draws."""
    jsmga, sparams, smga = _smga_pair(14, skeleton_bias=True)
    jp, params, pp = _pose2vid_pair()
    cfg = dict(width=SIZE, height=SIZE, video_length=6, num_inference_steps=2,
               a2p_sampling_steps=3, window_microbatch=None)
    jpipe = ja2v.Audio2VideoPipeline(smga=jsmga, smga_params=sparams, pose2vid=jp,
                                     pose2vid_params=params, config=JConfig(**cfg))
    ppipe = pa2v.Audio2VideoPipeline(smga=smga, pose2vid=pp, config=InferenceConfig(**cfg))
    path = str(tmp_path / "a.wav")
    dsp.save_wav(path, _wav(1.0), 16000)
    ref = np.random.default_rng(15).uniform(size=(SIZE, SIZE, 3)).astype(np.float32)
    init_kp = j_default_skeleton(SIZE, SIZE)
    key = jax.random.PRNGKey(16)
    want = jpipe(key, path, ref, init_kp)

    _, pose_rng, gen_rng = jax.random.split(key, 3)
    draws = {"pose": [_jax_slice_draws(k, (1, 80, 402), 3) for k in _jax_pose_keys(pose_rng, 1)],
             "latents": t(jax.random.normal(jax.random.split(gen_rng)[1], (6, 8, 8, 4)))}
    got = ppipe(path, ref, init_kp, draws=draws)
    assert got["frames"].shape == want["frames"].shape == (6, SIZE, SIZE, 3)
    assert set(ppipe.timings) == {"stage1_s", "conditioning_s", "audio_clip_s", "stage2_s"}
    assert all(n == 0 for ph in ppipe.phase_launches.values() for n in ph.values())
    close(got["keypoints"], want["keypoints"], rtol=0, atol=0.05)
    close(got["pose_video"], want["pose_video"], rtol=0, atol=1e-6)
    close(got["frames"], want["frames"], **NET)


def test_cli_parses_the_reference_arguments(tmp_path):
    """The reference CLI's arguments, --weights_dir and --solver included;
    a weights directory named by the config or the flag reaches the
    config (`build` then loads it), and --solver dpm++2m gives Stage 2
    DPM-Solver++(2M)."""
    from mmgt_tpu_torch.diffusion import DPMSolverPlusPlus2M, make_scheduler

    args = cli.parse_args(["--ref_image", "a.png", "--audio", "a.wav", "--steps", "3", "-W",
                           "256", "-L", "16", "--use_motion_selection", "--device", "cpu",
                           "--solver", "dpm++2m", "--weights_dir", "w2"])
    assert (args.steps, args.width, args.length, args.use_motion_selection, args.device,
            args.solver, args.weights_dir) == (3, 256, 16, True, "cpu", "dpm++2m", "w2")
    c = cli.config_from_args(args)
    assert (c.num_inference_steps, c.width, c.video_length, c.weights_dir) == (3, 256, 16, "w2")
    assert isinstance(make_scheduler(c.scheduler), DPMSolverPlusPlus2M)
    cfg = tmp_path / "cfg.json"
    cfg.write_text('{"weights_dir": "w"}')
    c = cli.config_from_args(cli.parse_args(["--ref_image", "a.png", "--audio", "a.wav",
                                             "--config", str(cfg)]))
    assert c.weights_dir == "w" and c.scheduler.solver == "ddim"
    with pytest.raises(SystemExit):
        cli.parse_args(["--ref_image", "a.png", "--audio", "a.wav", "--solver", "unipc"])
