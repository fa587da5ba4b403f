"""Long clips in the port against mmgt_tpu, the counterparts of
tests/test_long_video.py: the context schedule and the window fusion at
240 frames (30 windows a step, wrap-around windows included), and a tiny
`Audio2VideoPipeline.__call__` on a 9.6 s wav: 3 chained Stage-1 slices
with motion selection over 2 candidates, the seam splines, and 240 frames
through Stage 2 with 120 context windows fused a step.

Tolerances: the schedule is exact; the fusion 1e-5 (f32 sums in another
order); the whole call as `test_audio2vid_call_matches_jax`
(tests/test_torch_audio2vid.py): keypoints 0.05 px, the rasterized pose
video 1e-6, frames 1e-4. Over 3 slices the two Stage-1 runs' f32 roundings
reach ~1.4e-3 px, enough to move a few edge pixels of the rasterized
skeleton (25 of 2.9 M values, in 10 of the 240 frames, with this seed),
and the frames follow them (5e-3). So the port's Stage 1 is held to JAX's
keypoints, and the rest of the port's call (conditioning, encoders, Stage
2, decode) runs from JAX's keypoints and is held to JAX's pose video and
frames. The seam check is JAX's, on the port's own keypoints: the
per-frame L1 step at frames 80 and 160 at most 5x the median step + 1e-3.
The whole call takes ~80 s on the CPU, so it is `slow`, as JAX's is.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgt_tpu.config import InferenceConfig as JConfig
from mmgt_tpu.data.pose_init import default_skeleton as j_default_skeleton
from mmgt_tpu.pipelines import audio2vid as ja2v
from mmgt_tpu.pipelines.context import compute_context_schedule as j_schedule
from mmgt_tpu_torch.config import InferenceConfig
from mmgt_tpu_torch.data import dsp
from mmgt_tpu_torch.pipelines import audio2vid as pa2v
from mmgt_tpu_torch.pipelines.context import compute_context_schedule
from mmgt_tpu_torch.pipelines.pose2vid import window_average
from test_torch_audio2vid import (
    NET,
    SIZE,
    _jax_pose_keys,
    _jax_slice_draws,
    _pose2vid_pair,
    _smga_pair,
)
from torch_port_util import close, one_torch_thread, t  # noqa: F401

F = 240


def test_context_schedule_240_frames_full_coverage():
    """The flagship's windows at F = 240 (12 frames, overlap 4): the JAX
    schedule exactly, 30 windows a step, every frame covered every step,
    each window consecutive mod 240."""
    sched = compute_context_schedule(25, F, 12, 1, 4)
    np.testing.assert_array_equal(sched, j_schedule(25, F, 12, 1, 4))
    assert sched.shape[1] == 30, sched.shape
    for s in range(25):
        assert set(sched[s].reshape(-1).tolist()) == set(range(F))
        for w in sched[s]:
            assert ((np.diff(w) % F) == 1).all()


def test_window_fusion_average_is_exact_at_240():
    """`window_average`, the denoise loop's fusion, equals JAX's segment
    sum over counts and the per-frame mean of every window's prediction at
    F = 240 (a rotated step: wrap-around windows)."""
    ctx = 12
    idx = compute_context_schedule(2, F, ctx, 1, 4)[1]
    flat = idx.reshape(-1)
    pred = np.random.default_rng(0).standard_normal((flat.size, 4, 4, 3)).astype(np.float32)
    got = window_average(torch.from_numpy(pred), torch.from_numpy(flat).long(), F).numpy()

    seg = jax.ops.segment_sum(jnp.asarray(pred), jnp.asarray(flat), num_segments=F)
    cnt = jax.ops.segment_sum(jnp.ones((flat.size,), jnp.float32), jnp.asarray(flat),
                              num_segments=F)
    np.testing.assert_allclose(got, np.asarray(seg / cnt[:, None, None, None]),
                               rtol=1e-5, atol=1e-5)
    total, count = np.zeros((F, 4, 4, 3)), np.zeros(F)
    for i, fr in enumerate(flat):
        total[fr] += pred[i]
        count[fr] += 1
    np.testing.assert_allclose(got, total / count[:, None, None, None], rtol=1e-5, atol=1e-5)


@pytest.mark.slow
def test_audio2vid_240_frames_3_slices_matches_jax(tmp_path):
    """9.6 s of audio -> 3 chained Stage-1 slices, 2 candidates each ->
    seam-splined 240-frame keypoints -> 240 tiny frames (2 Stage-2 steps,
    120 windows of 4 a step), the port against JAX's call with JAX's key
    splits' normals as the port's draws."""
    jsmga, sparams, smga = _smga_pair(17, skeleton_bias=True)
    jp, params, pp = _pose2vid_pair()
    cfg = dict(width=SIZE, height=SIZE, video_length=F, num_inference_steps=2,
               a2p_sampling_steps=2, window_microbatch=None, use_motion_selection=True,
               motion_candidates=2)
    jpipe = ja2v.Audio2VideoPipeline(smga=jsmga, smga_params=sparams, pose2vid=jp,
                                     pose2vid_params=params, config=JConfig(**cfg))
    ppipe = pa2v.Audio2VideoPipeline(smga=smga, pose2vid=pp, config=InferenceConfig(**cfg))
    n = 16000 * 96 // 10  # 9.6 s
    wav = (0.1 * np.sin(np.linspace(0, 8000, n))
           + 0.02 * np.random.default_rng(18).standard_normal(n)).astype(np.float32)
    path = str(tmp_path / "long.wav")
    dsp.save_wav(path, wav, 16000)
    ref = np.random.default_rng(19).uniform(size=(SIZE, SIZE, 3)).astype(np.float32)
    init_kp = j_default_skeleton(SIZE, SIZE)
    key = jax.random.PRNGKey(20)
    want = jpipe(key, path, ref, init_kp, video_length=F)

    _, pose_rng, gen_rng = jax.random.split(key, 3)
    draws = {"pose": [_jax_slice_draws(k, (2, 80, 402), 2) for k in _jax_pose_keys(pose_rng, 3)],
             "latents": t(jax.random.normal(jax.random.split(gen_rng)[1], (F, 8, 8, 4)))}
    own = {}
    generate_pose = ppipe.generate_pose

    def pose_then_jax_keypoints(*a, **kw):
        own["keypoints"] = generate_pose(*a, **kw)
        return np.array(want["keypoints"])

    ppipe.generate_pose = pose_then_jax_keypoints
    got = ppipe(path, ref, init_kp, video_length=F, draws=draws)
    frames, kp = got["frames"], own["keypoints"]
    assert frames.shape == want["frames"].shape == (F, SIZE, SIZE, 3)
    assert kp.shape == (F, 402) and np.isfinite(kp).all() and np.isfinite(frames).all()
    close(kp, want["keypoints"], rtol=0, atol=0.05)
    close(got["pose_video"], want["pose_video"], rtol=0, atol=1e-6)
    close(frames, want["frames"], **NET)

    step_l1 = np.abs(np.diff(kp, axis=0)).mean(axis=1)
    for seam in (80, 160):
        assert step_l1[seam - 1] <= 5.0 * np.median(step_l1) + 1e-3, (
            seam, step_l1[seam - 1], np.median(step_l1))
