"""The port's Stage-2 samplers against mmgt_tpu's: DPM-Solver++(2M)'s
tables (bit-equal: both build them in float64 numpy and round to float32)
and step, the full DDIM step (eta, clipping, noise), `make_scheduler`, and
the tiny `Pose2VideoPipeline._denoise_chunk` sampling with DPM++ (the
table route) and with eta = 1 DDIM (the `step_carry` route).

Tolerances: the steps 1e-6 (relative and absolute; float32 elementwise
math on both sides), the 3-step denoise 2e-3 as
`test_pose2vid_slice_matches_jax` (guidance 3.5 scales the difference of
two UNet passes). The denoise runs the tiny models of
`test_torch_pipeline` at 128^2 (16^2 latents): at 64^2 the tiny UNet's
level-3 GroupNorm is 1x1 with two values a group, which turns f32
summation-order noise into 4e-2 along the eta = 1 trajectory (which, with
no noise added, does not carry x forward) by the third step, on either
package against the other.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgt_tpu import diffusion as JD
from mmgt_tpu.config import SchedulerConfig as JSchedulerConfig
from mmgt_tpu.diffusion.solver import init_solver_carry as j_init_carry
from mmgt_tpu.diffusion.solver import solver_tables_for as j_tables
from mmgt_tpu.pipelines.context import compute_context_schedule as j_schedule
from mmgt_tpu_torch import diffusion as PD
from mmgt_tpu_torch.config import SchedulerConfig
from mmgt_tpu_torch.diffusion.solver import SolverTables, solver_tables_for
from test_torch_pipeline import F, _jax_pipeline, _port_pipeline
from torch_port_util import close, noise_params, t

STEP_TOL = dict(rtol=1e-6, atol=1e-6)
SIZE = 128
PRED_TYPES = ("epsilon", "sample", "v_prediction")


@pytest.mark.parametrize("steps", [1, 2, 12, 15, 25])
def test_dpm_tables_equal_jax(steps):
    want = JD.DPMSolverPlusPlus2M().init(steps)
    got = PD.DPMSolverPlusPlus2M().init(steps)
    assert got._fields == want._fields
    for name, g, w in zip(got._fields, got, want):
        assert g.dtype == np.asarray(w).dtype, name
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)
    # the table route takes them unchanged
    tables = solver_tables_for(PD.DPMSolverPlusPlus2M(), steps)
    assert isinstance(tables, SolverTables)
    for name, g, w in zip(tables._fields, tables, j_tables(JD.DPMSolverPlusPlus2M(), steps)):
        np.testing.assert_array_equal(g, np.asarray(w), err_msg=name)


def _draw(shape, seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("pred", PRED_TYPES)
def test_dpm_step_carry_matches_jax(pred):
    """Every step of a 15-step run, including the first (alpha_t = 0:
    epsilon's x0 is inf or nan on both sides) and the first-order closing
    step."""
    js, ps = JD.DPMSolverPlusPlus2M(prediction_type=pred), PD.DPMSolverPlusPlus2M(
        prediction_type=pred)
    jst, pst = js.init(15), ps.init(15)
    x, out, carry = _draw((2, 4, 4, 4), seed=1)
    for i in range(15):
        jprev, jx0 = js.step_carry(jst, jnp.asarray(out), i, jnp.asarray(x), jnp.asarray(carry))
        pprev, px0 = ps.step_carry(pst, t(out), i, t(x), t(carry))
        close(px0, jx0, **STEP_TOL, msg=f"x0, step {i}")
        close(pprev, jprev, **STEP_TOL, msg=f"prev, step {i}")
    assert isinstance(ps.init_carry(t(x)), torch.Tensor)
    assert ps.init_carry(t(x)).dtype == torch.float32 and not ps.init_carry(t(x)).any()


@pytest.mark.parametrize("pred", PRED_TYPES)
@pytest.mark.parametrize("with_noise", [False, True])
def test_ddim_step_eta_clip_matches_jax(pred, with_noise):
    kw = dict(prediction_type=pred, eta=1.0, clip_sample=True, clip_sample_range=1.0)
    js, ps = JD.DDIMScheduler(**kw), PD.DDIMScheduler(**kw)
    jst, pst = js.init(10), ps.init(10)
    for name in jst._fields:
        np.testing.assert_array_equal(getattr(pst, name), np.asarray(getattr(jst, name)),
                                      err_msg=name)
    assert pst.sigma[1:-1].min() > 0  # 0 at the closing step (alpha_prev = 1)
    x, out, noise = _draw((2, 4, 4, 4), seed=2)
    for i in range(1, 10):  # step 0 has alpha_t = 0 (x0 inf or nan before clipping)
        jn = jnp.asarray(noise) if with_noise else None
        pn = t(noise) if with_noise else None
        want = js.step(jst, jnp.asarray(out), i, jnp.asarray(x), jn)
        close(ps.step(pst, t(out), i, t(x), pn), want, **STEP_TOL, msg=f"step {i}")
    # step_carry passes no noise, as the JAX package's
    jprev, jaux = js.step_carry(jst, jnp.asarray(out), 3, jnp.asarray(x), ())
    pprev, paux = ps.step_carry(pst, t(out), 3, t(x), ps.init_carry(t(x)))
    assert paux == () == jaux
    close(pprev, jprev, **STEP_TOL)


@pytest.mark.parametrize("solver,clip", [("ddim", False), ("ddim", True), ("dpm++2m", False),
                                         ("dpm", False), ("unipc", False)])
def test_make_scheduler_matches_jax(solver, clip):
    kw = dict(solver=solver, clip_sample=clip, beta_schedule="scaled_linear",
              prediction_type="epsilon")
    if solver == "unipc":
        for make, cfg in ((JD.make_scheduler, JSchedulerConfig(**kw)),
                          (PD.make_scheduler, SchedulerConfig(**kw))):
            with pytest.raises(ValueError, match="unknown solver"):
                make(cfg)
        return
    want = JD.make_scheduler(JSchedulerConfig(**kw))
    got = PD.make_scheduler(SchedulerConfig(**kw))
    assert type(got).__name__ == type(want).__name__
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    tables = solver_tables_for(got, 4)
    assert (tables is None) == (j_tables(want, 4) is None) == clip


# ------------------------------------------------------- the denoise loop
@pytest.fixture(scope="module")
def tiny():
    """The tiny pose2vid slice of test_torch_pipeline with JAX's prepared
    conditioning and initial latents."""
    jp = _jax_pipeline()
    shapes = jax.eval_shape(lambda: jp.init_params(jax.random.PRNGKey(0), SIZE, SIZE))
    params = noise_params(shapes, seed=1)
    pp = _port_pipeline(params)
    rng = np.random.default_rng(6)
    h8 = SIZE // 8
    x = dict(
        ref_image=rng.uniform(-1, 1, (1, SIZE, SIZE, 3)).astype(np.float32),
        pose_video=rng.uniform(0, 1, (1, F, SIZE, SIZE, 3)).astype(np.float32),
        clip_embed=rng.standard_normal((1, 1, 768)).astype(np.float32),
        masks=tuple(tuple((rng.uniform(size=(1, F, (h8 >> lv) ** 2)) > 0.4).astype(np.float32)
                          for _ in range(3)) for lv in range(3)),
        audio_embeds=rng.standard_normal((1, F, 5, 12, 768)).astype(np.float32))
    jmasks = tuple(tuple(map(jnp.asarray, lv)) for lv in x["masks"])
    jcond, jlat = jp._prepare(params, jax.random.PRNGKey(3), jnp.asarray(x["ref_image"]),
                              jnp.asarray(x["pose_video"]), jnp.asarray(x["clip_embed"]),
                              jmasks, jnp.asarray(x["audio_embeds"]))
    with torch.no_grad():
        pcond, _ = pp._prepare(t(x["ref_image"]), t(x["pose_video"]), t(x["clip_embed"]),
                               tuple(tuple(map(t, lv)) for lv in x["masks"]),
                               t(x["audio_embeds"]))
    return jp, params, jcond, jlat, pp, pcond


@pytest.mark.parametrize("sampler", ["dpm++2m", "ddim_eta1"])
@torch.no_grad()
def test_denoise_chunk_samplers_match_jax(tiny, sampler):
    jp0, params, jcond, jlat, pp, pcond = tiny
    steps = 3
    if sampler == "dpm++2m":
        jsched, psched = JD.DPMSolverPlusPlus2M(), PD.DPMSolverPlusPlus2M()
    else:
        jsched, psched = JD.DDIMScheduler(eta=1.0), PD.DDIMScheduler(eta=1.0)
    jp = dataclasses.replace(jp0, scheduler=jsched)
    pp.scheduler = psched
    jstate = j_tables(jsched, steps)
    if sampler == "dpm++2m":
        jaux = j_init_carry(jlat)
    else:
        assert jstate is None
        jstate, jaux = jsched.init(steps), jsched.init_carry(jlat)
    pstate = pp.sampler_state(steps)
    assert isinstance(pstate, SolverTables) == (sampler == "dpm++2m")
    windows = j_schedule(steps, F, 6, 1, 2)
    jlat2, _ = jp._denoise_chunk(params, jlat, jaux, jcond, jstate, jnp.asarray(windows), 3.5,
                                 (1.0, 1.0, 1.0), prediction_type="v_prediction")
    lat = t(jlat)
    plat2, _ = pp._denoise_chunk(lat, pp.init_aux(pstate, lat), pcond, pstate, windows, 3.5,
                                 (1.0, 1.0, 1.0))
    close(plat2, jlat2, rtol=2e-3, atol=2e-3, msg=f"latents after {steps} {sampler} steps")
