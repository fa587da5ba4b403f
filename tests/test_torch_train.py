"""The Stage-2 training slice: mmgt_tpu_torch (CPU, f32, plain versions)
against mmgt_tpu, with the same noised parameters, inputs and draws.

Tolerances, each with its reason:
  * schedule tables and weights: 1e-6 relative (both f64 host math cast to
    f32, or one f32 product);
  * UNet and ReferenceNet outputs: 1e-3 (network depth compounds f32
    summation-order differences, as tests/test_torch_modules.py);
  * remat on/off: 1e-6 (the same ops, recomputed);
  * the whole train step: loss 1e-5 relative; every trainable gradient
    rtol 1e-3 with atol 1e-4 x the largest |g| over all trainable tensors
    (f32 through two UNets and a backward pass; some gradients are zero up
    to rounding on both sides, so a per-tensor scale would compare noise);
    parameters after the AdamW step atol 5 % of the learning rate (one
    step moves a weight by about lr), except where the gradient is zero
    within its own tolerance: AdamW's first step there is g / (|g| + eps),
    about sign(g), which rounding decides, so those weights are held to
    2.05 lr.
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from flax import traverse_util
from jax.flatten_util import ravel_pytree

from mmgt_tpu.diffusion.ddim import DDIMScheduler as JDDIM
from mmgt_tpu.diffusion.losses import min_snr_weight as j_min_snr_weight
from mmgt_tpu.models.unet3d import DenoisingUNet3D as JUNet3D
from mmgt_tpu.models.unet_ref import ReferenceUNet2D as JUNet2D
from mmgt_tpu.training.stage2 import Stage2Trainer as JTrainer
from mmgt_tpu.training.stage2 import partition_params as j_partition
from mmgt_tpu_torch.diffusion.ddim import DDIMScheduler
from mmgt_tpu_torch.diffusion.losses import min_snr_weight
from mmgt_tpu_torch.models.audio_proj import AudioProjModel
from mmgt_tpu_torch.models.pose_guider import PoseGuider
from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D
from mmgt_tpu_torch.models.unet_ref import ReferenceUNet2D
from mmgt_tpu_torch.models.vae import AutoencoderKL
from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
from mmgt_tpu_torch.training.stage2 import Stage2Trainer, partition_params
from mmgt_tpu_torch.utils.convert import PIPELINE_MAPPERS, from_flax_tensor, load_jax_params, map_unet3d
from test_training import _tiny_pipeline
from torch_port_util import close, init_noised, noise_params, t

TINY = dict(block_out_channels=(16, 32, 32, 32), heads=4)
B, F, H = 2, 2, 64
RATIOS = dict(uncond_img_ratio=0.5, uncond_audio_ratio=0.5)
NET_TOL = dict(rtol=1e-3, atol=1e-3)


# ------------------------------------------------------------- diffusion
def test_snr_add_noise_velocity_and_min_snr_weight():
    js, ps = JDDIM(), DDIMScheduler()
    np.testing.assert_allclose(ps.tables.snr, np.asarray(js.tables.snr), rtol=1e-6)
    rng = np.random.default_rng(0)
    x0, noise = rng.standard_normal((2, 3, 4, 4, 4)), rng.standard_normal((2, 3, 4, 4, 4))
    x0, noise = x0.astype(np.float32), noise.astype(np.float32)
    tt = np.array([0, 999], np.int32)
    for name in ("add_noise", "get_velocity"):
        want = getattr(js, name)(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(tt)[:, None])
        got = getattr(ps, name)(t(x0), t(noise), torch.from_numpy(tt))
        close(got, want, rtol=1e-6, atol=1e-6, msg=name)
    ts = np.array([0, 1, 50, 400, 998, 999], np.int32)
    for kind in ("v_prediction", "epsilon"):
        want = j_min_snr_weight(js.tables, jnp.asarray(ts), 5.0, kind)
        got = min_snr_weight(ps.tables, torch.from_numpy(ts), 5.0, kind)
        close(got, want, rtol=1e-6, atol=0, msg=kind)


# ------------------------------------------------------------- the slice
def _port_pipeline(params=None, remat=False):
    torch.manual_seed(0)
    pipe = Pose2VideoPipeline(
        vae=AutoencoderKL((16, 16, 32, 32)), reference_unet=ReferenceUNet2D(**TINY),
        denoising_unet=DenoisingUNet3D(**TINY, remat=remat),
        pose_guider=PoseGuider(16, (4, 8, 8, 16)), audio_proj=AudioProjModel(intermediate_dim=32),
        context_size=4)
    if params is None:
        pipe.init_params(0, std=0.05)
    else:
        for name, model in pipe.models().items():
            load_jax_params(model, params[name], PIPELINE_MAPPERS[name]).eval()
    return pipe


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    h8 = H // 8
    u = lambda lo, *s: rng.uniform(lo, 1, s).astype(np.float32)
    return {
        "pixel_values": u(-1, B, F, H, H, 3),
        "ref_image": u(-1, B, H, H, 3),
        "clip_embed": rng.standard_normal((B, 1, 768)).astype(np.float32),
        "audio_embeds": rng.standard_normal((B, F, 5, 12, 768)).astype(np.float32),
        "pose_video": u(0, B, F, H, H, 3),
        "masks": [tuple((rng.uniform(size=(B, F, (h8 >> lv) ** 2)) > 0.4).astype(np.float32)
                        for _ in range(3)) for lv in range(3)],
    }


def _torch_batch(batch):
    return {k: ([tuple(map(t, lv)) for lv in v] if k == "masks" else t(v))
            for k, v in batch.items()}


def _jax_draws(rng):
    """The draws of `mmgt_tpu/training/stage2.py:136-167`, as the port's
    `draws` dict."""
    r_t, r_n, r_off, r_img, r_aud = jax.random.split(rng, 5)
    h8 = H // 8
    return {
        "t": torch.from_numpy(np.array(jax.random.randint(r_t, (B,), 0, 1000))).long(),
        "noise": t(jax.random.normal(r_n, (B, F, h8, h8, 4), jnp.float32)),
        "offset": t(jax.random.normal(r_off, (B, 1, 1, 1, 4), jnp.float32)),
        "keep_img": torch.from_numpy(np.array(jax.random.uniform(r_img, (B,)) >= 0.5)),
        "keep_aud": torch.from_numpy(np.array(jax.random.uniform(r_aud, (B,)) >= 0.5)),
    }


def _mixed_keys():
    """Two PRNG keys whose draws drop the reference image of one row and
    the audio of one row, so the per-row gates are exercised."""
    keys = []
    for seed in range(200):
        d = _jax_draws(jax.random.PRNGKey(seed))
        if d["keep_img"].tolist() in ([True, False], [False, True]) and \
                len(set(d["keep_aud"].tolist())) == 2:
            keys.append(jax.random.PRNGKey(seed))
        if len(keys) == 2:
            return keys
    raise AssertionError("no PRNG key with mixed gates")


@pytest.fixture(scope="module")
def jax_slice():
    """The JAX tiny trainer, its noised params and the compiled value and
    gradient of its loss at two mixed-gate keys."""
    pipe = _tiny_pipeline()
    shapes = jax.eval_shape(lambda: pipe.init_params(jax.random.PRNGKey(0), H, H))
    params = noise_params(shapes, seed=1)
    batch = _batch()
    jbatch = jax.tree.map(jnp.asarray, batch)
    trainer = JTrainer(pipe, **RATIOS)
    state = trainer.init_state(params)
    vg = jax.jit(jax.value_and_grad(trainer.loss_fn, has_aux=True))
    keys = _mixed_keys()
    runs = [vg(state.trainable, state.frozen, jbatch, k) for k in keys]
    return dict(pipe=pipe, params=params, batch=batch, state=state, keys=keys, runs=runs)


def _flax_to_port(tree):
    """{port name: numpy array in the port's layout} for a (sub)tree of the
    pipeline's params, e.g. JAX gradients."""
    out = {}
    for key, arr in traverse_util.flatten_dict(tree, sep="/").items():
        model, rest = key.split("/params/", 1)
        port_key = PIPELINE_MAPPERS[model](rest)
        out[f"{model}.{port_key}"] = (key, np.asarray(arr))
    return out


def test_trainable_set_matches_jax(jax_slice):
    """One-to-one with JAX's trainable leaves, mid_motion frozen (the JAX
    package's keyword deviation, reproduced)."""
    jtrain, jfrozen = j_partition(jax_slice["params"])
    want = set(_flax_to_port(jtrain))
    port = _port_pipeline(jax_slice["params"])
    train, frozen = partition_params(port)
    assert set(train) == want
    assert len(train) + len(frozen) == len(_flax_to_port(jax_slice["params"]))
    assert any(k.startswith("denoising_unet/params/mid_motion/")
               for k in traverse_util.flatten_dict(jfrozen, sep="/"))
    assert not any(k.startswith("denoising_unet.mid_block.motion_modules") for k in train)
    assert any(".motion_modules." in k for k in train)
    assert any(".audio_modules." in k for k in train)
    assert any(k.startswith("audio_proj.") for k in train)


def test_make_example_batch_matches_jax():
    want = JTrainer(_tiny_pipeline()).make_example_batch(b=2, f=3, height=64, width=48)
    got = Stage2Trainer(_port_pipeline()).make_example_batch(b=2, f=3, height=64, width=48)
    assert set(got) == set(want)
    for key in got:
        if key == "masks":
            shapes = [[tuple(m.shape) for m in lv] for lv in got[key]]
            assert shapes == [[tuple(m.shape) for m in lv] for lv in want[key]]
            assert all(bool((m == 1).all()) for lv in got[key] for m in lv)
        else:
            assert tuple(got[key].shape) == tuple(want[key].shape)
            assert not got[key].any()


def _port_grads(trainer, state, batch, draws):
    loss, metrics = trainer.loss_fn(batch, draws)
    names = list(state.trainable)
    grads = torch.autograd.grad(loss, [state.trainable[n] for n in names])
    return loss, dict(zip(names, grads))


def _port_layout(tree, like):
    """{port name: array in the port's layout} of a JAX tree shaped like
    the trainable tensors `like`."""
    want = _flax_to_port(tree)
    assert set(want) == set(like)
    return {n: from_flax_tensor(*want[n], p.shape) for n, p in like.items()}


def _grad_atol(grads):
    return 1e-4 * max(np.abs(g).max() for g in grads.values())


def _check_grads(got, jgrads):
    want = _port_layout(jgrads, got)
    atol = _grad_atol(want)
    for name, g in got.items():
        close(g.detach(), want[name], rtol=1e-3, atol=atol, msg=name)


def test_train_step_matches_jax(jax_slice):
    """One step against the JAX trainer's: loss, gradients, and the weights
    after its optax chain (clip_by_global_norm + adamw, run on the
    trainable tree raveled into one vector: the same elementwise math and
    global norm, compiled once instead of once per leaf)."""
    js = jax_slice
    port = _port_pipeline(js["params"])
    trainer = Stage2Trainer(port, **RATIOS)
    state = trainer.init_state()
    batch = _torch_batch(js["batch"])
    draws = _jax_draws(js["keys"][0])
    (jloss, _), jgrads = js["runs"][0]
    loss, grads = _port_grads(trainer, state, batch, draws)
    close(loss.detach(), jloss, rtol=1e-5, atol=0, msg="loss")
    _check_grads(grads, jgrads)

    jtr = JTrainer(js["pipe"], **RATIOS)
    flat, unravel = ravel_pytree(js["state"].trainable)
    updates, _ = jtr.tx.update(ravel_pytree(jgrads)[0], jtr.tx.init(flat), flat)
    jnew = unravel(optax.apply_updates(flat, updates))
    metrics = trainer.train_step(state, batch, draws)
    close(metrics["loss"], jloss, rtol=1e-5, atol=0, msg="train_step loss")
    _check_params(state, jnew, _port_layout(jgrads, state.trainable), trainer.learning_rate)


def _check_params(state, jnew, grads, lr):
    """Weights after the step against JAX's; `grads`: the gradient the step
    applied, which tells the weights AdamW moves by rounding alone."""
    want = _port_layout(jnew, state.trainable)
    g_atol = _grad_atol(grads)
    for name, p in state.trainable.items():
        err = np.abs(p.detach().numpy() - want[name])
        settled = np.abs(grads[name]) > g_atol
        assert err[settled].max(initial=0) <= 0.05 * lr, (name, err[settled].max())
        assert err.max() <= 2.05 * lr, (name, err.max())


def test_gradient_accumulation_matches_multisteps(jax_slice):
    """gradient_accumulation_steps=2: the first step leaves the weights as
    they are, the second applies the mean of both steps' gradients, as
    optax.MultiSteps."""
    js = jax_slice
    port = _port_pipeline(js["params"])
    trainer = Stage2Trainer(port, gradient_accumulation_steps=2, **RATIOS)
    state = trainer.init_state()
    before = {n: p.detach().clone() for n, p in state.trainable.items()}
    batch = _torch_batch(js["batch"])
    jtr = JTrainer(js["pipe"], gradient_accumulation_steps=2, **RATIOS)
    jparams, unravel = ravel_pytree(js["state"].trainable)
    opt_state = jtr.tx.init(jparams)
    mean = jax.tree.map(lambda a, b_: (a + b_) / 2, js["runs"][0][1], js["runs"][1][1])
    for i, (key, ((jloss, _), jgrads)) in enumerate(zip(js["keys"], js["runs"])):
        metrics = trainer.train_step(state, batch, _jax_draws(key))
        close(metrics["loss"], jloss, rtol=1e-5, atol=0, msg=f"loss {i}")
        updates, opt_state = jtr.tx.update(ravel_pytree(jgrads)[0], opt_state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        if i == 0:
            assert all(torch.equal(before[n], p) for n, p in state.trainable.items())
    _check_params(state, unravel(jparams), _port_layout(mean, state.trainable),
                  trainer.learning_rate)


# ------------------------------------------------------------- networks
def _unet_inputs(seed, b=2, f=2, h=8):
    rng = np.random.default_rng(seed)
    r = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    chans = TINY["block_out_channels"]
    shapes = [(h * h, chans[0])] * 2 + [((h // 2) ** 2, chans[1])] * 2 \
        + [((h // 4) ** 2, chans[2])] * 2 + [((h // 8) ** 2, chans[3])] \
        + [((h // 4) ** 2, chans[2])] * 3 + [((h // 2) ** 2, chans[1])] * 3 \
        + [(h * h, chans[0])] * 3
    return dict(
        lat=r(b, f, h, h, 4), tt=np.array([501, 77][:b], np.int32), ctx=r(b, 1, 768),
        audio=r(b, f, 32, 768), pose=r(b, f, h, h, chans[0], scale=0.1),
        masks=[tuple((rng.uniform(size=(b, f, (h >> lv) ** 2)) > 0.4).astype(np.float32)
                     for _ in range(3)) for lv in range(3)],
        banks=[r(b, ll, c) for ll, c in shapes], gate=np.array([0, 1][:b], np.int32))


def test_unet_raw_banks_and_bank_gate_match_jax():
    """The training route: per-example raw banks and a per-row bank_gate,
    at B = 2 (row 0 gated off)."""
    x = _unet_inputs(1)
    ms = (1.0, 2.0, 3.0)
    jm = JUNet3D(**TINY)
    jmasks = [tuple(map(jnp.asarray, lv)) for lv in x["masks"]]
    jargs = (jnp.asarray(x["lat"]), jnp.asarray(x["tt"]), jnp.asarray(x["ctx"]),
             jnp.asarray(x["audio"]), jnp.asarray(x["pose"]), jmasks,
             [jnp.asarray(bk) for bk in x["banks"]])
    params = init_noised(jm, *jargs)
    want = jax.jit(jm.apply, static_argnums=(8, 9))(params, *jargs, ms, 0,
                                                     bank_gate=jnp.asarray(x["gate"]))
    port = load_jax_params(DenoisingUNet3D(**TINY), params, map_unet3d).eval()
    with torch.no_grad():
        got = port(t(x["lat"]), torch.from_numpy(x["tt"]).long(), t(x["ctx"]), t(x["audio"]),
                   t(x["pose"]), [tuple(map(t, lv)) for lv in x["masks"]], motion_scale=ms,
                   banks=[t(bk) for bk in x["banks"]], bank_gate=torch.from_numpy(x["gate"]))
    close(got, want, **NET_TOL)


def test_unet_remat_matches_plain():
    """remat=True (checkpointed blocks) gives the outputs and gradients of
    remat=False, with autograd on."""
    x = _unet_inputs(2)
    outs = []
    for remat in (False, True):
        torch.manual_seed(0)
        unet = DenoisingUNet3D(**TINY, remat=remat)
        for p in unet.parameters():
            p.data.normal_(0, 0.05)
        params = list(unet.parameters())
        lat = t(x["lat"]).requires_grad_(True)
        out = unet(lat, torch.from_numpy(x["tt"]).long(), t(x["ctx"]), t(x["audio"]),
                   t(x["pose"]), [tuple(map(t, lv)) for lv in x["masks"]],
                   banks=[t(bk) for bk in x["banks"]], bank_gate=torch.from_numpy(x["gate"]))
        grads = torch.autograd.grad((out ** 2).sum(), [lat] + params, allow_unused=True)
        outs.append((out.detach(), grads))
    close(outs[1][0], outs[0][0], rtol=1e-6, atol=1e-6, msg="output")
    for i, (g1, g0) in enumerate(zip(outs[1][1], outs[0][1])):
        assert (g1 is None) == (g0 is None), i
        if g0 is not None:
            close(g1, g0, rtol=1e-6, atol=1e-6, msg=f"grad {i}")


@torch.no_grad()
def test_reference_unet_banks_per_example():
    """ReferenceNet at B = 2 gives one bank set per example, as the JAX
    module, and row i equals a batch-1 run on example i."""
    rng = np.random.default_rng(3)
    lat, ctx = rng.standard_normal((2, 8, 8, 4)).astype(np.float32), \
        rng.standard_normal((2, 1, 768)).astype(np.float32)
    tt = np.zeros((2,), np.int32)
    jm = JUNet2D(**TINY)
    params = init_noised(jm, jnp.asarray(lat), jnp.asarray(tt), jnp.asarray(ctx))
    _, want = jax.jit(jm.apply)(params, jnp.asarray(lat), jnp.asarray(tt), jnp.asarray(ctx))
    port = load_jax_params(ReferenceUNet2D(**TINY), params,
                           PIPELINE_MAPPERS["reference_unet"]).eval()
    _, banks = port(t(lat), torch.zeros(2, dtype=torch.long), t(ctx))
    _, banks1 = port(t(lat[1:]), torch.zeros(1, dtype=torch.long), t(ctx[1:]))
    assert len(banks) == len(want) == 16
    for i, (g, w, g1) in enumerate(zip(banks, want, banks1)):
        assert g.shape[0] == 2
        close(g, w, **NET_TOL, msg=f"bank {i}")
        close(g[1:], g1, rtol=1e-5, atol=1e-5, msg=f"bank {i} row 1")
