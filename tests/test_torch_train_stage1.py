"""Stage-1 (SMGA) training: mmgt_tpu_torch (CPU, f32) against mmgt_tpu:
Adan, the six-term gesture loss and q_sample, and two SMGA train steps
(Adan's first step leaves its moments at zero and moves no weight by a
gradient, so the second step is the one that holds the gradients and the
moments) with the same parameters, batch and draws.

Tolerances, each with its reason:
  * Adan: 1e-6 of the largest |p| (the same f32 elementwise math; the bias
    corrections are f32 on both sides, and lerp rounds once where JAX's
    m (1 - b) + b g rounds twice);
  * q_sample and the loss terms: 1e-6 relative (f32 elementwise math and
    means over one axis order);
  * the SMGA step: loss 1e-5 relative and every gradient rtol 1e-4 with
    atol 1e-5 x the largest |g| (f32 through a 2-layer decoder and its
    backward, summed in another order); the weights and the EMA after
    each step 1e-6 of the largest |p| plus 10 % of the learning rate where
    Adan's denominator |g + (1 - b2)(g - g_prev)| exceeds 10 x the
    gradient atol (so the gradients' error moves the ratio it divides by
    under 10 %), which at least 95 % of the weights must meet; elsewhere
    only finite: where that denominator is zero up to rounding, Adan's
    ratio is unbounded and the rounding decides it (on either package).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import torch

from mmgt_tpu.diffusion.gesture import GestureDiffusionSchedule as JSchedule
from mmgt_tpu.models.smga import GestureDecoder as JGestureDecoder
from mmgt_tpu.training.adan import adan as j_adan
from mmgt_tpu.training.stage1 import SMGA as JSMGA
from mmgt_tpu.training.stage1 import SMGATrainState as JState
from mmgt_tpu.training.stage1 import transform_if_no_negative as j_transform
from mmgt_tpu_torch.diffusion.gesture import GestureDiffusionSchedule
from mmgt_tpu_torch.models.smga import GestureDecoder
from mmgt_tpu_torch.training.adan import Adan
from mmgt_tpu_torch.training.stage1 import SMGA, transform_if_no_negative
from mmgt_tpu_torch.utils.convert import ENCODER_MAPPERS, load_jax_params
from torch_port_util import close, noise_params, one_torch_thread, t

KW = dict(seq_len=80, latent_dim=64, ff_size=128, num_layers=2, num_heads=4,
          cond_feature_dim=35)
B = 4


def test_adan_matches_jax_over_three_steps():
    """Weight decay on, lr 2e-4 (the reference's) and a large lr 0.05 that
    moves weights visibly; random gradients each step."""
    rng = np.random.default_rng(0)
    shapes = [(7, 5), (33,), (2, 3, 4)]
    for lr, wd in ((2e-4, 0.02), (0.05, 0.1)):
        params = [rng.standard_normal(s).astype(np.float32) for s in shapes]
        tx = j_adan(lr, weight_decay=wd)
        jp = [jnp.asarray(p) for p in params]
        jstate = tx.init(jp)
        pp = [t(p) for p in params]
        opt = Adan(pp, lr, weight_decay=wd)
        for step in range(3):
            grads = [rng.standard_normal(s).astype(np.float32) for s in shapes]
            updates, jstate = tx.update([jnp.asarray(g) for g in grads], jstate, jp)
            jp = optax.apply_updates(jp, updates)
            opt.step([t(g) for g in grads])
            for i, (got, want) in enumerate(zip(pp, jp)):
                scale = np.abs(np.asarray(want)).max()
                close(got, want, rtol=0, atol=1e-6 * scale, msg=f"lr {lr} step {step} leaf {i}")
            for name, bufs in zip(("prev_grad", "m", "v", "n"),
                                  (jstate.prev_grad, jstate.m, jstate.v, jstate.n)):
                for got, want in zip(opt.buffers[name], bufs):
                    close(got, want, rtol=1e-6, atol=1e-7, msg=f"{name} step {step}")
        assert opt.step_count == int(jstate.step) == 3


def test_adan_first_step_is_weight_decay_only():
    """n = 0 on the first step: the update is exact zeros over eps, the
    weights divided by 1 + lr wd, no inf or NaN."""
    p = t(np.random.default_rng(1).standard_normal((64,)))
    before = p.clone()
    opt = Adan([p], 2e-4, weight_decay=0.02)
    opt.step([t(np.random.default_rng(2).standard_normal((64,)) * 1e3)])
    assert torch.isfinite(p).all()
    close(p, before / (1 + 2e-4 * 0.02), rtol=1e-7, atol=0)
    assert all(not b.any() for k in ("m", "v", "n") for b in opt.buffers[k])


def test_gesture_loss_and_q_sample_match_jax():
    rng = np.random.default_rng(3)
    out, tgt = (rng.standard_normal((3, 80, 402)).astype(np.float32) for _ in range(2))
    js, ps = JSchedule(), GestureDiffusionSchedule()
    want_total, want = js.losses(jnp.asarray(out), jnp.asarray(tgt))
    got_total, got = ps.losses(t(out), t(tgt))
    assert set(got) == set(want) == {"pos", "vel", "acc", "head_pos", "head_vel", "head_acc"}
    for k in got:
        close(got[k], want[k], rtol=1e-6, atol=0, msg=k)
    close(got_total, want_total, rtol=1e-6, atol=0)
    tt = np.array([0, 1, 500, 999], np.int32)
    x0, noise = (rng.standard_normal((4, 80, 402)).astype(np.float32) for _ in range(2))
    close(ps.q_sample(t(x0), t(noise), torch.from_numpy(tt).long()),
          js.q_sample(jnp.asarray(x0), jnp.asarray(noise), jnp.asarray(tt)), rtol=1e-6, atol=1e-6)
    neg = rng.uniform(-1, 1, (2, 5)).astype(np.float32)
    pos = rng.uniform(0, 1, (2, 5)).astype(np.float32)
    for x in (neg, pos):
        close(transform_if_no_negative(t(x)), j_transform(jnp.asarray(x)), rtol=0, atol=0)


def _jax_draws(key):
    """The draws of `GestureDiffusionSchedule.training_loss`
    (`mmgt_tpu/diffusion/gesture.py:156-160`)."""
    t_rng, n_rng, d_rng = jax.random.split(key, 3)
    return {"t": torch.from_numpy(np.array(jax.random.randint(t_rng, (B,), 0, 1000))).long(),
            "noise": t(jax.random.normal(n_rng, (B, 80, 402), jnp.float32)),
            "keep": torch.from_numpy(np.array(jax.random.uniform(d_rng, (B,)) >= 0.25))}


def _as_port(tree):
    """A JAX parameter tree in the port's layout: {state-dict key: array}."""
    m = load_jax_params(GestureDecoder(**KW), tree, ENCODER_MAPPERS["smga"])
    return {k: v.numpy() for k, v in m.state_dict().items()}


def test_smga_train_steps_match_jax():
    jsmga = JSMGA(feature_type="baseline")
    jsmga.model = JGestureDecoder(**KW)
    params = noise_params(jax.eval_shape(
        lambda: jsmga.init_state(jax.random.PRNGKey(0), batch_size=1).params), seed=5)
    jstate = JState(jnp.zeros((), jnp.int32), params, params, jsmga.tx.init(params))
    smga = SMGA(feature_type="baseline",
                model=load_jax_params(GestureDecoder(**KW), params, ENCODER_MAPPERS["smga"]))
    state = smga.init_state()
    rng = np.random.default_rng(6)
    batch = {"keypoints": rng.uniform(0, 1, (B, 80, 402)).astype(np.float32),
             "cond_frame": rng.uniform(0, 1, (B, 402)).astype(np.float32),
             "audio_features": rng.standard_normal((B, 80, 35)).astype(np.float32)}
    jbatch = jax.tree.map(jnp.asarray, batch)
    pbatch = {k: t(v) for k, v in batch.items()}
    keys = [k for k in (jax.random.PRNGKey(s) for s in range(100))
            if len(set(_jax_draws(k)["keep"].tolist())) == 2][:2]
    step = jax.jit(jsmga.train_step)
    value_and_grad = jax.jit(jax.value_and_grad(jsmga.loss_fn, has_aux=True))
    lr = smga.learning_rate
    grads_seen = []
    for i, key in enumerate(keys):
        draws = _jax_draws(key)
        (jloss, _), jgrads = value_and_grad(jstate.params, jbatch, key)
        loss, _ = smga.loss_fn(pbatch, draws)
        names = list(state.params)
        grads = torch.autograd.grad(loss, [state.params[n] for n in names])
        want_g = _as_port(jgrads)
        atol = 1e-5 * max(np.abs(g).max() for g in want_g.values())
        for n, g in zip(names, grads):
            close(g, want_g[n], rtol=1e-4, atol=atol, msg=f"step {i} grad {n}")
        grads_seen.append(want_g)
        close(loss.detach(), jloss, rtol=1e-5, atol=0, msg=f"loss {i}")

        jstate, jm = step(jstate, jbatch, key)
        metrics = smga.train_step(state, pbatch, draws)
        assert set(metrics) == set(jm)
        for k in metrics:
            close(metrics[k], jm[k], rtol=1e-5, atol=0, msg=f"step {i} {k}")
        for what, got, want in (("params", {n: p.detach() for n, p in state.params.items()},
                                 _as_port(jstate.params)),
                                ("ema", state.ema, _as_port(jstate.ema_params))):
            scale = max(np.abs(w).max() for w in want.values())
            held = total = 0
            for n, g in got.items():
                err = np.abs(g.numpy() - want[n])
                assert np.isfinite(g.numpy()).all(), (what, i, n)
                settled = np.ones_like(err, bool)
                if i:  # Adan's denominator: |g + (1 - b2)(g - g_prev)|
                    g2, g1 = grads_seen[-1][n], grads_seen[-2][n]
                    settled = np.abs(g2 + 0.92 * (g2 - g1)) > 10 * atol
                assert err[settled].max(initial=0) <= 1e-6 * scale + 0.1 * lr, (what, i, n)
                held, total = held + settled.sum(), total + settled.size
            assert held >= 0.95 * total, (what, i, held / total)
    assert state.step == int(jstate.step) == 2
