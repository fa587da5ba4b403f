"""The Stage-2 image pretrain: mmgt_tpu_torch (CPU, f32, plain versions)
against mmgt_tpu's `Stage2ImageTrainer`, with the same noised parameters,
batch and draws (one row keeps its reference, one drops it).

Tolerances, as tests/test_torch_train.py's docstring states them: loss 1e-5
relative; every trainable gradient, the ReferenceNet's included, rtol 1e-3
with atol 1e-4 x the largest |g|; the parameters after the AdamW step atol
5 % of the learning rate where the gradient is settled, 2.05 lr elsewhere;
CLIP embeddings 1e-4 (a one-layer ViT in f32).
"""
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from mmgt_tpu.models.clip_vision import CLIPVisionModel as JCLIP
from mmgt_tpu.models.pose_guider import PoseGuider as JPoseGuider
from mmgt_tpu.models.unet3d import DenoisingUNet3D as JUNet3D
from mmgt_tpu.models.unet_ref import ReferenceUNet2D as JUNet2D
from mmgt_tpu.models.vae import AutoencoderKL as JVAE
from mmgt_tpu.training.stage2 import encode_clip_batch as j_encode_clip_batch
from mmgt_tpu.training.stage2_image import Stage2ImageTrainer as JTrainer
from mmgt_tpu.training.stage2_image import partition_params_image as j_partition
from mmgt_tpu_torch.models.clip_vision import CLIPVisionModel
from mmgt_tpu_torch.ops import attention as A
from mmgt_tpu_torch.scripts.train_stage2_image import tiny_pipeline
from mmgt_tpu_torch.training.stage2 import encode_clip_batch
from mmgt_tpu_torch.training.stage2_image import Stage2ImageTrainer, partition_params_image
from mmgt_tpu_torch.utils.convert import ENCODER_MAPPERS, PIPELINE_MAPPERS, load_jax_params
from test_torch_train import _check_grads, _check_params, _flax_to_port, _port_layout
from torch_port_util import close, init_noised, noise_params, one_torch_thread, t

TINY = dict(block_out_channels=(16, 32, 32, 32), heads=4)
B, H = 2, 64
RATIO = 0.5  # uncond_ratio: draws with one kept and one dropped row are easy to find
# K5 calls a step: the denoiser's 16 self-attentions and 14 of the
# ReferenceNet's 16: its last one (up_blocks.3.attentions.2) only feeds the
# discarded output sample, and at 64^2 its mid block sees one token, whose
# attention is v itself (at 256^2 it sees 16: 31 calls)
K5_PER_STEP = 30


def _jax_trainer():
    return JTrainer(
        vae=JVAE(block_out_channels=(16, 16, 32, 32)), reference_unet=JUNet2D(**TINY),
        denoising_unet=JUNet3D(use_motion_module=False, use_audio_module=False, **TINY),
        pose_guider=JPoseGuider(embedding_channels=16, block_out_channels=(4, 8, 8, 16)),
        uncond_ratio=RATIO)


def _port_trainer(params):
    pipe = tiny_pipeline("cpu")
    for name, model in pipe.models().items():
        load_jax_params(model, params[name], PIPELINE_MAPPERS[name]).eval()
    return Stage2ImageTrainer(pipe, uncond_ratio=RATIO)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    u = lambda lo, *s: rng.uniform(lo, 1, s).astype(np.float32)
    return {"tgt_image": u(-1, B, H, H, 3), "ref_image": u(-1, B, H, H, 3),
            "tgt_pose": u(0, B, H, H, 3),
            "clip_embed": rng.standard_normal((B, 1, 768)).astype(np.float32)}


def _jax_draws(rng):
    """The draws of `mmgt_tpu/training/stage2_image.py:145-156`, as the
    port's `draws` dict."""
    r_t, r_n, r_off, r_u = jax.random.split(rng, 4)
    h8 = H // 8
    return {
        "t": torch.from_numpy(np.array(jax.random.randint(r_t, (B,), 0, 1000))).long(),
        "noise": t(jax.random.normal(r_n, (B, h8, h8, 4), jnp.float32)),
        "offset": t(jax.random.normal(r_off, (B, 1, 1, 4), jnp.float32)),
        "keep": torch.from_numpy(np.array(jax.random.uniform(r_u, (B,)) >= RATIO)),
    }


def _mixed_key():
    for seed in range(200):
        key = jax.random.PRNGKey(seed)
        if _jax_draws(key)["keep"].tolist() == [True, False]:
            return key
    raise AssertionError("no PRNG key with one kept and one dropped row")


@pytest.fixture(scope="module")
def jax_step():
    """The JAX tiny image trainer, its noised params, and the compiled
    value and gradient of its loss at a key that drops row 1."""
    jtr = _jax_trainer()
    shapes = jax.eval_shape(lambda: jtr.init_params(jax.random.PRNGKey(0), H, H))
    params = noise_params(shapes, seed=1)
    batch = _batch()
    state = jtr.init_state(params)
    key = _mixed_key()
    vg = jax.jit(jax.value_and_grad(jtr.loss_fn, has_aux=True))
    run = vg(state.trainable, state.frozen, jax.tree.map(jnp.asarray, batch), key)
    return dict(trainer=jtr, params=params, batch=batch, state=state, key=key, run=run)


def test_partition_params_image_matches_jax(jax_step):
    """Key for key JAX's trainable set: the denoiser, the PoseGuider and the
    ReferenceNet but its up_blocks.3 (its conv_norm_out and conv_out stay
    trainable, as in JAX); the VAE frozen."""
    jtrain, _ = j_partition(jax_step["params"])
    train, frozen = partition_params_image(_port_trainer(jax_step["params"]).pipeline)
    assert set(train) == set(_flax_to_port(jtrain))
    assert len(train) + len(frozen) == len(_flax_to_port(jax_step["params"]))
    assert any(k.startswith("reference_unet.up_blocks.3.") for k in frozen)
    assert not any(k.startswith("reference_unet.up_blocks.3.") for k in train)
    assert any(k.startswith("reference_unet.up_blocks.2.") for k in train)
    assert "reference_unet.conv_out.weight" in train
    assert all(k.startswith(("vae.", "reference_unet.up_blocks.3.")) for k in frozen)


def test_encode_clip_batch_matches_jax():
    imgs = np.random.default_rng(0).uniform(0, 1, (2, 64, 64, 3)).astype(np.float32)
    z = encode_clip_batch(None, torch.from_numpy(imgs))
    assert z.shape == (2, 1, 768) and z.dtype == torch.float32 and not z.any()
    close(z, j_encode_clip_batch(None, None, jnp.asarray(imgs)), rtol=0, atol=0)
    kw = dict(hidden_dim=32, num_layers=1, heads=4, patch=32, image_size=224, proj_dim=768)
    jm = JCLIP(**kw)
    params = init_noised(jm, jnp.zeros((1, 224, 224, 3)), seed=2)
    pm = load_jax_params(CLIPVisionModel(**kw), params, ENCODER_MAPPERS["clip"]).eval()
    got = encode_clip_batch(pm, torch.from_numpy(imgs))
    assert got.shape == (2, 1, 768) and got.dtype == torch.float32
    close(got, j_encode_clip_batch(jm, params, jnp.asarray(imgs)), rtol=0, atol=1e-4)


def _bank_grads(trainer, batch, draws):
    """The loss's gradients with respect to the ReferenceNet's 16 banks."""
    ref = trainer.pipeline.reference_unet
    seen = []
    hook = ref.register_forward_hook(lambda m, i, out: seen.append(out[1]))
    try:
        loss, _ = trainer.loss_fn(batch, draws)
    finally:
        hook.remove()
    return torch.autograd.grad(loss, seen[0])


def test_train_step_matches_jax(jax_step, monkeypatch):
    """One step against the JAX trainer's: the loss, every trainable
    gradient (the ReferenceNet's, trained through the bank, among them),
    and the weights after clip_by_global_norm + adamw (run on the raveled
    trainable tree, as tests/test_torch_train.py). Row 1 drops its CLIP
    context and bank: the bank's gradient there is exactly zero. K5's
    calls a step are counted (the plain backward on the CPU)."""
    js = jax_step
    trainer = _port_trainer(js["params"])
    state = trainer.init_state()
    batch = {k: t(v) for k, v in js["batch"].items()}
    draws = _jax_draws(js["key"])
    (jloss, _), jgrads = js["run"]

    calls = []
    plain_bwd = A.attention_bwd_plain
    monkeypatch.setattr(A, "attention_bwd_plain", lambda *a, **k: calls.append(1) or
                        plain_bwd(*a, **k))
    loss, _ = trainer.loss_fn(batch, draws)
    names = list(state.trainable)
    grads = torch.autograd.grad(loss, [state.trainable[n] for n in names], allow_unused=True)
    assert len(calls) == K5_PER_STEP
    close(loss.detach(), jloss, rtol=1e-5, atol=0, msg="loss")
    got = {n: torch.zeros_like(state.trainable[n]) if g is None else g
           for n, g in zip(names, grads)}
    assert sum(1 for n in names if n.startswith("reference_unet.")) > 100
    _check_grads(got, jgrads)
    ref_g = max(got[n].abs().max().item() for n in names if n.startswith("reference_unet."))
    assert ref_g > 0, "no gradient reached the ReferenceNet"

    bank_g = _bank_grads(trainer, batch, draws)
    assert len(bank_g) == 16
    assert all(bool((g[1] == 0).all()) for g in bank_g), "a dropped row's bank got a gradient"
    assert all(g[0].abs().max().item() > 0 for g in bank_g)

    jtr = js["trainer"]
    flat, unravel = ravel_pytree(js["state"].trainable)
    updates, _ = jtr.tx.update(ravel_pytree(jgrads)[0], jtr.tx.init(flat), flat)
    jnew = unravel(optax.apply_updates(flat, updates))
    metrics = trainer.train_step(state, batch, draws)
    close(metrics["loss"], jloss, rtol=1e-5, atol=0, msg="train_step loss")
    _check_params(state, jnew, _port_layout(jgrads, state.trainable), trainer.learning_rate)
    moved = [n for n in names if not torch.equal(state.masters[n],
                                                 state.trainable[n].detach().float())]
    assert not moved, moved[:3]  # f32 working weights are the masters
    assert state.step == 1


def test_frozen_weights_unchanged_and_no_grad(jax_step):
    trainer = _port_trainer(jax_step["params"])
    state = trainer.init_state()
    before = {n: p.detach().clone() for n, p in state.frozen.items()}
    trainer.train_step(state, {k: t(v) for k, v in jax_step["batch"].items()},
                       _jax_draws(jax_step["key"]))
    assert all(torch.equal(before[n], p) for n, p in state.frozen.items())
    assert not any(p.requires_grad for p in state.frozen.values())
    assert all(p.requires_grad for p in state.trainable.values())
