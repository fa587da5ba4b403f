"""One Stage-2 train step on a (dp = 2, tp = 2) mesh of 4 gloo ranks (CPU,
f32) against the JAX package's unsharded step, and its checkpoint.

The configuration and draws are tests/test_torch_train.py's: the tiny
pipeline at 64^2, a global batch of 2 rows of 2 frames (one row a dp
rank), JAX's draws with one row's reference image and one row's audio
dropped, every leaf of the parameters noised. The rank function lives
here and imports no JAX; the parent hands the parameters, batch and
draws over through a pickle. Tolerances, as tests/test_tp.py:160-170
holds JAX's own sharded step to its unsharded one: the loss rtol 2e-5;
every trainable weight after the AdamW step atol 2e-5, rtol 2e-4 (2 x the
learning rate: where a gradient is zero up to rounding, AdamW's first
step is about sign(g), which rounding decides).

The checkpoint: every rank calls `save` on the whole-size tree (shards
gathered over tp); rank 0 writes it. Each rank restores it into its own
zeroed state, bitwise; a world-1 trainer restores the same file, and its
tree equals the gathered one bitwise.
"""
import os
import pickle

import numpy as np
import torch

from mmgt_tpu_torch.parallel.launch import spawn

TINY = dict(block_out_channels=(16, 32, 32, 32), heads=4)
RATIOS = dict(uncond_img_ratio=0.5, uncond_audio_ratio=0.5)


def _port_trainer(params, mesh=None):
    from mmgt_tpu_torch.models.audio_proj import AudioProjModel
    from mmgt_tpu_torch.models.pose_guider import PoseGuider
    from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D
    from mmgt_tpu_torch.models.unet_ref import ReferenceUNet2D
    from mmgt_tpu_torch.models.vae import AutoencoderKL
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
    from mmgt_tpu_torch.training.stage2 import Stage2Trainer
    from mmgt_tpu_torch.utils.convert import PIPELINE_MAPPERS, load_jax_params

    pipe = Pose2VideoPipeline(
        vae=AutoencoderKL((16, 16, 32, 32)), reference_unet=ReferenceUNet2D(**TINY),
        denoising_unet=DenoisingUNet3D(**TINY, remat=True),
        pose_guider=PoseGuider(16, (4, 8, 8, 16)), audio_proj=AudioProjModel(intermediate_dim=32),
        context_size=4)
    for name, model in pipe.models().items():
        load_jax_params(model, params[name], PIPELINE_MAPPERS[name]).eval()
    pipe.shard_(mesh)
    return Stage2Trainer(pipe, **RATIOS)


def _tensors(tree):
    if isinstance(tree, dict):
        return {k: _tensors(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tensors(v) for v in tree)
    return torch.from_numpy(np.asarray(tree))


def _train_rank(margs, payload_path, out_dir):
    torch.set_num_threads(1)
    from mmgt_tpu_torch.parallel.mesh import create_mesh, destroy
    from mmgt_tpu_torch.utils.checkpoint import CheckpointManager

    mesh = create_mesh(dp=2, tp=2, device="cpu", backend="gloo", timeout_s=300, **margs)
    with open(payload_path, "rb") as f:
        payload = pickle.load(f)
    trainer = _port_trainer(payload["params"], mesh)
    state = trainer.init_state()
    metrics = trainer.train_step(state, _tensors(payload["batch"]), _tensors(payload["draws"]))
    tree = trainer.checkpoint_tree(state)
    mgr = CheckpointManager(os.path.join(out_dir, "ckpt"), mesh=mesh)
    mgr.save(state.step, tree)
    local = {k: v.detach().clone() for k, v in trainer._local_tree(state).items()
             if torch.is_tensor(v)}
    with torch.no_grad():
        for v in trainer._local_tree(state).values():
            if torch.is_tensor(v):
                v.zero_()
    state.step = 0
    restored = trainer.restore(state, mgr)
    same = all(torch.equal(v, local[k]) for k, v in trainer._local_tree(state).items()
               if torch.is_tensor(v))
    specs = trainer.specs()
    sharded = sum(specs[n] is not None for n in state.trainable)
    res = dict(loss=metrics["loss"], restored=restored, same=same,
               shard_shape=tuple(state.trainable[
                   "denoising_unet.down_blocks.0.motion_modules.0.temporal_transformer"
                   ".transformer_blocks.0.attention_blocks.0.to_q.weight"].shape), sharded=sharded)
    if mesh.rank == 0:
        res["tree"] = {k: (v.detach().clone() if torch.is_tensor(v) else v)
                       for k, v in tree.items()}
    torch.save(res, os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    destroy(mesh)


def test_train_step_dp2_tp2_matches_jax_and_checkpoint_round_trips(tmp_path):
    import jax
    import optax
    from jax.flatten_util import ravel_pytree

    from mmgt_tpu.training.stage2 import Stage2Trainer as JTrainer
    from mmgt_tpu_torch.utils.checkpoint import CheckpointManager
    from test_torch_train import _batch, _flax_to_port, _jax_draws, _port_layout
    from test_training import _tiny_pipeline
    from torch_port_util import noise_params

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jpipe = _tiny_pipeline()
    params = noise_params(jax.eval_shape(lambda: jpipe.init_params(jax.random.PRNGKey(0), 64, 64)),
                          seed=1)
    batch = _batch()
    jtr = JTrainer(jpipe, **RATIOS)
    jstate = jtr.init_state(params)
    key = jax.random.PRNGKey(0)   # the first of test_torch_train.py's _mixed_keys
    draws = _jax_draws(key)
    assert draws["keep_img"].tolist() in ([True, False], [False, True])
    assert len(set(draws["keep_aud"].tolist())) == 2
    (jloss, _), jgrads = jax.jit(jax.value_and_grad(jtr.loss_fn, has_aux=True))(
        jstate.trainable, jstate.frozen, jax.tree.map(jax.numpy.asarray, batch), key)
    flat, unravel = ravel_pytree(jstate.trainable)
    updates, _ = jtr.tx.update(ravel_pytree(jgrads)[0], jtr.tx.init(flat), flat)
    jnew = unravel(optax.apply_updates(flat, updates))
    torch.set_num_threads(n)

    path = os.path.join(str(tmp_path), "payload.pkl")
    with open(path, "wb") as f:
        pickle.dump(dict(params=params, batch=batch,
                         draws={k: v.numpy() for k, v in draws.items()}), f)
    spawn(_train_rank, 4, str(tmp_path), path, str(tmp_path))
    ranks = [torch.load(os.path.join(str(tmp_path), f"rank{r}.pt")) for r in range(4)]
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(float(res["loss"]), float(jloss), rtol=2e-5, err_msg=f"rank {r}")
        assert res["restored"] == 1 and res["same"], r
        assert res["sharded"] > 0 and res["shard_shape"] == (8, 16), r
    tree = ranks[0]["tree"]
    trainable = {k.split("/", 1)[1]: v for k, v in tree.items() if k.startswith("trainable/")}
    want = _port_layout(jnew, trainable)
    assert set(_flax_to_port(jnew)) == set(trainable)
    for name, p in trainable.items():
        np.testing.assert_allclose(p.numpy(), want[name], atol=2e-5, rtol=2e-4, err_msg=name)

    # the same file at world 1: its tree is the gathered one, bitwise
    trainer = _port_trainer(params)
    state = trainer.init_state()
    assert trainer.restore(state, CheckpointManager(os.path.join(str(tmp_path), "ckpt"))) == 1
    back = trainer.checkpoint_tree(state)
    assert set(back) == set(tree)
    for k, v in back.items():
        if torch.is_tensor(v):
            assert v.shape == tree[k].shape and torch.equal(v, tree[k]), k
        else:
            assert v == tree[k], k
