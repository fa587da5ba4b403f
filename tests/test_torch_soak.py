"""Multi-step training evidence for the port, the counterparts of
tests/test_training_soak.py:54 and :165, at JAX's tiny sizes and with
JAX's criteria (CPU, f32, plain versions):

  * the Stage-2 trainer overfits one fixed jittered batch: 52 steps with
    4 fixed (t, noise) draws in turn, CFG dropout and noise offset off,
    lr 2e-4; every loss finite, each draw's loss ends lower than it
    started, and the mean of the last 4 is below 0.8x the first 4's. The
    tiny pipeline starts from JAX's own initial weights (flax's init at
    PRNGKey(0), carried over by `load_jax_params`), on which that
    criterion was set: zero-initialised output layers and variance-scaled
    kernels. From the port's flat N(0, 0.02) fill every draw's loss falls
    too, but the mean falls by ~9 %;
  * SMGA at the reference's widths overfits one (keypoints, audio)
    sample: 120 steps, lr 3e-4, no condition dropout, 4 fixed draws; the
    mean loss of the last 4 steps below a quarter of the first 4's.

Both are `slow`, as JAX's are. On the card, `chip_smoke.py`'s soak phase
runs the same two at full width.
"""
import numpy as np
import pytest
import torch

from mmgt_tpu_torch.models.audio_proj import AudioProjModel
from mmgt_tpu_torch.models.pose_guider import PoseGuider
from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D
from mmgt_tpu_torch.models.unet_ref import ReferenceUNet2D
from mmgt_tpu_torch.models.vae import AutoencoderKL
from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
from mmgt_tpu_torch.training.stage1 import SMGA
from mmgt_tpu_torch.training.stage2 import Stage2Trainer
from torch_port_util import one_torch_thread  # noqa: F401


def _tiny_pipeline():
    """tests/test_training_soak.py's tiny pipeline with its weights."""
    import jax

    from mmgt_tpu.models.audio_proj import AudioProjModel as JAudioProj
    from mmgt_tpu.models.pose_guider import PoseGuider as JPoseGuider
    from mmgt_tpu.models.unet3d import DenoisingUNet3D as JUNet3D
    from mmgt_tpu.models.unet_ref import ReferenceUNet2D as JUNet2D
    from mmgt_tpu.models.vae import AutoencoderKL as JVAE
    from mmgt_tpu.pipelines.pose2vid import Pose2VideoPipeline as JPipeline
    from mmgt_tpu_torch.utils.convert import PIPELINE_MAPPERS, load_jax_params

    tiny = dict(block_out_channels=(16, 32, 32, 32), heads=4)
    params = JPipeline(
        vae=JVAE(block_out_channels=(16, 16, 32, 32)), reference_unet=JUNet2D(**tiny),
        denoising_unet=JUNet3D(**tiny),
        pose_guider=JPoseGuider(embedding_channels=16, block_out_channels=(4, 8, 8, 16)),
        audio_proj=JAudioProj(intermediate_dim=32), context_size=4,
    ).init_params(jax.random.PRNGKey(0), 64, 64)
    pipe = Pose2VideoPipeline(
        vae=AutoencoderKL((16, 16, 32, 32)), reference_unet=ReferenceUNet2D(**tiny),
        denoising_unet=DenoisingUNet3D(**tiny), pose_guider=PoseGuider(16, (4, 8, 8, 16)),
        audio_proj=AudioProjModel(intermediate_dim=32), context_size=4)
    for name, model in pipe.models().items():
        load_jax_params(model, jax.tree_util.tree_map(np.asarray, params[name]),
                        PIPELINE_MAPPERS[name])
    return pipe


def _fixed_batch(trainer):
    batch = trainer.make_example_batch(b=1, f=2, height=64, width=64)
    rng = np.random.default_rng(0)
    jitter = lambda x: x + 0.3 * torch.from_numpy(  # noqa: E731
        rng.standard_normal(tuple(x.shape)).astype(np.float32))
    for k in ("pixel_values", "ref_image", "audio_embeds"):
        batch[k] = jitter(batch[k])
    batch["pose_video"] = jitter(batch["pose_video"]).abs()
    return batch


@pytest.mark.slow
def test_stage2_overfit_loss_decreases():
    trainer = Stage2Trainer(_tiny_pipeline(), learning_rate=2e-4, uncond_img_ratio=0.0,
                            uncond_audio_ratio=0.0, noise_offset=0.0)
    state = trainer.init_state()
    batch = _fixed_batch(trainer)
    draws = [trainer.draws(1, 2, 8, 8, torch.Generator().manual_seed(100 + i)) for i in range(4)]
    losses = [float(trainer.train_step(state, batch, draws[i % 4])["loss"]) for i in range(52)]
    assert np.isfinite(losses).all(), losses
    for j in range(4):
        cyc = losses[j::4]
        assert cyc[-1] < cyc[0], (j, cyc)
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    assert last < 0.8 * first, (first, last, losses[::8])


@pytest.mark.slow
def test_smga_overfit_single_sample():
    smga = SMGA.build("cpu", seed=0, feature_type="baseline", learning_rate=3e-4,
                      cond_drop_prob=0.0)
    state = smga.init_state()
    rng = np.random.default_rng(3)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    batch = {"keypoints": t(np.cumsum(0.02 * rng.standard_normal((1, 80, 402)), axis=1)),
             "cond_frame": t(rng.standard_normal((1, 402))),
             "audio_features": t(rng.standard_normal((1, 80, 35)))}
    draws = [smga.draws(1, torch.Generator().manual_seed(50 + i)) for i in range(4)]
    losses = [float(smga.train_step(state, batch, draws[i % 4])["loss"]) for i in range(120)]
    assert np.isfinite(losses).all(), losses
    first, last = np.mean(losses[:4]), np.mean(losses[-4:])
    assert last < first / 4.0, (first, last, losses[::20])
