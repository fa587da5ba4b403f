"""Pose2VideoPipeline on a (dp = 2, tp = 2) mesh of 4 gloo ranks (CPU, f32)
against the JAX package's unsharded pipeline, with tests/test_tp.py's
configuration: 64^2, 6 frames, context 4 overlapping by 2 (3 windows, so
dp = 2 pads the group with a repeat of its last window), 2 DDIM steps,
guidance 3.5, every leaf of the parameters noised.

The ranks get the JAX parameters and the JAX `_prepare`'s initial latents
through a pickle and import no JAX (the rank function lives here, and
this module imports JAX only inside its test). Tolerances:
  * every rank's frames against JAX's: 1e-3 relative and absolute, as
    tests/test_torch_pipeline.py holds the unsharded port (f32 sums in
    another order than XLA's; the tp partial sums add another order);
  * against the unsharded port on the same inputs: atol 2e-4, rtol 1e-3,
    tests/test_tp.py's bound for JAX's own sharded run against its
    unsharded one;
  * the four ranks' frames bitwise equal (every rank decodes the same
    gathered latents, and a gloo all_reduce gives every rank one sum).
"""
import os
import pickle

import numpy as np
import torch

from mmgt_tpu_torch.parallel.launch import spawn

TINY = dict(block_out_channels=(16, 32, 32, 32), heads=4)
H, F, STEPS = 64, 6, 2


def _port_pipeline(params):
    from mmgt_tpu_torch.models.audio_proj import AudioProjModel
    from mmgt_tpu_torch.models.pose_guider import PoseGuider
    from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D
    from mmgt_tpu_torch.models.unet_ref import ReferenceUNet2D
    from mmgt_tpu_torch.models.vae import AutoencoderKL
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
    from mmgt_tpu_torch.utils.convert import PIPELINE_MAPPERS, load_jax_params

    pipe = Pose2VideoPipeline(
        vae=AutoencoderKL((16, 16, 32, 32)), reference_unet=ReferenceUNet2D(**TINY),
        denoising_unet=DenoisingUNet3D(**TINY), pose_guider=PoseGuider(16, (4, 8, 8, 16)),
        audio_proj=AudioProjModel(intermediate_dim=32), context_size=4, context_overlap=2)
    for name, model in pipe.models().items():
        load_jax_params(model, params[name], PIPELINE_MAPPERS[name]).eval()
    return pipe


@torch.no_grad()
def _run(pipe, x):
    t = lambda a: torch.from_numpy(np.asarray(a))
    masks = tuple(tuple(map(t, lv)) for lv in x["masks"])
    return pipe(t(x["ref_image"]), t(x["pose_video"]), t(x["clip_embed"]), masks,
                t(x["audio_embeds"]), num_inference_steps=STEPS, guidance_scale=3.5,
                latents=t(x["latents"]))


def _pipeline_rank(margs, payload_path, out_dir):
    torch.set_num_threads(1)
    from mmgt_tpu_torch.parallel.mesh import create_mesh, destroy

    mesh = create_mesh(dp=2, tp=2, device="cpu", backend="gloo", timeout_s=120, **margs)
    with open(payload_path, "rb") as f:
        payload = pickle.load(f)
    pipe = _port_pipeline(payload["params"])
    specs = pipe.shard_(mesh)
    n_sharded = sum(s is not None for s in specs.values())
    frames = _run(pipe, payload["inputs"])
    torch.save(dict(frames=frames, n_sharded=n_sharded,
                    q_rows=pipe.denoising_unet.down_blocks[0].attentions[0]
                    .transformer_blocks[0].attn1.to_q.weight.shape[0]),
               os.path.join(out_dir, f"rank{mesh.rank}.pt"))
    destroy(mesh)


def test_pipeline_dp2_tp2_matches_jax(tmp_path):
    import jax
    import jax.numpy as jnp

    from mmgt_tpu.models.audio_proj import AudioProjModel as JAudioProj
    from mmgt_tpu.models.pose_guider import PoseGuider as JPoseGuider
    from mmgt_tpu.models.unet3d import DenoisingUNet3D as JUNet3D
    from mmgt_tpu.models.unet_ref import ReferenceUNet2D as JUNet2D
    from mmgt_tpu.models.vae import AutoencoderKL as JVAE
    from mmgt_tpu.pipelines.pose2vid import Pose2VideoPipeline as JPipe
    from torch_port_util import noise_params

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    jp = JPipe(vae=JVAE(block_out_channels=(16, 16, 32, 32)), reference_unet=JUNet2D(**TINY),
               denoising_unet=JUNet3D(**TINY),
               pose_guider=JPoseGuider(embedding_channels=16, block_out_channels=(4, 8, 8, 16)),
               audio_proj=JAudioProj(intermediate_dim=32), context_size=4, context_overlap=2,
               window_microbatch=None)
    params = noise_params(jax.eval_shape(lambda: jp.init_params(jax.random.PRNGKey(0), H, H)),
                          seed=1)
    rng = np.random.default_rng(0)
    h8 = H // 8
    x = dict(ref_image=rng.uniform(-1, 1, (1, H, H, 3)).astype(np.float32),
             pose_video=rng.uniform(0, 1, (1, F, H, H, 3)).astype(np.float32),
             clip_embed=rng.standard_normal((1, 1, 768)).astype(np.float32),
             masks=tuple(tuple((rng.uniform(size=(1, F, (h8 >> lv) ** 2)) > 0.4)
                               .astype(np.float32) for _ in range(3)) for lv in range(3)),
             audio_embeds=rng.standard_normal((1, F, 5, 12, 768)).astype(np.float32))
    key = jax.random.PRNGKey(2)
    jargs = (jnp.asarray(x["ref_image"]), jnp.asarray(x["pose_video"]),
             jnp.asarray(x["clip_embed"]), tuple(tuple(map(jnp.asarray, lv)) for lv in x["masks"]),
             jnp.asarray(x["audio_embeds"]))
    _, latents = jp._prepare(params, key, *jargs)
    x["latents"] = np.asarray(latents)
    want = np.asarray(jp(params, key, *jargs, num_inference_steps=STEPS))
    unsharded = _run(_port_pipeline(params), x).numpy()
    torch.set_num_threads(n)
    path = os.path.join(str(tmp_path), "payload.pkl")
    with open(path, "wb") as f:
        pickle.dump(dict(params=params, inputs=x), f)
    spawn(_pipeline_rank, 4, str(tmp_path), path, str(tmp_path))
    ranks = [torch.load(os.path.join(str(tmp_path), f"rank{r}.pt")) for r in range(4)]
    assert want.shape == (1, F, H, H, 3)
    for r, res in enumerate(ranks):
        assert res["n_sharded"] > 0 and res["q_rows"] == TINY["block_out_channels"][0] // 2
        got = res["frames"].numpy()
        np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-3, err_msg=f"rank {r}")
        np.testing.assert_allclose(got, unsharded, rtol=1e-3, atol=2e-4, err_msg=f"rank {r}")
        assert torch.equal(res["frames"], ranks[0]["frames"]), r
