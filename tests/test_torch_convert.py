"""`mmgt_tpu_torch.utils.convert.load_jax_params` against mmgt_tpu's own
converter: a port state_dict -> `mmgt_tpu.utils.convert.convert` (with the
JAX package's map_* functions) -> `load_jax_params` into a fresh module is
the identity, for each of the five Stage-2 models; a missing or left-over
key raises."""
import jax
import numpy as np
import pytest
import torch

from mmgt_tpu.utils import convert as JC
from mmgt_tpu_torch.models.audio_proj import AudioProjModel
from mmgt_tpu_torch.models.pose_guider import PoseGuider
from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D
from mmgt_tpu_torch.models.unet_ref import ReferenceUNet2D
from mmgt_tpu_torch.models.vae import AutoencoderKL
from mmgt_tpu_torch.utils import convert as PC

CHANS = (32, 64, 64, 64)

PORT = {
    "vae": lambda: AutoencoderKL((32, 32, 64, 64)),
    "reference_unet": lambda: ReferenceUNet2D(CHANS, heads=8),
    "denoising_unet": lambda: DenoisingUNet3D(CHANS, heads=8),
    "pose_guider": lambda: PoseGuider(32, (4, 8, 8, 16)),
    "audio_proj": lambda: AudioProjModel(intermediate_dim=32),
}
JAX_MAPPERS = {
    "vae": JC.map_vae, "reference_unet": JC.map_unet2d, "denoising_unet": JC.map_unet3d,
    "pose_guider": JC.map_pose_guider, "audio_proj": JC.map_audio_proj,
}


@pytest.fixture(scope="module")
def jax_shapes():
    from mmgt_tpu.models.audio_proj import AudioProjModel as JA
    from mmgt_tpu.models.pose_guider import PoseGuider as JP
    from mmgt_tpu.models.unet3d import DenoisingUNet3D as J3
    from mmgt_tpu.models.unet_ref import ReferenceUNet2D as J2
    from mmgt_tpu.models.vae import AutoencoderKL as JV
    from mmgt_tpu.pipelines.pose2vid import Pose2VideoPipeline as JPipe

    tiny = dict(block_out_channels=CHANS, heads=8)
    pipe = JPipe(vae=JV(block_out_channels=(32, 32, 64, 64)), reference_unet=J2(**tiny),
                 denoising_unet=J3(**tiny),
                 pose_guider=JP(embedding_channels=32, block_out_channels=(4, 8, 8, 16)),
                 audio_proj=JA(intermediate_dim=32), context_size=4)
    return jax.eval_shape(lambda: pipe.init_params(jax.random.PRNGKey(0), 64, 64))


def _randomized(module, seed):
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in module.parameters():
            p.copy_(torch.randn(p.shape, generator=g))
    return module


@pytest.mark.parametrize("name", list(PORT))
def test_state_dict_round_trip_is_identity(name, jax_shapes):
    src = _randomized(PORT[name](), seed=len(name))
    sd = {k: v.numpy() for k, v in src.state_dict().items()}
    params, report = JC.convert(jax_shapes[name], [sd], JAX_MAPPERS[name])
    assert not report["missing"] and not report["unexpected"], report
    dst = PC.load_jax_params(PORT[name](), params, PC.PIPELINE_MAPPERS[name])
    got = dst.state_dict()
    assert got.keys() == src.state_dict().keys()
    for k, v in src.state_dict().items():
        assert torch.equal(got[k], v), k


def _flat_pose_params(jax_shapes):
    sd = {k: v.numpy() for k, v in PORT["pose_guider"]().state_dict().items()}
    params, _ = JC.convert(jax_shapes["pose_guider"], [sd], JC.map_pose_guider)
    return jax.tree.map(np.asarray, params)


def test_missing_key_raises(jax_shapes):
    params = _flat_pose_params(jax_shapes)
    del params["params"]["conv_out"]["bias"]
    with pytest.raises(KeyError, match="without a flax leaf"):
        PC.load_jax_params(PORT["pose_guider"](), params, PC.map_pose_guider)


def test_left_over_key_raises(jax_shapes):
    params = _flat_pose_params(jax_shapes)
    params["params"]["extra"] = {"kernel": np.zeros((3, 3), np.float32)}
    with pytest.raises(KeyError, match="left over"):
        PC.load_jax_params(PORT["pose_guider"](), params, PC.map_pose_guider)


def test_shape_mismatch_raises(jax_shapes):
    params = _flat_pose_params(jax_shapes)
    params["params"]["conv_out"]["bias"] = np.zeros((7,), np.float32)
    with pytest.raises(ValueError):
        PC.load_jax_params(PORT["pose_guider"](), params, PC.map_pose_guider)


@pytest.mark.parametrize("name", list(PORT))
def test_port_mappers_match_the_jax_mappers(name, jax_shapes):
    flat = jax.tree_util.tree_flatten_with_path(jax_shapes[name]["params"])[0]
    for path, _ in flat:
        key = "/".join(p.key for p in path)
        assert PC.PIPELINE_MAPPERS[name](key) == JAX_MAPPERS[name](key), key
