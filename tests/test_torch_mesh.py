"""The port's mesh (`mmgt_tpu_torch/parallel/mesh.py`) against the JAX
package's (`mmgt_tpu/parallel/mesh.py`), with no processes: the mesh
shapes and errors, the per-parameter shardings on the same pipelines, the
optimizer state's, and the GEGLU half-pair split.

The shardings are compared one to one: each flax leaf of JAX's param tree
(`jax.eval_shape`, no values) is paired with its port key through the
port's own name maps (`PIPELINE_MAPPERS`), and P() must be replicated,
P(None, "tp") a shard of the torch weight's dim 0 and P("tp", None) of its
dim 1. The half-pair split is exact (slices, no arithmetic); the
no-process reconstruction of a sharded FeedForward holds at 1e-5 (f32 sums
in another order).
"""
import copy

import jax
import numpy as np
import pytest
import torch
from flax import traverse_util
from jax.sharding import PartitionSpec as P

from mmgt_tpu.models.audio_proj import AudioProjModel as JAudioProj
from mmgt_tpu.models.pose_guider import PoseGuider as JPoseGuider
from mmgt_tpu.models.unet3d import DenoisingUNet3D as JUNet3D
from mmgt_tpu.models.unet_ref import ReferenceUNet2D as JUNet2D
from mmgt_tpu.models.vae import AutoencoderKL as JVAE
from mmgt_tpu.parallel import mesh as jmesh
from mmgt_tpu.pipelines.pose2vid import Pose2VideoPipeline as JPipe
from mmgt_tpu.training.stage2 import Stage2Trainer as JTrainer
from mmgt_tpu.training.stage2 import partition_params as j_partition
from mmgt_tpu_torch.models.audio_proj import AudioProjModel
from mmgt_tpu_torch.models.pose_guider import PoseGuider
from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D
from mmgt_tpu_torch.models.unet_ref import ReferenceUNet2D
from mmgt_tpu_torch.models.vae import AutoencoderKL
from mmgt_tpu_torch.nn.layers import FeedForward
from mmgt_tpu_torch.parallel import mesh as pmesh
from mmgt_tpu_torch.parallel.mesh import Mesh, TPShard
from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
from mmgt_tpu_torch.training.stage2 import Stage2Trainer, partition_params
from mmgt_tpu_torch.utils.convert import PIPELINE_MAPPERS
from torch_port_util import close

# (name, UNet widths and heads, VAE widths, guider, audio-proj width)
CONFIGS = {
    # tests/test_tp.py's real 320/640 widths (head_dim 40 and 80)
    "real_width": (dict(block_out_channels=(320, 640), heads=8), (16, 16, 32, 32),
                   (320, (4, 8, 8, 16)), 32),
    # tests/test_tp.py's tiny inference pipeline
    "tiny": (dict(block_out_channels=(16, 32, 32, 32), heads=4), (16, 16, 32, 32),
             (16, (4, 8, 8, 16)), 32),
}


def _fake_mesh(tp: int = 2, rank: int = 0) -> Mesh:
    """A mesh object with no process group: shard_ and the rules read only
    its shape and coordinates."""
    return Mesh(world=tp, rank=rank, dp=1, tp=tp, device=torch.device("cpu"))


def _jax_params(cfg):
    unet, vae, (emb, guider), inter = CONFIGS[cfg]
    pipe = JPipe(vae=JVAE(block_out_channels=vae), reference_unet=JUNet2D(**unet),
                 denoising_unet=JUNet3D(**unet),
                 pose_guider=JPoseGuider(embedding_channels=emb, block_out_channels=guider),
                 audio_proj=JAudioProj(intermediate_dim=inter), context_size=4)
    return pipe, jax.eval_shape(lambda: pipe.init_params(jax.random.PRNGKey(0), 64, 64))


def _port_models(cfg, device="meta"):
    unet, vae, (emb, guider), inter = CONFIGS[cfg]
    with torch.device(device):
        return dict(vae=AutoencoderKL(vae), reference_unet=ReferenceUNet2D(**unet),
                    denoising_unet=DenoisingUNet3D(**unet), pose_guider=PoseGuider(emb, guider),
                    audio_proj=AudioProjModel(intermediate_dim=inter))


def _pairs(tree, specs):
    """[(flax key, JAX spec, port key)] for every leaf."""
    out = []
    flat = traverse_util.flatten_dict(specs, sep="/")
    for key, sh in flat.items():
        model, rest = key.split("/params/", 1)
        out.append((key, sh.spec, f"{model}.{PIPELINE_MAPPERS[model](rest)}"))
    return out


@pytest.mark.parametrize("case", [
    dict(), dict(tp=2), dict(tp=3), dict(tp=8), dict(tp=16), dict(dp=3, tp=2),
    dict(dp=4, tp=2), dict(dp=0, tp=2), dict(n_devices=4, tp=2), dict(n_devices=16),
    dict(n_devices=2, dp=1, tp=2), dict(n_devices=6, tp=4),
])
def test_mesh_shape_and_errors_match_jax(case):
    """Over the 8 CPU devices of tests/conftest.py against as many ranks
    (n_devices of them when asked for fewer): the same (dp, tp), or an
    error where JAX raises one."""
    world = min(case.get("n_devices") or 8, 8)
    try:
        jm = jmesh.create_mesh(**case)
    except ValueError:
        with pytest.raises(ValueError, match="create_mesh"):
            pmesh.mesh_shape(world, **case)
        return
    assert pmesh.mesh_shape(world, **case) == (jm.shape["dp"], jm.shape["tp"])


def test_create_mesh_world_one(monkeypatch):
    """A single process without torchrun: (1, 1) and no process group;
    tp = 2 there raises as JAX's does on one device."""
    for var in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(var, raising=False)
    m = pmesh.create_mesh(device="cpu")
    assert (m.world, m.rank, m.dp, m.tp, m.dp_rank, m.tp_rank) == (1, 0, 1, 1, 0, 0)
    assert m.dp_group is None and m.tp_group is None and m.world_group is None
    assert m.shape == {"dp": 1, "tp": 1}
    with pytest.raises(ValueError, match="dp\\*tp"):
        pmesh.create_mesh(tp=2, device="cpu")
    # rank = dp_rank * tp + tp_rank: the row-major reshape of the JAX mesh
    coords = [(Mesh(8, r, 4, 2, torch.device("cpu")).dp_rank,
               Mesh(8, r, 4, 2, torch.device("cpu")).tp_rank) for r in range(8)]
    assert coords == [(r // 2, r % 2) for r in range(8)]
    jm = jmesh.create_mesh(n_devices=8, dp=4, tp=2)
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    assert [tuple(np.argwhere(ids == r)[0]) for r in range(8)] == coords


@pytest.mark.parametrize("cfg", list(CONFIGS))
def test_param_shardings_match_jax(cfg):
    """Every parameter: the port's spec is JAX's on the torch layout, with
    both column and row shards present and every sharded dim divisible."""
    _, params = _jax_params(cfg)
    jspecs = jmesh.param_shardings(jmesh.create_mesh(n_devices=8, tp=2), params)
    models = _port_models(cfg)
    specs = pmesh.param_shardings(_fake_mesh(), models)
    shapes = {f"{n}.{k}": tuple(p.shape) for n, m in models.items()
              for k, p in m.named_parameters()}
    pairs = _pairs(params, jspecs)
    assert len(pairs) == len(specs) and {p for _, _, p in pairs} == set(specs)
    kinds = {"col": 0, "row": 0}
    flat = traverse_util.flatten_dict(params, sep="/")
    for key, spec, port in pairs:
        got = specs[port]
        if spec == P():
            assert got is None, (key, got)
        elif spec == P(None, "tp"):
            kinds["col"] += 1
            pairs_ = 2 if "proj_geglu" in key else 1
            assert got == TPShard(0, pairs_), (key, got)
            assert shapes[port][0] == flat[key].shape[-1]
            assert shapes[port][0] % (2 * pairs_) == 0, key
        else:
            assert spec == P("tp", None), (key, spec)
            kinds["row"] += 1
            assert got == TPShard(1), (key, got)
            assert shapes[port][1] == flat[key].shape[0] and shapes[port][1] % 2 == 0
    assert kinds["col"] > 0 and kinds["row"] > 0
    # the intended kernels are among them (tests/test_tp.py:68-76)
    for pattern, want in (("attn1.to_q.weight", TPShard(0)), ("ff.net.0.proj.weight",
                                                               TPShard(0, 2)),
                          ("attn1.to_out.0.weight", TPShard(1)), ("ff.net.2.weight", TPShard(1)),
                          ("proj1.weight", TPShard(0)), ("proj3.weight", TPShard(1))):
        assert any(k.endswith(pattern) and s == want for k, s in specs.items()), pattern
    # tp = 1: nothing is sharded
    assert not any(pmesh.param_shardings(_fake_mesh(1), models).values())


def test_opt_state_shardings_mirror_params():
    """The trainer's state specs (`_entry_specs`, through
    `opt_state_shardings`): AdamW's moments, the f32 masters and the
    gradient sums take their parameters' specs, as JAX's mu/nu take
    theirs; the step counts are replicated."""
    jpipe, params = _jax_params("tiny")
    jtr = JTrainer(jpipe)
    jtrain, _ = j_partition(params)
    jmesh_ = jmesh.create_mesh(n_devices=8, tp=2)
    jopt = jmesh.opt_state_shardings(jmesh_, jax.eval_shape(jtr.tx.init, jtrain), jtrain)
    jmu = traverse_util.flatten_dict(jopt[1][0].mu, sep="/")

    models = _port_models("tiny", "cpu")
    pipe = Pose2VideoPipeline(**models, context_size=4)
    pipe.shard_(_fake_mesh())
    trainer = Stage2Trainer(pipe)
    state = trainer.init_state()
    got = trainer._entry_specs(state)
    pspecs = trainer.specs()
    per_param = ("trainable", "master", "adamw/m", "adamw/v", "grad_acc")
    assert set(got) == ({f"{s}/{n}" for s in per_param for n in state.masters}
                        | {f"frozen/{n}" for n in state.frozen})
    tree = trainer._local_tree(state)
    assert set(tree) - set(got) == {"step", "adamw/step"}
    for n in state.masters:
        assert all(got[f"{s}/{n}"] == pspecs[n] for s in per_param), n
    # against JAX's moments, leaf by leaf
    train, _ = partition_params(pipe)
    assert set(train) == set(state.masters)
    want = {}
    for key, spec in jmu.items():
        model, rest = key.split("/params/", 1)
        want[f"{model}.{PIPELINE_MAPPERS[model](rest)}"] = spec.spec
    assert set(want) == set(state.masters)
    for n, spec in want.items():
        assert (got[f"adamw/m/{n}"] is None) == (spec == P()), n
    assert sum(s is not None for s in got.values()) > 0


def test_geglu_half_pair_split():
    """proj_geglu's [hidden | gate] columns: rank r keeps hidden[r] and
    gate[r] (not a contiguous half), its bias stays whole, and the ranks'
    partial FeedForward outputs add up to the unsharded one."""
    torch.manual_seed(0)
    dim, tp = 8, 2
    ff = FeedForward(dim)
    for p in ff.parameters():
        p.data.normal_(0, 0.3)
    x = torch.randn(3, 5, dim)
    want = ff(x)
    inner = 4 * dim
    w, b = ff.net[0].proj.weight.detach(), ff.net[0].proj.bias.detach()
    outs = []
    for rank in range(tp):
        mesh = _fake_mesh(tp, rank)
        part = copy.deepcopy(ff)
        specs = pmesh.shard_({"ff": part}, mesh)
        assert specs["ff.net.0.proj.weight"] == TPShard(0, 2)
        assert specs["ff.net.2.weight"] == TPShard(1)
        n = inner // tp
        lw = part.net[0].proj.weight
        assert torch.equal(lw[:n], w[rank * n:(rank + 1) * n])
        assert torch.equal(lw[n:], w[inner + rank * n:inner + (rank + 1) * n])
        assert torch.equal(part.net[0].proj.bias, b)
        assert torch.equal(part.net[2].weight, ff.net[2].weight[:, rank * n:(rank + 1) * n])
        # full_tensor's inverse: the rank's slice of the whole tensor
        assert torch.equal(pmesh.local_slice(w, TPShard(0, 2), mesh), lw)
        with torch.no_grad():
            outs.append(part(x))   # no group: the reduce is the identity
    # each rank's output is its partial sum + the bias once
    got = sum(outs) - (tp - 1) * ff.net[2].bias
    close(got.detach(), want.detach(), rtol=1e-5, atol=1e-5)


def test_shard_batch_rows():
    """Rank d of dp keeps rows [d k, (d + 1) k) of every tensor of a nested
    batch; a batch dp does not divide raises."""
    batch = {"a": torch.arange(8).reshape(4, 2), "m": [(torch.arange(4),)], "n": 3}
    for d in range(2):
        got = pmesh.shard_batch(Mesh(4, 2 * d, 2, 2, torch.device("cpu")), batch)
        assert torch.equal(got["a"], batch["a"][2 * d:2 * d + 2])
        assert torch.equal(got["m"][0][0], torch.arange(4)[2 * d:2 * d + 2])
        assert got["n"] == 3
    with pytest.raises(ValueError, match="does not split"):
        pmesh.shard_batch(Mesh(3, 0, 3, 1, torch.device("cpu")), batch)
