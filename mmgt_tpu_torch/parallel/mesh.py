"""The ("dp", "tp") mesh on `torch.distributed` (`mmgt_tpu/parallel/mesh.py`).

Axes, as in the JAX package:
  * "dp": data parallel. Training splits the global batch's rows over it
    and sums the gradients; inference splits the context windows of each
    denoise step over it (each window's CFG pair stays on one rank);
  * "tp": Megatron tensor parallelism on attention heads and FFN columns,
    by the JAX package's rules (`_TP_COL`, `_TP_ROW`), applied to each
    port parameter's flax name (`flax_parent`).

Rank r = dp_rank * tp + tp_rank, the row-major reshape of the JAX mesh. A
mesh is read from the torchrun environment (`RANK`, `WORLD_SIZE`,
`LOCAL_RANK`) or given `rank` / `world_size`; a single process started
without torchrun needs no process group. Each rank computes on
`cuda:LOCAL_RANK` unless given a device.

JAX shards through global-view annotations and XLA inserts the
collectives; here the sharding is explicit. `shard_` keeps each rank's
slice of every tensor-parallel weight in place and hands the mesh to the
modules, which then run on their local heads and complete their partial
sums (`parallel/collectives.py`). A flax column spec P(None, "tp") on an
(in, out) kernel shards dim 0 of the torch `Linear.weight` (out, in); a
row spec P("tp", None) shards dim 1. 1-D leaves (biases, norm scales) stay
replicated as in `_spec_for`; a column layer slices its bias when it
computes. GEGLU's `proj_geglu` holds [hidden | gate] on its 2 * inner
outputs, so its shard takes the same slice of each half (`pairs = 2`):
rank r holds hidden[r] and gate[r].
"""
from __future__ import annotations

import dataclasses
import datetime
import os
import re
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist
from torch import nn

from mmgt_tpu_torch.device import resolve_device
from mmgt_tpu_torch.parallel.collectives import all_reduce_


# ------------------------------------------------------------- the mesh
@dataclasses.dataclass(frozen=True)
class TPShard:
    """A tensor-parallel shard: `dim` split over tp, in `pairs` equal
    parts that are each split alike."""

    dim: int
    pairs: int = 1


@dataclasses.dataclass(eq=False)
class Mesh:
    world: int
    rank: int
    dp: int
    tp: int
    device: torch.device
    dp_group: Any = None    # None where the axis has one rank
    tp_group: Any = None
    world_group: Any = None

    @property
    def dp_rank(self) -> int:
        return self.rank // self.tp

    @property
    def tp_rank(self) -> int:
        return self.rank % self.tp

    @property
    def shape(self) -> Dict[str, int]:
        return {"dp": self.dp, "tp": self.tp}

    def barrier(self) -> None:
        """Every rank has reached this point (an `all_reduce`)."""
        if self.world_group is not None:
            all_reduce_(torch.zeros(1, device=self.device), self.world_group)


def mesh_shape(world: int, n_devices: Optional[int] = None, dp: Optional[int] = None,
               tp: int = 1) -> Tuple[int, int]:
    """(dp, tp) over `world` ranks, raising where `mmgt_tpu/parallel/
    mesh.py:create_mesh` raises: fewer ranks than `n_devices`, or dp * tp
    not the rank count (dp inferred as n // tp)."""
    if n_devices is not None:
        if world < n_devices:
            raise ValueError(
                f"create_mesh: asked for n_devices={n_devices} but only {world} rank(s) "
                "are running; start the program under `torchrun --nproc_per_node N` (or "
                "pass rank/world_size) for a mesh of N ranks.")
        if world > n_devices:
            raise ValueError(f"create_mesh: a mesh of n_devices={n_devices} needs as many "
                             f"ranks, {world} are running")
    n = world if n_devices is None else n_devices
    if dp is None:
        dp = n // tp
    if dp < 1 or dp * tp != n:
        raise ValueError(
            f"create_mesh: dp*tp must equal the device count, got dp={dp} tp={tp} over {n} "
            f"device(s). Pick tp dividing {n} (dp is then inferred as {n}//tp) or pass dp "
            "explicitly.")
    return dp, tp


def create_mesh(n_devices: Optional[int] = None, dp: Optional[int] = None, tp: int = 1,
                device=None, backend: Optional[str] = None, init_method: Optional[str] = None,
                rank: Optional[int] = None, world_size: Optional[int] = None,
                timeout_s: float = 600.0) -> Mesh:
    """A ("dp", "tp") mesh over the running ranks. `rank` / `world_size`
    default to the torchrun environment; `device` to `cuda:LOCAL_RANK`
    (raising without a card: pass device="cpu" for the plain path);
    `backend` to nccl on a card and gloo on the CPU; `init_method` to
    `env://`. A single process started without torchrun (no WORLD_SIZE)
    joins no process group; under torchrun, or given `world_size`, every
    rank joins one, one rank included. Collectives that wait longer than
    `timeout_s` raise."""
    env = os.environ
    launched = world_size is not None or "WORLD_SIZE" in env
    world = int(env.get("WORLD_SIZE", 1)) if world_size is None else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    dp, tp = mesh_shape(world, n_devices, dp, tp)
    if device is None:
        device = f"cuda:{int(env.get('LOCAL_RANK', rank))}"
    device = resolve_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = Mesh(world, rank, dp, tp, device)
    if not launched:
        return mesh
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if device.type == "cuda" else "gloo"),
            init_method=init_method or "env://", world_size=world, rank=rank,
            timeout=datetime.timedelta(seconds=timeout_s))
    mesh.world_group = dist.group.WORLD
    # every rank creates every group, in the same order
    for t in range(tp):
        g = dist.new_group([d * tp + t for d in range(dp)])
        if dp > 1 and t == mesh.tp_rank:
            mesh.dp_group = g
    for d in range(dp):
        g = dist.new_group([d * tp + t for t in range(tp)])
        if tp > 1 and d == mesh.dp_rank:
            mesh.tp_group = g
    return mesh


def destroy(mesh: Optional[Mesh]) -> None:
    """Leave the mesh's process group, if it joined one."""
    if mesh is not None and mesh.world_group is not None and dist.is_initialized():
        dist.destroy_process_group()


# ------------------------------------------------------------- the rules
# The JAX package's rules, copied (`mmgt_tpu/parallel/mesh.py:77-78`):
# q/k/v and FFN-in kernels shard their OUTPUT dim over "tp"; attention-out
# and FFN-out kernels shard their INPUT dim (row parallel), so each block
# is a Megatron column -> row pair with one reduce.
_TP_COL = re.compile(r"(to_q|to_k|to_v|proj_geglu|proj1|proj2)$")
_TP_ROW = re.compile(r"(to_out|proj_out|proj3)$")


def _spec_for(path: Tuple[str, ...], shape: Tuple[int, ...], tp_enabled: bool) -> tuple:
    """The JAX partition spec of a flax leaf, as a tuple (`mesh.py:81-92`)."""
    if not tp_enabled or len(shape) < 2:
        return ()
    *parents, leaf = path
    parent = parents[-1] if parents else ""
    if leaf == "kernel":
        if _TP_COL.search(parent):
            return (*([None] * (len(shape) - 1)), "tp")
        if _TP_ROW.search(parent):
            return ("tp", *([None] * (len(shape) - 1)))
    return ()


def flax_parent(key: str) -> Tuple[str, str]:
    """(flax parent module name, flax leaf name) of a port state-dict key:
    the inverse of `utils/convert.py:_tx_block_suffix` and `_leaf` on the
    last two names (`to_out.0` -> `to_out`, `ff.net.0.proj` ->
    `proj_geglu`, `ff.net.2` -> `proj_out`; a 2-D or 4-D `weight` is a
    kernel)."""
    *parts, leaf = key.split(".")
    if parts[-2:] == ["to_out", "0"]:
        parent = "to_out"
    elif parts[-3:] == ["net", "0", "proj"]:
        parent = "proj_geglu"
    elif parts[-2:] == ["net", "2"]:
        parent = "proj_out"
    else:
        parent = parts[-1] if parts else ""
    return parent, {"weight": "kernel"}.get(leaf, leaf)


def port_spec(key: str, shape: Tuple[int, ...], tp_enabled: bool) -> Optional[TPShard]:
    """The shard of a port parameter: the JAX spec of its flax name, on the
    torch layout (column -> dim 0, row -> dim 1 of a Linear weight)."""
    parent, leaf = flax_parent(key)
    # the JAX kernel is (in, out): the torch weight's dims reversed
    spec = _spec_for((parent, leaf), tuple(reversed(shape)), tp_enabled)
    if not spec:
        return None
    if spec[-1] == "tp":
        return TPShard(0, 2 if parent == "proj_geglu" else 1)
    return TPShard(1)


def param_shardings(mesh: Mesh, models: Mapping[str, nn.Module]) -> Dict[str, Optional[TPShard]]:
    """{"<model>.<key>": TPShard or None} for every parameter of `models`."""
    tp_enabled = mesh.tp > 1
    return {f"{name}.{key}": port_spec(key, tuple(p.shape), tp_enabled)
            for name, model in models.items() for key, p in model.named_parameters()}


def opt_state_shardings(param_specs: Mapping[str, Optional[TPShard]], states: Sequence[str]
                        ) -> Dict[str, Optional[TPShard]]:
    """Specs of an optimizer's per-parameter state, as JAX's state
    subtrees that mirror the parameters take their shardings: each of
    `states` (AdamW's moments, the f32 masters, the gradient sums) holds
    one tensor per parameter of `param_specs` and takes its spec, keyed
    "<state>/<name>"; what is not listed (the step) is replicated. Moments
    are 2-3x the parameter bytes, so replicating them would forfeit the
    memory tp exists to save."""
    return {f"{s}/{n}": spec for s in states for n, spec in param_specs.items()}


# ------------------------------------------------------------- tensors
def _split_view(t: torch.Tensor, spec: TPShard, tp: int) -> torch.Tensor:
    n = t.shape[spec.dim]
    return t.unflatten(spec.dim, (spec.pairs, tp, n // (spec.pairs * tp)))


def local_slice(t: torch.Tensor, spec: Optional[TPShard], mesh: Mesh) -> torch.Tensor:
    """This rank's shard of the whole tensor `t` (contiguous)."""
    if spec is None or mesh.tp == 1:
        return t
    v = _split_view(t, spec, mesh.tp).select(spec.dim + 1, mesh.tp_rank)
    return v.flatten(spec.dim, spec.dim + 1).contiguous()


def empty_full(t: torch.Tensor, spec: Optional[TPShard], mesh: Mesh,
               device=None) -> torch.Tensor:
    """An uninitialised whole tensor for the shard `t`, on `device`
    (default: t's)."""
    shape = list(t.shape)
    shape[spec.dim] *= mesh.tp
    return t.new_empty(shape, device=t.device if device is None else device)


def full_tensor(t: torch.Tensor, spec: Optional[TPShard], mesh: Mesh) -> torch.Tensor:
    """The whole tensor from every tp rank's shard (an `all_reduce` of a
    zero-filled buffer)."""
    if spec is None or mesh.tp == 1:
        return t
    buf = empty_full(t, spec, mesh).zero_()
    _split_view(buf, spec, mesh.tp).select(spec.dim + 1, mesh.tp_rank).copy_(
        t.unflatten(spec.dim, (spec.pairs, -1)))
    return all_reduce_(buf, mesh.tp_group)


@torch.no_grad()
def shard_(models: Mapping[str, nn.Module], mesh: Optional[Mesh]) -> Dict[str, Optional[TPShard]]:
    """Keep this rank's slice of every tensor-parallel weight of `models`, in
    place, and hand the mesh to every module (`module.tp`; a sharded
    Linear also gets its `tp_shard`). Returns `param_shardings`."""
    if mesh is None or mesh.tp == 1:
        return {} if mesh is None else param_shardings(mesh, models)
    specs = param_shardings(mesh, models)
    for name, model in models.items():
        keys = {id(p): k for k, p in model.named_parameters()}
        for mod in model.modules():
            mod.tp = mesh
            for p in mod.parameters(recurse=False):
                spec = specs[f"{name}.{keys[id(p)]}"]
                if spec is not None:
                    p.data = local_slice(p.data, spec, mesh)
                    mod.tp_shard = spec
    return specs


def shard_batch(mesh: Optional[Mesh], tree, axis: int = 0):
    """This dp rank's rows of a global batch: every tensor of `tree`
    (nested dicts, lists, tuples) split on `axis` into dp equal parts."""
    if mesh is None or mesh.dp == 1:
        return tree
    if isinstance(tree, dict):
        return {k: shard_batch(mesh, v, axis) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(shard_batch(mesh, v, axis) for v in tree)
    if torch.is_tensor(tree):
        n = tree.shape[axis]
        if n % mesh.dp:
            raise ValueError(f"a batch of {n} rows does not split over dp = {mesh.dp}")
        k = n // mesh.dp
        return tree.narrow(axis, mesh.dp_rank * k, k)
    return tree


def dp_mean(mesh, metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The dp ranks' mean of each scalar metric (equal row counts: the
    global batch's mean)."""
    if mesh is None or mesh.dp == 1:
        return metrics
    keys = sorted(metrics)
    vals = torch.stack([metrics[k].float().reshape(()) for k in keys])
    all_reduce_(vals, mesh.dp_group)
    return {k: v / mesh.dp for k, v in zip(keys, vals)}
