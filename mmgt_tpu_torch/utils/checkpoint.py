"""Training checkpoints (`mmgt_tpu/utils/checkpoint.py`, which is orbax in
the JAX package; the reference's keep-recent scheme, train_stage_2.py:
942-1029, src/utils/util.py:60-74, SMGA.py:305-313).

One file per step, `ckpt-<step>.ckpt`, in this package's own format: the
8 bytes `MMGTCKP1`, the length of a JSON header (8 bytes, little endian),
the header (per entry its name and either an int value or a tensor's dtype,
shape, offset and size), then each tensor's raw bytes at a 64-byte
aligned offset. No pickle: a file is read with numpy alone, and a tensor
is copied from it straight into its target, one at a time.

A state is a flat {name: tensor or int} tree (`checkpoint_tree` of the
trainers). Leaves are stored and restored BY NAME, as the JAX package's
`_save_np`: a restore into a tree whose names, shapes or dtypes differ
from the file's raises, listing what differs. `restore` copies each tensor
in place into the target's own tensor, on its device, and returns the
ints. JAX's orbax checkpoints are not read.

Pruning after each save: the newest `max_to_keep` files stay, and so does
every older one whose step is a multiple of `keep_period` (orbax's rule).

On a mesh (`mesh`), every rank calls `save` with the same whole-size tree
(the trainers gather their shards first); rank 0 alone writes and prunes,
and the others wait until the file is complete. Every rank restores from
the same path, which must be one the ranks share.
"""
from __future__ import annotations

import json
import os
import struct
from pathlib import Path
from typing import Dict, List, Mapping, Optional, Union

import numpy as np
import torch

MAGIC = b"MMGTCKP1"
ALIGN = 64
Tree = Mapping[str, Union[torch.Tensor, int]]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).split(".", 1)[1]


class CheckpointManager:
    def __init__(self, directory: str, max_to_keep: Optional[int] = 5,
                 keep_period: Optional[int] = None, mesh=None):
        self.directory = Path(directory)
        self.directory.mkdir(parents=True, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.keep_period = keep_period
        self.mesh = mesh

    def path(self, step: int) -> Path:
        return self.directory / f"ckpt-{step}.ckpt"

    def all_steps(self) -> List[int]:
        return sorted(int(p.stem.split("-", 1)[1]) for p in self.directory.glob("ckpt-*.ckpt"))

    def latest_step(self) -> Optional[int]:
        steps = self.all_steps()
        return steps[-1] if steps else None

    # ---------------------------------------------------------------- save
    def save(self, step: int, tree: Tree) -> Path:
        """Write `tree` as checkpoint `step` (through a temporary file, so a
        cut write leaves no checkpoint behind), then prune; on a mesh rank
        0 writes and every rank returns once the file is there."""
        if self.mesh is not None and self.mesh.rank != 0:
            self.mesh.barrier()
            return self.path(step)
        entries, offset = [], 0
        for name, value in tree.items():
            if isinstance(value, torch.Tensor):
                nb = value.numel() * value.element_size()
                entries.append({"name": name, "dtype": _dtype_name(value.dtype),
                                "shape": list(value.shape), "offset": offset, "nbytes": nb})
                offset += -(-nb // ALIGN) * ALIGN
            else:
                entries.append({"name": name, "int": int(value)})
        header = json.dumps({"step": int(step), "entries": entries}).encode()
        base = -(-(len(MAGIC) + 8 + len(header)) // ALIGN) * ALIGN
        tmp = self.path(step).with_suffix(".tmp")
        with open(tmp, "wb") as f:
            f.write(MAGIC + struct.pack("<Q", len(header)) + header)
            for e in entries:
                if "int" in e:
                    continue
                t = tree[e["name"]].detach().contiguous().cpu().reshape(-1)
                f.seek(base + e["offset"])
                f.write(memoryview(t.view(torch.uint8).numpy()))
        os.replace(tmp, self.path(step))
        self._prune()
        if self.mesh is not None:
            self.mesh.barrier()
        return self.path(step)

    def _prune(self) -> None:
        if self.max_to_keep is None:
            return
        steps = self.all_steps()
        for s in steps[:-self.max_to_keep] if self.max_to_keep > 0 else steps:
            if self.keep_period is None or s % self.keep_period:
                self.path(s).unlink()

    # ------------------------------------------------------------- restore
    @staticmethod
    def _read_header(path: Path):
        """(header, byte offset of the payload)."""
        with open(path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                raise ValueError(f"{path} is not a checkpoint of this package")
            (n,) = struct.unpack("<Q", f.read(8))
            header = json.loads(f.read(n))
        return header, -(-(len(MAGIC) + 8 + n) // ALIGN) * ALIGN

    def restore(self, target: Tree, step: Optional[int] = None) -> Dict[str, Union[torch.Tensor, int]]:
        """Copy checkpoint `step` (default: the latest) into `target`'s
        tensors in place; returns {name: the target's tensor, or the
        file's int}. Raises when the names, shapes or dtypes differ."""
        if step is None:
            step = self.latest_step()
        if step is None:
            raise FileNotFoundError(f"no checkpoints in {self.directory}")
        path = self.path(step)
        header, base = self._read_header(path)
        saved = {e["name"]: e for e in header["entries"]}
        missing = [k for k in target if k not in saved]
        extra = sorted(set(saved) - set(target))
        if missing or extra:
            raise KeyError(f"checkpoint/target tree mismatch: missing {missing[:5]} extra "
                           f"{extra[:5]} (of {len(missing)}/{len(extra)})")
        bad = []
        for name, value in target.items():
            e = saved[name]
            if isinstance(value, torch.Tensor) != ("int" not in e) or (
                    isinstance(value, torch.Tensor) and (
                        e["dtype"] != _dtype_name(value.dtype) or e["shape"] != list(value.shape))):
                bad.append((name, e.get("dtype", "int"), e.get("shape"),
                            getattr(value, "dtype", "int"), getattr(value, "shape", None)))
        if bad:
            raise ValueError(f"checkpoint/target layout mismatch ({len(bad)}), e.g. "
                             f"(name, saved dtype, saved shape, target dtype, target shape) "
                             f"{bad[:3]}")
        data = np.memmap(path, dtype=np.uint8, mode="r")
        out: Dict[str, Union[torch.Tensor, int]] = {}
        with torch.no_grad():
            for name, value in target.items():
                e = saved[name]
                if "int" in e:
                    out[name] = e["int"]
                    continue
                off = base + e["offset"]
                if e["nbytes"]:
                    raw = torch.from_numpy(np.array(data[off:off + e["nbytes"]]))
                    value.copy_(raw.view(value.dtype).reshape(value.shape))
                out[name] = value
        del data
        return out
