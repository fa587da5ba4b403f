"""Ranks in processes of one host without torchrun: `spawn(fn, world, ...)`
starts `world` processes (`torch.multiprocessing.spawn`), each calling
`fn(mesh_args, *args)` where `mesh_args` holds `rank`, `world_size` and a
`file://` `init_method` under `store_dir`, ready for `create_mesh(**mesh_args,
...)`. A file store needs no port, so concurrent runs do not clash. It
raises if any rank raises or exits non-zero; the tests and the one-card
smoke run use it, a multi-card run starts under torchrun instead."""
from __future__ import annotations

import os

import torch


def _entry(rank: int, fn, world: int, init_method: str, args: tuple) -> None:
    fn(dict(rank=rank, world_size=world, init_method=init_method), *args)


def spawn(fn, world: int, store_dir: str, *args) -> None:
    store = os.path.join(store_dir, "store")
    if os.path.exists(store):
        os.remove(store)
    torch.multiprocessing.spawn(_entry, args=(fn, world, f"file://{store}", args),
                                nprocs=world, join=True)
