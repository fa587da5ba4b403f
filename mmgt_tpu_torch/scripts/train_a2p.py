"""Stage-1 (SMGA, audio -> pose) training on the card: the port's
counterpart of `scripts/train_a2p.py` (reference train_a2p.py +
SMGA.train_loop, SMGA.py:137-316): Adan + EMA steps on the GestureDecoder
in f32, over epochs of a `GestureDataset` directory.

    python -m mmgt_tpu_torch.scripts.train_a2p --data_dir DIR [--config cfg.json] \\
        [--batch_size 128] [--epochs N] [--feature_type wavlm|baseline] \\
        [--checkpoint_dir DIR] [--resume] [--device cuda]

`--data_dir` holds `keypoints/*.npy` (T, 402) and `wavlm_feats/*.npy`
(T, 1059) or `baseline_feats/*.npy` (T, 35). An epoch is max(len // batch,
1) steps; the metrics are logged after the first step and every tenth epoch,
checkpoints (`utils/checkpoint.py`) every `checkpoint_every_epochs` epochs
and at the end. A resumed run stops at the same total step as an
uninterrupted one. f32 work runs in full f32, not TF32.

Under `torchrun --nproc_per_node N` every rank is a data-parallel rank, as
the JAX CLI's `create_mesh()`: the batch is max(batch_size // N * N, N)
rows of the same data order, each rank keeps its rows, the gradients are
averaged and the Adan and EMA state stays identical on every rank; rank 0
alone logs and writes. A single process without torchrun trains on one
card as before.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--data_dir", required=True)
    ap.add_argument("--config", default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--epochs", type=int, default=None)
    ap.add_argument("--feature_type", default=None)
    ap.add_argument("--checkpoint_dir", default=None)
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def config_from_args(args):
    from mmgt_tpu_torch.config import Stage1TrainConfig, load_config

    overrides = {k: v for k, v in (
        ("batch_size", args.batch_size), ("epochs", args.epochs),
        ("feature_type", args.feature_type), ("checkpoint_dir", args.checkpoint_dir),
        ("data_dir", args.data_dir)) if v is not None}
    return load_config(Stage1TrainConfig, args.config, **overrides)


def build(cfg, device=None, seed: int = 0):
    """The SMGA bundle in f32 on `device` (the card unless the caller asks
    for the CPU) with seeded random weights and the config's
    hyper-parameters."""
    from mmgt_tpu_torch.training.stage1 import SMGA

    return SMGA.build(device, seed, feature_type=cfg.feature_type,
                      learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                      ema_decay=cfg.ema_decay, guidance_weight=cfg.guidance_weight,
                      cond_drop_prob=cfg.cond_drop_prob)


def run(smga, dataset, cfg, state=None, resume: bool = False, on_step=None):
    """Train `cfg.epochs` epochs of `dataset` (a `GestureDataset`) of
    max(len // batch_size, 1) steps each; `state` defaults to
    `smga.init_state()`, and `resume` first restores the latest checkpoint
    of `cfg.checkpoint_dir`. On the SMGA's mesh the batch is rounded to
    max(batch_size // dp * dp, dp) rows. Returns the state."""
    from mmgt_tpu_torch.training.loop import fit
    from mmgt_tpu_torch.utils.checkpoint import CheckpointManager
    from mmgt_tpu_torch.utils.metrics import MetricsLogger

    dev, mesh = smga.device, smga.mesh
    dp = 1 if mesh is None else mesh.dp
    bs = max(cfg.batch_size // dp * dp, dp)
    state = smga.init_state() if state is None else state
    mgr = CheckpointManager(cfg.checkpoint_dir, mesh=mesh)
    if resume and mgr.latest_step() is not None:
        print(f"resumed from step {smga.restore(state, mgr)}")
    per_epoch = max(len(dataset) // bs, 1)

    def batches():
        for raw in dataset.batches(bs, cfg.seed + state.step):
            yield {k: torch.from_numpy(v).to(dev) for k, v in raw.items()}

    mlog = MetricsLogger(cfg.checkpoint_dir, "train_a2p", enabled=mesh is None or mesh.rank == 0)
    try:
        return fit(smga, state, batches(), cfg.epochs * per_epoch, mgr, mlog,
                   cfg.checkpoint_every_epochs * per_epoch, dev, cfg.seed,
                   log_every=10 * per_epoch, on_step=on_step,
                   log_fields=lambda step: {"epoch": -(-step // per_epoch)})
    finally:
        mlog.close()


def main(argv=None) -> int:
    args = parse_args(argv)
    from mmgt_tpu_torch.data.datasets import GestureDataset
    from mmgt_tpu_torch.device import disable_tf32
    from mmgt_tpu_torch.parallel.mesh import create_mesh, destroy

    cfg = config_from_args(args)
    disable_tf32()
    mesh = create_mesh(device=args.device)
    smga = build(cfg, mesh.device, cfg.seed)
    smga.mesh = mesh
    ds = GestureDataset(cfg.data_dir, cfg.feature_type)
    print(f"dataset: {len(ds)} clips")
    t0 = time.time()
    state = run(smga, ds, cfg, resume=args.resume)
    print(f"done: step {state.step} in {time.time() - t0:.0f}s")
    destroy(mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
