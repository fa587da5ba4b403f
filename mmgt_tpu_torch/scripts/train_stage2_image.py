"""Stage-2 process-1 training on the card, the single-image pretrain of the
spatial nets: the port's counterpart of `scripts/train_stage2_image.py`
(reference train_stage_1.py:283-615). Trains the denoiser without motion
or audio modules, the ReferenceNet minus its last up block and the
PoseGuider on (reference, target, pose) pairs, 256^2, batch 4.

    python -m mmgt_tpu_torch.scripts.train_stage2_image --meta meta.json \\
        [--config cfg.json] [--weights_dir DIR] [--batch_size 4] \\
        [--max_steps N] [--checkpoint_dir DIR] [--size 256] [--resume] \\
        [--tiny] [--mesh_dp N] [--mesh_tp N] [--device cuda]

`--meta`: JSON lists of packed .npz records (`data/datasets.py`,
`HumanDanceDataset`). `--weights_dir` loads the VAE, ReferenceNet,
PoseGuider and CLIP from a reference-layout directory
(`utils/weights.load_all_weights`); the denoiser keeps its seeded random
weights, as in the JAX CLI. Without CLIP weights the CLIP context is zeros.
`--tiny` trains tiny nets (smoke runs and tests). Each step logs to
`<checkpoint_dir>/train_stage2_image.jsonl`; checkpoints
(`utils/checkpoint.py`) every `checkpointing_steps` and at the end.

Under `torchrun --nproc_per_node N` it trains on the mesh of the config's
`mesh_dp` x `mesh_tp` (`--mesh_dp` / `--mesh_tp`), as the video CLI
(`scripts/train_stage2.py`): batches of max(batch_size, dp) rows, each
rank's rows of the same data order, rank 0 alone logging and writing. A
single process without torchrun trains on one card as before.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import torch


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--meta", nargs="+", required=True, help="meta JSON paths")
    ap.add_argument("--config", default=None)
    ap.add_argument("--weights_dir", default=None)
    ap.add_argument("--batch_size", type=int, default=None)
    ap.add_argument("--max_steps", type=int, default=None)
    ap.add_argument("--checkpoint_dir", default=None)
    ap.add_argument("--size", type=int, default=None, help="train resolution")
    ap.add_argument("--resume", action="store_true")
    ap.add_argument("--tiny", action="store_true", help="tiny nets (smoke runs, tests)")
    ap.add_argument("--mesh_dp", type=int, default=None, help="data-parallel ranks")
    ap.add_argument("--mesh_tp", type=int, default=None, help="tensor-parallel ranks")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def config_from_args(args):
    from mmgt_tpu_torch.config import Stage2ImageTrainConfig, load_config

    overrides = {k: v for k, v in (
        ("batch_size", args.batch_size), ("max_train_steps", args.max_steps),
        ("checkpoint_dir", args.checkpoint_dir), ("meta_paths", args.meta),
        ("mesh_dp", args.mesh_dp), ("mesh_tp", args.mesh_tp)) if v is not None}
    if args.size:
        overrides["train_width"] = overrides["train_height"] = args.size
    return load_config(Stage2ImageTrainConfig, args.config, **overrides)


def tiny_pipeline(device, dtype=torch.float32, seed: int = 0):
    """The JAX CLI's --tiny nets (`mmgt_tpu_torch/testing.py`'s DRILL):
    UNets (16, 32, 32, 32) with 4 heads, a (16, 16, 32, 32) VAE, a (4, 8,
    8, 16) PoseGuider; seeded weights."""
    from mmgt_tpu_torch.pipelines.pose2img import Pose2ImagePipeline
    from mmgt_tpu_torch.testing import DRILL, stage2_model

    pipe = Pose2ImagePipeline(
        vae=stage2_model(DRILL, "vae"), reference_unet=stage2_model(DRILL, "reference_unet"),
        denoising_unet=stage2_model(DRILL, "denoising_unet", use_motion_module=False,
                                    use_audio_module=False),
        pose_guider=stage2_model(DRILL, "pose_guider"))
    for m in pipe.models().values():
        m.to(device=device, dtype=dtype)
    pipe.init_params(seed, std=0.05)
    return pipe


def build(cfg, device=None, seed: int = 0, weights_dir: Optional[str] = None,
          tiny: bool = False):
    """(trainer, CLIP model or None): the image trainer in bf16 on `device`
    (the card unless the caller asks for the CPU; f32 when `tiny`) with the
    config's hyper-parameters; whole tensors (`main` then keeps this rank's
    slices)."""
    from mmgt_tpu_torch.device import resolve_device
    from mmgt_tpu_torch.training.stage2_image import Stage2ImageTrainer

    hyper = dict(learning_rate=cfg.learning_rate, weight_decay=cfg.weight_decay,
                 max_grad_norm=cfg.max_grad_norm, snr_gamma=cfg.snr_gamma,
                 noise_offset=cfg.noise_offset, uncond_ratio=cfg.uncond_ratio)
    if tiny:
        trainer = Stage2ImageTrainer(tiny_pipeline(resolve_device(device), seed=seed), **hyper)
    else:
        trainer = Stage2ImageTrainer.build(torch.bfloat16, device, seed, **hyper)
    clip_model = load_spatial_weights(weights_dir, trainer.pipeline) if weights_dir else None
    return trainer, clip_model


def load_spatial_weights(weights_dir: str, pipe):
    """The VAE, ReferenceNet and PoseGuider of a reference-layout
    directory into `pipe` (through a full Stage-2 pipeline, as
    `load_all_weights` fills one); returns the CLIP model it found, or
    None."""
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
    from mmgt_tpu_torch.training.stage1 import SMGA
    from mmgt_tpu_torch.utils.weights import load_all_weights

    full = Pose2VideoPipeline.build(pipe.dtype, pipe.device)
    with torch.device("meta"):
        smga = SMGA()
    smga.model.to_empty(device=pipe.device)
    loaded = load_all_weights(weights_dir, full, smga, pipe.device)
    for name in ("vae", "reference_unet", "pose_guider"):
        getattr(pipe, name).load_state_dict(getattr(full, name).state_dict())
    del full, smga
    return loaded.get("clip_model")


def run(trainer, dataset, cfg, clip_model=None, state=None, resume: bool = False,
        on_step=None):
    """Train until `cfg.max_train_steps` on batches of `dataset` (a
    `HumanDanceDataset`); `state` defaults to `trainer.init_state()`, and
    `resume` first restores the latest checkpoint of `cfg.checkpoint_dir`.
    On the trainer's mesh: batches of max(batch_size, dp) rows, the same
    on every rank; rank 0 logs and writes. Returns the state."""
    from mmgt_tpu_torch.training.loop import fit
    from mmgt_tpu_torch.training.stage2 import encode_clip_batch
    from mmgt_tpu_torch.utils.checkpoint import CheckpointManager
    from mmgt_tpu_torch.utils.metrics import MetricsLogger

    dev, mesh = trainer.pipeline.device, trainer.mesh
    bs = max(cfg.batch_size, 1 if mesh is None else mesh.dp)
    state = trainer.init_state() if state is None else state
    mgr = CheckpointManager(cfg.checkpoint_dir, max_to_keep=5, mesh=mesh)
    if resume and mgr.latest_step() is not None:
        print(f"resumed from step {trainer.restore(state, mgr)}")

    def batches():
        for raw in dataset.batches(bs, cfg.seed + state.step):
            batch = {k: torch.from_numpy(raw[k]).to(dev)
                     for k in ("tgt_image", "ref_image", "tgt_pose")}
            batch["clip_embed"] = encode_clip_batch(clip_model,
                                                    torch.from_numpy(raw["clip_image"]).to(dev))
            yield batch

    mlog = MetricsLogger(cfg.checkpoint_dir, "train_stage2_image",
                         enabled=mesh is None or mesh.rank == 0)
    try:
        return fit(trainer, state, batches(), cfg.max_train_steps, mgr, mlog,
                   cfg.checkpointing_steps, dev, cfg.seed, on_step=on_step)
    finally:
        mlog.close()


def main(argv=None) -> int:
    args = parse_args(argv)
    from mmgt_tpu_torch.data.datasets import HumanDanceDataset
    from mmgt_tpu_torch.device import disable_tf32
    from mmgt_tpu_torch.parallel.mesh import create_mesh, destroy

    cfg = config_from_args(args)
    disable_tf32()
    mesh = create_mesh(dp=cfg.mesh_dp, tp=cfg.mesh_tp, device=args.device)
    trainer, clip_model = build(cfg, mesh.device, cfg.seed, args.weights_dir, args.tiny)
    trainer.pipeline.shard_(mesh)
    ds = HumanDanceDataset(cfg.meta_paths, cfg.sample_margin)
    print(f"dataset: {len(ds)} records")
    t0 = time.time()
    state = run(trainer, ds, cfg, clip_model, resume=args.resume)
    print(f"done: step {state.step} in {time.time() - t0:.0f}s")
    destroy(mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
