"""Stage-2 training on the card, the temporal/audio fine-tune of the
denoiser: the port's counterpart of `scripts/train_stage2.py` (reference
train_stage_2.py:399-962). Trains the audio and motion modules and the
AudioProjModel (`training/stage2.py`) on 12-frame windows of packed clip
records, 512^2, batch 1, the denoiser checkpointed.

    python -m mmgt_tpu_torch.scripts.train_stage2 --meta meta.json \\
        [--config cfg.json] [--weights_dir DIR] [--batch_size 1] \\
        [--max_steps N] [--checkpoint_dir DIR] [--size 512] [--resume] \\
        [--val_ref face.png --val_record clip.npz [--val_every 500]] \\
        [--mesh_dp N] [--mesh_tp N] [--device cuda]

`--meta`: JSON lists of packed .npz records (`TalkingVideoDataset`).
`--weights_dir` loads every Stage-2 model and CLIP from a reference-layout
directory (`utils/weights.load_all_weights`); without it the models have
seeded random weights and the CLIP context is zeros. `--val_ref` and
`--val_record` render a validation clip (20 DDIM steps) every
`--val_every` steps into the checkpoint directory (cv2 writes it).

On several cards, under torchrun (one rank a card, `cuda:LOCAL_RANK`):

    torchrun --nproc_per_node N -m mmgt_tpu_torch.scripts.train_stage2 \\
        --meta meta.json --mesh_tp 2 ...

The mesh is the config's `mesh_dp` x `mesh_tp` (`--mesh_dp` / `--mesh_tp`
override them; dp defaults to N / tp), as the JAX CLI's
(`parallel/mesh.py`): the batch is max(batch_size, dp) rows, every rank
reads the same data order and keeps its rows, and rank 0 alone logs and
writes checkpoints. A single process started without torchrun trains on
one card as before.
"""
from __future__ import annotations

import argparse
import sys
import time
from typing import Optional

import numpy as np
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
    ap.add_argument("--val_ref", default=None, help="validation ref image")
    ap.add_argument("--val_record", default=None,
                    help="validation .npz record (pose+masks+audio)")
    ap.add_argument("--val_every", type=int, default=500)
    ap.add_argument("--mesh_dp", type=int, default=None, help="data-parallel ranks")
    ap.add_argument("--mesh_tp", type=int, default=None, help="tensor-parallel ranks")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap.parse_args(argv)


def config_from_args(args):
    from mmgt_tpu_torch.config import Stage2TrainConfig, load_config

    overrides = {k: v for k, v in (
        ("batch_size", args.batch_size), ("max_train_steps", args.max_steps),
        ("checkpoint_dir", args.checkpoint_dir), ("meta_paths", args.meta),
        ("mesh_dp", args.mesh_dp), ("mesh_tp", args.mesh_tp)) if v is not None}
    if args.size:
        overrides["train_width"] = overrides["train_height"] = args.size
    return load_config(Stage2TrainConfig, args.config, **overrides)


def build(cfg, device=None, seed: int = 0, weights_dir: Optional[str] = None):
    """(trainer, CLIP model or None): the video trainer in bf16 on `device`
    (the card unless the caller asks for the CPU), the denoiser
    checkpointed, with the config's hyper-parameters; whole tensors (`main`
    then keeps this rank's slices)."""
    from mmgt_tpu_torch.training.stage1 import SMGA
    from mmgt_tpu_torch.training.stage2 import Stage2Trainer
    from mmgt_tpu_torch.utils.weights import load_all_weights

    trainer = Stage2Trainer.build(
        torch.bfloat16, device, seed, remat=True, learning_rate=cfg.learning_rate,
        weight_decay=cfg.weight_decay, max_grad_norm=cfg.max_grad_norm,
        snr_gamma=cfg.snr_gamma, noise_offset=cfg.noise_offset,
        uncond_img_ratio=cfg.uncond_img_ratio, uncond_audio_ratio=cfg.uncond_audio_ratio,
        motion_scale=tuple(cfg.motion_scale))
    pipe, clip_model = trainer.pipeline, None
    if weights_dir:
        with torch.device("meta"):
            smga = SMGA()
        smga.model.to_empty(device=pipe.device)
        clip_model = load_all_weights(weights_dir, pipe, smga, pipe.device).get("clip_model")
    return trainer, clip_model


def run(trainer, dataset, cfg, clip_model=None, state=None, resume: bool = False,
        on_step=None):
    """Train until `cfg.max_train_steps` on batches of `dataset` (a
    `TalkingVideoDataset`); `state` defaults to `trainer.init_state()`, and
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
    as_t = lambda a: torch.from_numpy(a).to(dev)

    def batches():
        for raw in dataset.batches(bs, cfg.seed + state.step):
            yield {
                "pixel_values": as_t(raw["pixel_values"]), "ref_image": as_t(raw["ref_image"]),
                # zeros without CLIP weights: permanent uncond-image dropout
                "clip_embed": encode_clip_batch(clip_model, as_t(raw["clip_image"])),
                "audio_embeds": as_t(raw["audio_embeds"]), "pose_video": as_t(raw["pose_video"]),
                "masks": [tuple(map(as_t, lv)) for lv in raw["masks"]],
            }

    mlog = MetricsLogger(cfg.checkpoint_dir, "train_stage2",
                         enabled=mesh is None or mesh.rank == 0)
    try:
        return fit(trainer, state, batches(), cfg.max_train_steps, mgr, mlog,
                   cfg.checkpointing_steps, dev, cfg.seed, on_step=on_step)
    finally:
        mlog.close()


def log_validation(pipe, cfg, ref_path: str, record_path: str, step: int) -> str:
    """Render a validation clip with the current weights (the reference's
    log_validation, train_stage_2.py:214-396; `scripts/train_stage2.py:155`):
    the record's pose, masks (box-averaged pyramid) and audio, zero CLIP
    context, 20 DDIM steps, guidance 3.5. Returns the mp4's path."""
    from mmgt_tpu_torch.utils.media import load_image, save_video

    dev = pipe.device
    ref = load_image(ref_path, cfg.train_height)
    with np.load(record_path) as z:
        f = min(z["frames"].shape[0], cfg.n_sample_frames)
        pose = z["pose"][:f].astype(np.float32) / 255.0
        face = z["face_mask"][:f].astype(np.float32) / 255.0
        lips = z["lips_mask"][:f].astype(np.float32) / 255.0
        audio = z["audio_emb"][:f].astype(np.float32)
    full = np.clip(1.0 - face, 0.0, 1.0)
    h8 = face.shape[-1]
    masks = []
    for lv in range(3):
        k = 1 << lv
        dn = lambda m: m.reshape(f, h8 // k, k, h8 // k, k).mean((2, 4)).reshape(1, f, -1)
        masks.append(tuple(torch.from_numpy(dn(m)).to(dev) for m in (full, face, lips)))
    idx = np.clip(np.arange(f)[:, None] + np.arange(-2, 3)[None, :], 0, f - 1)
    as_t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)
    frames = pipe(as_t(ref)[None] * 2 - 1, as_t(pose)[None], torch.zeros((1, 1, 768), device=dev),
                  masks, as_t(audio[idx][None]), num_inference_steps=20, guidance_scale=3.5,
                  motion_scale=tuple(cfg.motion_scale),
                  generator=torch.Generator(device=dev).manual_seed(0))
    out = f"{cfg.checkpoint_dir}/val_{step}.mp4"
    if pipe.mesh is None or pipe.mesh.rank == 0:
        save_video(frames[0].float().cpu().numpy(), out, fps=25)
        print(f"[val] wrote {out}")
    return out


def main(argv=None) -> int:
    args = parse_args(argv)
    from mmgt_tpu_torch.data.datasets import TalkingVideoDataset
    from mmgt_tpu_torch.device import disable_tf32
    from mmgt_tpu_torch.parallel.mesh import create_mesh, destroy

    cfg = config_from_args(args)
    disable_tf32()
    mesh = create_mesh(dp=cfg.mesh_dp, tp=cfg.mesh_tp, device=args.device)
    trainer, clip_model = build(cfg, mesh.device, cfg.seed, args.weights_dir)
    trainer.pipeline.shard_(mesh)
    ds = TalkingVideoDataset(cfg.meta_paths, cfg.n_sample_frames, cfg.audio_margin)
    print(f"dataset: {len(ds)} clips")
    on_step = None
    if args.val_ref and args.val_record:
        def on_step(step, _metrics):
            if step % args.val_every == 0:
                log_validation(trainer.pipeline, cfg, args.val_ref, args.val_record, step)
    t0 = time.time()
    state = run(trainer, ds, cfg, clip_model, resume=args.resume, on_step=on_step)
    print(f"done: step {state.step} in {time.time() - t0:.0f}s")
    destroy(mesh)
    return 0


if __name__ == "__main__":
    sys.exit(main())
