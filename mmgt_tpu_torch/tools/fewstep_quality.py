"""Few-step sampler quality on the port's own numerics: the counterpart of
`tools/fewstep_quality.py`.

Protocol (the JAX tool's): the full-width Stage-2 pipeline in bf16, one
fixed initial noise and conditioning, guidance 3.5. A 200-step DDIM run is
the ground truth; DDIM-25/15 and DPM-Solver++(2M)-25/15/12 are scored
against it by
  * rel_latent_err = ||x - x_gt|| / ||x_gt|| on the final latents,
  * PSNR, SSIM, temporal flicker and CLIP identity drift of the decoded
    frames against the ground truth's decode (`utils/metrics.py`),
  * wall seconds (the denoise and the decode, ending in a synchronise).
One pipeline object serves every row: only its scheduler is swapped.

Weights: seeded random (`init_params`), or a reference-layout directory
through `load_all_weights` (`--weights_dir`). CLIP drift uses the
directory's image encoder where it has one, else a ViT-L/14 with the
module's own variance-scaled init (`reset_parameters`, seeded): a flat
N(0, 0.02) fill collapses the 24-layer ViT's embeddings to near-constants,
and the JAX tool measured a drift of ~1e-5 for every row with one. The
random tower is a fixed nonlinear feature map: valid between rows, not an
identity metric. CLIP runs in f32.

    python -m mmgt_tpu_torch.tools.fewstep_quality [--out fewstep.json] \\
        [--weights_dir DIR] [--size 512] [--frames 16] [--ref_steps 200] [--device cuda]

`main` returns the result ({"protocol", "rows"}) and writes it as JSON to
`--out`; each row is printed as it is scored.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from typing import Dict, Optional

import numpy as np
import torch

GUIDANCE = 3.5
# (sampler, steps) of each candidate row, the JAX tool's
CONFIGS = (("ddim", 25), ("ddim", 15), ("dpm++2m", 25), ("dpm++2m", 15), ("dpm++2m", 12))


def make_inputs(size: int, frames: int) -> Dict:
    """The conditioning of the JAX tool, from numpy's generator seeded 0:
    reference image and CLIP embedding N(0, 0.5), pose video U(0, 1),
    all-ones masks, audio embeddings N(0, 0.5); CPU f32 tensors."""
    r = np.random.default_rng(0)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    h8 = size // 8
    return {
        "ref_image": t(r.normal(0, 0.5, (1, size, size, 3))),
        "pose_video": t(r.uniform(0, 1, (1, frames, size, size, 3))),
        "clip_embed": t(r.normal(0, 0.5, (1, 1, 768))),
        "masks": tuple(tuple(torch.ones(1, frames, (h8 >> lv) ** 2) for _ in range(3))
                       for lv in range(3)),
        "audio_embeds": t(r.normal(0, 0.5, (1, frames, 5, 12, 768))),
    }


@torch.no_grad()
def run_latents(pipe, steps: int, inputs: Dict, latents: torch.Tensor) -> torch.Tensor:
    """The pipeline's denoise path from the initial noise `latents` (F,
    H/8, W/8, 4) with the pipeline's current scheduler, stopping at the
    final latents (f32, on the pipeline's device)."""
    from mmgt_tpu_torch.pipelines.context import compute_context_schedule

    dev = pipe.device
    d = {k: v.to(dev) for k, v in inputs.items() if k != "masks"}
    d["masks"] = tuple(tuple(m.to(dev) for m in lv) for lv in inputs["masks"])
    frames = d["pose_video"].shape[1]
    windows = compute_context_schedule(steps, frames, pipe.context_size, 1, pipe.context_overlap)
    cond, lat = pipe._prepare(**d, latents=latents)
    state = pipe.sampler_state(steps)
    lat, _ = pipe._denoise_chunk(lat, pipe.init_aux(state, lat), cond, state, windows, GUIDANCE,
                                 (1.0, 1.0, 1.0))
    return lat


@torch.no_grad()
def seeded_clip(device, seed: int = 3):
    """CLIP ViT-L/14 in f32 on `device` with the module's own init: every
    submodule's `reset_parameters` under a seeded generator, the class
    embedding N(0, d^-0.5) (HF's `_init_weights`)."""
    from mmgt_tpu_torch.models.clip_vision import CLIPVisionModel

    devices = [device] if torch.device(device).type == "cuda" else []
    with torch.random.fork_rng(devices=devices):
        torch.manual_seed(seed)
        if devices:
            torch.cuda.manual_seed(seed)
        with torch.device(device):
            model = CLIPVisionModel()
        for m in model.modules():
            if hasattr(m, "reset_parameters"):
                m.reset_parameters()
        emb = model.vision_model.embeddings.class_embedding
        emb.copy_(torch.randn(emb.shape, device=emb.device) * emb.shape[0] ** -0.5)
    return model.eval().requires_grad_(False)


def _sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=None, help="write the result as JSON")
    ap.add_argument("--weights_dir", default=None)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--frames", type=int, default=16)
    ap.add_argument("--ref_steps", type=int, default=200)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    args = ap.parse_args(argv)

    from mmgt_tpu_torch.device import disable_tf32, resolve_device
    from mmgt_tpu_torch.diffusion import DDIMScheduler, DPMSolverPlusPlus2M
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
    from mmgt_tpu_torch.training.stage1 import SMGA
    from mmgt_tpu_torch.utils import metrics as M
    from mmgt_tpu_torch.utils.weights import load_all_weights

    dev = resolve_device(args.device)
    disable_tf32()
    pipe = Pose2VideoPipeline.build(torch.bfloat16, dev, seed=0, window_microbatch=2)
    clip: Optional[torch.nn.Module] = None
    clip_src = "ViT-L/14, reset_parameters init (seed 3)"
    if args.weights_dir:
        with torch.device("meta"):
            smga = SMGA(feature_type="baseline")
        smga.model.to_empty(device=dev)
        clip = load_all_weights(args.weights_dir, pipe, smga, dev).get("clip_model")
        print(f"# weights: {args.weights_dir}", file=sys.stderr)
    if clip is None:
        clip = seeded_clip(dev)
    else:
        clip, clip_src = clip.float(), "the weights directory's image encoder"
    inputs = make_inputs(args.size, args.frames)
    noise = torch.randn((args.frames, args.size // 8, args.size // 8, 4),
                        generator=torch.Generator().manual_seed(7))

    def render(steps):
        _sync(dev)
        t0 = time.perf_counter()
        lat = run_latents(pipe, steps, inputs, noise)
        frames = pipe._decode(lat)[0]
        _sync(dev)
        wall = time.perf_counter() - t0
        return lat.float().cpu().numpy(), frames.float().cpu().numpy(), wall

    ddim = DDIMScheduler()
    pipe.scheduler = ddim
    gt_lat, gt_frames, gt_wall = render(args.ref_steps)
    gt_norm = float(np.linalg.norm(gt_lat))
    print(f"# ground truth DDIM-{args.ref_steps}: {gt_wall:.1f} s, |x_gt| = {gt_norm:.1f}",
          file=sys.stderr)
    samplers = {"ddim": ddim, "dpm++2m": DPMSolverPlusPlus2M()}
    rows = []
    for name, steps in CONFIGS:
        pipe.scheduler = samplers[name]
        lat, frames, wall = render(steps)
        row = {
            "sampler": name, "steps": steps,
            "rel_latent_err": float(np.linalg.norm(lat - gt_lat)) / gt_norm,
            "psnr_vs_gt_db": M.psnr(frames, gt_frames),
            "ssim_vs_gt": M.ssim(frames, gt_frames),
            "flicker": M.temporal_flicker(frames),
            "clip_drift_vs_gt": M.clip_identity_drift(frames, gt_frames, clip),
            "wall_s": wall,
        }
        rows.append(row)
        print(json.dumps(row), flush=True)
    result = {
        "protocol": {
            "size": args.size, "frames": args.frames, "ref": f"ddim-{args.ref_steps}",
            "ref_wall_s": gt_wall, "gt_flicker": M.temporal_flicker(gt_frames),
            "weights": args.weights_dir or "init_params(seed=0)", "guidance": GUIDANCE,
            "device": (torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"),
            "clip": clip_src,
        },
        "rows": rows,
    }
    if args.out:
        with open(args.out, "w") as f:
            json.dump(result, f, indent=1)
    print(json.dumps(result["protocol"]))
    return result


if __name__ == "__main__":
    main()
