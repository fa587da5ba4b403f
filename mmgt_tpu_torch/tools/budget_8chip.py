"""The n-card budget of the flagship denoise loop: the counterpart of
`tools/budget_8chip.py`.

The JAX tool runs the full-width denoise step dp-sharded over 8 virtual
CPU devices, finds the per-device shard shapes and every collective in the
compiled HLO, and budgets 8 chips from those facts. The port splits each
denoise group's context windows over the dp ranks
(`pipelines/pose2vid.py`): a rank denoises its windows, both CFG halves,
in one UNet call, and an `all_reduce` of a zero-filled buffer gathers the
predictions. This tool

  * runs `--devices` ranks (`parallel/launch.py:spawn`, a `file://` store)
    on ONE device at (dp = n, tp = 1) through gloo (NCCL refuses two ranks
    on one card). Each rank builds the full-width Stage-2 models (320 /
    640 / 1280 channels; `--tiny`: the drills' widths) with seeded random
    weights (`init_params`), bf16 on the card, f32 on the CPU, at 16 x 16
    latents (128^2 pixels, the JAX tool's cut) and `--frames` 32 frames in
    windows of 8 overlapping by 4: 8 windows in one group
    (`window_microbatch=None`), one window a rank at n = 8;
  * runs one real denoise step (`_prepare`, then step 1 of `--steps` of
    `_denoise_chunk`) and fails unless
      1. shard shapes: the denoising UNet's conv_in saw 2 mb_l ctx frame
         rows on every rank (mb_l windows a rank): out (16, 16, 16, 320)
         here, the counterpart of the HLO's per-device [8,16,16,320];
      2. collectives: `parallel/collectives.py:STATS` over the step equals
         the closed form of the gather, one all_reduce of (2, mb_l dp, ctx,
         h8, w8, 4) f32 a group: 524,288 bytes here;
      3. equality: every rank's latents are bitwise equal to one process's
         run of the same step at one window a UNet call
         (`window_microbatch = 1`), which is what each rank runs;
  * prints the budget of the flagship (80 frames, 512^2, 10 windows of 12
    frames in groups of 5; 25 and 15 steps) on n cards, from the port's
    own figures:
      - per step: one window's UNet call (2 rows x 12 frames at 512^2,
        timed on the card; left out at `--tiny`) x `windows_per_rank`,
        the most windows a rank denoises in a flagship step (2 at n = 8),
        plus the step's collective bytes, scaled to 80 frames at 64^2 by
        latent volume, as a ring all_reduce (2 (n - 1) / n of the bytes a
        rank) over `--link-gbps` GB/s (default 450: NVIDIA's specification
        of H100 SXM NVLink 4 a direction, not a measurement);
      - the VAE decode divided by n; Stage 1 and the host terms (the
        conditioning, the encoders, `_prepare`, the frames' copy to the
        host) as they are, from the `timings` of an audio2vid call on the
        card (`--a2v-json`; without one these terms are left out).
    Every n-card figure is a projection from one card's measurements.

    python -m mmgt_tpu_torch.tools.budget_8chip [--devices 8] [--device cpu]
        [--frames 32] [--a2v-json a2v.json] [--link-gbps 450] [--json out.json]
        [--tiny]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

GUIDANCE = 3.5
LINK_GBPS = 450.0  # H100 SXM NVLink 4, GB/s a direction (NVIDIA's specification)
# the flagship: 80 frames, 512^2, 12-frame windows overlapping by 4, 5 a group
FLAGSHIP = dict(frames=80, h8=64, context_size=12, context_overlap=4, window_microbatch=5)


def default_layout(**kw) -> Dict:
    """The run's layout: n ranks on one device, full width, 16 x 16 latents,
    32 frames in 8-frame windows overlapping by 4 (one window a rank at
    n = 8), step 1 of 25."""
    layout = dict(devices=8, device="cuda", frames=32, size=128, context_size=8,
                  context_overlap=4, steps=25, seed=0, tiny=False, timeout_s=600)
    layout.update(kw)
    return layout


def build(layout: Dict, window_microbatch: Optional[int] = None):
    """The Stage-2 pipeline of the layout on its device, seeded weights."""
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline, materialize
    from mmgt_tpu_torch.testing import DRILL, stage2_models

    dev = torch.device(layout["device"])
    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    kw = dict(context_size=layout["context_size"], context_overlap=layout["context_overlap"],
              window_microbatch=window_microbatch)
    if not layout["tiny"]:
        return Pose2VideoPipeline.build(dtype, device=dev, seed=layout["seed"], **kw)
    with torch.device("meta"):
        models = stage2_models(DRILL)
    pipe = Pose2VideoPipeline(**materialize(models, dev, dtype), **kw)
    pipe.init_params(layout["seed"])
    return pipe


def inputs(layout: Dict) -> Dict:
    """Seeded conditioning (numpy's generator), CPU f32 tensors."""
    r = np.random.default_rng(layout["seed"])
    f, s = layout["frames"], layout["size"]
    h8 = s // 8
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    return {"ref_image": t(r.uniform(-1, 1, (1, s, s, 3))),
            "pose_video": t(r.uniform(0, 1, (1, f, s, s, 3))),
            "clip_embed": t(r.normal(0, 1, (1, 1, 768))),
            "masks": tuple(tuple(t(r.uniform(size=(1, f, (h8 >> lv) ** 2)) > 0.4)
                                 for _ in range(3)) for lv in range(3)),
            "audio_embeds": t(r.normal(0, 1, (1, f, 5, 12, 768)))}


def windows(layout: Dict) -> np.ndarray:
    """The context windows of the step run: step 1 of the layout's steps,
    (1, windows, ctx)."""
    from mmgt_tpu_torch.pipelines.context import compute_context_schedule

    return compute_context_schedule(layout["steps"], layout["frames"], layout["context_size"],
                                    1, layout["context_overlap"])[:1]


@torch.no_grad()
def prepare(pipe, layout: Dict):
    """`_prepare` on the layout's inputs, the noise drawn from the seed."""
    dev = pipe.device
    x = inputs(layout)
    masks = tuple(tuple(m.to(dev) for m in lv) for lv in x.pop("masks"))
    return pipe._prepare(**{k: v.to(dev) for k, v in x.items()}, masks=masks,
                         generator=torch.Generator(device=dev).manual_seed(layout["seed"]))


@torch.no_grad()
def step(pipe, cond, lat, win: np.ndarray, layout: Dict) -> torch.Tensor:
    """The denoise step over the windows `win`, f32 latents."""
    tables = pipe.sampler_state(layout["steps"])
    out, _ = pipe._denoise_chunk(lat, pipe.init_aux(tables, lat), cond, tables, win, GUIDANCE,
                                 (1.0, 1.0, 1.0))
    return out


def _sync(dev: torch.device):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def reference(layout: Dict) -> torch.Tensor:
    """One process's run of the step at one window a UNet call, f32 latents
    on the CPU (on the CPU with one thread, as each rank runs: the kernels
    of torch's CPU build sum in another order with more threads)."""
    cpu = torch.device(layout["device"]).type == "cpu"
    threads = torch.get_num_threads()
    if cpu:
        torch.set_num_threads(1)
    try:
        pipe = build(layout, window_microbatch=1)
        cond, lat = prepare(pipe, layout)
        out = step(pipe, cond, lat, windows(layout), layout).float().cpu()
    finally:
        torch.set_num_threads(threads)
    del pipe, cond, lat
    if not cpu:
        torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------- the ranks
def rank_setup(margs: Dict, layout: Dict) -> Dict:
    """This rank's mesh (dp = n, tp = 1, gloo), its pipeline on the mesh,
    `_prepare`'s conditioning and latents, and a hook on the denoiser's
    conv_in that records the shapes it sees."""
    from mmgt_tpu_torch.parallel.mesh import create_mesh

    mesh = create_mesh(dp=layout["devices"], tp=1, device=layout["device"], backend="gloo",
                       timeout_s=layout["timeout_s"], **margs)
    pipe = build(layout)
    pipe.shard_(mesh)
    cond, lat = prepare(pipe, layout)
    shapes: List[Tuple[tuple, tuple]] = []
    pipe.denoising_unet.conv_in.register_forward_hook(
        lambda m, i, o: shapes.append((tuple(i[0].shape), tuple(o.shape))))
    return dict(mesh=mesh, pipe=pipe, cond=cond, lat=lat, shapes=shapes)


def rank_step(ctx: Dict, win: np.ndarray, layout: Dict, around=None) -> Dict:
    """The step on this rank, with the collective statistics and the kernel
    launch counts set to 0 just before and read just after (inside
    `around`, a context manager, when given): its latents, conv_in's
    shapes, the all_reduce calls and bytes, the launches, the seconds and
    the rank's peak device memory."""
    from mmgt_tpu_torch.ops import launch_counts, reset_launch_counts
    from mmgt_tpu_torch.parallel import collectives as C

    pipe, dev = ctx["pipe"], ctx["pipe"].device
    del ctx["shapes"][:]
    _sync(dev)
    C.reset_stats()
    reset_launch_counts()
    t0 = time.perf_counter()
    with around if around is not None else contextlib.nullcontext():
        out = step(pipe, ctx["cond"], ctx["lat"], win, layout)
        _sync(dev)
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
    return dict(rank=ctx["mesh"].rank, latents=out.float().cpu(), shapes=list(ctx["shapes"]),
                stats=dict(calls=C.STATS["calls"], bytes=C.STATS["bytes"]),
                launches=launch_counts(), s=sec, peak_gib=peak)


def rank_main(margs: Dict, layout: Dict, out_dir: str):
    """One rank: set up, run the step, write rank<r>.pt."""
    from mmgt_tpu_torch.parallel.mesh import destroy

    if torch.device(layout["device"]).type == "cpu":
        torch.set_num_threads(1)   # the ranks share the host's cores
    ctx = rank_setup(margs, layout)
    res = rank_step(ctx, windows(layout), layout)
    torch.save(res, os.path.join(out_dir, f"rank{ctx['mesh'].rank}.pt"))
    destroy(ctx["mesh"])


# ---------------------------------------------------------------- the checks
def gather_closed_form(layout: Dict) -> Dict:
    """The step's gather (every window in one group, `window_microbatch=None`):
    one all_reduce of (2, mb_l dp, ctx, h8, w8, 4) f32, mb_l windows a rank;
    its calls and bytes, and the UNet rows of a rank's call."""
    n, ctx = layout["devices"], layout["context_size"]
    mb_l = -(-windows(layout).shape[1] // n)
    h8 = layout["size"] // 8
    return dict(calls=1, bytes=2 * mb_l * n * ctx * h8 * h8 * 4 * 4, rows=2 * mb_l * ctx,
                mb_l=mb_l)


def check(results: List[Dict], ref: torch.Tensor, layout: Dict) -> List[str]:
    """The three checks over the ranks' results; the failures, as text."""
    fails = []
    cf = gather_closed_form(layout)
    h8 = layout["size"] // 8
    for res in results:
        r = res["rank"]
        if not res["shapes"]:
            fails.append(f"rank {r}: the denoiser's conv_in never ran")
        for shp_in, shp_out in res["shapes"]:
            if shp_in != (cf["rows"], h8, h8, 4) or shp_out[:3] != (cf["rows"], h8, h8):
                fails.append(f"rank {r}: conv_in saw {shp_in} -> {shp_out}, not "
                             f"{cf['rows']} frame rows of {h8} x {h8}")
        if res["stats"] != dict(calls=cf["calls"], bytes=cf["bytes"]):
            fails.append(f"rank {r}: collectives {res['stats']} against the closed form "
                         f"{dict(calls=cf['calls'], bytes=cf['bytes'])}")
        if not torch.equal(res["latents"], ref):
            d = (res["latents"] - ref).abs().max().item()
            fails.append(f"rank {r}: latents differ from one process's run (max |diff| {d})")
    return fails


def run(layout: Dict, rank_fn: Callable = rank_main, store: Optional[str] = None):
    """The reference, then the ranks (`rank_fn(margs, layout, out_dir)`);
    returns (ranks' results, reference latents, failures)."""
    from mmgt_tpu_torch.parallel.launch import spawn

    ref = reference(layout)
    with contextlib.ExitStack() as stack:
        if store is None:
            store = stack.enter_context(tempfile.TemporaryDirectory())
        spawn(rank_fn, layout["devices"], store, layout, store)
        results = [torch.load(os.path.join(store, f"rank{r}.pt"))
                   for r in range(layout["devices"])]
    return results, ref, check(results, ref, layout)


# ---------------------------------------------------------------- the budget
def flagship_windows_per_rank(n: int) -> int:
    """The most windows a rank denoises in one flagship step at dp = n: each
    group's windows split over the ranks (`_denoise_chunk`)."""
    from mmgt_tpu_torch.pipelines.pose2vid import _largest_divisor_at_most

    fl = FLAGSHIP
    w = -(-fl["frames"] // (fl["context_size"] - fl["context_overlap"]))
    mb = _largest_divisor_at_most(w, fl["window_microbatch"])
    return (w // mb) * -(-mb // n)


def host_terms(timings: Dict[str, float]) -> Dict[str, float]:
    """Stage 1, the decode and the host terms of an audio2vid call's
    `timings`: the conditioning, the encoders, Stage 2's prepare and
    whatever of Stage 2 is neither prepare, denoise nor decode (the
    frames' copy to the host)."""
    s2 = timings["stage2_s"]
    rest = s2 - sum(timings[f"stage2_{k}_s"] for k in ("prepare", "denoise", "decode"))
    return dict(stage1_s=timings["stage1_s"], decode_s=timings["stage2_decode_s"],
                host_s=timings["conditioning_s"] + timings["audio_clip_s"]
                + timings["stage2_prepare_s"] + max(0.0, rest))


def budget(n: int, stats: Dict, layout: Dict, window_s: Optional[float],
           a2v_timings: Optional[Dict] = None, link_gbps: float = LINK_GBPS,
           steps: int = 25) -> Dict:
    """The flagship's budget on n cards (the JAX tool's keys, `collectives`
    for its `hlo_collectives`, plus `windows_per_rank`); seconds are
    projections from one card."""
    fl = FLAGSHIP
    h8 = layout["size"] // 8
    scale = (fl["frames"] * fl["h8"] ** 2) / (layout["frames"] * h8 * h8)
    coll_bytes = stats["bytes"] * scale
    coll_s = 2 * coll_bytes * (n - 1) / n / (link_gbps * 1e9)
    wpr = flagship_windows_per_rank(n)
    out = {"devices": n, "windows_per_rank": wpr, "per_device_batch_rows": 2 * wpr,
           "collectives": {"all_reduce": dict(stats)},
           "collective_bytes_per_step_flagship": coll_bytes,
           "link_gbps": link_gbps, "link_source": "specification (H100 SXM NVLink 4)",
           "collective_s_per_step_flagship": coll_s, "window_s": window_s}
    if window_s is None:
        return out
    per_step = window_s * wpr + coll_s
    out.update(per_step_s=per_step, denoise_s=steps * per_step)
    if a2v_timings:
        t = host_terms(a2v_timings)
        vae = t["decode_s"] / n
        fixed = vae + t["stage1_s"] + t["host_s"]
        out.update(vae_s=vae, stage1_s=t["stage1_s"], host_s=t["host_s"],
                   e2e_25steps_s=25 * per_step + fixed, e2e_15steps_s=15 * per_step + fixed)
    return out


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=8)
    ap.add_argument("--device", default=None, help="cuda (default) or cpu; every rank on it")
    ap.add_argument("--frames", type=int, default=32)
    ap.add_argument("--tiny", action="store_true", help="the drills' Stage-2 widths")
    ap.add_argument("--a2v-json", default=None,
                    help="an audio2vid call's `timings` as JSON (Stage 1, decode, host)")
    ap.add_argument("--link-gbps", type=float, default=LINK_GBPS)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    from mmgt_tpu_torch.device import disable_tf32, resolve_device

    dev = resolve_device(args.device)
    if dev.type == "cuda":   # every rank on this one card (a mesh sets it by index)
        dev = torch.device("cuda", dev.index or 0)
        disable_tf32()
    layout = default_layout(devices=args.devices, device=str(dev), frames=args.frames,
                            tiny=args.tiny)
    results, ref, fails = run(layout)
    for res in results:
        print(f"rank {res['rank']}: conv_in {res['shapes']}; all_reduce {res['stats']}; "
              f"{res['s']:.3f} s; peak {res['peak_gib']} GiB; launches {res['launches']}")
    window_s = None
    if dev.type == "cuda" and not args.tiny:
        from mmgt_tpu_torch.tools.mfu_audit import time_group

        window_s = time_group(dev, 1, FLAGSHIP["context_size"], 8 * FLAGSHIP["h8"],
                              layout["seed"])
    timings = None
    if args.a2v_json:
        with open(args.a2v_json) as f:
            timings = json.load(f)
    out = budget(args.devices, results[0]["stats"], layout, window_s, timings, args.link_gbps)
    out["checks"] = {"failures": fails, "closed_form": gather_closed_form(layout)}
    print(json.dumps(out, indent=2))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(out, f, indent=2)
    if fails:
        raise SystemExit("budget_8chip: " + "; ".join(fails))
    return out


if __name__ == "__main__":
    main()
