"""FLOP audit of the Stage-2 denoise step: the counterpart of
`tools/mfu_audit.py`.

The JAX tool lowers one flagship denoise group (5 windows x CFG = 10 UNet
rows of 12 frames, 64^2 latents, full width) and reads XLA's cost
analysis. This tool counts the same group on the port's own math, three
ways:

  * counted: `torch.utils.flop_counter.FlopCounterMode` over fake tensors
    (`FakeTensorMode`, a fake CPU device: every op wrapper takes its plain
    route and nothing is allocated), split by family: conv (aten
    `convolution`), linear (`mm`, `addmm`) and attention (`bmm`: the
    attention products, K4's frame products among them). Like every
    product count it leaves elementwise work out (K2's ~10 FLOPs an
    element among it);
  * executed: counted, with the plain FLOPs of each K1, K3 and K4 call
    replaced by what the kernel executes as its plan tiles the call (the
    counterpart of the JAX tool's lane-pad tax):
      - K1 (`csrc/flash_attn.cu`) pads the head dim to its variant (40 ->
        48, 80 -> 96; 160, 512), runs query tiles of 128 (64 at d = 512)
        and, per row, the self keys and the bank keys below the row's
        kv_len in tiles of 128 keys (64 at d >= 160; at d = 512 a call of
        few blocks splits a row's key tiles over 2-4 blocks, the same
        tiles). It skips the bank keys of the CFG-uncond rows, which the
        plain version computes and masks;
      - K3 (`csrc/ln_proj.cu`) runs 128-row stripes against 80-column
        weight tiles (K <= 320), or 128 x 256 tiles of two 128-column
        weight units (K > 320), over 64-column K chunks
        (`ops/fused_ln.py:gemm_plan`);
      - K4 (`csrc/motion_attn.cu`): at C <= 320 and d <= 64 its fused
        kernel runs every head's q/k/v products on 128-row units and P . V
        as a 64 x 64 product a half; at d = 80, 128 and 160 its cluster
        kernel runs them on one or two 64-row groups a CTA (F Lh rows of
        each used) over 64-column chunks of C, cs CTAs a unit; elsewhere its
        per-head kernel runs them on blocks of 128 rows (F x Lt of them used)
        and the frame attention on Lt tokens a block
        (`ops/motion_attention.py:attn_plan`); W_o runs on K3's GEMM plan;
  * closed_form: the JAX bench's (`bench.py:useful_flops`): 0.68e12 x 1.55
    FLOPs a UNet frame row, 1.24e12 a decoded 512^2 frame, and its rough
    SMGA term over 50 sampling steps.

Besides the group it counts a full denoise step (`_denoise_chunk` over
every window at `--frames-e2e`), the VAE decode of one frame and one
Stage-1 SMGA sampling step (a CFG-doubled decoder forward): the three
terms of `bench.py:useful_flops`. With a group time it gives each count's
utilization of 989 TFLOP/s, the H100 SXM's dense bf16 peak; on the card
(the default) it times the group itself unless `--group-seconds` is
given; `--device cpu` counts only.

    python -m mmgt_tpu_torch.tools.mfu_audit [--device cpu] [--group-seconds S]
        [--mb 5] [--frames 12] [--steps 25] [--frames-e2e 80] [--json out.json]
"""
from __future__ import annotations

import argparse
import collections
import json
import sys
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

import torch

PEAK_FLOPS = 989e12  # H100 SXM dense bf16, FLOP/s
# aten op -> family of the split
FAMILY = {"convolution": "conv", "mm": "linear", "addmm": "linear", "bmm": "attention",
          "baddbmm": "attention"}
# bench.py:useful_flops' closed forms
UNET_FRAME_ROW = 0.68e12 * 1.55          # a UNet frame row at 64^2 latents
VAE_FRAME = 1.24e12                      # a decoded 512^2 frame
SMGA_CLIP = 2 * 50 * 2 * (80 * 512 * 512 * 2 * 10)   # 50 sampling steps
SMGA_STEPS = 50
AUDIO_TOKENS, CTX_DIM = 32, 768          # the audio projection's tokens, CLIP's width
GUIDANCE = 3.5
SIZE = 512                               # the flagship's frames, pixels a side


def _up(a: int, b: int) -> int:
    return -(-a // b) * b


# ------------------------------------------------ the kernels' closed forms
def k1_variant(d: int) -> Tuple[int, int, int]:
    """(padded head dim, query tile, key tile) of K1's variant for head dim
    d (`csrc/flash_attn.cu:mmgt_flash_attn`)."""
    if d <= 48:
        return 48, 128, 128
    if d <= 96:
        return 96, 128, 128
    if d <= 160:
        return 160, 128, 64
    return 512, 64, 64


def k1_executed(sq: int, heads: int, d: int, ls: int, lb: int, kv_lens: Iterable[int]) -> int:
    """K1's product FLOPs for one launch: per row (kv_lens gives one valid
    key count a row), the self keys and the bank keys below the row's
    kv_len in whole key tiles, against whole query tiles, at the padded
    head dim; 4 FLOPs a (query, key, column): q k and p v."""
    dp, bq, bk = k1_variant(d)
    keys = 0
    for kv, n in collections.Counter(kv_lens).items():
        kv = min(max(int(kv), 0), ls + lb)
        keys += n * (_up(min(ls, kv), bk) + _up(max(0, kv - ls), bk))
    return 4 * heads * dp * _up(sq, bq) * keys


def k3_executed(m: int, k: int, ns: Sequence[int]) -> int:
    """K3's FLOPs for x (m, k) against weights of ns output columns, as
    `gemm_plan` tiles it: 128-row stripes (or row tiles) x the plan's padded
    columns (80-column tiles a weight at K <= 320, else 256-column tiles
    of two 128-column units) x 64-column K chunks."""
    from mmgt_tpu_torch.ops.fused_ln import gemm_plan

    plan = gemm_plan(m, k, list(ns))
    return 2 * plan["stripes"] * plan["bm"] * plan["cols"] * _up(k, 64)


def k4_executed(b: int, f: int, l: int, c: int, heads: int, inner: int) -> int:
    """K4's FLOPs for x (b, f, l, c) and `heads` heads of inner / heads
    columns. The fused regime: each unit (2 Lh tokens of a row: two 64-row
    halves, F Lh of each used) runs every head's q, k and v on its 128 rows
    over 64-column chunks of C, the logits of its tokens and P . V as a
    64 x 64 x d product a half and head. The cluster regime: each of a
    unit's cs CTAs runs one head's q, k and v on its 64-row groups (one at d
    >= 128, else two) over 64-column chunks of C, the logits of its
    tokens and P . V as a 64 x 64 x d product a group. The per-head regime:
    one block per head, Lt tokens and row runs q, k and v on 128 rows and
    the frame attention of Lt tokens. Then W_o on K3's plan."""
    from mmgt_tpu_torch.ops.motion_attention import attn_plan

    plan = attn_plan(f, l, c, heads, inner, b)
    d = inner // heads
    if plan["regime"] == "fused":
        items = plan["units"] // plan["groups"]
        per_item = (3 * 2 * 128 * inner * _up(c, 64) + 2 * 2 * plan["lh"] * f * f * inner
                    + 2 * 2 * 64 * 64 * inner)
        return items * per_item + k3_executed(b * f * l, inner, [c])
    if plan["regime"] == "cluster":
        rows = 64 * plan["groups"]
        per_cta = (3 * 2 * rows * d * _up(c, 64) + 2 * 2 * plan["groups"] * plan["lh"] * f * f * d
                   + 2 * rows * 64 * d)
        return plan["units"] * plan["cs"] * per_cta + k3_executed(b * f * l, inner, [c])
    blocks = heads * -(-l // plan["lt"]) * b
    per_block = 3 * 2 * 128 * d * _up(c, 64) + 4 * plan["lt"] * f * f * d
    return blocks * per_block + k3_executed(b * f * l, inner, [c])


class KernelTally:
    """Within a `with` block under `counter` (a FlopCounterMode): every call
    that the card would run on K1, K3 or K4 reaches its plain version here
    (its wrapper's CPU route); each is recorded with the FLOPs the counter
    gave it and the FLOPs its kernel executes. `gate` (one 0/1 a UNet row,
    the CFG-uncond rows 0) gives the kv_lens of a bank call whose kv_lens
    are fake, as the denoiser's blocks form them (kv_len = L_self + gate
    L_bank, L_self the query count, each row's gate repeated over its
    frames); real kv_lens are read as they are. `dot_product_attention`'s
    calls are K1's only where it routes them to K1 on the card (512 tokens
    or more on both sides)."""

    def __init__(self, counter, gate: Optional[Sequence[int]] = None):
        from mmgt_tpu_torch.ops import attention as A
        from mmgt_tpu_torch.ops import fused_ln as L
        from mmgt_tpu_torch.ops import motion_attention as M

        self.counter, self.gate = counter, None if gate is None else list(gate)
        self.mods = (A, L, M)
        self.kernels: Dict[str, Dict[str, int]] = {}

    def _add(self, name: str, counted: int, executed: int):
        k = self.kernels.setdefault(name, dict(calls=0, counted=0, executed=0))
        k["calls"] += 1
        k["counted"] += counted
        k["executed"] += executed

    def _counted(self, plain, *args, **kwargs):
        before = self.counter.get_total_flops()
        out = plain(*args, **kwargs)
        return out, self.counter.get_total_flops() - before

    def _kv_lens(self, b: int, sq: int, ls: int, lb: int, kv_lens) -> List[int]:
        from torch._subclasses.fake_tensor import FakeTensor

        if kv_lens is None:
            return [ls + lb] * b
        if not isinstance(kv_lens, FakeTensor):
            return [int(v) for v in kv_lens.tolist()]
        # a bank self-attention: sq self keys, then the bank (pre-projected,
        # or raw and concatenated into k)
        if self.gate is None or ls + lb <= sq or b % len(self.gate):
            raise ValueError("fake kv_lens: the tally needs the rows' bank gate")
        f = b // len(self.gate)
        return [sq + self.gate[i // f] * (ls + lb - sq) for i in range(b)]

    def __enter__(self):
        A, L, M = self.mods
        self.saved = (A.attention_plain, L.ln_projections_plain, M.motion_attention_plain)
        attention_plain, ln_plain, motion_plain = self.saved
        dpa_code = A.dot_product_attention.__code__

        def attention(q, k, v, kv_lens=None, k_bank=None, v_bank=None, scale=None,
                      return_lse=False):
            out, counted = self._counted(attention_plain, q, k, v, kv_lens, k_bank, v_bank,
                                       scale, return_lse)
            b, sq, h, d = q.shape
            ls, lb = k.shape[1], 0 if k_bank is None else k_bank.shape[1]
            if (sys._getframe(1).f_code is not dpa_code
                    or min(sq, ls) >= A.FLASH_MIN_SEQ):
                self._add("flash_attention", counted,
                          k1_executed(sq, h, d, ls, lb, self._kv_lens(b, sq, ls, lb, kv_lens)))
            return out

        def ln_projections(x, gamma, beta, ws, bs, eps=1e-5):
            out, counted = self._counted(ln_plain, x, gamma, beta, ws, bs, eps)
            k = x.shape[-1]
            self._add("ln_projections", counted,
                      k3_executed(x.numel() // k, k, [w.shape[0] for w in ws]))
            return out

        def motion(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads, eps=1e-5, residual=True):
            out, counted = self._counted(motion_plain, x, gamma, beta, pe, wq, wk, wv, wo, bo,
                                       heads, eps, residual)
            b, f, l, c = x.shape
            self._add("motion_attention", counted, k4_executed(b, f, l, c, heads, wq.shape[0]))
            return out

        A.attention_plain, L.ln_projections_plain, M.motion_attention_plain = \
            attention, ln_projections, motion
        return self

    def __exit__(self, *exc):
        A, L, M = self.mods
        A.attention_plain, L.ln_projections_plain, M.motion_attention_plain = self.saved


def count(fn: Callable[[], object], gate: Optional[Sequence[int]] = None) -> Dict:
    """fn() under no_grad, FlopCounterMode and a KernelTally: {"counted",
    "families", "executed", "kernels"}."""
    from torch.utils.flop_counter import FlopCounterMode

    with torch.no_grad(), FlopCounterMode(display=False) as fc, KernelTally(fc, gate) as tally:
        fn()
    families: Dict[str, int] = {}
    for op, n in fc.get_flop_counts().get("Global", {}).items():
        fam = FAMILY.get(str(op).split(".")[-1], "other")
        families[fam] = families.get(fam, 0) + int(n)
    counted = int(fc.get_total_flops())
    kernels = tally.kernels
    executed = counted + sum(k["executed"] - k["counted"] for k in kernels.values())
    return dict(counted=counted, families=families, executed=executed, kernels=kernels)


# ---------------------------------------------------------------- the calls
def stage2_pipeline(unet, window_microbatch: Optional[int] = 5, context_size: int = 12,
                    context_overlap: int = 4):
    """A Pose2VideoPipeline around `unet` alone: what the denoise step
    touches (the other models are not built)."""
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline

    return Pose2VideoPipeline(vae=None, reference_unet=None, denoising_unet=unet,
                              pose_guider=None, context_size=context_size,
                              context_overlap=context_overlap,
                              window_microbatch=window_microbatch)


def _rand(shape, dtype, device, generator=None):
    return torch.randn(shape, generator=generator, device=device).to(dtype)


def bank_kv(pipe, h8: int, generator=None):
    """Random pre-projected banks (`precompute_bank_kv`'s layout) of the
    denoiser at h8 x h8 latents."""
    unet = pipe.denoising_unet
    dev, dt = pipe.device, pipe.dtype
    return [tuple(_rand((1, l, a.heads, a.head_dim), dt, dev, generator) for _ in range(2))
            for (l, _), a in zip(pipe._bank_shapes(h8, h8), unet.bank_attentions())]


def group_inputs(pipe, mb: int, frames: int, h8: int, generator=None) -> Tuple[tuple, dict]:
    """(args, kwargs) of one denoise group's UNet call as `_denoise_chunk`
    makes it: mb windows x CFG = 2 mb rows of `frames` frames at h8^2
    latents, random values (fake under a FakeTensorMode), the uncond rows
    first (`n_uncond`)."""
    dev, dt = pipe.device, pipe.dtype
    b = 2 * mb
    r = lambda *s: _rand(s, dt, dev, generator)  # noqa: E731
    masks = [tuple(r(b, frames, (h8 >> lv) ** 2) for _ in range(3)) for lv in range(3)]
    args = (r(b, frames, h8, h8, 4), torch.full((b,), 500, dtype=torch.long, device=dev),
            r(b, 1, CTX_DIM), r(b, frames, AUDIO_TOKENS, CTX_DIM),
            r(b, frames, h8, h8, pipe.denoising_unet.block_out_channels[0]), masks,
            bank_kv(pipe, h8, generator), (1.0, 1.0, 1.0))
    return args, dict(n_uncond=mb)


def count_group(pipe, mb: int = 5, frames: int = 12, h8: int = 64) -> Dict:
    """One denoise group's UNet call (`group_inputs`)."""
    args, kw = group_inputs(pipe, mb, frames, h8)
    return count(lambda: pipe.denoising_unet(*args, **kw), gate=[0] * mb + [1] * mb)


def step_cond(pipe, frames: int, h8: int, mb: int, generator=None) -> Dict:
    """`_prepare`'s conditioning for a clip of `frames` frames (random
    values) and the CFG context of mb windows a group."""
    dev, dt = pipe.device, pipe.dtype
    r = lambda *s: _rand(s, dt, dev, generator)  # noqa: E731
    return {"banks_kv": bank_kv(pipe, h8, generator),
            "pose_feat": r(1, frames, h8, h8, pipe.denoising_unet.block_out_channels[0]),
            "audio_tokens": r(1, frames, AUDIO_TOKENS, CTX_DIM),
            "ctx_cfg": r(2 * mb, 1, CTX_DIM),
            "masks": tuple(tuple(r(frames, (h8 >> lv) ** 2) for _ in range(3))
                           for lv in range(3))}


def windows_per_group(pipe, frames: int) -> Tuple[int, int]:
    """(windows, windows a group) of a clip of `frames` frames."""
    from mmgt_tpu_torch.pipelines.pose2vid import _largest_divisor_at_most

    w = pipe._num_windows(frames)
    return w, _largest_divisor_at_most(w, pipe.window_microbatch or w)


def count_step(pipe, frames: int = 80, h8: int = 64, steps: int = 25) -> Dict:
    """One denoising step of a clip of `frames` frames: `_denoise_chunk`
    over every context window, its groups, the overlap average, the CFG
    combine and the solver step."""
    from mmgt_tpu_torch.pipelines.context import compute_context_schedule

    _, mb = windows_per_group(pipe, frames)
    cond = step_cond(pipe, frames, h8, mb)
    lat = torch.randn((frames, h8, h8, 4), device=pipe.device)
    tables = pipe.sampler_state(steps)
    win = compute_context_schedule(1, frames, pipe.context_size, 1, pipe.context_overlap)
    return count(lambda: pipe._denoise_chunk(lat, pipe.init_aux(tables, lat), cond, tables, win,
                                             GUIDANCE, (1.0, 1.0, 1.0)),
                 gate=[0] * mb + [1] * mb)


def count_vae_frame(vae, h8: int = 64) -> Dict:
    """The VAE decode of one frame of h8^2 latents."""
    p = next(vae.parameters())
    z = torch.randn((1, h8, h8, 4), device=p.device).to(p.dtype)
    return count(lambda: vae.decode_scaled(z))


def count_smga_step(model, batch: int = 1, horizon: int = 80, cond_dim: int = 1024 + 35,
                    guidance: float = 2.0) -> Dict:
    """One Stage-1 sampling step: the decoder's CFG-doubled forward
    (`guided_forward`) on `batch` samples of `horizon` frames."""
    from mmgt_tpu_torch.models import smga as S

    p = next(model.parameters())
    dev = p.device
    x = torch.randn((batch, horizon, S.NFEATS), device=dev)
    cf = torch.randn((batch, S.NFEATS), device=dev)
    c = torch.randn((batch, horizon, cond_dim), device=dev)
    t = torch.full((batch,), 10, dtype=torch.long, device=dev)
    S.rotary_cos_sin.cache_clear()  # its tables are made on first use, fake ones here
    try:
        return count(lambda: model.guided_forward(x, cf, c, t, guidance))
    finally:
        S.rotary_cos_sin.cache_clear()


# ------------------------------------------------------------------ the audit
def unet_closed_form(frames: int) -> float:
    """The bench's UNet FLOPs of one step of a clip (both CFG halves):
    `frames * 1.5` window frame rows (12-frame windows, 4 overlapping)."""
    return UNET_FRAME_ROW * 2 * int(frames * 1.5)


def fake_models(cond_dim: int = 1024 + 35):
    """The full-width denoiser, VAE and SMGA decoder (f32; a FLOP count does
    not depend on the dtype) built inside the caller's FakeTensorMode."""
    from mmgt_tpu_torch.models.smga import NFEATS, GestureDecoder
    from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D
    from mmgt_tpu_torch.models.vae import AutoencoderKL

    models = dict(unet=DenoisingUNet3D(), vae=AutoencoderKL(),
                  smga=GestureDecoder(NFEATS, 80, 512, 1024, 8, 8, cond_dim))
    for m in models.values():
        m.eval().requires_grad_(False)
    return models


def counts(mb: int = 5, frames: int = 12, size: int = 512, frames_e2e: int = 80,
           step_frames: Sequence[int] = ()) -> Dict:
    """The full-width counts over fake tensors: the group, a step at
    frames_e2e and at each of step_frames, a VAE frame, an SMGA step."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    h8 = size // 8
    with FakeTensorMode():
        models = fake_models()
        pipe = stage2_pipeline(models["unet"], window_microbatch=mb)
        out = {"group": count_group(pipe, mb, frames, h8),
               "steps": {f: count_step(pipe, f, h8) for f in sorted({frames_e2e, *step_frames})},
               "vae_frame": count_vae_frame(models["vae"], h8),
               "smga_step": count_smga_step(models["smga"])}
    out["shapes"] = dict(mb=mb, frames=frames, size=size, frames_e2e=frames_e2e)
    return out


def _with_closed(c: Dict, closed: float) -> Dict:
    c = dict(c, closed_form=closed)
    c["ratios"] = {"executed/counted": c["executed"] / c["counted"],
                   "closed_form/counted": closed / c["counted"],
                   "closed_form/executed": closed / c["executed"]}
    return c


def _util(c: Dict, seconds: float) -> Dict:
    return {"seconds": seconds, **{k: c[k] / seconds / PEAK_FLOPS
                                   for k in ("counted", "executed", "closed_form")}}


def report(cnt: Dict, group_seconds: Optional[float] = None,
           timed_steps: Sequence[Tuple[int, float]] = (), steps: int = 25) -> Dict:
    """The closed forms beside the counts, their ratios, and each timed
    count's utilization of PEAK_FLOPS: the group at group_seconds, and
    each (frames, seconds) of timed_steps against the count of a step at
    that many frames."""
    sh = cnt["shapes"]
    scale = (sh["size"] / 512) ** 2
    out = {"peak_flops": PEAK_FLOPS, "shapes": sh,
           "group": _with_closed(cnt["group"], UNET_FRAME_ROW * 2 * sh["mb"] * sh["frames"]),
           "steps": {f: _with_closed(c, unet_closed_form(f)) for f, c in cnt["steps"].items()},
           "vae_frame": _with_closed(cnt["vae_frame"], VAE_FRAME * scale),
           "smga_step": _with_closed(cnt["smga_step"], SMGA_CLIP / SMGA_STEPS)}
    e2e = out["steps"][sh["frames_e2e"]]
    out["denoise_e2e"] = {"steps": steps, **{k: steps * e2e[k]
                                              for k in ("counted", "executed", "closed_form")}}
    if group_seconds:
        out["group"]["utilization"] = _util(out["group"], group_seconds)
    for f, s in timed_steps:
        out["steps"][f]["utilization"] = _util(out["steps"][f], s)
    return out


def text(rep: Dict) -> str:
    """The report as lines of text."""
    lines = []

    def block(name, c):
        fam = ", ".join(f"{k} {v / 1e12:.3f}" for k, v in sorted(c["families"].items()))
        lines.append(f"{name}: counted {c['counted'] / 1e12:.3f} TFLOP ({fam}); executed "
                     f"{c['executed'] / 1e12:.3f}; closed_form {c['closed_form'] / 1e12:.3f}; "
                     + ", ".join(f"{k} {v:.3f}" for k, v in c["ratios"].items()))
        for k, v in sorted(c["kernels"].items()):
            lines.append(f"  {k}: {v['calls']} calls, counted {v['counted'] / 1e12:.3f}, "
                         f"executed {v['executed'] / 1e12:.3f} TFLOP")
        if "utilization" in c:
            u = c["utilization"]
            lines.append(f"  at {u['seconds']:.4f} s: utilization of {PEAK_FLOPS / 1e12:.0f} "
                         f"TFLOP/s: counted {u['counted']:.1%}, executed {u['executed']:.1%}, "
                         f"closed_form {u['closed_form']:.1%}")

    sh = rep["shapes"]
    block(f"group ({sh['mb']} windows x CFG, {sh['frames']} frames, {sh['size']}^2)",
          rep["group"])
    for f, c in sorted(rep["steps"].items()):
        block(f"step at {f} frames", c)
    block(f"VAE decode of one {sh['size']}^2 frame", rep["vae_frame"])
    block("SMGA sampling step (batch 1, CFG)", rep["smga_step"])
    d = dict(rep["denoise_e2e"])
    lines.append(f"denoise of {sh['frames_e2e']} frames, {d.pop('steps')} steps: "
                 + ", ".join(f"{k} {v / 1e15:.2f} PFLOP" for k, v in d.items()))
    return "\n".join(lines)


def time_call(fn: Callable[[], object], iters: int = 3, warmup: int = 1) -> float:
    """Seconds a call of fn on the card (CUDA events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters / 1e3


def time_group(device, mb: int, frames: int, size: int, seed: int = 0) -> float:
    """One denoise group's UNet call at full width in bf16 on the card,
    seeded random weights and inputs."""
    from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline

    pipe = Pose2VideoPipeline.build(torch.bfloat16, device=device, seed=seed)
    args, kw = group_inputs(pipe, mb, frames, size // 8,
                            torch.Generator(device=device).manual_seed(seed))
    with torch.no_grad():
        return time_call(lambda: pipe.denoising_unet(*args, **kw))


def main(argv=None) -> Dict:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default=None, help="cuda (default: time the group) or cpu")
    ap.add_argument("--group-seconds", type=float, default=None,
                    help="a measured group time (skips the timing on the card)")
    ap.add_argument("--mb", type=int, default=5)
    ap.add_argument("--frames", type=int, default=12)
    ap.add_argument("--steps", type=int, default=25)
    ap.add_argument("--frames-e2e", type=int, default=80)
    ap.add_argument("--json", default=None, help="write the report as JSON")
    args = ap.parse_args(argv)

    from mmgt_tpu_torch.device import disable_tf32, resolve_device

    dev = resolve_device(args.device)
    group_s = args.group_seconds
    if group_s is None and dev.type == "cuda":
        disable_tf32()
        group_s = time_group(dev, args.mb, args.frames, SIZE)
    rep = report(counts(args.mb, args.frames, SIZE, args.frames_e2e), group_s, (), args.steps)
    print(text(rep))
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rep, f, indent=1)
    return rep


if __name__ == "__main__":
    main()
