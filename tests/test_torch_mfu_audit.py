"""The port's FLOP audit (`mmgt_tpu_torch/tools/mfu_audit.py`) on the CPU, at
the small pipeline's widths (`mmgt_tpu_torch/testing.py`'s SMALL: UNet
channels 64/128, 2 heads): one denoise group of 2 windows x CFG = 4 UNet
rows of 6 frames at 8 x 8 latents.

  * the count over fake tensors equals the count over real CPU tensors,
    exactly: every family, every kernel's counted and executed FLOPs (the
    fake side forms the bank calls' kv_lens from the rows' gate, the real
    side reads them);
  * the family split equals an independent count from shapes: 2 M N K of
    every Conv2d and Linear module (forward hooks), of the products the
    blocks and the plain kernel versions form from weights directly
    (K3's projections, K4's q/k/v and W_o, the MM-HAA block's audio K/V,
    out and zero-conv products) and the attention products (K1's plain
    route, the audio cross-attention, K4's frame attention), exactly;
  * a step counted through `_denoise_chunk` (one group here) is its
    group's UNet call and nothing more: the overlap average, the CFG
    combine and the solver run no products;
  * the same call of the JAX package, built from the same weights, lowered
    and read by XLA's cost analysis as tools/mfu_audit.py reads it, counts
    at least the port's FLOPs: XLA counts elementwise work too. The gap
    measured here is the tolerance (JAX_GAP). This call runs at 32 x 32
    latents: XLA counts only the taps of a padded convolution that meet
    the input, so at 8 x 8 latents (3 x 3 kernels on maps of 8 down to 1)
    its count of the group above falls to 0.967 of the port's, 0.994 at
    16 x 16.
"""
import math

import numpy as np
import torch
from torch import nn
from torch._subclasses.fake_tensor import FakeTensorMode

from mmgt_tpu_torch.models import blocks as B
from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D
from mmgt_tpu_torch.ops import attention as A
from mmgt_tpu_torch.ops import fused_ln as L
from mmgt_tpu_torch.ops import motion_attention as M
from mmgt_tpu_torch.testing import SMALL
from mmgt_tpu_torch.tools import mfu_audit as MA
from torch_port_util import noise_params

TINY = SMALL["unet"]
MB, F, H8 = 2, 6, 8
# the JAX call: one window x CFG of 4 frames at 32 x 32 latents through a
# UNet of two levels, one layer a block (each layer costs seconds of JAX
# tracing)
JAX_TINY = dict(block_out_channels=(64, 128), heads=2, layers_per_block=1)
H8_JAX = 32
# XLA's count over the port's at the JAX call, measured: 1.0084 (elementwise
# work, the LayerNorms and softmaxes among it)
JAX_GAP = 0.009


def _pipe(window_microbatch=MB):
    unet = DenoisingUNet3D(**TINY).eval().requires_grad_(False)
    return MA.stage2_pipeline(unet, window_microbatch, context_size=F, context_overlap=2)


class HandCount:
    """2 M N K of every product of a forward, by family, from the shapes:
    conv and linear modules by forward hooks; the products formed from
    weights outside a module's forward, and the attention products, by
    wrapping the functions that form them."""

    def __init__(self, model: nn.Module):
        self.model = model
        self.fam = {"conv": 0, "linear": 0, "attention": 0}

    def _conv(self, mod, inp, out):
        # ConvNHWC: (N, H, W, C) in and out
        kh, kw = mod.kernel_size
        self.fam["conv"] += 2 * out.numel() * (mod.in_channels // mod.groups) * kh * kw

    def _linear(self, mod, inp, out):
        self.fam["linear"] += 2 * inp[0].numel() * mod.out_features

    def __enter__(self):
        self.handles = [m.register_forward_hook(self._conv if isinstance(m, nn.Conv2d)
                                                else self._linear)
                        for m in self.model.modules() if isinstance(m, (nn.Conv2d, nn.Linear))]
        self.saved = (A.attention_plain, B.attention_plain, L.ln_projections_plain,
                      M.motion_attention_plain, B.AudioTransformerBlock.forward)
        attn, attn_b, ln, motion, audio_fwd = self.saved
        fam = self.fam

        def attention(plain):
            def run(q, k, v, kv_lens=None, k_bank=None, v_bank=None, *a, **kw):
                b, sq, h, d = q.shape
                sk = k.shape[1] + (0 if k_bank is None else k_bank.shape[1])
                fam["attention"] += 4 * b * h * sq * sk * d
                return plain(q, k, v, kv_lens, k_bank, v_bank, *a, **kw)
            return run

        def ln_proj(x, gamma, beta, ws, bs, eps=1e-5):
            fam["linear"] += 2 * x.numel() * sum(w.shape[0] for w in ws)
            return ln(x, gamma, beta, ws, bs, eps)

        def motion_attn(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads, *a, **kw):
            b, f, l, c = x.shape
            inner = wq.shape[0]
            fam["linear"] += 4 * 2 * b * f * l * c * inner
            fam["attention"] += 4 * b * l * heads * f * f * (inner // heads)
            return motion(x, gamma, beta, pe, wq, wk, wv, wo, bo, heads, *a, **kw)

        def audio_block(blk, x, audio_tokens, masks, motion_scale=(1.0, 1.0, 1.0),
                        n_uncond_rows=0):
            rows, lq, c = x.shape
            rc = rows - n_uncond_rows
            inner = blk.attn2_0.to_q.weight.shape[0]
            la, ca = audio_tokens.shape[1], audio_tokens.shape[2]
            fam["linear"] += 3 * 2 * 2 * rc * la * ca * inner      # the audio K and V
            # batched over the 3 regions (aten bmm): the out products and the
            # masks of the bias terms
            fam["attention"] += 2 * rc * lq * 3 * inner * c + 2 * rows * lq * 3 * c
            fam["linear"] += 2 * rc * lq * 3 * c * c              # the zero convs
            fam["linear"] += 3 * 2 * c * c                        # their bias terms
            return audio_fwd(blk, x, audio_tokens, masks, motion_scale, n_uncond_rows)

        A.attention_plain, B.attention_plain = attention(attn), attention(attn_b)
        L.ln_projections_plain, M.motion_attention_plain = ln_proj, motion_attn
        B.AudioTransformerBlock.forward = audio_block
        return self

    def __exit__(self, *exc):
        for h in self.handles:
            h.remove()
        (A.attention_plain, B.attention_plain, L.ln_projections_plain,
         M.motion_attention_plain, B.AudioTransformerBlock.forward) = self.saved


_REAL = {}


def _real():
    """The group counted over real CPU tensors, with the hand count of the
    same forward (computed once for the module's tests)."""
    if not _REAL:
        torch.manual_seed(0)
        pipe = _pipe()
        with HandCount(pipe.denoising_unet) as hand:
            _REAL["count"] = MA.count_group(pipe, MB, F, H8)
        _REAL["hand"] = hand.fam
    return _REAL["count"], _REAL["hand"]


def test_fake_count_equals_real_count():
    real, _ = _real()
    with FakeTensorMode():
        fake = MA.count_group(_pipe(), MB, F, H8)
    assert fake == real
    assert real["counted"] > 0 and set(real["kernels"]) == {
        "flash_attention", "ln_projections", "motion_attention"}
    # rows of 64 tokens run in K1's 128-query and 128-key tiles at d = 48
    k1 = real["kernels"]["flash_attention"]
    assert k1["executed"] > k1["counted"]


def test_family_split_equals_hand_count():
    real, hand = _real()
    assert real["families"] == hand
    assert sum(hand.values()) == real["counted"]


def test_step_count_is_its_group():
    group, _ = _real()
    pipe = _pipe()
    frames = 8                          # 2 windows of 6 overlapping by 2: one group of 2
    assert MA.windows_per_group(pipe, frames) == (2, MB)
    assert MA.count_step(pipe, frames, H8) == group


def test_k1_executed_closed_form():
    """The flagship's level-0 bank call (d = 40 -> 48): 10 rows x 12 frames,
    5 uncond rows without the bank."""
    rows = [4096] * 60 + [8192] * 60
    got = MA.k1_executed(4096, 8, 40, 4096, 4096, rows)
    assert got == 4 * 8 * 48 * 4096 * (60 * 4096 + 60 * 8192)
    # a ragged kv_len runs whole key tiles; d = 160 runs 64-key tiles
    assert MA.k1_executed(100, 1, 160, 100, 0, [100]) == 4 * 160 * 128 * 128
    # d = 512 (the VAE's mid attention) runs 64-query and 64-key tiles
    assert MA.k1_executed(300, 1, 512, 300, 0, [300, 202]) == 4 * 512 * 320 * (320 + 256)


def test_jax_cost_analysis_counts_at_least_the_port():
    import jax
    import jax.numpy as jnp

    from mmgt_tpu.models.unet3d import DenoisingUNet3D as JUNet3D
    from mmgt_tpu_torch.utils.convert import load_jax_params, map_unet3d

    mb, f = 1, 4
    b = 2 * mb
    rng = np.random.default_rng(0)
    r = lambda *s: rng.standard_normal(s).astype(np.float32)  # noqa: E731
    unet = DenoisingUNet3D(**JAX_TINY).eval().requires_grad_(False)
    pipe = MA.stage2_pipeline(unet, mb, context_size=f)
    h8 = H8_JAX
    masks = [tuple(r(b, f, (h8 >> lv) ** 2) for _ in range(3)) for lv in range(3)]
    # the raw banks, one set a row: the JAX package's CPU route projects
    # them in every call; the port counts the same route (`banks=`)
    banks = [r(b, lt, c) for lt, c in pipe._bank_shapes(h8, h8)]
    x = dict(lat=r(b, f, h8, h8, 4), t=np.full((b,), 500, np.int32), ctx=r(b, 1, 768),
             audio=r(b, f, 32, 768), pose=r(b, f, h8, h8, TINY["block_out_channels"][0]))

    jm = JUNet3D(**JAX_TINY)
    params = noise_params(jax.eval_shape(lambda: jm.init(
        jax.random.PRNGKey(0), x["lat"], x["t"], x["ctx"], x["audio"], x["pose"], masks, banks,
        (1.0, 1.0, 1.0), n_uncond=mb)), seed=1)
    load_jax_params(unet, params, map_unet3d)
    tt = lambda a: torch.from_numpy(np.asarray(a))  # noqa: E731
    port = MA.count(lambda: unet(
        tt(x["lat"]), tt(x["t"]).long(), tt(x["ctx"]), tt(x["audio"]), tt(x["pose"]),
        [tuple(map(tt, lv)) for lv in masks], motion_scale=(1.0, 1.0, 1.0), n_uncond=mb,
        banks=[tt(bk) for bk in banks]))["counted"]

    fn = jax.jit(lambda p, *a: jm.apply(p, *a, (1.0, 1.0, 1.0), n_uncond=mb))
    cost = fn.lower(params, *(jnp.asarray(x[k]) for k in ("lat", "t", "ctx", "audio", "pose")),
                    [tuple(map(jnp.asarray, lv)) for lv in masks],
                    [jnp.asarray(bk) for bk in banks]).cost_analysis()
    if isinstance(cost, (list, tuple)):
        cost = cost[0]
    flops = float(cost["flops"])
    assert port <= flops <= port * (1 + JAX_GAP), (flops, port, flops / port)
    assert math.isfinite(flops)
