"""Each of the port's five kernels against its plain version, on the card,
and the gradients of K1-K4's autograd Functions against autograd through
their plain versions.

Marked `gpu`; each test skips when no CUDA device is present (decided
inside the test, never at import). Run them on a GPU machine with
    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q
Tolerance: two bf16 ulps at the largest output magnitude (both sides
round an f32 result to bf16; the summation order may flip that rounding);
four for K5 and for gradients, which sum hundreds of keys or queries in
another order and round P and dS to bf16 as product operands.
"""
import math

import pytest
import torch

from mmgt_tpu_torch import ops
from mmgt_tpu_torch.ops import _build
from mmgt_tpu_torch.ops import attention as A
from mmgt_tpu_torch.ops import fused_ln as L
from mmgt_tpu_torch.ops import motion_attention as M
from mmgt_tpu_torch.ops import norms as N

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    # every library built before the first test that profiles: a build
    # takes 30-45 s, and a profiler session opened that long after the
    # process's previous one loses kernels of its first milliseconds
    # (`mmgt_tpu_torch/tools/trace_gap.py`; the launch checks below)
    _build.build()
    return torch.Generator(device="cuda").manual_seed(0)


def _bf(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def _check(got, want, ulps=2):
    tol = ulps * 2.0 ** -7 * want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


# Sq = 300 and Lb = 257 end inside a tile of every variant (128 queries and
# 128 or 64 keys for d <= 160, 64 and 64 for d > 160); kv_lens end inside a
# self tile ([200, ...]), inside a bank tile (300 + 100) or at 0 (no key).
# d <= 160: kv_lens at the key tiles' edges (1, BK - 1, BK, BK + 1, 2 BK + 1
# with BK = 128, and 64 at d = 160) in the self segment and in the bank,
# beside a row with no key, in one launch; Sq = 1, 65 and 129 leave the
# second consumer warpgroup of the last query tile one row or none; d = 64
# runs padded to 96.
# At d > 160 each warpgroup takes 32 keys of a tile: 202 ends in the first
# half of a self tile, 168 in the second, 400 and 557 inside bank tiles; a
# batch of 2 is split over the keys (the wrapper's `wide_splits`), the
# batch of 8 (one row per len) is not. d = 192 and 264 run the d = 512
# path with the columns past d zero-filled (264: a partial 64-column box)
@pytest.mark.parametrize("d,bank,lens,sq", [
    (40, True, [300, 557], 300), (40, True, [200, 400], 300), (80, False, [300, 150], 300),
    (80, True, [130, 0], 300), (160, True, None, 300), (160, True, [77, 450], 300),
    (512, False, None, 300), (512, True, [299, 0], 300), (512, True, [202, 400], 300),
    (512, True, [168, 557], 300), (512, True, [300, 557, 0, 202, 168, 400, 64, 299], 300),
    (192, True, [202, 400], 300), (264, False, None, 300),
    (40, True, [1, 127, 128, 129, 257, 0], 300), (80, False, [1, 127, 128, 129, 257, 0], 300),
    (160, True, [1, 63, 64, 65, 129, 0], 300),
    (40, True, [301, 427, 428, 429, 557, 0], 300), (80, True, [301, 427, 428, 429, 557, 0], 300),
    (160, True, [301, 363, 364, 365, 429, 0], 300),
    (40, False, None, 1), (40, True, [557, 300], 65), (80, True, [1, 428], 129),
    (160, True, [77, 450], 129), (64, False, [300, 150], 300), (64, True, [1, 429, 0], 65)])
def test_flash_attention_kernel(gen, d, bank, lens, sq):
    s, h = 300, 2
    b = 2 if lens is None else len(lens)
    q, k, v = _bf(gen, b, sq, h, d), _bf(gen, b, s, h, d), _bf(gen, b, s, h, d)
    kb = _bf(gen, 1, 257, h, d) if bank else None
    vb = _bf(gen, 1, 257, h, d) if bank else None
    kl = None if lens is None else torch.tensor(lens, device="cuda", dtype=torch.int32)
    before = A.LAUNCHES
    got, lse = A.flash_attention(q, k, v, kl, kb, vb, return_lse=True)
    assert A.LAUNCHES == before + 1
    want, want_lse = A.attention_plain(q, k, v, kl, kb, vb, return_lse=True)
    _check(got, want)
    assert (lse - want_lse).abs().max().item() <= 1e-3
    if d in (192, 264):  # these rows split their keys over blocks
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        assert A.wide_splits(b, h, sq, s + (257 if bank else 0), sms) > 1
    if lens is not None and 0 in lens:  # a row with no valid key gives 0
        assert got[lens.index(0)].abs().max().item() == 0


@pytest.mark.parametrize("d,bank", [(40, True), (80, False), (160, True), (512, False)])
def test_flash_attention_kernel_packed_qkv(gen, d, bank):
    """Strided BSHD q/k/v taken from one packed (B, S, 3, H, D) projection,
    as the packed JAX call sites pass them."""
    s, h = 300, 2
    qkv = _bf(gen, 2, s, 3, h, d)
    q, k, v = qkv[:, :, 0], qkv[:, :, 1], qkv[:, :, 2]
    assert not q.is_contiguous()
    kb = _bf(gen, 1, 257, h, d) if bank else None
    vb = _bf(gen, 1, 257, h, d) if bank else None
    kl = torch.tensor([211, 557 if bank else 300], device="cuda", dtype=torch.int32)
    got = A.flash_attention(q, k, v, kl, kb, vb)
    want = A.attention_plain(q.contiguous(), k.contiguous(), v.contiguous(), kl, kb, vb)
    _check(got, want)


# d <= 160: the bank form with kv_lens, many key tiles; (1, 4096, 1, 512),
# the reference encode, splits its keys over 2 blocks and combines them;
# (8, 4096, 1, 512), a decode chunk, does not
@pytest.mark.parametrize("d,b", [(40, 2), (80, 2), (160, 2), (512, 1), (512, 8)])
def test_flash_attention_kernel_deterministic(gen, d, b):
    """Two K1 calls on the same inputs are bitwise equal, output and LSE."""
    kb = vb = kl = None
    if d <= 160:
        s, h = 1000, 4
        q, k, v = (_bf(gen, b, s, h, d) for _ in range(3))
        kb, vb = _bf(gen, 1, s, h, d), _bf(gen, 1, s, h, d)
        kl = torch.tensor([s, 2 * s - 77], device="cuda", dtype=torch.int32)
    else:
        q, k, v = (_bf(gen, b, 4096, 1, 512) for _ in range(3))
        sms = torch.cuda.get_device_properties(q.device).multi_processor_count
        assert (A.wide_splits(b, 1, 4096, 4096, sms) > 1) == (b == 1)
    first, lse1 = A.flash_attention(q, k, v, kl, kb, vb, return_lse=True)
    second, lse2 = A.flash_attention(q, k, v, kl, kb, vb, return_lse=True)
    assert torch.equal(first, second) and torch.equal(lse1, lse2)
    want, want_lse = A.attention_plain(q, k, v, kl, kb, vb, return_lse=True)
    _check(first, want)
    assert (lse1 - want_lse).abs().max().item() <= 1e-3


def _gn_input(gen, shape, groups, dtype=torch.bfloat16):
    # every group its own mean (up to 3 x its index) and every channel its
    # own scale, so a channel read into the wrong group's statistics is off
    # by O(1), and E[x^2] - E[x]^2 would lose digits
    c = shape[-1]
    ch = torch.arange(c, device="cuda")
    return (torch.randn(*shape, generator=gen, device="cuda") * (1 + ch / c)
            + 3.0 * (ch // (c // groups))).to(dtype)


BF, F32 = torch.bfloat16, torch.float32


# both regimes; group sizes 3, 4, 10, 30, 40 and 60 (a 16-byte vector of 8
# bf16 channels straddles groups of 3, 10 and 30); L ragged against the
# cluster's CTAs and the streaming splits; gamma/beta bf16, f32 or absent;
# x bf16 and f32; SiLU on and off
@pytest.mark.parametrize("shape,groups,act,wdtype,xdtype,regime", [
    ((3, 1000, 320), 32, "silu", BF, BF, "resident"),
    ((2, 64, 1280), 32, None, BF, BF, "resident"),
    ((2, 333, 96), 32, "silu", F32, BF, "resident"),
    ((2, 4096, 128), 32, None, None, BF, "resident"),
    ((2, 777, 960), 32, "silu", BF, BF, "resident"),
    ((2, 100, 1920), 32, None, F32, BF, "resident"),
    ((3, 1000, 320), 32, "silu", F32, F32, "resident"),
    ((2, 4099, 960), 32, None, F32, BF, "streaming"),
    ((2, 2049, 1920), 32, "silu", BF, BF, "streaming"),
    ((2, 20001, 128), 32, "silu", None, BF, "streaming"),
    ((2, 5000, 640), 32, None, BF, F32, "streaming"),
])
def test_group_norm_kernel(gen, shape, groups, act, wdtype, xdtype, regime):
    assert N.gn_plan(*shape, groups, xdtype)["regime"] == regime
    c = shape[-1]
    x = _gn_input(gen, shape, groups, xdtype)
    w = b = None
    if wdtype is not None:
        w, b = _bf(gen, c).to(wdtype), _bf(gen, c).to(wdtype)
    before = N.LAUNCHES
    got = N.group_norm(x, groups, w, b, 1e-6, act)
    assert N.LAUNCHES == before + 1
    assert got.dtype == xdtype and got.shape == x.shape
    _check(got, N.group_norm_plain(x, groups, w, b, 1e-6, act))


def test_group_norm_kernel_every_cluster_size_of_the_path(gen):
    """One full-size path shape for each cluster size the plan gives the
    main path (and one streaming shape), each against the plain version."""
    from test_torch_tile_plans import gn_path_shapes

    by_k = {}
    for shape in gn_path_shapes("full"):
        plan = N.gn_plan(*shape, 32)
        key = plan["k"] if plan["regime"] == "resident" else "streaming"
        if key not in by_k or shape[0] * shape[1] * shape[2] < math.prod(by_k[key]):
            by_k[key] = shape
    assert 16 in by_k and "streaming" in by_k
    for key, shape in sorted(by_k.items(), key=lambda kv: str(kv[0])):
        x = _gn_input(gen, shape, 32)
        w, b = _bf(gen, shape[-1]), _bf(gen, shape[-1])
        _check(N.group_norm(x, 32, w, b, 1e-6, "silu"), N.group_norm_plain(x, 32, w, b, 1e-6,
                                                                            "silu"))


# wav2vec2's conv-0 GroupNorm: 512 groups of one channel, f32, a 4 s clip's
# 12,799 frames (streaming); and shapes whose plan once asked for more shared
# memory than a block has (now resident in smaller clusters)
@pytest.mark.parametrize("shape,groups,xdtype,regime", [
    ((1, 12799, 512), 512, F32, "streaming"),
    ((2, 1001, 512), 512, F32, "streaming"),
    ((1, 64, 768), 768, F32, "resident"),
    ((1, 64, 1024), 1024, BF, "resident"),
    ((1, 32, 1536), 768, F32, "resident"),
])
def test_group_norm_kernel_many_groups(gen, shape, groups, xdtype, regime):
    plan = N.gn_plan(*shape, groups, xdtype)
    assert plan["regime"] == regime and plan["smem"] <= N.SMEM_LIMIT
    c = shape[-1]
    x = _gn_input(gen, shape, groups, xdtype)
    w, b = _bf(gen, c).to(F32), _bf(gen, c).to(F32)
    before = N.LAUNCHES
    got = N.group_norm(x, groups, w, b, 1e-5)
    assert N.LAUNCHES == before + 1
    _check(got, N.group_norm_plain(x, groups, w, b, 1e-5))


@pytest.mark.parametrize("sq,launches", [(600, 1), (257, 0)])
def test_dot_product_attention_f32_route(gen, sq, launches):
    """f32 (B, S, H, D) at 512 tokens or more goes through K1 in bf16 and
    back (wav2vec2 on clips over ~20 s); under 512 it is the plain math.
    Against the f32 plain version: the inputs' bf16 rounding, within 2 bf16
    ulps of the largest output."""
    q, k, v = (torch.randn(1, sq, 12, 64, generator=gen, device="cuda") for _ in range(3))
    before = A.LAUNCHES
    got = A.dot_product_attention(q, k, v)
    assert A.LAUNCHES == before + launches and got.dtype == torch.float32
    _check(got, A.attention_plain(q, k, v))


@pytest.mark.parametrize("n_w", [1, 2, 3])
def test_ln_projections_kernel(gen, n_w):
    c = 320
    x = _bf(gen, 2, 333, c)
    g, b = 1 + _bf(gen, c, scale=0.1), _bf(gen, c, scale=0.1)
    ws = [_bf(gen, 96 * (i + 1), c, scale=1 / math.sqrt(c)) for i in range(n_w)]
    bs = [_bf(gen, 96 * (i + 1)) for i in range(n_w)]
    for got, want in zip(L.ln_projections(x, g, b, ws, bs), L.ln_projections_plain(x, g, b, ws, bs)):
        _check(got, want)


@pytest.mark.parametrize("b,seq,d", [(1, 4096, 40), (2, 1024, 80), (1, 256, 160)])
def test_flash_attention_kernel_raw_bank_single_frame(gen, b, seq, d):
    """Pose2img's raw-bank route at f = 1: q (2b, L, 8, d) against its own
    keys concatenated with the bank's (2L keys), tiled [bk ; bk], with the
    CFG-uncond half (n_uncond = b) gated to its own L keys by kv_lens."""
    h = 8
    q, ks, vs = (_bf(gen, 2 * b, seq, h, d) for _ in range(3))
    kb, vb = _bf(gen, b, seq, h, d), _bf(gen, b, seq, h, d)
    k = torch.cat([ks, torch.cat([kb, kb], 0)], 1)
    v = torch.cat([vs, torch.cat([vb, vb], 0)], 1)
    gate = (torch.arange(2 * b, device="cuda") >= b).to(torch.int32)
    kl = seq + gate * seq
    got = A.flash_attention(q, k, v, kl)
    _check(got, A.attention_plain(q, k, v, kl))
    # the uncond rows see their own keys only
    _check(got[:b], A.attention_plain(q[:b], ks[:b], vs[:b]))


@pytest.mark.parametrize("outs,bias", [([320, 320, 320], False), ([2560], True)])
def test_ln_projections_kernel_pose2img_rows(gen, outs, bias):
    """Pose2img's level-0 batch: x (2, 4096, 320), 8192 rows (the CFG
    pair of one single-frame example), q/k/v and GEGLU."""
    c = 320
    x = _bf(gen, 2, 4096, c)
    g, b = 1 + _bf(gen, c, scale=0.1), _bf(gen, c, scale=0.1)
    ws = [_bf(gen, n, c, scale=1 / math.sqrt(c)) for n in outs]
    bs = [_bf(gen, n) if bias else None for n in outs]
    for got, want in zip(L.ln_projections(x, g, b, ws, bs), L.ln_projections_plain(x, g, b, ws, bs)):
        _check(got, want)


# M against the 128-row stripes and tiles; K = 64 and 320 (stripes), 640
# and 1280 (tiles); 1-3 weights with N off the 160-column stripe tile and
# the 128-column unit (96, 200), the GEGLU (2560) and the widest (10240)
# widths; with and without bias
@pytest.mark.parametrize("m,k,outs,bias", [
    (333, 320, [320, 320, 320], False), (1000, 640, [640, 200], True),
    (200, 1280, [1280, 96, 2560], True), (300, 320, [2560], True), (130, 1280, [10240], False),
    (77, 64, [64, 512], True)])
def test_ln_projections_kernel_tile_edges(gen, m, k, outs, bias):
    x = _bf(gen, m, k)
    g, b = 1 + _bf(gen, k, scale=0.1), _bf(gen, k, scale=0.1)
    ws = [_bf(gen, n, k, scale=1 / math.sqrt(k)) for n in outs]
    bs = [_bf(gen, n, scale=0.1) if bias else None for n in outs]
    before = L.LAUNCHES
    got = L.ln_projections(x, g, b, ws, bs)
    assert L.LAUNCHES == before + 1
    for gg, want in zip(got, L.ln_projections_plain(x, g, b, ws, bs)):
        _check(gg, want)


# K3's tiled regime (K >= 640): K = 640, 1280 and above (1344: a partial
# chunk; 2560); M off the 128-row tile (77, 130, 333, 1000); N off the
# 128-column unit and the 256-column tile (64: one unit; 136: a second unit
# of 8 columns, its second 64-column box past N; 200; 640: units of two
# weights in one tile); with and without bias; x far from a zero mean (the
# shifted sums), and rows past M
@pytest.mark.parametrize("m,k,outs,bias,offset", [
    (1000, 640, [640, 640, 640], False, 0.0), (333, 1280, [1280, 200], True, 0.0),
    (130, 2560, [136], True, 0.0), (77, 1344, [64, 640], False, 0.0),
    (300, 1280, [1280, 1280, 1280], True, 40.0)])
def test_ln_projections_kernel_tiled(gen, m, k, outs, bias, offset):
    x = (_bf(gen, m, k).float() + offset).to(torch.bfloat16)
    g, b = 1 + _bf(gen, k, scale=0.1), _bf(gen, k, scale=0.1)
    ws = [_bf(gen, n, k, scale=1 / math.sqrt(k)) for n in outs]
    bs = [_bf(gen, n, scale=0.1) if bias else None for n in outs]
    assert L.gemm_plan(m, k, outs)["regime"] == "tiled"
    before = L.LAUNCHES
    got = L.ln_projections(x, g, b, ws, bs)
    assert L.LAUNCHES == before + 1
    for gg, want in zip(got, L.ln_projections_plain(x, g, b, ws, bs)):
        _check(gg, want)


@pytest.mark.parametrize("m,k,outs", [(48 * 256, 1280, [1280] * 3), (1000, 640, [640])])
def test_ln_projections_kernel_deterministic(gen, m, k, outs):
    """Two K3 calls on the same inputs are bitwise equal (tiled regime)."""
    x = _bf(gen, m, k)
    g, b = 1 + _bf(gen, k, scale=0.1), _bf(gen, k, scale=0.1)
    ws = [_bf(gen, n, k, scale=1 / math.sqrt(k)) for n in outs]
    first = L.ln_projections(x, g, b, ws, [None] * len(outs))
    second = L.ln_projections(x, g, b, ws, [None] * len(outs))
    assert all(torch.equal(a, c) for a, c in zip(first, second))


# K3's stripe regime (K <= 320): persistent blocks over (128-row stripe, N
# split) items, each consumer warpgroup's 64 rows of the normalised stripe
# held as register A fragments against 80-column weight tiles. K = 64 and
# 320, and 512 and 576 (the tiled regime, which takes K > 320); N = 80, 160,
# 320, 3 x 320 and 2560; the single projections with a bias, q/k/v without
@pytest.mark.parametrize("k", [64, 320, 512, 576])
@pytest.mark.parametrize("outs", [[80], [160], [320], [320, 320, 320], [2560]])
def test_ln_projections_kernel_k_le_576(gen, k, outs):
    m = 333
    bias = len(outs) == 1
    x = _bf(gen, m, k)
    g, b = 1 + _bf(gen, k, scale=0.1), _bf(gen, k, scale=0.1)
    ws = [_bf(gen, n, k, scale=1 / math.sqrt(k)) for n in outs]
    bs = [_bf(gen, n, scale=0.1) if bias else None for n in outs]
    assert L.gemm_plan(m, k, outs)["regime"] == ("stripe" if k <= 320 else "tiled")
    before = L.LAUNCHES
    got = L.ln_projections(x, g, b, ws, bs)
    assert L.LAUNCHES == before + 1
    for gg, want in zip(got, L.ln_projections_plain(x, g, b, ws, bs)):
        _check(gg, want)


# M off the 128-row stripe (77: one partial stripe; 333; 8192 + 40: 65
# stripes, the last of 40 rows, split over the card) with x far from a zero
# mean (K = 576: the tiled regime)
@pytest.mark.parametrize("m", [77, 333, 8192 + 40])
@pytest.mark.parametrize("k", [64, 320, 576])
def test_ln_projections_kernel_stripe_rows(gen, m, k):
    x = (_bf(gen, m, k).float() + 20.0).to(torch.bfloat16)
    g, b = 1 + _bf(gen, k, scale=0.1), _bf(gen, k, scale=0.1)
    ws = [_bf(gen, 320, k, scale=1 / math.sqrt(k)) for _ in range(3)]
    bs = [_bf(gen, 320, scale=0.1) for _ in range(3)]
    for gg, want in zip(L.ln_projections(x, g, b, ws, bs), L.ln_projections_plain(x, g, b, ws, bs)):
        _check(gg, want)


# gamma, beta and the biases as the caller holds them, bf16 or f32, read
# without a cast in both regimes
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("k", [320, 576, 640])
def test_ln_projections_kernel_param_dtypes(gen, dtype, k):
    x = _bf(gen, 333, k)
    g, b = (1 + _bf(gen, k, scale=0.1)).to(dtype), _bf(gen, k, scale=0.1).to(dtype)
    ws = [_bf(gen, n, k, scale=1 / math.sqrt(k)) for n in (320, 160)]
    bs = [_bf(gen, n, scale=0.1).to(dtype) for n in (320, 160)]
    for gg, want in zip(L.ln_projections(x, g, b, ws, bs), L.ln_projections_plain(x, g, b, ws, bs)):
        _check(gg, want)


@pytest.mark.parametrize("outs,bias", [([320, 320, 320], False), ([2560], True)])
def test_ln_projections_kernel_stripe_deterministic(gen, outs, bias):
    """Two K3 calls on the same inputs are bitwise equal (stripe regime,
    K = 320, 65 stripes split over the card)."""
    m, k = 8192 + 40, 320
    x = _bf(gen, m, k)
    g, b = 1 + _bf(gen, k, scale=0.1), _bf(gen, k, scale=0.1)
    ws = [_bf(gen, n, k, scale=1 / math.sqrt(k)) for n in outs]
    bs = [_bf(gen, n, scale=0.1) if bias else None for n in outs]
    first = L.ln_projections(x, g, b, ws, bs)
    second = L.ln_projections(x, g, b, ws, bs)
    assert all(torch.equal(a, c) for a, c in zip(first, second))


@pytest.mark.parametrize("k,w_o", [(64, False), (320, False), (320, True)])
def test_ln_projections_stripe_launches_one_kernel(gen, k, w_o):
    """A K <= 320 call (bf16 gamma, beta and biases as the model holds
    them) is one kernel on the card: no cast, no pre-pass."""
    x = _bf(gen, 1000, k)
    g, b = 1 + _bf(gen, k, scale=0.1), _bf(gen, k, scale=0.1)
    ws = [_bf(gen, 320, k, scale=1 / math.sqrt(k)) for _ in range(1 if w_o else 3)]
    bs = [_bf(gen, 320, scale=0.1) for _ in ws]
    res = [_bf(gen, 1000, 320)] if w_o else None
    call = (lambda: L.ln_gemm(x, None, None, ws, bs, res=res)) if w_o else \
        (lambda: L.ln_projections(x, g, b, ws, bs))
    call()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        call()
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages() if e.device_time_total > 0]
    assert len(kernels) == 1 and kernels[0][1] == 1, kernels
    assert "ln_gemm_stripe" in kernels[0][0], kernels


@pytest.mark.parametrize("m,k,n", [(333, 320, 320), (1000, 640, 640), (200, 1280, 1280),
                                   (333, 1408, 200)])
def test_gemm_residual_epilogue(gen, m, k, n):
    """The GEMM without LayerNorm and with the bias + residual epilogue
    (K4's W_o)."""
    x, w = _bf(gen, m, k), _bf(gen, n, k, scale=1 / math.sqrt(k))
    bias, res = _bf(gen, n, scale=0.1), _bf(gen, m, n)
    (got,) = L.ln_gemm(x, None, None, [w], [bias], res=[res])
    want = (x.float() @ w.float().t() + bias.float() + res.float()).to(torch.bfloat16)
    _check(got, want)


@pytest.mark.parametrize("shape", [(2, 12, 200, 320), (2, 16, 64, 640)])
def test_motion_attention_kernel(gen, shape):
    c = shape[-1]
    x = _bf(gen, *shape)
    g, b = 1 + _bf(gen, c, scale=0.1), _bf(gen, c, scale=0.1)
    pe = M.sinusoidal_positions(32, c, "cuda")[: shape[1]]
    ws = [_bf(gen, c, c, scale=1 / math.sqrt(c)) for _ in range(4)]
    args = (x, g, b, pe, *ws, _bf(gen, c, scale=0.1), 8)
    ops.reset_launch_counts()
    got = M.motion_attention(*args)
    assert ops.launch_counts()["motion_attention"] == 1
    assert ops.launch_counts()["ln_projections"] == 0  # its GEMM launches are K4's own
    _check(got, M.motion_attention_plain(*args))


# token counts off the Lt-token blocks (Lt = 128 // F or 64 // F), F = 2, 8,
# 12 and 32, and C = 320, 640, 1280 at 8 heads (d = 40, 80, 160)
@pytest.mark.parametrize("shape", [(2, 2, 203, 320), (2, 8, 37, 640), (2, 12, 65, 1280),
                                   (1, 32, 41, 320), (1, 32, 9, 1280), (2, 12, 1001, 320)])
def test_motion_attention_kernel_tile_edges(gen, shape):
    c = shape[-1]
    x = _bf(gen, *shape)
    g, b = 1 + _bf(gen, c, scale=0.1), _bf(gen, c, scale=0.1)
    pe = M.sinusoidal_positions(32, c, "cuda")[: shape[1]]
    ws = [_bf(gen, c, c, scale=1 / math.sqrt(c)) for _ in range(4)]
    args = (x, g, b, pe, *ws, _bf(gen, c, scale=0.1), 8)
    ops.reset_launch_counts()
    got = M.motion_attention(*args)
    assert ops.launch_counts()["motion_attention"] == 1
    assert ops.launch_counts()["ln_projections"] == 0
    _check(got, M.motion_attention_plain(*args))


# a head shard under tensor parallelism: H_local heads of d columns, q/k/v
# (H_local d, C), W_o (C, H_local d), no residual and no bias (tp = 2 at
# levels 0 and 1: 4 heads of 40 and 80; tp = 4 at level 0: 2 heads of 40)
@pytest.mark.parametrize("shape,heads", [((2, 12, 200, 320), 4), ((2, 16, 64, 640), 4),
                                         ((1, 12, 203, 320), 2), ((2, 12, 65, 1280), 4)])
def test_motion_attention_kernel_head_shard(gen, shape, heads):
    c = shape[-1]
    d = c // 8
    inner = heads * d
    x = _bf(gen, *shape)
    g, b = 1 + _bf(gen, c, scale=0.1), _bf(gen, c, scale=0.1)
    pe = M.sinusoidal_positions(32, c, "cuda")[: shape[1]]
    ws = [_bf(gen, inner, c, scale=1 / math.sqrt(c)) for _ in range(3)]
    wo = _bf(gen, c, inner, scale=1 / math.sqrt(inner))
    args = (x, g, b, pe, *ws, wo, None, heads, 1e-5, False)
    ops.reset_launch_counts()
    got = M.motion_attention(*args)
    assert ops.launch_counts()["motion_attention"] == 1
    assert got.shape == x.shape
    _check(got, M.motion_attention_plain(*args))


def _k4_args(gen, shape, heads, tp=1, pdt=torch.bfloat16):
    """x, gamma and beta (in `pdt`), pe, q/k/v (inner, C) and W_o (C, inner)
    for `heads` heads of d = inner / heads; tp > 1: a head shard of the
    weights, no residual and no bias."""
    b, f, l, c = shape
    inner = c // tp
    x = _bf(gen, *shape)
    g, bb = (1 + _bf(gen, c, scale=0.1)).to(pdt), _bf(gen, c, scale=0.1).to(pdt)
    pe = M.sinusoidal_positions(32, c, "cuda")[:f]
    ws = [_bf(gen, inner, c, scale=1 / math.sqrt(c)) for _ in range(3)]
    wo = _bf(gen, c, inner, scale=1 / math.sqrt(inner))
    if tp == 1:
        return (x, g, bb, pe, *ws, wo, _bf(gen, c, scale=0.1), heads)
    return (x, g, bb, pe, *ws, wo, None, heads, 1e-5, False)


def _k4_check(args):
    ops.reset_launch_counts()
    got = M.motion_attention(*args)
    assert ops.launch_counts()["motion_attention"] == 1
    assert got.shape == args[0].shape
    _check(got, M.motion_attention_plain(*args))
    assert torch.equal(got, M.motion_attention(*args))  # two calls, the same bits


# every head dim K4 takes, at 2 and 8 heads (C = 2 d .. 8 d: the resident
# regime up to C = 320 and d = 64, 128 streamed rows to d = 80, 64 streamed
# rows with the head's columns split above), gamma and beta in bf16 and f32;
# 37 tokens end inside a block of every regime
@pytest.mark.parametrize("pdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("d,heads", [(d, h) for d in M._HEAD_DIMS for h in (2, 8)])
def test_motion_attention_kernel_head_dims(gen, d, heads, pdt):
    _k4_check(_k4_args(gen, (2, 12, 37, heads * d), heads, pdt=pdt))


# 1 to 32 frames at C = 320, 640 and 1280 (8 heads: d = 40, 80, 160), token
# counts off the blocks (Lh = 64 // F tokens a 64-row half)
@pytest.mark.parametrize("c", [320, 640, 1280])
@pytest.mark.parametrize("f,l", [(1, 130), (2, 70), (8, 19), (12, 23), (16, 9), (32, 5)])
def test_motion_attention_kernel_frames(gen, f, l, c):
    _k4_check(_k4_args(gen, (2, f, l, c), 8))


# head shards at tp = 2 and 4 at C = 320, 640 and 1280, gamma and beta in
# bf16 and f32
@pytest.mark.parametrize("pdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c,tp", [(320, 2), (320, 4), (640, 2), (640, 4), (1280, 2), (1280, 4)])
def test_motion_attention_kernel_shards(gen, c, tp, pdt):
    _k4_check(_k4_args(gen, (2, 12, 51, c), 8 // tp, tp, pdt))


# a unit count that the cluster size does not divide: one row of L = 64 + 5
# tokens, at d = 160 14 blocks of 5 tokens in clusters of 4, at d = 80 7
# blocks of 10 in clusters of 2; gamma and beta in bf16 and f32
@pytest.mark.parametrize("pdt", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c", [640, 1280])
def test_motion_attention_kernel_ragged_clusters(gen, c, pdt):
    plan = M.attn_plan(12, 69, c, 8, batch=1)
    blocks = -(-69 // (plan["groups"] * plan["lh"]))
    assert plan["regime"] == "cluster" and blocks % plan["cs"] != 0
    _k4_check(_k4_args(gen, (1, 12, 69, c), 8, pdt=pdt))


@pytest.mark.parametrize("c,pdt", [(320, torch.bfloat16), (320, torch.float32),
                                   (640, torch.float32), (1280, torch.bfloat16)])
def test_motion_attention_launches_only_its_kernels(gen, c, pdt):
    """A K4 call launches only K4's kernels and K3's W_o GEMM, and no cast,
    with gamma and beta in bf16 or f32: at C <= 320 the fused kernel and
    the GEMM; at C = 640 and 1280 (d = 80, 160) the LayerNorm pre-pass, the
    cluster kernel and the GEMM."""
    args = _k4_args(gen, (2, 12, 64, c), 8, pdt=pdt)
    M.motion_attention(*args)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        M.motion_attention(*args)
        torch.cuda.synchronize()
    kernels = [(e.key, e.count) for e in prof.key_averages() if e.device_time_total > 0]
    want = ("motion_fused", "ln_gemm") if c <= 320 else ("ln_pe", "motion_cluster", "ln_gemm")
    assert len(kernels) == len(want) and all(n == 1 for _, n in kernels), kernels
    for name in want:
        assert sum(name in k for k, _ in kernels) == 1, (name, kernels)


# K3 on the tp shard shapes: level-0 q/k/v at tp = 2 (3 x 160) and tp = 4
# (3 x 80, a partial 160-column tile), the GEGLU half-pairs (1280, 640)
# with bias, level-2 audio q at tp = 2 (3 x 640 of K = 1280)
@pytest.mark.parametrize("m,k,outs,bias", [(48 * 512, 320, (160, 160, 160), False),
                                           (48 * 512, 320, (80, 80, 80), False),
                                           (12 * 4096, 320, (1280,), True),
                                           (12 * 4096, 320, (640,), True),
                                           (24 * 256, 1280, (640, 640, 640), False)])
def test_ln_projections_kernel_shard_shapes(gen, m, k, outs, bias):
    x = _bf(gen, m, k)
    g, b = 1 + _bf(gen, k, scale=0.1), _bf(gen, k, scale=0.1)
    ws = [_bf(gen, n, k, scale=1 / math.sqrt(k)) for n in outs]
    bs = [_bf(gen, n, scale=0.1) if bias else None for n in outs]
    before = L.LAUNCHES
    got = L.ln_projections(x, g, b, ws, bs)
    assert L.LAUNCHES == before + 1
    for gt, want in zip(got, L.ln_projections_plain(x, g, b, ws, bs)):
        _check(gt, want)


def _qkv(gen, sq, skv, h, d, interleaved):
    """q, k, v of (2, S, h, d); interleaved: views into one projection
    output a row, as K3's fused q/k/v (row stride 3 h d, or 2 h d for K/V)."""
    if not interleaved:
        return _bf(gen, 2, sq, h, d), _bf(gen, 2, skv, h, d), _bf(gen, 2, skv, h, d)
    qbuf, kvbuf = _bf(gen, 2, sq, 3, h, d), _bf(gen, 2, skv, 2, h, d)
    return qbuf[:, :, 0], kvbuf[:, :, 0], kvbuf[:, :, 1]


# ragged Sq / Skv against the 128-query and 128-key blocks, the 128- or
# 64-key tiles of the dq pass, the 64- or 32-query tiles of the dk/dv pass
# and the 64 keys of each consumer warpgroup; kv_lens ending inside a tile
# (97: in the second warpgroup's keys; 45: the first's, the second's all
# masked; 33 at d = 160), rows with kv_len = 0 (d = 40, 80, 160), strided
# views of a fused q/k/v projection, and the tp = 2 head count (4 of 8)
@pytest.mark.parametrize("d,sq,skv,h,lens,interleaved", [
    (40, 300, 557, 2, [557, 123], False), (40, 200, 300, 2, [300, 0], False),
    (80, 300, 600, 2, [450, 0], False), (160, 130, 257, 2, None, False),
    (160, 200, 400, 2, [333, 0], False),
    (40, 190, 333, 2, [333, 97], False), (40, 77, 190, 2, [45, 150], False),
    (80, 77, 131, 2, [0, 100], False), (160, 100, 197, 2, [150, 33], False),
    (40, 300, 557, 2, [500, 129], True), (80, 130, 260, 2, [200, 260], True),
    (160, 70, 140, 2, None, True), (40, 1024, 2048, 4, [1024, 2048], False)])
def test_flash_attention_backward_kernel(gen, d, sq, skv, h, lens, interleaved):
    """K5 against attention_bwd_plain; a 0 in lens is a row with no valid
    key (lse ~ -1e30), whose gradients must be exactly zero."""
    q, k, v = _qkv(gen, sq, skv, h, d, interleaved)
    do = _bf(gen, 2, sq, h, d)
    kl = None if lens is None else torch.tensor(lens, device="cuda", dtype=torch.int32)
    o, lse = A.flash_attention(q, k, v, kl, return_lse=True)
    before = A.BWD_LAUNCHES
    got = A.flash_attention_bwd(q, k, v, o, do, lse, kl)
    assert A.BWD_LAUNCHES == before + 1
    want = A.attention_bwd_plain(q, k, v, o, do, lse, kl)
    for g, w in zip(got, want):
        assert torch.isfinite(g).all()
        _check(g, w, ulps=4)
    if lens is not None and 0 in lens:
        row = lens.index(0)
        assert all(g[row].abs().max().item() == 0 for g in got)


@pytest.mark.parametrize("d", [40, 80, 160])
def test_flash_attention_backward_kernel_deterministic(gen, d):
    """Two K5 calls on the same inputs are bitwise equal (no atomics, a
    fixed summation order)."""
    h, sq, skv = 2, 300, 557
    q, k, v, do = _bf(gen, 2, sq, h, d), _bf(gen, 2, skv, h, d), _bf(gen, 2, skv, h, d), \
        _bf(gen, 2, sq, h, d)
    kl = torch.tensor([500, 129], device="cuda", dtype=torch.int32)
    o, lse = A.flash_attention(q, k, v, kl, return_lse=True)
    first = A.flash_attention_bwd(q, k, v, o, do, lse, kl)
    second = A.flash_attention_bwd(q, k, v, o, do, lse, kl)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def _grads_match(kernel, plain, inputs, gen):
    outs = kernel(*inputs)
    outs = outs if isinstance(outs, tuple) else (outs,)
    cots = [torch.randn(o.shape, generator=gen, device="cuda").to(o.dtype) for o in outs]
    got = torch.autograd.grad(outs, inputs, cots)
    want_outs = plain(*inputs)
    want_outs = want_outs if isinstance(want_outs, tuple) else (want_outs,)
    for g, w in zip(got, torch.autograd.grad(want_outs, inputs, cots)):
        assert g is not None
        _check(g, w, ulps=4)


def _leaf(gen, *shape, scale=1.0):
    return _bf(gen, *shape, scale=scale).requires_grad_(True)


def test_flash_attention_function_grads(gen):
    kl = torch.tensor([300, 557], device="cuda", dtype=torch.int32)
    inputs = [_leaf(gen, 2, 300, 2, 40) for _ in range(3)] + [_leaf(gen, 1, 257, 2, 40)
                                                              for _ in range(2)]
    ops.reset_launch_counts()
    _grads_match(lambda q, k, v, kb, vb: A.flash_attention(q, k, v, kl, kb, vb),
                 lambda q, k, v, kb, vb: A.attention_plain(q, k, v, kl, kb, vb), inputs, gen)
    counts = ops.launch_counts()
    assert counts["flash_attention"] == 1 and counts["flash_attention_bwd"] == 1


def test_group_norm_function_grads(gen):
    c = 320
    ops.reset_launch_counts()
    _grads_match(lambda x, w, b: N.group_norm(x, 32, w, b, 1e-6, "silu"),
                 lambda x, w, b: N.group_norm_plain(x, 32, w, b, 1e-6, "silu"),
                 [_leaf(gen, 2, 500, c), _leaf(gen, c), _leaf(gen, c)], gen)
    assert ops.launch_counts()["group_norm"] == 1


def test_ln_projections_function_grads(gen):
    c = 320
    inputs = [_leaf(gen, 2, 333, c), _leaf(gen, c, scale=0.1), _leaf(gen, c, scale=0.1)] + \
        [_leaf(gen, 96 * (i + 1), c, scale=1 / math.sqrt(c)) for i in range(2)] + \
        [_leaf(gen, 96 * (i + 1)) for i in range(2)]
    ops.reset_launch_counts()
    _grads_match(lambda x, g, b, w0, w1, b0, b1: L.ln_projections(x, g, b, [w0, w1], [b0, b1]),
                 lambda x, g, b, w0, w1, b0, b1: L.ln_projections_plain(x, g, b, [w0, w1],
                                                                         [b0, b1]),
                 inputs, gen)
    assert ops.launch_counts()["ln_projections"] == 1


def test_motion_attention_function_grads(gen):
    c = 320
    pe = M.sinusoidal_positions(32, c, "cuda")[:12]
    inputs = [_leaf(gen, 2, 12, 200, c), _leaf(gen, c, scale=0.1), _leaf(gen, c, scale=0.1)] + \
        [_leaf(gen, c, c, scale=1 / math.sqrt(c)) for _ in range(4)] + [_leaf(gen, c, scale=0.1)]
    ops.reset_launch_counts()
    _grads_match(lambda x, g, b, wq, wk, wv, wo, bo: M.motion_attention(x, g, b, pe, wq, wk, wv,
                                                                        wo, bo, 8),
                 lambda x, g, b, wq, wk, wv, wo, bo: M.motion_attention_plain(
                     x, g, b, pe, wq, wk, wv, wo, bo, 8), inputs, gen)
    assert ops.launch_counts()["motion_attention"] == 1


def test_onnx_runner_on_the_card_matches_the_cpu(gen, tmp_path):
    """The port's OnnxRunner (no kernel of its own: cuDNN and cuBLAS in f32,
    TF32 off) on the exported miniature TFC-TDF separator graph, card
    against CPU, within 1e-4 of the largest |output|; none of K1-K5."""
    import numpy as np

    from test_separator_mdx_arch import MiniConvTDFNetTrim, _export_onnx

    from mmgt_tpu_torch.device import disable_tf32
    from mmgt_tpu_torch.utils.onnx_exec import OnnxRunner

    disable_tf32()
    torch.manual_seed(0)
    path = str(tmp_path / "mini_tfc_tdf.onnx")
    _export_onnx(MiniConvTDFNetTrim(dim_f=64).eval(), torch.randn(1, 4, 64, 32), path)
    x = np.random.default_rng(0).standard_normal((1, 4, 64, 32)).astype(np.float32)
    ops.reset_launch_counts()
    (got,) = OnnxRunner.from_file(path, "cuda")(x).values()
    (want,) = OnnxRunner.from_file(path, "cpu")(x).values()
    assert got.device.type == "cuda" and want.device.type == "cpu"
    err = (got.cpu() - want).abs().max().item()
    assert err <= 1e-4 * want.abs().max().item(), err
    assert not any(ops.launch_counts().values())
