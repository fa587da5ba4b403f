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
from mmgt_tpu_torch.ops import attention as A
from mmgt_tpu_torch.ops import fused_ln as L
from mmgt_tpu_torch.ops import motion_attention as M
from mmgt_tpu_torch.ops import norms as N

pytestmark = pytest.mark.gpu


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.Generator(device="cuda").manual_seed(0)


def _bf(gen, *shape, scale=1.0):
    return (torch.randn(*shape, generator=gen, device="cuda") * scale).to(torch.bfloat16)


def _check(got, want, ulps=2):
    tol = ulps * 2.0 ** -7 * want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


# Sq = 300 and Lb = 257 end inside a tile of every variant (128 queries and
# 128 or 64 keys for d <= 160, 64 and 64 for d = 512); kv_lens end inside a
# self tile ([200, ...]), inside a bank tile (300 + 100) or at 0 (no key)
@pytest.mark.parametrize("d,bank,lens", [
    (40, True, [300, 557]), (40, True, [200, 400]), (80, False, [300, 150]),
    (80, True, [130, 0]), (160, True, None), (160, True, [77, 450]), (512, False, None),
    (512, True, [299, 0])])
def test_flash_attention_kernel(gen, d, bank, lens):
    s, h = 300, 2
    q, k, v = _bf(gen, 2, s, h, d), _bf(gen, 2, s, h, d), _bf(gen, 2, s, h, d)
    kb = _bf(gen, 1, 257, h, d) if bank else None
    vb = _bf(gen, 1, 257, h, d) if bank else None
    kl = None if lens is None else torch.tensor(lens, device="cuda", dtype=torch.int32)
    before = A.LAUNCHES
    got, lse = A.flash_attention(q, k, v, kl, kb, vb, return_lse=True)
    assert A.LAUNCHES == before + 1
    want, want_lse = A.attention_plain(q, k, v, kl, kb, vb, return_lse=True)
    _check(got, want)
    assert (lse - want_lse).abs().max().item() <= 1e-3
    if lens is not None and 0 in lens:  # a row with no valid key gives 0
        assert got[lens.index(0)].abs().max().item() == 0


@pytest.mark.parametrize("d,bank", [(40, True), (80, False), (160, True)])
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


# M against the 128- and 64-row stripes; K = 320 (128-row stripes), 640 and
# 1280 (64-row); 1-3 weights with N off the 160-column tile (96, 200), the
# GEGLU (2560) and the widest (10240) widths; with and without bias
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


@pytest.mark.parametrize("m,k,n", [(333, 320, 320), (1000, 640, 640), (200, 1280, 1280)])
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


# ragged Sq / Skv against the 128-query and 128- or 64-key tiles, kv_lens
# ending inside a tile, and rows with kv_len = 0
@pytest.mark.parametrize("d,sq,skv,lens", [(40, 300, 557, [557, 123]), (40, 200, 300, [300, 0]),
                                           (80, 300, 600, [450, 0]), (160, 130, 257, None),
                                           (160, 200, 400, [333, 0])])
def test_flash_attention_backward_kernel(gen, d, sq, skv, lens):
    """K5 against attention_bwd_plain; a 0 in lens is a row with no valid
    key (lse ~ -1e30), whose gradients must be exactly zero."""
    h = 2
    q, k, v, do = _bf(gen, 2, sq, h, d), _bf(gen, 2, skv, h, d), _bf(gen, 2, skv, h, d), \
        _bf(gen, 2, sq, h, d)
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


@pytest.mark.parametrize("d", [40, 160])
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
