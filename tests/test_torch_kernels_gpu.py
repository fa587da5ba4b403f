"""Each of the port's four kernels against its plain version, on the card.

Marked `gpu`; each test skips when no CUDA device is present (decided
inside the test, never at import). Run them on a GPU machine with
    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q
Tolerance: two bf16 ulps at the largest output magnitude (both sides
round an f32 result to bf16; the summation order may flip that rounding).
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


def _check(got, want):
    tol = 2 * 2.0 ** -7 * want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert err <= tol, (err, tol)


@pytest.mark.parametrize("d,bank,lens", [(40, True, [300, 557]), (80, False, [300, 150]),
                                         (160, True, None), (512, False, None)])
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


@pytest.mark.parametrize("shape,act", [((3, 1000, 320), "silu"), ((2, 64, 1280), None)])
def test_group_norm_kernel(gen, shape, act):
    # every group its own mean and every channel its own scale, so a channel
    # read into the wrong group's statistics is off by O(1)
    c = shape[-1]
    ch = torch.arange(c, device="cuda")
    x = (torch.randn(*shape, generator=gen, device="cuda") * (1 + ch / c)
         + 3.0 * (ch // (c // 32))).to(torch.bfloat16)
    w, b = _bf(gen, shape[-1]), _bf(gen, shape[-1])
    _check(N.group_norm(x, 32, w, b, 1e-6, act), N.group_norm_plain(x, 32, w, b, 1e-6, act))


@pytest.mark.parametrize("n_w", [1, 2, 3])
def test_ln_projections_kernel(gen, n_w):
    c = 320
    x = _bf(gen, 2, 333, c)
    g, b = 1 + _bf(gen, c, scale=0.1), _bf(gen, c, scale=0.1)
    ws = [_bf(gen, 96 * (i + 1), c, scale=1 / math.sqrt(c)) for i in range(n_w)]
    bs = [_bf(gen, 96 * (i + 1)) for i in range(n_w)]
    for got, want in zip(L.ln_projections(x, g, b, ws, bs), L.ln_projections_plain(x, g, b, ws, bs)):
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
