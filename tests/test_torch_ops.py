"""mmgt_tpu_torch ops (plain versions, CPU, f32) against mmgt_tpu's Pallas
kernels run in interpret mode (or their plain reference).

Tolerance 1e-5 (relative and absolute): both sides compute in f32 and
differ only in summation order.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmgt_tpu.ops import attention as JA
from mmgt_tpu.ops import fused_ln as JL
from mmgt_tpu.ops import motion_attention as JM
from mmgt_tpu.ops import norms as JN
from mmgt_tpu_torch import ops
from mmgt_tpu_torch.ops import attention as A
from mmgt_tpu_torch.ops import fused_ln as L
from mmgt_tpu_torch.ops import motion_attention as M
from mmgt_tpu_torch.ops import norms as N
from torch_port_util import close, one_torch_thread, t  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)


def _rand(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


@pytest.mark.parametrize("b,h,sq,skv,d,lens", [
    (2, 2, 64, 96, 8, [96, 40]),
    (1, 3, 130, 70, 16, None),
])
def test_flash_attention_matches_pallas(b, h, sq, skv, d, lens):
    rng = np.random.default_rng(0)
    q, k, v = _rand(rng, b, sq, h, d), _rand(rng, b, skv, h, d), _rand(rng, b, skv, h, d)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    want = JA.dot_product_attention(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
        kv_lens=jl, impl="pallas_interpret",
    ).transpose(0, 2, 1, 3)
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    got = A.flash_attention(t(q), t(k), t(v), kl)
    close(got, want, **TOL)


def test_flash_attention_lse_matches_pallas():
    rng = np.random.default_rng(1)
    b, h, sq, skv, d = 2, 2, 40, 72, 8
    q, k, v = _rand(rng, b, sq, h, d), _rand(rng, b, skv, h, d), _rand(rng, b, skv, h, d)
    lens = [72, 33]
    scale = 1.0 / math.sqrt(d)
    o, lse = JA._flash_attention_fwd_lse(
        *(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
        jnp.asarray(lens, jnp.int32), scale, interpret=True)
    got_o, got_lse = A.flash_attention(t(q), t(k), t(v), torch.tensor(lens), scale=scale,
                                       return_lse=True)
    close(got_o, np.asarray(o).transpose(0, 2, 1, 3), **TOL)
    close(got_lse, np.asarray(lse)[:, :sq, 0].reshape(b, h, sq), **TOL)


def _pack(x, slab=128):
    b, s, h, d = x.shape
    out = np.zeros((b, s, h, slab), np.float32)
    out[..., :d] = x
    return jnp.asarray(out.reshape(b, s, h * slab))


@pytest.mark.parametrize("bank_on", [True, False])
def test_two_segment_matches_pallas(bank_on):
    rng = np.random.default_rng(2)
    b, h, ls, lb, d = 3, 2, 48, 40, 8
    q, ks, vs = _rand(rng, b, ls, h, d), _rand(rng, b, ls, h, d), _rand(rng, b, ls, h, d)
    kb, vb = _rand(rng, 1, lb, h, d), _rand(rng, 1, lb, h, d)
    # CFG layout: the first row is uncond (bank off)
    lens = [ls, ls + lb, ls + lb] if bank_on else [ls] * b
    scale = 1.0 / math.sqrt(d)
    o, lse = JA._flash_attention_packed_2seg_fwd(
        _pack(q), _pack(ks), _pack(vs), _pack(kb), _pack(vb), jnp.asarray(lens, jnp.int32),
        scale, 128, interpret=True)
    want_o = np.asarray(o).reshape(b, ls, h, 128)[..., :d]
    got_o, got_lse = A.flash_attention(t(q), t(ks), t(vs), torch.tensor(lens), t(kb), t(vb),
                                       return_lse=True)
    close(got_o, want_o, **TOL)
    close(got_lse, np.asarray(lse)[:, :ls, 0].reshape(b, h, ls), **TOL)


def test_single_kv_token_shortcut():
    rng = np.random.default_rng(3)
    q, k, v = _rand(rng, 2, 10, 2, 8), _rand(rng, 2, 1, 2, 8), _rand(rng, 2, 1, 2, 8)
    want = JA.dot_product_attention_bshd(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    close(A.flash_attention(t(q), t(k), t(v)), want, **TOL)


# C = 64 (group size 2), and the group sizes that a 16-byte vector of 8
# bf16 channels straddles on the card: 3 (C = 96) and 10 (C = 320)
_GN_CASES = [(act, impl, c) for c in (64, 96, 320) for act in (None, "silu")
             for impl in ("pallas_interpret", "pallas_blocked_interpret")]


@pytest.mark.parametrize("act,impl,c", _GN_CASES, ids=[
    f"{act}-{impl}" + ("" if c == 64 else f"-c{c}") for act, impl, c in _GN_CASES])
def test_group_norm_matches_pallas(impl, act, c):
    rng = np.random.default_rng(4)
    x = _rand(rng, 2, 8, 8, c) * 2 + 0.5
    w, b = _rand(rng, c), _rand(rng, c)
    want = JN.group_norm(jnp.asarray(x), 32, jnp.asarray(w), jnp.asarray(b), 1e-6, act,
                         impl=impl)
    close(N.group_norm(t(x), 32, t(w), t(b), 1e-6, act), want, **TOL)


def test_layer_norm_matches_reference():
    rng = np.random.default_rng(5)
    x, w, b = _rand(rng, 3, 7, 48), _rand(rng, 48), _rand(rng, 48)
    want = JN.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b), 1e-5)
    close(N.layer_norm(t(x), t(w), t(b), 1e-5), want, **TOL)


@pytest.mark.parametrize("n_w", [1, 2, 3])
def test_ln_projections_match_pallas(n_w):
    rng = np.random.default_rng(6 + n_w)
    c = 64
    x = _rand(rng, 2, 40, c)
    g, beta = 1 + 0.1 * _rand(rng, c), 0.1 * _rand(rng, c)
    ws = [_rand(rng, c, 24 + 8 * i) / 8 for i in range(n_w)]   # flax (C, D) layout
    bs = [_rand(rng, 24 + 8 * i) for i in range(n_w)]
    want = JL._ln_proj_fwd(jnp.asarray(x), jnp.asarray(g), jnp.asarray(beta),
                           tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)), 1e-5,
                           interpret=True)
    got = L.ln_projections(t(x), t(g), t(beta), [t(w.T) for w in ws], [t(b) for b in bs])
    assert len(got) == n_w
    for gi, wi in zip(got, want):
        close(gi, wi, **TOL)


def _motion_args(rng, b, f, l, c):
    x = _rand(rng, b, f, l, c)
    g, beta = 1 + 0.1 * _rand(rng, c), 0.1 * _rand(rng, c)
    pe = np.asarray(M.sinusoidal_positions(32, c)[:f])
    ws = [_rand(rng, c, c) / math.sqrt(c) for _ in range(4)]  # flax (in, out)
    bo = 0.1 * _rand(rng, c)
    return x, g, beta, pe, ws, bo


def _port_motion(x, g, beta, pe, ws, bo, heads):
    return M.motion_attention(t(x), t(g), t(beta), t(pe), *[t(w.T) for w in ws], t(bo), heads)


def test_motion_attention_matches_pallas():
    rng = np.random.default_rng(10)
    x, g, beta, pe, ws, bo = _motion_args(rng, 2, 4, 128, 64)
    want = JM._motion_fwd(jnp.asarray(x), jnp.asarray(g), jnp.asarray(beta), jnp.asarray(pe),
                          *map(jnp.asarray, ws), jnp.asarray(bo), 8, 1e-5, interpret=True)
    close(_port_motion(x, g, beta, pe, ws, bo, 8), want, **TOL)


def test_motion_attention_64_tokens_matches_reference():
    """L = 64 (level-3 and mid motion modules): the JAX package routes it
    to XLA; the port's kernel takes it."""
    rng = np.random.default_rng(11)
    x, g, beta, pe, ws, bo = _motion_args(rng, 2, 6, 64, 64)
    want = JM.motion_ref(jnp.asarray(x), jnp.asarray(g), jnp.asarray(beta), jnp.asarray(pe),
                         *map(jnp.asarray, ws), jnp.asarray(bo), 8, 1e-5)
    close(_port_motion(x, g, beta, pe, ws, bo, 8), want, **TOL)


@pytest.mark.parametrize("tp", [2, 4])
def test_motion_attention_head_shards_sum_to_pallas(tp):
    """Under tensor parallelism each rank runs the plain K4 on its heads
    (q/k/v rows and W_o columns of its slice), without residual and bias;
    the partial sums + b_o + x equal the JAX kernel's whole output (TOL)."""
    rng = np.random.default_rng(12)
    c, heads = 64, 8
    x, g, beta, pe, ws, bo = _motion_args(rng, 2, 4, 128, c)
    want = JM._motion_fwd(jnp.asarray(x), jnp.asarray(g), jnp.asarray(beta), jnp.asarray(pe),
                          *map(jnp.asarray, ws), jnp.asarray(bo), heads, 1e-5, interpret=True)
    n = c // tp
    got = t(x) + t(bo)
    for r in range(tp):
        cols = slice(r * n, (r + 1) * n)
        wq, wk, wv = (t(w[:, cols].T.copy()) for w in ws[:3])
        wo = t(ws[3][cols].T.copy())  # W_o (C, inner): the shard's input columns
        part = M.motion_attention(t(x), t(g), t(beta), t(pe), wq, wk, wv, wo, None,
                                  heads // tp, 1e-5, residual=False)
        assert part.shape == x.shape
        got = got + part
    close(got, want, **TOL)


def test_sinusoidal_positions_match():
    from mmgt_tpu.models.blocks import sinusoidal_positions

    close(M.sinusoidal_positions(32, 64), sinusoidal_positions(32, 64), rtol=0, atol=1e-6)


def test_cpu_tensors_take_the_plain_path_and_other_devices_raise():
    """CPU tensors run the plain versions (no kernel launch is counted);
    a device with no kernel raises instead of falling back."""
    ops.reset_launch_counts()
    x = torch.randn(2, 16, 64)
    A.flash_attention(x.reshape(2, 16, 8, 8), x.reshape(2, 16, 8, 8), x.reshape(2, 16, 8, 8))
    N.group_norm(x, 32)
    L.ln_projections(x, torch.ones(64), torch.zeros(64), [torch.randn(8, 64)], [None])
    assert ops.launch_counts() == {k: 0 for k in ops.KERNEL_COUNTERS}
    meta = torch.empty(2, 16, 64, device="meta")
    with pytest.raises(ValueError):
        N.group_norm(meta, 32)
    with pytest.raises(ValueError):
        L.ln_projections(meta, meta[0, 0], meta[0, 0], [meta[0, :8]], [None])
    with pytest.raises(ValueError):
        q = meta.reshape(2, 16, 8, 8)
        A.flash_attention(q, q, q)


# ------------------------------------------------------------- gradients
# The port's autograd Functions against jax.grad of the JAX package's
# custom VJPs, both in f32. Tolerance 1e-4 (relative and absolute): the
# gradients sum hundreds of f32 products in another order.
GRAD_TOL = dict(rtol=1e-4, atol=1e-4)


def _grads(out, inputs, cot):
    outs = out if isinstance(out, tuple) else (out,)
    cots = cot if isinstance(cot, tuple) else (cot,)
    loss = sum((o * c).sum() for o, c in zip(outs, cots))
    return torch.autograd.grad(loss, inputs)


@pytest.mark.parametrize("lens", [None, [390, 200]])
def test_flash_attention_backward_matches_pallas(lens):
    """`_FlashAttention` (forward with LSE, `attention_bwd_plain` on the CPU)
    against the Pallas dq and dk/dv kernels in interpret mode."""
    rng = np.random.default_rng(12)
    b, h, sq, skv, d = 2, 3, 260, 390, 40
    q, k, v = (_rand(rng, b, s, h, d) * 0.5 for s in (sq, skv, skv))
    do = _rand(rng, b, sq, h, d)
    jl = None if lens is None else jnp.asarray(lens, jnp.int32)
    bhsd = lambda x: jnp.asarray(x).transpose(0, 2, 1, 3)
    want = jax.grad(
        lambda *a: jnp.sum(JA.dot_product_attention(*a, kv_lens=jl, impl="pallas_interpret")
                           * bhsd(do)), argnums=(0, 1, 2))(bhsd(q), bhsd(k), bhsd(v))
    tq, tk, tv = (t(x).requires_grad_(True) for x in (q, k, v))
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32)
    got = _grads(A.flash_attention(tq, tk, tv, kl), (tq, tk, tv), t(do))
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        close(g, np.asarray(w).transpose(0, 2, 1, 3), **GRAD_TOL, msg=name)


def test_attention_bwd_plain_zero_row():
    """A row with kv_len = 0 (K1's lse ~ -1e30): its keys are masked before
    the exp, so every gradient of that row is exactly 0 and finite."""
    rng = np.random.default_rng(13)
    q, k, v, do = (t(_rand(rng, 2, 33, 2, 8)) for _ in range(4))
    lens = torch.tensor([33, 0], dtype=torch.int32)
    o, lse = A.attention_plain(q, k, v, lens, return_lse=True)
    dq, dk, dv = A.flash_attention_bwd(q, k, v, o, do, lse, lens)
    for g in (dq, dk, dv):
        assert torch.isfinite(g).all() and g[1].abs().max() == 0
    assert dq[0].abs().max() > 0


def test_bank_form_grads_match_packed_2seg_vjp():
    """The bank form: the bank's dK/dV are summed over the batch, as
    `packed_attention_2seg`'s VJP (`_packed_2seg_bwd`)."""
    rng = np.random.default_rng(14)
    b, h, d, lq, lb = 2, 2, 40, 256, 128
    slab = JA.packed_slab(d)
    q, ks, vs = (_rand(rng, b, lq, h, d) * 0.3 for _ in range(3))
    kb, vb = (_rand(rng, 1, lb, h, d) * 0.3 for _ in range(2))
    lens = [lq, lq + lb]
    p = lambda x: _pack(x, slab)
    prev = JA.FORCE_PACKED_INTERPRET
    JA.FORCE_PACKED_INTERPRET = True
    try:
        want = jax.grad(lambda *a: jnp.sum(JA.packed_attention_2seg(
            *a, jnp.asarray(lens, jnp.int32), 1.0 / math.sqrt(d), slab, d) ** 2),
            argnums=(0, 1, 2, 3, 4))(p(q), p(ks), p(vs), p(kb), p(vb))
    finally:
        JA.FORCE_PACKED_INTERPRET = prev
    args = [t(x).requires_grad_(True) for x in (q, ks, vs, kb, vb)]
    o = A.flash_attention(args[0], args[1], args[2], torch.tensor(lens), args[3], args[4])
    got = torch.autograd.grad((o ** 2).sum(), args)
    for name, g, w in zip(("q", "k_self", "v_self", "k_bank", "v_bank"), got, want):
        w = np.asarray(w).reshape(*g.shape[:3], slab)[..., :d]
        close(g, w, **GRAD_TOL, msg=name)


@pytest.mark.parametrize("act", [None, "silu"])
def test_group_norm_grads_match_pallas_vjp(act):
    rng = np.random.default_rng(15)
    x = _rand(rng, 2, 8, 8, 64) * 2 + 0.5
    w, b, g = _rand(rng, 64), _rand(rng, 64), _rand(rng, 2, 8, 8, 64)
    want = jax.grad(lambda x, w, b: jnp.sum(
        JN.group_norm(x, 32, w, b, 1e-6, act, impl="pallas_interpret") * g),
        argnums=(0, 1, 2))(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    args = [t(a).requires_grad_(True) for a in (x, w, b)]
    got = _grads(N.group_norm(args[0], 32, args[1], args[2], 1e-6, act), args, t(g))
    for name, gi, wi in zip(("x", "weight", "bias"), got, want):
        close(gi, wi, **GRAD_TOL, msg=name)


def test_ln_projections_grads_match_pallas_vjp():
    rng = np.random.default_rng(16)
    c, outs = 64, (24, 32, 40)
    x = _rand(rng, 2, 40, c)
    gam, beta = 1 + 0.1 * _rand(rng, c), 0.1 * _rand(rng, c)
    ws = [_rand(rng, c, n) / 8 for n in outs]     # flax (C, D) layout
    bs = [_rand(rng, n) for n in outs]
    cots = [_rand(rng, 2, 40, n) for n in outs]
    prev = JL.FORCE_FUSED_INTERPRET
    JL.FORCE_FUSED_INTERPRET = True
    try:
        want = jax.grad(lambda x, g_, b_, ws_, bs_: sum(
            jnp.sum(o * cg) for o, cg in zip(JL.ln_projections(x, g_, b_, ws_, bs_, 1e-5), cots)),
            argnums=(0, 1, 2, 3, 4))(jnp.asarray(x), jnp.asarray(gam), jnp.asarray(beta),
                                     tuple(map(jnp.asarray, ws)), tuple(map(jnp.asarray, bs)))
    finally:
        JL.FORCE_FUSED_INTERPRET = prev
    tx, tg, tb = (t(a).requires_grad_(True) for a in (x, gam, beta))
    tws = [t(w.T).requires_grad_(True) for w in ws]
    tbs = [t(b).requires_grad_(True) for b in bs]
    got = _grads(L.ln_projections(tx, tg, tb, tws, tbs), [tx, tg, tb, *tws, *tbs],
                 tuple(map(t, cots)))
    close(got[0], want[0], **GRAD_TOL, msg="x")
    close(got[1], want[1], **GRAD_TOL, msg="gamma")
    close(got[2], want[2], **GRAD_TOL, msg="beta")
    for i in range(3):
        close(got[3 + i], np.asarray(want[3][i]).T, **GRAD_TOL, msg=f"w{i}")
        close(got[6 + i], want[4][i], **GRAD_TOL, msg=f"b{i}")


def test_motion_attention_grads_match_pallas_vjp():
    rng = np.random.default_rng(17)
    x, g, beta, pe, ws, bo = _motion_args(rng, 2, 4, 128, 64)
    cot = _rand(rng, *x.shape)
    prev = JM.FORCE_MOTION_INTERPRET
    JM.FORCE_MOTION_INTERPRET = True
    try:
        want = jax.grad(lambda x, g_, b_, wq, wk, wv, wo, bo_: jnp.sum(JM.motion_attention(
            x, g_, b_, jnp.asarray(pe), wq, wk, wv, wo, bo_, 8, 1e-5) * cot),
            argnums=tuple(range(8)))(*map(jnp.asarray, (x, g, beta, *ws, bo)))
    finally:
        JM.FORCE_MOTION_INTERPRET = prev
    tx, tg, tb = (t(a).requires_grad_(True) for a in (x, g, beta))
    tws = [t(w.T).requires_grad_(True) for w in ws]
    tbo = t(bo).requires_grad_(True)
    out = M.motion_attention(tx, tg, tb, t(pe), *tws, tbo, 8)
    got = _grads(out, [tx, tg, tb, *tws, tbo], t(cot))
    for i, name in enumerate(("x", "gamma", "beta", "wq", "wk", "wv", "wo", "bo")):
        w = np.asarray(want[i])
        close(got[i], w.T if name.startswith("w") else w, **GRAD_TOL, msg=name)
