"""Gradients for the kernels whose JAX VJP is XLA math (K2, K3, K4).

The JAX package differentiates GroupNorm, the LN projections and the
motion attention with a custom VJP whose backward recomputes the plain
math (`mmgt_tpu/ops/norms.py:_gn_diff_bwd`, `fused_ln.py:_ln_projections_bwd`,
`motion_attention.py:_motion_vjp_bwd`); it has no backward kernel. The port
does the same: `kernel_with_plain_vjp` runs the kernel forward and, on the
backward, autograd through the plain version recomputed from the saved
inputs. The recompute is the counterpart of the JAX package's XLA VJP.
"""
from __future__ import annotations

import torch


def needs_grad(*tensors) -> bool:
    """Autograd is on and one of the tensors takes part in it."""
    return torch.is_grad_enabled() and any(
        t is not None and torch.is_tensor(t) and t.requires_grad for t in tensors)


class _KernelPlainVJP(torch.autograd.Function):
    @staticmethod
    def forward(ctx, kernel, plain, *args):
        ctx.plain = plain
        ctx.is_tensor = [torch.is_tensor(a) for a in args]
        ctx.consts = [None if it else a for a, it in zip(args, ctx.is_tensor)]
        ctx.save_for_backward(*[a for a in args if torch.is_tensor(a)])
        return kernel(*args)

    @staticmethod
    def backward(ctx, *grads):
        saved = iter(ctx.saved_tensors)
        args, wrt = [], []
        for it, const, need in zip(ctx.is_tensor, ctx.consts, ctx.needs_input_grad[2:]):
            if not it:
                args.append(const)
                continue
            a = next(saved).detach().requires_grad_(need)
            args.append(a)
            if need:
                wrt.append(a)
        with torch.enable_grad():
            outs = ctx.plain(*args)
        outs = outs if isinstance(outs, tuple) else (outs,)
        pairs = [(o, g) for o, g in zip(outs, grads) if g is not None and o.requires_grad]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt, [g for _, g in pairs],
                                       allow_unused=True) if pairs else [None] * len(wrt))
        return (None, None, *[next(got) if it and need else None
                              for it, need in zip(ctx.is_tensor, ctx.needs_input_grad[2:])])


def kernel_with_plain_vjp(kernel, plain, *args):
    """`kernel(*args)` forward; backward = autograd through `plain(*args)`,
    recomputed. Both take the same positional arguments (tensors, None or
    plain values) and return a tensor or a tuple of tensors."""
    return _KernelPlainVJP.apply(kernel, plain, *args)
