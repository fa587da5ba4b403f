"""Shared helpers for the tests that hold mmgt_tpu_torch against mmgt_tpu.

Both packages get the same numbers: inputs are made with numpy from a
seed, JAX parameters are initialised and then every leaf is overwritten
with seeded numpy noise (so zero-initialised zero-convs and to_outs do
not hide errors), and the port loads them with `load_jax_params`.
"""
import math

import jax
import numpy as np
import pytest
import torch
# torch imports its compiler package lazily, on the first optimizer or
# activation checkpoint; the reference-parity tests (test_dwpose_ref_parity.py,
# test_rasterize_ref.py) leave a spec-less `onnxruntime` stub module in
# sys.modules, which makes that late import fail in the same worker. Import
# it while collecting, before any test runs.
import torch._dynamo  # noqa: F401


def noise_params(tree, seed: int = 0):
    """Overwrite every leaf: norm scales 1 + 0.1 N, kernels N / sqrt(fan_in),
    everything else 0.1 N."""
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten_with_path(tree)
    out = []
    for path, leaf in leaves:
        name = getattr(path[-1], "key", str(path[-1]))
        shape = tuple(leaf.shape)
        if name == "scale":
            v = 1.0 + 0.1 * rng.standard_normal(shape)
        elif name == "kernel":
            v = rng.standard_normal(shape) / math.sqrt(max(1, int(np.prod(shape[:-1]))))
        else:
            v = 0.1 * rng.standard_normal(shape)
        out.append(np.asarray(v, np.float32))
    return jax.tree_util.tree_unflatten(treedef, out)


def init_noised(module, *args, seed: int = 0, **kwargs):
    """Flax init (shapes only) + seeded noise on every leaf, as numpy."""
    shapes = jax.eval_shape(lambda: module.init(jax.random.PRNGKey(0), *args, **kwargs))
    return noise_params(shapes, seed)


def t(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32))


def close(got, want, rtol, atol, msg=""):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=rtol, atol=atol, err_msg=msg)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Torch's intra-op threads, off for the module that imports this: the
    tests' tiny shapes gain nothing from them, and under the suite's
    parallel workers they oversubscribe the cores (a tiny train step ran
    20-200x slower so)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)
