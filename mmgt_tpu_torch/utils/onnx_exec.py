"""Minimal ONNX graph executor on torch (`mmgt_tpu/utils/onnx_exec.py`):
the port's onnxruntime replacement (the reference runs DWPose and the
Kim_Vocal_2 separator through onnxruntime sessions,
src/dwpose/wholebody.py:22-27, src/dataset/audio_processor.py:56-70).

Scope: the static-shape inference graphs the reference depends on
(convnets: YOLOX, RTMPose, MDX-style separators). Ops run on torch
tensors in NCHW, the graph's own layout, on the runner's device; small
integer "shape arithmetic" chains (Shape -> Gather -> Concat -> Reshape,
Range, ConstantOfShape) fold on the host in numpy, as the JAX package
folds them at trace time. Float initializers move to the device once,
when the runner is built; the others stay host arrays, which the shape
chains read.

    runner = OnnxRunner.from_file("yolox_l.onnx")            # on the card
    outs = runner(np.zeros((1, 3, 640, 640), np.float32))   # {name: tensor}

Semantics are the JAX executor's, including where it departs from the
ONNX specification: `SAME_UPPER` and `SAME_LOWER` both pad as
`SAME_UPPER`; ConvTranspose ignores `group`, `dilations` and
`output_padding`; pools round down (no `ceil_mode`) and AveragePool
leaves the padding out of its counts; Softmax normalises along `axis`
(default -1) whatever the opset; LayerNormalization normalises along the
one `axis`. Float64 host values become float32 on the device, as JAX's
32-bit default makes them; `Cast` to double gives float32 on the device.
One op goes beyond the JAX executor: ReduceL2, which torch's exporter
writes for a vector norm (mmpose's ScaleNorm computes one). An op the
table does not hold raises NotImplementedError.
"""
from __future__ import annotations

import math
from typing import Any, Callable, Dict, List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from mmgt_tpu_torch.device import resolve_device
from mmgt_tpu_torch.utils.onnx_reader import parse_onnx_model

# ONNX TensorProto.DataType -> device dtype (double as float32, as above)
_DTYPE_ENUM = {
    1: torch.float32, 2: torch.uint8, 3: torch.int8, 6: torch.int32, 7: torch.int64,
    9: torch.bool, 10: torch.float16, 11: torch.float32,
}
_NP_DTYPE_ENUM = {
    1: np.float32, 2: np.uint8, 3: np.int8, 6: np.int32, 7: np.int64,
    9: np.bool_, 10: np.float16, 11: np.float64,
}


def _is_host(x) -> bool:
    """Host-side constant (safe to use for shapes/control decisions)."""
    return isinstance(x, np.ndarray) or np.isscalar(x)


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pair(v, default):
    return default if v is None else list(v)


def _same_pads(size: Sequence[int], k: Sequence[int], s: Sequence[int],
               d: Sequence[int]) -> List[tuple]:
    """lax's "SAME": out = ceil(in / s), the odd pixel at the end."""
    pads = []
    for n, kk, ss, dd in zip(size, k, s, d):
        total = max((math.ceil(n / ss) - 1) * ss + (kk - 1) * dd + 1 - n, 0)
        pads.append((total // 2, total - total // 2))
    return pads


def _torch_pad(pads: Sequence[tuple]) -> List[int]:
    """[(lo, hi) per spatial dim] -> F.pad's last-dim-first list."""
    return [p for lo_hi in reversed(pads) for p in lo_hi]


class OnnxRunner:
    """Executes a parsed ONNX graph on `device` (the card unless the caller
    asks for the CPU). Call with positional arrays or tensors matching the
    graph inputs; returns {output_name: tensor on the device}."""

    def __init__(self, inits, nodes, input_names, output_names, device=None):
        self.device = resolve_device(device)
        self.inits: Dict[str, Any] = {}
        for k, v in inits.items():
            v = np.asarray(v)
            self.inits[k] = (self._t(v) if np.issubdtype(v.dtype, np.floating) else v)
        self.nodes = nodes
        self.input_names = input_names
        self.output_names = output_names

    @classmethod
    def from_file(cls, path: str, device=None) -> "OnnxRunner":
        with open(path, "rb") as f:
            return cls(*parse_onnx_model(f.read()), device=device)

    @classmethod
    def from_bytes(cls, data: bytes, device=None) -> "OnnxRunner":
        return cls(*parse_onnx_model(data), device=device)

    def _t(self, x) -> torch.Tensor:
        """A value as a tensor on the runner's device (float64 -> float32)."""
        if isinstance(x, torch.Tensor):
            t = x if x.device == self.device else x.to(self.device)
        else:
            t = torch.as_tensor(np.asarray(x), device=self.device)
        return t.float() if t.dtype == torch.float64 else t

    @torch.no_grad()
    def __call__(self, *arrays) -> Dict[str, torch.Tensor]:
        if len(arrays) != len(self.input_names):
            raise ValueError(
                f"graph expects {len(self.input_names)} inputs "
                f"{self.input_names}, got {len(arrays)}"
            )
        env: Dict[str, Any] = dict(self.inits)
        env.update((n, self._t(a)) for n, a in zip(self.input_names, arrays))
        for node in self.nodes:
            outs = self._run_node(node, env)
            for name, val in zip(node["output"], outs):
                if name:
                    env[name] = val
        return {n: self._t(env[n]) for n in self.output_names}

    def _run_node(self, node, env) -> List[Any]:
        op = node["op_type"]
        fn = _OPS.get(op)
        if fn is None:
            raise NotImplementedError(
                f"ONNX op {op!r} (node {node['name'] or node['output']}) is not "
                "implemented in mmgt_tpu_torch.utils.onnx_exec"
            )
        ins = [env[n] if n else None for n in node["input"]]
        return fn(self, ins, node["attrs"], node)


# ------------------------------------------------------------------ ops
_OPS: Dict[str, Callable] = {}


def _op(*names):
    def deco(fn):
        for n in names:
            _OPS[n] = fn
        return fn
    return deco


def _unary(name, fn):
    _OPS[name] = lambda r, ins, attrs, node: [fn(r._t(ins[0]))]


def _host_or_device(name, fn):
    """x stays on the host when it is there (numpy), as the JAX executor's
    `1.0 / x` and `-x` do."""
    _OPS[name] = lambda r, ins, attrs, node: [
        fn(_np(ins[0])) if _is_host(ins[0]) else fn(r._t(ins[0]))]


def _binary(name, fn, torch_fn=None):
    def run(r, ins, attrs, node):
        a, b = ins[0], ins[1]
        if _is_host(a) and _is_host(b):
            return [fn(_np(a), _np(b))]
        return [(torch_fn or fn)(r._t(a), r._t(b))]
    _OPS[name] = run


@_op("Conv")
def _conv(r, ins, attrs, node):
    x = r._t(ins[0])
    w = r._t(ins[1]).to(x.dtype)
    b = r._t(ins[2]).to(x.dtype) if len(ins) > 2 and ins[2] is not None else None
    nd = x.ndim - 2
    strides = _pair(attrs.get("strides"), [1] * nd)
    dil = _pair(attrs.get("dilations"), [1] * nd)
    pads = attrs.get("pads")
    if attrs.get("auto_pad", "NOTSET") in ("SAME_UPPER", "SAME_LOWER"):
        pairs = _same_pads(x.shape[2:], w.shape[2:], strides, dil)
    elif pads is None:
        pairs = [(0, 0)] * nd
    else:
        pairs = list(zip(pads[:nd], pads[nd:]))
    conv = {1: F.conv1d, 2: F.conv2d}[nd]
    if all(lo == hi for lo, hi in pairs):
        padding = [lo for lo, _ in pairs]
    else:  # asymmetric (SAME at stride 2 on an even extent): pad first
        x = F.pad(x, _torch_pad(pairs))
        padding = [0] * nd
    return [conv(x, w, b, strides, padding, dil, attrs.get("group", 1))]


@_op("ConvTranspose")
def _conv_transpose(r, ins, attrs, node):
    """ONNX ConvTranspose (weight (Cin, Cout, k...)): torch's transposed
    convolution without padding, then the ONNX pads cropped from each end
    (the JAX executor's dilated-input convolution gives the same grid)."""
    x = r._t(ins[0])
    w = r._t(ins[1]).to(x.dtype)
    b = r._t(ins[2]).to(x.dtype) if len(ins) > 2 and ins[2] is not None else None
    nd = x.ndim - 2
    strides = _pair(attrs.get("strides"), [1] * nd)
    pads = attrs.get("pads") or [0] * (2 * nd)
    convt = {1: F.conv_transpose1d, 2: F.conv_transpose2d}[nd]
    out = convt(x, w, b, strides)
    idx = [slice(None), slice(None)] + [
        slice(p0, out.shape[2 + i] - p1) for i, (p0, p1) in enumerate(zip(pads[:nd], pads[nd:]))]
    return [out[tuple(idx)]]


@_op("BatchNormalization")
def _batch_norm(r, ins, attrs, node):
    x = r._t(ins[0])
    scale, bias, mean, var = (r._t(v) for v in ins[1:5])
    inv = scale / torch.sqrt(var + attrs.get("epsilon", 1e-5))
    sh = (1, -1) + (1,) * (x.ndim - 2)
    return [x * inv.reshape(sh).to(x.dtype) + (bias - mean * inv).reshape(sh).to(x.dtype)]


@_op("InstanceNormalization")
def _instance_norm(r, ins, attrs, node):
    x = r._t(ins[0])
    axes = tuple(range(2, x.ndim))
    m = x.mean(axes, keepdim=True)
    v = x.var(axes, unbiased=False, keepdim=True)
    sh = (1, -1) + (1,) * (x.ndim - 2)
    return [(x - m) * torch.rsqrt(v + attrs.get("epsilon", 1e-5))
            * r._t(ins[1]).reshape(sh).to(x.dtype) + r._t(ins[2]).reshape(sh).to(x.dtype)]


@_op("LayerNormalization")
def _layer_norm(r, ins, attrs, node):
    x = r._t(ins[0])
    ax = attrs.get("axis", -1)
    m = x.mean(ax, keepdim=True)
    v = x.var(ax, unbiased=False, keepdim=True)
    out = (x - m) * torch.rsqrt(v + attrs.get("epsilon", 1e-5)) * r._t(ins[1])
    if len(ins) > 2 and ins[2] is not None:
        out = out + r._t(ins[2])
    return [out]


@_op("Gemm")
def _gemm(r, ins, attrs, node):
    a, bmat = r._t(ins[0]), r._t(ins[1])
    if attrs.get("transA"):
        a = a.T
    if attrs.get("transB"):
        bmat = bmat.T
    out = attrs.get("alpha", 1.0) * (a @ bmat)
    if len(ins) > 2 and ins[2] is not None:
        out = out + attrs.get("beta", 1.0) * r._t(ins[2])
    return [out]


_OPS["MatMul"] = lambda r, ins, attrs, node: [torch.matmul(r._t(ins[0]), r._t(ins[1]))]
_OPS["Einsum"] = lambda r, ins, attrs, node: [
    torch.einsum(attrs["equation"], *[r._t(i) for i in ins])]

_unary("Relu", torch.relu)
_unary("Sigmoid", torch.sigmoid)
_unary("Tanh", torch.tanh)
_unary("Erf", torch.erf)
_unary("Exp", torch.exp)
_unary("Log", torch.log)
_unary("Sqrt", torch.sqrt)
_unary("Abs", torch.abs)
_unary("Floor", torch.floor)
_host_or_device("Reciprocal", lambda x: 1.0 / x)
_host_or_device("Neg", lambda x: -x)
_OPS["LeakyRelu"] = lambda r, ins, attrs, node: [
    F.leaky_relu(r._t(ins[0]), attrs.get("alpha", 0.01))]
_OPS["HardSigmoid"] = lambda r, ins, attrs, node: [
    torch.clamp(attrs.get("alpha", 0.2) * r._t(ins[0]) + attrs.get("beta", 0.5), 0.0, 1.0)]
_OPS["Softmax"] = lambda r, ins, attrs, node: [
    torch.softmax(r._t(ins[0]), dim=attrs.get("axis", -1))]
_OPS["Identity"] = _OPS["Dropout"] = lambda r, ins, attrs, node: [ins[0]]  # inference mode


@_op("PRelu")
def _prelu(r, ins, attrs, node):
    x = r._t(ins[0])
    return [torch.where(x >= 0, x, x * r._t(ins[1]))]


@_op("Clip")
def _clip(r, ins, attrs, node):
    out = r._t(ins[0])
    lo = ins[1] if len(ins) > 1 else attrs.get("min")
    hi = ins[2] if len(ins) > 2 else attrs.get("max")
    if lo is not None:
        out = torch.maximum(out, r._t(lo).to(out.dtype))
    if hi is not None:
        out = torch.minimum(out, r._t(hi).to(out.dtype))
    return [out]


_binary("Add", lambda a, b: a + b)
_binary("Sub", lambda a, b: a - b)
_binary("Mul", lambda a, b: a * b)
_binary("Div", lambda a, b: a / b)
_binary("Pow", lambda a, b: a ** b)
_binary("Min", np.minimum, torch.minimum)
_binary("Max", np.maximum, torch.maximum)
_binary("Equal", np.equal, torch.eq)
_binary("Greater", np.greater, torch.gt)
_binary("Less", np.less, torch.lt)


@_op("Where")
def _where(r, ins, attrs, node):
    return [torch.where(r._t(ins[0]).bool(), r._t(ins[1]), r._t(ins[2]))]


@_op("Concat")
def _concat(r, ins, attrs, node):
    if all(_is_host(i) for i in ins):
        return [np.concatenate([_np(i) for i in ins], axis=attrs["axis"])]
    return [torch.cat([r._t(i) for i in ins], dim=attrs["axis"])]


@_op("Split")
def _split(r, ins, attrs, node):
    x = r._t(ins[0])
    ax = attrs.get("axis", 0)
    if len(ins) > 1 and ins[1] is not None:
        sizes = _np(ins[1]).tolist()
    elif "split" in attrs:
        sizes = attrs["split"]
    else:
        n = len(node["output"])
        sizes = [x.shape[ax] // n] * n
    return list(torch.split(x, [int(s) for s in sizes], dim=ax))


def _slice(x, starts, ends, axes, steps):
    """ONNX Slice as the JAX executor clamps it: negative starts/ends count
    from the end, out-of-range ones are clipped, INT_MAX means to the end."""
    starts, ends = _np(starts).tolist(), _np(ends).tolist()
    axes = list(range(len(starts))) if axes is None else _np(axes).tolist()
    steps = [1] * len(starts) if steps is None else _np(steps).tolist()
    for s, e, a, st in zip(starts, ends, axes, steps):
        dim = x.shape[a]
        s2 = int(np.clip(s + dim if s < 0 else s, 0, dim))
        e2 = dim if e >= 2**31 - 1 else int(np.clip(e + dim if e < 0 else e, 0, dim))
        if _is_host(x) or st > 0:
            idx = [slice(None)] * x.ndim
            idx[a] = slice(s2, e2, int(st))
            x = x[tuple(idx)]
        else:  # torch slices take no negative step
            keep = torch.from_numpy(np.arange(dim)[s2:e2:int(st)].copy()).to(x.device)
            x = x.index_select(a, keep)
    return x


@_op("Slice")
def _slice_op(r, ins, attrs, node):
    x = ins[0] if _is_host(ins[0]) else r._t(ins[0])
    if len(ins) > 1:  # opset >= 10: starts/ends/axes/steps as inputs
        return [_slice(x, ins[1], ins[2], ins[3] if len(ins) > 3 else None,
                       ins[4] if len(ins) > 4 else None)]
    return [_slice(x, attrs["starts"], attrs["ends"], attrs.get("axes"), attrs.get("steps"))]


@_op("Gather")
def _gather(r, ins, attrs, node):
    ax = attrs.get("axis", 0)
    if _is_host(ins[0]) and _is_host(ins[1]):
        return [np.take(_np(ins[0]), _np(ins[1]), axis=ax)]
    x, idx = r._t(ins[0]), r._t(ins[1]).long()
    ax = ax % x.ndim
    idx = torch.where(idx < 0, idx + x.shape[ax], idx)
    out = x.index_select(ax, idx.reshape(-1))
    return [out.reshape(x.shape[:ax] + idx.shape + x.shape[ax + 1:])]


@_op("Reshape")
def _reshape(r, ins, attrs, node):
    x = ins[0]
    # 0 = keep dim, -1 = infer
    shape = [x.shape[i] if s == 0 else s for i, s in enumerate(_np(ins[1]).tolist())]
    return [np.reshape(_np(x), shape) if _is_host(x) else r._t(x).reshape(shape)]


@_op("Transpose")
def _transpose(r, ins, attrs, node):
    x = r._t(ins[0])
    return [x.permute(attrs.get("perm", list(range(x.ndim))[::-1]))]


@_op("Unsqueeze")
def _unsqueeze(r, ins, attrs, node):
    axes = _np(ins[1]).tolist() if len(ins) > 1 else attrs["axes"]
    out = _np(ins[0]) if _is_host(ins[0]) else r._t(ins[0])
    for a in sorted(axes):
        out = np.expand_dims(out, a) if _is_host(out) else out.unsqueeze(a)
    return [out]


@_op("Squeeze")
def _squeeze(r, ins, attrs, node):
    axes = (_np(ins[1]).tolist() if len(ins) > 1 and ins[1] is not None
            else attrs.get("axes"))
    if axes is None:
        return [r._t(ins[0]).squeeze()]
    out = _np(ins[0]) if _is_host(ins[0]) else r._t(ins[0])
    for a in sorted(axes, reverse=True):
        out = np.squeeze(out, a) if _is_host(out) else out.squeeze(a)
    return [out]


@_op("Flatten")
def _flatten(r, ins, attrs, node):
    x = r._t(ins[0])
    ax = attrs.get("axis", 1)
    lead = int(np.prod(x.shape[:ax])) if ax else 1
    return [x.reshape(lead, -1)]


@_op("Expand")
def _expand(r, ins, attrs, node):
    x = r._t(ins[0])
    shape = np.broadcast_shapes(tuple(x.shape), tuple(_np(ins[1]).tolist()))
    return [x.broadcast_to(shape)]


@_op("Cast")
def _cast(r, ins, attrs, node):
    x = ins[0]
    if _is_host(x):
        return [_np(x).astype(_NP_DTYPE_ENUM[attrs["to"]])]
    return [r._t(x).to(_DTYPE_ENUM[attrs["to"]])]


_OPS["Shape"] = lambda r, ins, attrs, node: [np.asarray(tuple(ins[0].shape), np.int64)]
_OPS["Constant"] = lambda r, ins, attrs, node: [_np(attrs["value"])]


@_op("ConstantOfShape")
def _constant_of_shape(r, ins, attrs, node):
    fill = attrs.get("value")
    fill = _np(fill).ravel()[0] if fill is not None else 0.0
    return [np.full(_np(ins[0]).tolist(), fill)]


_OPS["Range"] = lambda r, ins, attrs, node: [
    np.arange(_np(ins[0]).item(), _np(ins[1]).item(), _np(ins[2]).item())]


@_op("MaxPool", "AveragePool")
def _pool(r, ins, attrs, node):
    """Padding as given (or lax's SAME), rounding down; a max pool pads
    with -inf, an average pool divides by the count of unpadded inputs."""
    x = r._t(ins[0])
    ks = list(attrs["kernel_shape"])
    nd = len(ks)
    strides = _pair(attrs.get("strides"), [1] * nd)
    pads = attrs.get("pads")
    if attrs.get("auto_pad") in ("SAME_UPPER", "SAME_LOWER"):
        pairs = _same_pads(x.shape[2:], ks, strides, [1] * nd)
    elif pads is None:
        pairs = [(0, 0)] * nd
    else:
        pairs = list(zip(pads[:nd], pads[nd:]))
    pool_nd = x
    if nd == 1:  # 1-D windows as 2-D ones of height 1
        pool_nd, ks, strides, pairs = x.unsqueeze(-2), [1] + ks, [1] + strides, [(0, 0)] + pairs
    if node["op_type"] == "MaxPool":
        fill = -math.inf if x.is_floating_point() else torch.iinfo(x.dtype).min
        out = F.max_pool2d(F.pad(pool_nd, _torch_pad(pairs), value=fill), ks, strides)
    else:
        ones = torch.ones_like(pool_nd[:1, :1])
        s = F.avg_pool2d(F.pad(pool_nd, _torch_pad(pairs)), ks, strides, divisor_override=1)
        n = F.avg_pool2d(F.pad(ones, _torch_pad(pairs)), ks, strides, divisor_override=1)
        out = s / n
    return [out.squeeze(-2) if nd == 1 else out]


_OPS["GlobalAveragePool"] = lambda r, ins, attrs, node: [
    r._t(ins[0]).mean(tuple(range(2, ins[0].ndim)), keepdim=True)]


@_op("Resize")
def _resize(r, ins, attrs, node):
    """jax.image.resize's grids: nearest samples floor((i + 0.5) in / out)
    (torch's "nearest-exact"); linear and cubic are half-pixel and
    antialiased when shrinking (cubic with a = -0.5), torch's antialiased
    interpolation. Only the trailing (spatial) dims may change."""
    x = r._t(ins[0])
    scales = ins[2] if len(ins) > 2 else None
    sizes = ins[3] if len(ins) > 3 else None
    mode = attrs.get("mode", "nearest")
    if sizes is not None:
        out_shape = tuple(int(s) for s in _np(sizes))
    else:
        sc = _np(scales).astype(np.float64)
        out_shape = tuple(int(round(d * s)) for d, s in zip(x.shape, sc))
    ctm = attrs.get("coordinate_transformation_mode", "half_pixel")
    integer_up = all(o % d == 0 for d, o in zip(x.shape, out_shape))
    if ctm not in ("half_pixel", "pytorch_half_pixel") and not (
        mode == "nearest" and ctm == "asymmetric" and integer_up
    ):
        raise NotImplementedError(
            f"Resize coordinate_transformation_mode={ctm!r} (mode={mode!r}) "
            "not supported: the executor uses half-pixel sampling"
        )
    if tuple(out_shape[:2]) != tuple(x.shape[:2]):
        raise NotImplementedError(f"Resize of the batch or channel dims: {tuple(x.shape)} -> "
                                  f"{out_shape}")
    size = list(out_shape[2:])
    if mode == "nearest":
        return [F.interpolate(x, size=size, mode="nearest-exact")]
    method = {("linear", 1): "linear", ("linear", 2): "bilinear", ("cubic", 2): "bicubic"}[
        (mode, len(size))]
    return [F.interpolate(x, size=size, mode=method, align_corners=False,
                          antialias=method != "linear")]


@_op("Pad")
def _pad(r, ins, attrs, node):
    x = r._t(ins[0])
    mode = attrs.get("mode", "constant")
    pads = _np(ins[1]).tolist() if len(ins) > 1 else attrs["pads"]
    half = len(pads) // 2
    pairs = list(zip(pads[:half], pads[half:]))
    if mode == "constant":
        cval = (_np(ins[2]).item() if len(ins) > 2 and ins[2] is not None
                else attrs.get("value", 0.0))
        return [F.pad(x, _torch_pad(pairs), value=cval)]
    while pairs and pairs[0] == (0, 0):  # torch pads the trailing dims only
        pairs = pairs[1:]
    return [F.pad(x, _torch_pad(pairs), mode={"reflect": "reflect", "edge": "replicate"}[mode])]


@_op("ReduceMean", "ReduceSum", "ReduceMax", "ReduceMin")
def _reduce(r, ins, attrs, node):
    x = r._t(ins[0])
    axes = attrs.get("axes")
    if axes is None and len(ins) > 1 and ins[1] is not None:
        axes = _np(ins[1]).tolist()
    keep = bool(attrs.get("keepdims", 1))
    dims = tuple(axes) if axes is not None else tuple(range(x.ndim))
    fn = {"ReduceMean": torch.mean, "ReduceSum": torch.sum,
          "ReduceMax": torch.amax, "ReduceMin": torch.amin}[node["op_type"]]
    return [fn(x, dim=dims, keepdim=keep)]


@_op("ReduceL2")
def _reduce_l2(r, ins, attrs, node):
    """sqrt(sum(x^2)) over `axes` (an attribute before opset 18, an input
    from 18 on); no axes reduce every axis, or none with
    `noop_with_empty_axes`. torch exports `torch.norm` and
    `torch.linalg.norm` so; the JAX executor has no ReduceL2."""
    x = r._t(ins[0])
    axes = attrs.get("axes")
    if axes is None and len(ins) > 1 and ins[1] is not None:
        axes = _np(ins[1]).tolist()
    if not axes:
        if attrs.get("noop_with_empty_axes", 0):
            return [x]
        axes = range(x.ndim)
    return [torch.linalg.vector_norm(x, dim=tuple(axes), keepdim=bool(attrs.get("keepdims", 1)))]


SUPPORTED_OPS = frozenset(_OPS)


def unsupported_ops(nodes: Sequence[Dict]) -> List[str]:
    """The op types of `nodes` this executor lacks, sorted."""
    return sorted({n["op_type"] for n in nodes} - SUPPORTED_OPS)

