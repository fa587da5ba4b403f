"""The port's ONNX reader, executor and vocal separator against mmgt_tpu's.

The same bytes (graphs hand-encoded with the JAX tests' protobuf
encoders, and a miniature TFC-TDF separator exported by torch) go through
`mmgt_tpu.utils.onnx_reader` / `onnx_exec` and their copies in
`mmgt_tpu_torch` (on the CPU). Tolerances:
  * the reader, `fold_batchnorms`, the STFT / iSTFT / window and the
    separator's host plumbing: bitwise;
  * the executor: 1e-5 of the largest |output| per output (f32 on both
    sides; XLA's and torch's CPU convolutions sum in other orders), and
    bitwise for integer and boolean outputs;
  * the separator through a real graph: 1e-5 of the largest |output|.
"""
import re
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

sys.path.insert(0, str(Path(__file__).parent))
from test_onnx_exec import _model_io, _node_a  # noqa: E402
from test_onnx_reader import _model, _node, _tag, _tensor, _varint  # noqa: E402
from torch_port_util import one_torch_thread  # noqa: E402,F401

from mmgt_tpu.data import separator as jsep  # noqa: E402
from mmgt_tpu.utils import onnx_exec as jexec  # noqa: E402
from mmgt_tpu.utils import onnx_reader as jreader  # noqa: E402
from mmgt_tpu_torch.data import separator as tsep  # noqa: E402
from mmgt_tpu_torch.utils import onnx_exec as texec  # noqa: E402
from mmgt_tpu_torch.utils import onnx_reader as treader  # noqa: E402

REL_TOL = 1e-5


# ----------------------------------------------------------------- reader
def _reader_graphs():
    rng = np.random.default_rng(0)
    w = np.arange(24, dtype=np.float32).reshape(2, 3, 4)
    f = np.linspace(-1, 1, 6, dtype=np.float32).reshape(2, 3)
    i = np.array([-3, 5, 2**40], dtype=np.int64)
    h = np.array([[0.5, -2.0], [1.25, 3.0]], dtype=np.float16)
    conv_bn = [
        _tensor("conv.w", rng.standard_normal((4, 3, 3, 3)).astype(np.float32)),
        _tensor("bn.s", rng.uniform(0.5, 2, 4).astype(np.float32)),
        _tensor("bn.b", rng.standard_normal(4).astype(np.float32)),
        _tensor("bn.m", rng.standard_normal(4).astype(np.float32)),
        _tensor("bn.v", rng.uniform(0.5, 2, 4).astype(np.float32)),
    ]
    bn_nodes = [
        _node("Conv", ["x", "conv.w"], ["c_out"]),
        _node("BatchNormalization", ["c_out", "bn.s", "bn.b", "bn.m", "bn.v"], ["y"]),
    ]
    return {
        "raw": _model([_tensor("w", w)]),
        "typed_unpacked": _model([_tensor("f", f, use_raw=False, packed_dims=False),
                                  _tensor("i", i, use_raw=False)]),
        "fp16": _model([_tensor("h", h)]),
        "nodes": _model(nodes=[_node("Conv", ["x", "w", "b"], ["y"], name="conv0")]),
        "conv_bn": _model(conv_bn, bn_nodes),
        "attrs": _model_io([_tensor("w", w)], [_node_a(
            "Conv", ["x", "w"], ["y"], {"strides": [2, 2], "auto_pad": "SAME_UPPER",
                                         "alpha": 0.5, "t": np.ones((2, 2), np.float32),
                                         "fl": [0.25, 0.5]})], ["x", "w"], ["y"]),
    }


def _same(a, b):
    """Bitwise equality of nested parse results, dtypes included."""
    if isinstance(a, dict):
        assert isinstance(b, dict) and list(a) == list(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (list, tuple)):
        assert type(a) is type(b) and len(a) == len(b)
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, np.ndarray):
        assert isinstance(b, np.ndarray) and a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()
    else:
        assert type(a) is type(b) and a == b, (a, b)


@pytest.mark.parametrize("graph", list(_reader_graphs()))
def test_reader_matches_jax_bitwise(graph):
    blob = _reader_graphs()[graph]
    _same(treader.parse_onnx_model(blob), jreader.parse_onnx_model(blob))
    _same(treader.parse_onnx_graph(blob), jreader.parse_onnx_graph(blob))


def test_reader_rejects_what_jax_rejects(tmp_path):
    bad = _tag(1, 0) + _varint(3)
    for mod in (jreader, treader):
        with pytest.raises(ValueError):
            mod.parse_onnx_graph(bad)
    p = tmp_path / "g.onnx"
    p.write_bytes(_reader_graphs()["raw"])
    _same(treader.load_onnx(str(p)), jreader.load_onnx(str(p)))


@pytest.mark.parametrize("eps", [1e-5, 1e-3])
def test_fold_batchnorms_matches_jax_bitwise(eps):
    inits, nodes = jreader.parse_onnx_graph(_reader_graphs()["conv_bn"])
    _same(treader.fold_batchnorms(inits, nodes, eps), jreader.fold_batchnorms(inits, nodes, eps))


# --------------------------------------------------------------- executor
def _g(nodes, inputs, outputs, tensors=()):
    return _model_io(list(tensors), nodes, inputs, outputs)


def _family(name, rng):
    """(graph bytes, inputs) of one op family."""
    x4 = rng.standard_normal((2, 3, 8, 8)).astype(np.float32)
    if name == "convnet":
        w1 = rng.standard_normal((8, 3, 3, 3)).astype(np.float32) * 0.2
        t = [_tensor("w1", w1), _tensor("b1", rng.standard_normal(8).astype(np.float32)),
             _tensor("bn_s", rng.uniform(0.5, 2, 8).astype(np.float32)),
             _tensor("bn_b", rng.standard_normal(8).astype(np.float32)),
             _tensor("bn_m", rng.standard_normal(8).astype(np.float32)),
             _tensor("bn_v", rng.uniform(0.5, 2, 8).astype(np.float32)),
             _tensor("wfc", rng.standard_normal((8, 4)).astype(np.float32)),
             _tensor("bfc", rng.standard_normal(4).astype(np.float32))]
        n = [_node_a("Conv", ["x", "w1", "b1"], ["c1"], {"strides": [2, 2], "pads": [1, 1, 1, 1]}),
             _node_a("BatchNormalization", ["c1", "bn_s", "bn_b", "bn_m", "bn_v"], ["bn"],
                     {"epsilon": 1e-3}),
             _node_a("Relu", ["bn"], ["r"]),
             _node_a("MaxPool", ["r"], ["p"], {"kernel_shape": [2, 2], "strides": [2, 2]}),
             _node_a("GlobalAveragePool", ["p"], ["g"]),
             _node_a("Flatten", ["g"], ["f"], {"axis": 1}),
             _node_a("Gemm", ["f", "wfc", "bfc"], ["y"], {})]
        return _g(n, ["x"], ["y", "bn"], t), [rng.standard_normal((2, 3, 16, 16)).astype(np.float32)]
    if name == "conv_variants":
        w = rng.standard_normal((4, 3, 3, 3)).astype(np.float32) * 0.3
        dw = rng.standard_normal((3, 1, 5, 5)).astype(np.float32) * 0.2
        w1 = rng.standard_normal((5, 3, 3)).astype(np.float32) * 0.3
        t = [_tensor("w", w), _tensor("dw", dw), _tensor("w1", w1),
             _tensor("b1", rng.standard_normal(5).astype(np.float32))]
        n = [_node_a("Conv", ["x", "w"], ["same_up"], {"auto_pad": "SAME_UPPER", "strides": [2, 2]}),
             _node_a("Conv", ["x", "w"], ["same_lo"], {"auto_pad": "SAME_LOWER", "strides": [2, 2]}),
             _node_a("Conv", ["x", "w"], ["asym"], {"pads": [0, 1, 1, 0], "strides": [2, 1]}),
             _node_a("Conv", ["x", "w"], ["dil"], {"pads": [2, 2, 2, 2], "dilations": [2, 2]}),
             _node_a("Conv", ["x", "w"], ["valid"], {}),
             _node_a("Conv", ["x", "dw"], ["grp"], {"group": 3, "pads": [2, 2, 2, 2]}),
             _node_a("LeakyRelu", ["grp"], ["leaky"], {"alpha": 0.1}),
             _node_a("Conv", ["s", "w1", "b1"], ["c1d"], {"strides": [2], "pads": [1, 1]}),
             _node_a("Conv", ["s", "w1"], ["c1d_same"], {"auto_pad": "SAME_UPPER", "strides": [2]})]
        s = rng.standard_normal((2, 3, 10)).astype(np.float32)
        return (_g(n, ["x", "s"], ["same_up", "same_lo", "asym", "dil", "valid", "leaky", "c1d",
                                   "c1d_same"], t), [x4, s])
    if name == "conv_transpose":
        w = rng.standard_normal((3, 4, 4, 4)).astype(np.float32) * 0.2
        w3 = rng.standard_normal((3, 2, 3, 3)).astype(np.float32) * 0.2
        w1 = rng.standard_normal((3, 2, 4)).astype(np.float32) * 0.2
        t = [_tensor("w", w), _tensor("b", rng.standard_normal(4).astype(np.float32)),
             _tensor("w3", w3), _tensor("w1", w1)]
        n = [_node_a("ConvTranspose", ["x", "w", "b"], ["sym"], {"strides": [2, 2], "pads": [1, 1, 1, 1]}),
             _node_a("ConvTranspose", ["x", "w3"], ["asym"], {"strides": [2, 3], "pads": [0, 1, 1, 0]}),
             _node_a("ConvTranspose", ["x", "w3"], ["nopad"], {}),
             _node_a("ConvTranspose", ["s", "w1"], ["t1d"], {"strides": [2], "pads": [1, 1]})]
        s = rng.standard_normal((2, 3, 7)).astype(np.float32)
        return _g(n, ["x", "s"], ["sym", "asym", "nopad", "t1d"], t), [x4, s]
    if name == "pools":
        n = [_node_a("MaxPool", ["x"], ["mp_pad"], {"kernel_shape": [3, 3], "strides": [2, 2],
                                                     "pads": [1, 1, 1, 1]}),
             _node_a("MaxPool", ["x"], ["mp_same"], {"kernel_shape": [3, 3], "strides": [2, 2],
                                                      "auto_pad": "SAME_UPPER"}),
             _node_a("AveragePool", ["x"], ["ap_pad"], {"kernel_shape": [3, 3], "pads": [1, 1, 1, 1]}),
             _node_a("AveragePool", ["x"], ["ap_asym"], {"kernel_shape": [2, 3], "strides": [2, 2],
                                                          "pads": [0, 0, 1, 1]}),
             _node_a("AveragePool", ["x"], ["ap_same"], {"kernel_shape": [3, 3], "strides": [2, 2],
                                                          "auto_pad": "SAME_LOWER"}),
             _node_a("MaxPool", ["s"], ["mp1d"], {"kernel_shape": [3], "strides": [2]}),
             _node_a("AveragePool", ["s"], ["ap1d"], {"kernel_shape": [3], "pads": [1, 1]})]
        s = rng.standard_normal((2, 3, 9)).astype(np.float32)
        return _g(n, ["x", "s"], ["mp_pad", "mp_same", "ap_pad", "ap_asym", "ap_same", "mp1d",
                                  "ap1d"]), [x4, s]
    if name == "resize":
        t = [_tensor("up2", np.asarray([1, 1, 2, 2], np.float32)),
             _tensor("sz_odd", np.asarray([2, 3, 12, 5], np.int64)),
             _tensor("sz_down", np.asarray([2, 3, 5, 3], np.int64))]
        n = [_node_a("Resize", ["x", "", "up2"], ["near2"], {"mode": "nearest"}),
             _node_a("Resize", ["x", "", "up2"], ["near_asym"],
                     {"mode": "nearest", "coordinate_transformation_mode": "asymmetric"}),
             _node_a("Resize", ["x", "", "", "sz_odd"], ["near_odd"], {"mode": "nearest"}),
             _node_a("Resize", ["x", "", "up2"], ["lin2"], {"mode": "linear"}),
             _node_a("Resize", ["x", "", "", "sz_odd"], ["lin_odd"], {"mode": "linear"}),
             _node_a("Resize", ["x", "", "", "sz_down"], ["lin_down"], {"mode": "linear"}),
             _node_a("Resize", ["x", "", "up2"], ["cub2"], {"mode": "cubic"})]
        return _g(n, ["x"], ["near2", "near_asym", "near_odd", "lin2", "lin_odd", "lin_down",
                             "cub2"], t), [x4]
    if name == "slices":
        t = [_tensor("st", np.asarray([-6, 1], np.int64)),
             _tensor("en", np.asarray([2**31 - 1, 100], np.int64)),
             _tensor("ax", np.asarray([2, 3], np.int64)),
             _tensor("stp", np.asarray([2, 3], np.int64)),
             _tensor("st_r", np.asarray([-1], np.int64)), _tensor("en_r", np.asarray([-100], np.int64)),
             _tensor("ax_r", np.asarray([3], np.int64)), _tensor("stp_r", np.asarray([-2], np.int64)),
             _tensor("st2", np.asarray([0, -3], np.int64)), _tensor("en2", np.asarray([-1, 7], np.int64))]
        n = [_node_a("Slice", ["x", "st", "en", "ax", "stp"], ["s_step"]),
             _node_a("Slice", ["x", "st_r", "en_r", "ax_r", "stp_r"], ["s_rev"]),
             _node_a("Slice", ["x", "st2", "en2"], ["s_noax"]),
             _node_a("Slice", ["x"], ["s_attr"], {"starts": [0, 2], "ends": [1, -1], "axes": [0, 2]})]
        return _g(n, ["x"], ["s_step", "s_rev", "s_noax", "s_attr"], t), [x4]
    if name == "softmax_cast_where":
        t = [_tensor("idx", np.asarray([[0, -1], [2, 1]], np.int64)),
             _tensor("thr", np.asarray(0.25, np.float32).reshape(()))]
        n = [_node_a("Softmax", ["x"], ["sm_last"]),
             _node_a("Softmax", ["x"], ["sm_1"], {"axis": 1}),
             _node_a("Gather", ["x", "idx"], ["ga"], {"axis": 1}),
             _node_a("Gather", ["x", "idx"], ["ga3"], {"axis": 3}),
             _node_a("Mul", ["x", "x"], ["x2"]),
             _node_a("Cast", ["x2"], ["xi"], {"to": 7}),
             _node_a("Cast", ["xi"], ["xf"], {"to": 1}),
             _node_a("Cast", ["x"], ["xd"], {"to": 11}),
             _node_a("Greater", ["x", "thr"], ["gt"]),
             _node_a("Less", ["x", "thr"], ["lt"]),
             _node_a("Equal", ["xi", "xi"], ["eq"]),
             _node_a("Where", ["gt", "x", "x2"], ["wh"])]
        return _g(n, ["x"], ["sm_last", "sm_1", "ga", "ga3", "xi", "xf", "xd", "gt", "lt", "eq",
                             "wh"], t), [x4]
    if name == "unary":
        ops = ["Relu", "Sigmoid", "Tanh", "Erf", "Exp", "Neg", "Abs", "Floor", "Identity", "Dropout"]
        t = [_tensor("slope", rng.uniform(0.1, 0.3, (3, 1, 1)).astype(np.float32))]
        n = [_node_a(op, ["x"], [op.lower()]) for op in ops]
        n += [_node_a("Abs", ["x"], ["ax"]), _node_a("Log", ["ax"], ["log"]),
              _node_a("Sqrt", ["ax"], ["sqrt"]), _node_a("Reciprocal", ["ax"], ["recip"]),
              _node_a("HardSigmoid", ["x"], ["hsig"], {"alpha": 0.3, "beta": 0.4}),
              _node_a("HardSigmoid", ["x"], ["hsig_d"]),
              _node_a("LeakyRelu", ["x"], ["leaky"]),
              _node_a("PRelu", ["x", "slope"], ["prelu"])]
        outs = [op.lower() for op in ops] + ["log", "sqrt", "recip", "hsig", "hsig_d", "leaky",
                                             "prelu"]
        return _g(n, ["x"], outs, t), [x4]
    if name == "binary":
        y = rng.standard_normal((3, 1, 8)).astype(np.float32)
        t = [_tensor("lo", np.asarray(-0.5, np.float32).reshape(())),
             _tensor("hi", np.asarray(0.7, np.float32).reshape(())),
             _tensor("two", np.asarray([2.0], np.float32))]
        ops = ["Add", "Sub", "Mul", "Div", "Min", "Max"]
        n = [_node_a(op, ["x", "y"], [op.lower()]) for op in ops]
        n += [_node_a("Abs", ["x"], ["ax"]), _node_a("Pow", ["ax", "y"], ["pow"]),
              _node_a("Pow", ["x", "two"], ["sq"]),
              _node_a("Clip", ["x", "lo", "hi"], ["clip"]),
              _node_a("Clip", ["x", "lo"], ["clip_lo"]),
              _node_a("Clip", ["x"], ["clip_attr"], {"min": -0.2, "max": 0.3})]
        return _g(n, ["x", "y"], [o.lower() for o in ops] + ["pow", "sq", "clip", "clip_lo",
                                                               "clip_attr"], t), [x4, y]
    if name == "shape_ops":
        t = [_tensor("i0", np.asarray(0, np.int64).reshape(())),
             _tensor("rest", np.asarray([-1], np.int64)),
             _tensor("keep", np.asarray([0, 3, -1], np.int64)),
             _tensor("ax0", np.asarray([0, 3], np.int64)),
             _tensor("exp", np.asarray([2, 1, 4, 1, 1], np.int64)),
             _tensor("sp", np.asarray([1, 2], np.int64)),
             _tensor("sq_ax", np.asarray([0], np.int64))]
        n = [_node_a("Shape", ["x"], ["sh"]),
             _node_a("Gather", ["sh", "i0"], ["d0"], {"axis": 0}),
             _node_a("Unsqueeze", ["d0"], ["d0u"], {"axes": [0]}),
             _node_a("Concat", ["d0u", "rest"], ["newshape"], {"axis": 0}),
             _node_a("Reshape", ["x", "newshape"], ["flat"]),
             _node_a("Reshape", ["x", "keep"], ["kept"]),
             _node_a("Transpose", ["x"], ["tr_rev"]),
             _node_a("Transpose", ["x"], ["tr"], {"perm": [0, 2, 3, 1]}),
             _node_a("Unsqueeze", ["x", "ax0"], ["unsq"]),
             _node_a("Squeeze", ["unsq", "sq_ax"], ["sq_in"]),
             _node_a("Squeeze", ["unsq"], ["sq_attr"], {"axes": [0]}),
             _node_a("Squeeze", ["unsq"], ["sq_all"]),
             _node_a("Flatten", ["x"], ["fl2"], {"axis": 2}),
             _node_a("Flatten", ["x"], ["fl0"], {"axis": 0}),
             _node_a("ReduceMean", ["x"], ["rm"], {"axes": [1, 2, 3], "keepdims": 1}),
             _node_a("Unsqueeze", ["rm"], ["rmu"], {"axes": [1]}),
             _node_a("Expand", ["rmu", "exp"], ["expd"]),
             _node_a("Split", ["x"], ["sa", "sb", "sc"], {"axis": 1}),
             _node_a("Split", ["x", "sp"], ["sd", "se"], {"axis": 1}),
             _node_a("Split", ["x"], ["sf", "sg"], {"axis": 2, "split": [3, 5]}),
             _node_a("Concat", ["sc", "sa", "x"], ["cat"], {"axis": 1})]
        outs = ["flat", "kept", "tr_rev", "tr", "unsq", "sq_in", "sq_attr", "sq_all", "fl2", "fl0",
                "expd", "sa", "sb", "sc", "sd", "se", "sf", "sg", "cat"]
        return _g(n, ["x"], outs, t), [x4]
    if name == "constants":
        t = [_tensor("r0", np.asarray(1, np.int64).reshape(())),
             _tensor("r1", np.asarray(17, np.int64).reshape(())),
             _tensor("r2", np.asarray(2, np.int64).reshape(())),
             _tensor("shp", np.asarray([2, 1, 8, 8], np.int64))]
        n = [_node_a("Constant", [], ["c"], {"value": np.full((1, 3, 1, 1), 0.5, np.float32)}),
             _node_a("ConstantOfShape", ["shp"], ["zeros"]),
             _node_a("ConstantOfShape", ["shp"], ["fives"], {"value": np.asarray([5], np.float32)}),
             _node_a("Range", ["r0", "r1", "r2"], ["rng"]),
             _node_a("Cast", ["rng"], ["rngf"], {"to": 1}),
             _node_a("Add", ["x", "c"], ["xc"]),
             _node_a("Mul", ["xc", "zeros"], ["xz"]),
             _node_a("Add", ["xz", "fives"], ["xf"]),
             _node_a("Add", ["x", "rngf"], ["xr"]),
             _node_a("Cast", ["shp"], ["shpf"], {"to": 1})]
        return _g(n, ["x"], ["xc", "xz", "xf", "xr", "rng", "shpf"], t), [x4]
    if name == "reduce_norm":
        t = [_tensor("axes", np.asarray([2, 3], np.int64)),
             _tensor("s", rng.uniform(0.5, 1.5, 3).astype(np.float32)),
             _tensor("b", rng.standard_normal(3).astype(np.float32)),
             _tensor("g8", rng.uniform(0.5, 1.5, 8).astype(np.float32)),
             _tensor("b8", rng.standard_normal(8).astype(np.float32)),
             _tensor("m", rng.standard_normal((8, 5)).astype(np.float32)),
             _tensor("gm", rng.standard_normal((5, 8)).astype(np.float32)),
             _tensor("gc", rng.standard_normal(5).astype(np.float32)),
             _tensor("v2", rng.standard_normal((8, 2)).astype(np.float32))]
        n = [_node_a("ReduceMean", ["x"], ["rmean"], {"axes": [1], "keepdims": 1}),
             _node_a("ReduceSum", ["x", "axes"], ["rsum"], {"keepdims": 0}),
             _node_a("ReduceMax", ["x"], ["rmax"], {"axes": [-1], "keepdims": 0}),
             _node_a("ReduceMin", ["x"], ["rmin"], {"keepdims": 0}),
             _node_a("InstanceNormalization", ["x", "s", "b"], ["inorm"], {"epsilon": 1e-4}),
             _node_a("LayerNormalization", ["x", "g8", "b8"], ["lnorm"], {"axis": -1}),
             _node_a("LayerNormalization", ["x", "g8"], ["lnorm_nb"]),
             _node_a("MatMul", ["x", "m"], ["mm"]),
             _node_a("Einsum", ["x", "m"], ["es"], {"equation": "bchw,wk->bchk"}),
             _node_a("Flatten", ["x"], ["f"], {"axis": 3}),
             _node_a("Gemm", ["f", "gm", "gc"], ["gemm_t"], {"transB": 1, "alpha": 0.5, "beta": 2.0}),
             _node_a("Gemm", ["v2", "f"], ["gemm_a"], {"transA": 1, "transB": 1})]
        return _g(n, ["x"], ["rmean", "rsum", "rmax", "rmin", "inorm", "lnorm", "lnorm_nb", "mm",
                             "es", "gemm_t", "gemm_a"], t), [x4]
    if name == "pad":
        t = [_tensor("pads", np.asarray([0, 0, 1, 2, 0, 0, 2, 1], np.int64)),
             _tensor("cval", np.asarray(1.5, np.float32).reshape(()))]
        n = [_node_a("Pad", ["x", "pads", "cval"], ["pc"], {"mode": "constant"}),
             _node_a("Pad", ["x", "pads"], ["pz"]),
             _node_a("Pad", ["x", "pads"], ["pr"], {"mode": "reflect"}),
             _node_a("Pad", ["x", "pads"], ["pe"], {"mode": "edge"}),
             _node_a("Pad", ["x"], ["pattr"], {"pads": [0, 1, 0, 0, 0, 0, 0, 1], "value": -1.0})]
        return _g(n, ["x"], ["pc", "pz", "pr", "pe", "pattr"], t), [x4]
    raise KeyError(name)


FAMILIES = ["convnet", "conv_variants", "conv_transpose", "pools", "resize", "slices",
            "softmax_cast_where", "unary", "binary", "shape_ops", "constants", "reduce_norm", "pad"]


def _hold(got: dict, want: dict):
    assert list(got) == list(want)
    for name in want:
        w = np.asarray(want[name])
        g = got[name]
        assert isinstance(g, torch.Tensor) and g.device.type == "cpu", name
        g = g.numpy()
        assert g.shape == w.shape, (name, g.shape, w.shape)
        if np.issubdtype(w.dtype, np.floating):
            assert g.dtype == np.float32, (name, g.dtype)
            tol = REL_TOL * max(np.abs(w).max(), 1e-30)
            err = np.abs(g.astype(np.float64) - w).max()
            assert err <= tol, (name, err, tol)
        else:  # JAX's 32-bit ints against the port's int64: values, bitwise
            assert g.dtype.kind == w.dtype.kind, (name, g.dtype, w.dtype)
            np.testing.assert_array_equal(g, w, err_msg=name)


@pytest.mark.parametrize("family", FAMILIES)
def test_runner_matches_jax_runner(family):
    blob, inputs = _family(family, np.random.default_rng(FAMILIES.index(family)))
    want = jexec.OnnxRunner.from_bytes(blob)(*inputs)
    got = texec.OnnxRunner.from_bytes(blob, device="cpu")(*inputs)
    _hold(got, {k: np.asarray(v) for k, v in want.items()})


def _jax_ops() -> set:
    src = Path(jexec.__file__).read_text()
    ops = set(re.findall(r'if op == "([A-Z]\w+)"', src))
    for group in re.findall(r"if op in \(([^)]*)\)", src):
        ops |= set(re.findall(r'"(\w+)"', group))
    return ops


def test_runner_covers_every_op_of_the_jax_runner():
    jax_ops = _jax_ops()
    assert len(jax_ops) >= 60
    assert jax_ops <= texec.SUPPORTED_OPS, sorted(jax_ops - texec.SUPPORTED_OPS)
    assert texec.SUPPORTED_OPS <= jax_ops, sorted(texec.SUPPORTED_OPS - jax_ops)
    used = set()
    for family in FAMILIES:
        blob, _ = _family(family, np.random.default_rng(0))
        used |= {n["op_type"] for n in treader.parse_onnx_graph(blob)[1]}
    assert used == texec.SUPPORTED_OPS, sorted(texec.SUPPORTED_OPS - used)


def test_unknown_op_raises():
    blob = _model_io([], [_node_a("FancyNewOp", ["x"], ["y"])], ["x"], ["y"])
    with pytest.raises(NotImplementedError, match="FancyNewOp"):
        texec.OnnxRunner.from_bytes(blob, device="cpu")(np.zeros((1,), np.float32))
    nodes = treader.parse_onnx_graph(blob)[1]
    assert texec.unsupported_ops(nodes) == ["FancyNewOp"]


def test_runner_keeps_float_initializers_on_its_device_and_ints_on_the_host():
    blob, _ = _family("shape_ops", np.random.default_rng(0))
    run = texec.OnnxRunner.from_bytes(blob, device="cpu")
    assert all(isinstance(v, np.ndarray) and v.dtype == np.int64 for v in run.inits.values())
    blob, _ = _family("convnet", np.random.default_rng(0))
    run = texec.OnnxRunner.from_bytes(blob, device="cpu")
    assert all(isinstance(v, torch.Tensor) for v in run.inits.values())


# -------------------------------------------------------- TFC-TDF graph
@pytest.fixture(scope="module")
def mini_mdx(tmp_path_factory):
    from test_separator_mdx_arch import MiniConvTDFNetTrim, _export_onnx

    torch.manual_seed(0)
    net = MiniConvTDFNetTrim(dim_f=16).eval()
    path = str(tmp_path_factory.mktemp("mdx") / "mini_tfc_tdf.onnx")
    _export_onnx(net, torch.randn(1, 4, 16, 8), path)
    return net, path


def test_runner_matches_jax_on_the_tfc_tdf_graph(mini_mdx):
    net, path = mini_mdx
    x = np.random.default_rng(0).standard_normal((1, 4, 16, 8)).astype(np.float32)
    (want,) = jexec.OnnxRunner.from_file(path)(x).values()
    (got,) = texec.OnnxRunner.from_file(path, device="cpu")(x).values()
    _hold({"y": got}, {"y": np.asarray(want)})
    with torch.no_grad():
        _hold({"y": got}, {"y": net(torch.from_numpy(x)).numpy()})


# --------------------------------------------------------------- separator
def test_stft_istft_and_window_match_jax_bitwise():
    wav = np.random.default_rng(0).standard_normal((2, 8000)).astype(np.float32)
    for n_fft, hop in ((1024, 256), (7680, 1024)):
        _same(tsep._hann(n_fft), jsep._hann(n_fft))
        spec = tsep._stft(wav, n_fft, hop)
        _same(spec, jsep._stft(wav, n_fft, hop))
        _same(tsep._istft(spec, n_fft, hop, 8000), jsep._istft(spec, n_fft, hop, 8000))
    back = tsep._istft(tsep._stft(wav, 1024, 256), 1024, 256, 8000)
    np.testing.assert_allclose(back, wav, atol=1e-6)


def test_separator_plumbing_matches_jax_bitwise():
    """A spectrogram-identity net: the port's chunking, trimming and
    overlap-add give JAX's vocals, bit for bit, mono and stereo."""

    def identity(x):
        return {"out": x}

    kw = dict(onnx_path=None, n_fft=512, hop=128, dim_f=200, dim_t=6, compensation=1.009,
              runner=identity)
    rng = np.random.default_rng(1)
    for wav in (rng.standard_normal(30000).astype(np.float32),
                rng.standard_normal((2, 20000)).astype(np.float32)):
        _same(tsep.MDXVocalSeparator(**kw)(wav), jsep.MDXVocalSeparator(**kw)(wav))


def test_separator_through_the_tfc_tdf_graph_matches_jax(mini_mdx):
    _, path = mini_mdx
    kw = dict(n_fft=64, hop=16, dim_f=16, dim_t=3, compensation=1.0)
    wav = np.random.default_rng(1).standard_normal(500).astype(np.float32) * 0.1
    want = jsep.MDXVocalSeparator(onnx_path=path, **kw)(wav)
    sep = tsep.MDXVocalSeparator(onnx_path=path, device="cpu", **kw)
    assert sep.run.device == torch.device("cpu")
    got = sep(wav)
    assert got.shape == wav.shape and got.dtype == np.float32
    err = np.abs(got.astype(np.float64) - want).max()
    assert err <= REL_TOL * np.abs(want).max(), err


def test_separator_defaults_are_kim_vocal_2s():
    sep = tsep.MDXVocalSeparator(onnx_path=None, runner=lambda x: {"y": x})
    ref = jsep.MDXVocalSeparator(onnx_path=None, runner=lambda x: {"y": x})
    for k in ("n_fft", "hop", "dim_f", "frames", "compensation", "chunk_size", "trim"):
        assert getattr(sep, k) == getattr(ref, k), k
    assert (sep.n_fft, sep.hop, sep.dim_f, sep.frames, sep.compensation) == (
        7680, 1024, 3072, 256, 1.009)
