"""Minimal ONNX wire-format reader, numpy only (a copy of
`mmgt_tpu/utils/onnx_reader.py`; no onnx/protobuf packages needed).

It ingests the DWPose weights (yolox_l.onnx and dw-ll_ucoco_384.onnx, which
the reference loads with onnxruntime at src/dwpose/wholebody.py:14-27)
and the MDX separator graph for the port's `utils/onnx_exec.OnnxRunner`.
ONNX is plain protobuf; this module hand-parses the wire format for the
three message types needed:

  ModelProto.graph (field 7) -> GraphProto
  GraphProto.initializer (field 5, repeated TensorProto) -> weights
  GraphProto.node (field 1, repeated NodeProto) -> op topology (for
  BatchNorm folding and scheme detection)

Wire format recap: each field is a varint key (field_no << 3 | wire_type);
wire types 0=varint, 1=64-bit, 2=length-delimited, 5=32-bit. Repeated
scalars may arrive packed (wire type 2) or unpacked.
"""
from __future__ import annotations

from typing import Dict, Iterator, List, Tuple

import numpy as np

# TensorProto.DataType -> numpy dtype (onnx.proto enum values)
_DTYPES = {
    1: np.float32,
    2: np.uint8,
    3: np.int8,
    4: np.uint16,
    5: np.int16,
    6: np.int32,
    7: np.int64,
    9: np.bool_,
    10: np.float16,
    11: np.float64,
    12: np.uint32,
    13: np.uint64,
}


def _read_varint(buf: bytes, i: int) -> Tuple[int, int]:
    val, shift = 0, 0
    while True:
        b = buf[i]
        i += 1
        val |= (b & 0x7F) << shift
        if not b & 0x80:
            return val, i
        shift += 7


def _iter_fields(buf: bytes, start: int, end: int) -> Iterator[Tuple[int, int, object]]:
    """Yield (field_no, wire_type, value). Length-delimited values come as
    (lo, hi) spans into buf; varints as ints; fixed as raw bytes."""
    i = start
    while i < end:
        key, i = _read_varint(buf, i)
        field, wt = key >> 3, key & 7
        if wt == 0:
            v, i = _read_varint(buf, i)
            yield field, wt, v
        elif wt == 1:
            yield field, wt, buf[i : i + 8]
            i += 8
        elif wt == 2:
            ln, i = _read_varint(buf, i)
            yield field, wt, (i, i + ln)
            i += ln
        elif wt == 5:
            yield field, wt, buf[i : i + 4]
            i += 4
        else:  # groups (3/4) don't appear in onnx
            raise ValueError(f"unsupported wire type {wt} at offset {i}")


def _packed_varints(buf: bytes, lo: int, hi: int) -> List[int]:
    out, i = [], lo
    while i < hi:
        v, i = _read_varint(buf, i)
        out.append(v)
    return out


def _zigzag_to_signed(v: int, bits: int = 64) -> int:
    # onnx int64 fields are plain (not zigzag) varints; negative values are
    # encoded as 2^64 complements.
    return v - (1 << bits) if v >= (1 << (bits - 1)) else v


def _parse_tensor(buf: bytes, lo: int, hi: int) -> Tuple[str, np.ndarray]:
    name = ""
    dims: List[int] = []
    dtype_code = 1
    raw = None
    float_data: List[float] = []
    int_data: List[int] = []
    double_data: List[float] = []
    for field, wt, v in _iter_fields(buf, lo, hi):
        if field == 1:  # dims
            if wt == 0:
                dims.append(_zigzag_to_signed(v))
            else:
                dims.extend(_zigzag_to_signed(x) for x in _packed_varints(buf, *v))
        elif field == 2 and wt == 0:  # data_type
            dtype_code = v
        elif field == 4:  # float_data
            if wt == 5:
                float_data.append(np.frombuffer(v, "<f4")[0])
            else:
                s, e = v
                float_data.extend(np.frombuffer(buf[s:e], "<f4").tolist())
        elif field in (5, 7):  # int32_data / int64_data
            if wt == 0:
                int_data.append(_zigzag_to_signed(v))
            else:
                int_data.extend(_zigzag_to_signed(x) for x in _packed_varints(buf, *v))
        elif field == 8 and wt == 2:  # name
            s, e = v
            name = buf[s:e].decode("utf-8")
        elif field == 9 and wt == 2:  # raw_data
            s, e = v
            raw = buf[s:e]
        elif field == 10:  # double_data
            if wt == 1:
                double_data.append(np.frombuffer(v, "<f8")[0])
            else:
                s, e = v
                double_data.extend(np.frombuffer(buf[s:e], "<f8").tolist())
    np_dtype = _DTYPES.get(dtype_code)
    if np_dtype is None:
        raise ValueError(f"tensor {name!r}: unsupported data_type {dtype_code}")
    if raw is not None:
        arr = np.frombuffer(raw, np_dtype)
    elif float_data:
        arr = np.asarray(float_data, np.float32)
    elif double_data:
        arr = np.asarray(double_data, np.float64)
    elif int_data:
        arr = np.asarray(int_data, np.int64).astype(np_dtype)
    else:
        arr = np.zeros(0, np_dtype)
    # dims == [] is a genuine ONNX scalar (shape ()); only fall back to the
    # flat shape when the element count contradicts a scalar read
    shape = tuple(dims) if (dims or arr.size == 1) else arr.shape
    return name, arr.reshape(shape).copy()


def _parse_attribute(buf: bytes, lo: int, hi: int):
    """AttributeProto -> (name, python value). Covers the kinds the DWPose /
    separator graphs use: f(2), i(3), s(4), t(5), floats(7), ints(8)."""
    name = ""
    val = None
    ints: List[int] = []
    floats: List[float] = []
    for field, wt, v in _iter_fields(buf, lo, hi):
        if field == 1 and wt == 2:
            name = buf[v[0] : v[1]].decode("utf-8")
        elif field == 2 and wt == 5:  # f
            val = float(np.frombuffer(v, "<f4")[0])
        elif field == 3 and wt == 0:  # i
            val = _zigzag_to_signed(v)
        elif field == 4 and wt == 2:  # s
            val = buf[v[0] : v[1]].decode("utf-8", "replace")
        elif field == 5 and wt == 2:  # t (tensor)
            val = _parse_tensor(buf, *v)[1]
        elif field == 7:  # floats
            if wt == 5:
                floats.append(float(np.frombuffer(v, "<f4")[0]))
            else:
                s, e = v
                floats.extend(np.frombuffer(buf[s:e], "<f4").tolist())
        elif field == 8:  # ints
            if wt == 0:
                ints.append(_zigzag_to_signed(v))
            else:
                ints.extend(_zigzag_to_signed(x) for x in _packed_varints(buf, *v))
    if ints:
        val = ints
    elif floats:
        val = floats
    return name, val


def _parse_node(buf: bytes, lo: int, hi: int) -> Dict[str, object]:
    node = {"input": [], "output": [], "name": "", "op_type": "", "attrs": {}}
    for field, wt, v in _iter_fields(buf, lo, hi):
        if wt != 2:
            continue
        s, e = v
        if field == 1:
            node["input"].append(buf[s:e].decode("utf-8"))
        elif field == 2:
            node["output"].append(buf[s:e].decode("utf-8"))
        elif field == 3:
            node["name"] = buf[s:e].decode("utf-8")
        elif field == 4:
            node["op_type"] = buf[s:e].decode("utf-8")
        elif field == 5:
            k, val = _parse_attribute(buf, s, e)
            node["attrs"][k] = val
    return node


def _value_info_name(buf: bytes, lo: int, hi: int) -> str:
    for field, wt, v in _iter_fields(buf, lo, hi):
        if field == 1 and wt == 2:
            return buf[v[0] : v[1]].decode("utf-8")
    return ""


def parse_onnx_graph(data: bytes) -> Tuple[Dict[str, np.ndarray], List[Dict]]:
    """Parse serialized ModelProto bytes -> (initializers, nodes)."""
    inits, nodes, _, _ = parse_onnx_model(data)
    return inits, nodes


def parse_onnx_model(
    data: bytes,
) -> Tuple[Dict[str, np.ndarray], List[Dict], List[str], List[str]]:
    """ModelProto bytes -> (initializers, nodes, input_names, output_names).

    input_names excludes initializers (following onnxruntime's notion of
    runtime inputs)."""
    graph_span = None
    for field, wt, v in _iter_fields(data, 0, len(data)):
        if field == 7 and wt == 2:  # ModelProto.graph
            graph_span = v
            break
    if graph_span is None:
        raise ValueError("no GraphProto found — not an ONNX ModelProto?")
    inits: Dict[str, np.ndarray] = {}
    nodes: List[Dict] = []
    inputs: List[str] = []
    outputs: List[str] = []
    for field, wt, v in _iter_fields(data, *graph_span):
        if wt != 2:
            continue
        if field == 5:  # initializer
            name, arr = _parse_tensor(data, *v)
            inits[name] = arr
        elif field == 1:  # node
            nodes.append(_parse_node(data, *v))
        elif field == 11:  # input (ValueInfoProto)
            inputs.append(_value_info_name(data, *v))
        elif field == 12:  # output
            outputs.append(_value_info_name(data, *v))
    inputs = [n for n in inputs if n not in inits]
    return inits, nodes, inputs, outputs


def load_onnx(path: str) -> Tuple[Dict[str, np.ndarray], List[Dict]]:
    with open(path, "rb") as f:
        return parse_onnx_graph(f.read())


# ------------------------------------------------------------------ helpers
def fold_batchnorms(
    inits: Dict[str, np.ndarray], nodes: List[Dict], eps: float = 1e-5
) -> Dict[str, np.ndarray]:
    """Fold Conv->BatchNormalization pairs into the conv weights, returning
    a new initializer dict where each folded conv gains a ".folded_bias"
    companion and BN params disappear.

    Used when the source graph keeps explicit BatchNormalization nodes but
    the target layout wants fused weights. Graphs already fused by onnxsim
    need no folding.
    """
    out = dict(inits)
    producers = {o: n for n in nodes for o in n["output"]}
    for n in nodes:
        if n["op_type"] != "BatchNormalization":
            continue
        src = producers.get(n["input"][0])
        if src is None or src["op_type"] != "Conv":
            continue
        wname = src["input"][1]
        scale, bias, mean, var = (inits[k] for k in n["input"][1:5])
        w = out[wname].astype(np.float64)
        node_eps = float(n.get("attrs", {}).get("epsilon", eps))
        inv = scale / np.sqrt(var + node_eps)
        out[wname] = (w * inv.reshape(-1, *([1] * (w.ndim - 1)))).astype(
            inits[wname].dtype
        )
        b0 = inits[src["input"][2]] if len(src["input"]) > 2 else 0.0
        out[wname + ".folded_bias"] = ((b0 - mean) * inv + bias).astype(
            inits[wname].dtype
        )
        for k in n["input"][1:5]:
            out.pop(k, None)
    return out
