"""The port's DWPose (`models/dwpose.py`, `data/dwpose_infer.py`,
`utils/convert.load_dwpose_weights`, `data/pose_init.portrait_keypoints`
with a detector) against mmgt_tpu's, on the CPU.

Tolerances:
  * YOLOX-L (160^2) and RTMPose (128x96 crops), weights and BatchNorm
    statistics crossed from one seeded flax tree by `load_jax_params`:
    1e-5 of the largest |output| for each of the box regressions, the
    sigmoided scores and the two SimCC outputs (f32 on both sides; XLA's
    and torch's CPU convolutions sum in other orders through ~100 layers);
  * the host pre- and post-processing, the detector around stub nets and
    the weights read from an .onnx file: bitwise;
  * the detector through the two ONNX executors: keypoints within 1e-3 px
    (the SimCC argmax agrees) and scores (SimCC maxima) within 1e-4 of the
    largest, since the synthetic pose graph averages 110,592 pixels in f32
    in another order on each side.
"""
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

sys.path.insert(0, str(Path(__file__).parent))
from test_convert import _inverse_tensor  # noqa: E402
from test_onnx_exec import _model_io, _node_a  # noqa: E402
from test_onnx_reader import _model, _tensor  # noqa: E402
from torch_port_util import init_noised, one_torch_thread  # noqa: E402,F401

from mmgt_tpu.data import conditioning as jcond  # noqa: E402
from mmgt_tpu.data import dwpose_infer as jdi  # noqa: E402
from mmgt_tpu.data import pose_init as jpi  # noqa: E402
from mmgt_tpu.models import dwpose as jdw  # noqa: E402
from mmgt_tpu.utils import convert as jcv  # noqa: E402
from mmgt_tpu_torch.data import dwpose_infer as tdi  # noqa: E402
from mmgt_tpu_torch.data import pose_init as tpi  # noqa: E402
from mmgt_tpu_torch.models import dwpose as tdw  # noqa: E402
from mmgt_tpu_torch.utils import convert as tcv  # noqa: E402

REL_TOL = 1e-5


def _noised_with_stats(module, shape, seed=0, bn_gain=1.0):
    """Seeded flax params and batch_stats; the running variances positive,
    the BatchNorm scales times `bn_gain`."""
    tree = init_noised(module, jnp.zeros(shape), seed=seed)
    stats = jax.tree_util.tree_map_with_path(
        lambda p, v: np.abs(v) + 0.5 if getattr(p[-1], "key", "") == "var" else v,
        tree["batch_stats"])
    params = jax.tree_util.tree_map_with_path(
        lambda p, v: v * bn_gain if getattr(p[-1], "key", "") == "scale" else v, tree["params"])
    return {"params": params, "batch_stats": stats}


def _rel(got, want, what):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err, tol = np.abs(got - want).max(), REL_TOL * np.abs(want).max()
    assert err <= tol, (what, err, tol)


# ------------------------------------------------------------------- nets
def test_yolox_matches_jax():
    """Raw pixels in; the BatchNorm scales damped to 0.7 so that ~100
    layers keep the logits O(1): the sigmoided scores then span
    (0.002, 0.99) and are compared where they are not saturated."""
    jm, shape = jdw.YOLOXL(), (1, 160, 160, 3)
    tree = _noised_with_stats(jm, shape, bn_gain=0.7)
    x = np.random.default_rng(1).uniform(0, 255, shape).astype(np.float32)
    want = np.asarray(jax.jit(jm.apply)(tree, x))
    tm = tcv.load_jax_params(tdw.YOLOXL(), tree, tcv.DWPOSE_MAPPERS["yolox"]).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2)).numpy()
    assert got.shape == (1, 20 ** 2 + 10 ** 2 + 5 ** 2, 85)
    _rel(got[..., :4], want[..., :4], "box regressions")
    _rel(got[..., 4:], want[..., 4:], "obj/cls scores")
    assert ((want[..., 4:] > 0.01) & (want[..., 4:] < 0.99)).mean() > 0.9


def test_rtmpose_matches_jax():
    jm, shape = jdw.RTMPose(input_wh=(96, 128)), (2, 128, 96, 3)
    tree = _noised_with_stats(jm, shape, seed=2)
    x = np.random.default_rng(3).standard_normal(shape).astype(np.float32)
    want = jax.jit(jm.apply)(tree, x)
    tm = tcv.load_jax_params(tdw.RTMPose(input_wh=(96, 128)), tree,
                             tcv.DWPOSE_MAPPERS["rtmpose"]).eval()
    with torch.no_grad():
        got = tm(torch.from_numpy(x).permute(0, 3, 1, 2))
    assert got[0].shape == (2, 133, 192) and got[1].shape == (2, 133, 256)
    for g, w, what in zip(got, want, ("simcc_x", "simcc_y")):
        _rel(g.numpy(), w, what)


@pytest.mark.parametrize("pos_enc", [False, True])
def test_gau_matches_jax(pos_enc):
    """The GAU alone, with the rotary that RTMPose's configs leave off."""
    jm = jdw.GAU(hidden=32, s=16, pos_enc=pos_enc)
    x = np.random.default_rng(4).standard_normal((2, 7, 32)).astype(np.float32)
    tree = init_noised(jm, jnp.zeros(x.shape), seed=4)
    want = jm.apply(tree, x)
    tm = tdw.GAU(hidden=32, s=16, pos_enc=pos_enc)
    tcv.load_jax_params(tm, tree, lambda k: tcv.map_rtmpose("gau/" + k)[len("head.gau."):])
    with torch.no_grad():
        _rel(tm(torch.from_numpy(x)).numpy(), want, "gau")
    q = np.random.default_rng(5).standard_normal((2, 7, 2, 16)).astype(np.float32)
    _rel(tdw._rope_half(torch.from_numpy(q)).numpy(), jdw._rope_half(jnp.asarray(q)), "rope")


def test_port_keys_are_the_mapped_flax_names():
    for jm, tm, shape, which in ((jdw.YOLOXL(), tdw.YOLOXL(), (1, 64, 64, 3), "yolox"),
                                 (jdw.RTMPose(), tdw.RTMPose(), (1, 384, 288, 3), "rtmpose")):
        tree = jax.eval_shape(lambda: jm.init(jax.random.PRNGKey(0), jnp.zeros(shape)))
        flat = traverse_util.flatten_dict(tree, sep="/")
        mapped = {tcv.DWPOSE_MAPPERS[which](k.replace("params/", "", 1)) for k in flat}
        assert mapped == set(tm.state_dict()), which


# ------------------------------------------------------- host processing
def _raw_dets(rng):
    raw = rng.standard_normal((1, 8400, 85)).astype(np.float32) * 0.5
    raw[..., 4:] = rng.uniform(0, 0.2, (1, 8400, 81)).astype(np.float32)
    for idx, (w, h) in ((10 * 80 + 10, (10.0, 20.0)), (40 * 80 + 40, (120.0, 200.0)),
                        (41 * 80 + 40, (110.0, 190.0)), (6400 + 300, (60.0, 70.0))):
        raw[0, idx, :4] = [0.2, -0.1, np.log(w / 8), np.log(h / 8)]
        raw[0, idx, 4:6] = 0.95
    return raw


def _host_cases():
    rng = np.random.default_rng(7)
    img = rng.integers(0, 255, (480, 360, 3)).astype(np.uint8)
    raw = _raw_dets(rng)
    boxes = rng.uniform(0, 300, (12, 4)).astype(np.float32)
    boxes[:, 2:] = boxes[:, :2] + rng.uniform(5, 80, (12, 2)).astype(np.float32)
    box_scores = rng.permutation(12).astype(np.float32)
    sx = rng.standard_normal((3, 133, 576)).astype(np.float32)
    sy = rng.standard_normal((3, 133, 768)).astype(np.float32)
    sy[0, :5] = -1.0  # invalid keypoints (max <= 0)
    kp = rng.uniform(0, 500, (3, 133, 2)).astype(np.float32)
    sc = rng.uniform(0, 1, (3, 133)).astype(np.float32)
    c, s = np.asarray([180.0, 240.0], np.float32), np.asarray([150.0, 260.0], np.float32)
    return {
        "yolox_preprocess": (lambda m: m.yolox_preprocess(img)),
        "yolox_preprocess_wide": (lambda m: m.yolox_preprocess(img[:200])),
        "yolox_decode": (lambda m: m.yolox_decode(raw)),
        "nms": (lambda m: m.nms(boxes, box_scores, 0.3)),
        "detect_person_boxes": (lambda m: m.detect_person_boxes(raw, 0.75)),
        "detect_person_boxes_none": (lambda m: m.detect_person_boxes(raw * 0, 1.0)),
        "bbox_xyxy2cs": (lambda m: m.bbox_xyxy2cs(boxes[3])),
        "fix_aspect_ratio": (lambda m: (m.fix_aspect_ratio(s, 288 / 384),
                                        m.fix_aspect_ratio(s[::-1].copy(), 288 / 384))),
        "crop_affine": (lambda m: m.crop_affine(img, c, s)),
        "simcc_decode": (lambda m: m.simcc_decode(sx, sy)),
        "keypoints_to_image": (lambda m: m.keypoints_to_image(kp[0], (288, 384), s, c)),
        "to_openpose_134": (lambda m: m.to_openpose_134(kp, sc)),
    }


def _bitwise(got, want, what=""):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _bitwise(g, w, what)
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), what
    else:
        assert type(got) is type(want) and got == want, (what, got, want)


@pytest.mark.parametrize("case", list(_host_cases()))
def test_host_processing_matches_jax_bitwise(case):
    fn = _host_cases()[case]
    _bitwise(fn(tdi), fn(jdi), case)


# -------------------------------------------------------------- detector
def _stub_nets(offset=40):
    def det_fn(img640):
        assert img640.shape == (1, 640, 640, 3)
        raw = np.zeros((1, 8400, 85), np.float32)
        idx = offset * 80 + offset
        raw[0, idx, :4] = [0, 0, np.log(120.0), np.log(200.0)]
        raw[0, idx, 4:6] = 0.95
        return raw

    def pose_fn(crops):
        n = crops.shape[0]
        g = np.random.default_rng(int(abs(crops).sum()) % 2**32)
        sx = g.standard_normal((n, 133, 576)).astype(np.float32)
        sy = g.standard_normal((n, 133, 768)).astype(np.float32)
        return sx, sy

    return det_fn, pose_fn


def test_detector_with_stub_nets_matches_jax_bitwise():
    img = np.random.default_rng(0).integers(0, 255, (480, 640, 3)).astype(np.uint8)
    want = jdi.DWPoseDetector(*_stub_nets())(img)
    got = tdi.DWPoseDetector(*_stub_nets())(img)
    assert got.shape == (134, 3) and np.isfinite(got).all()
    _bitwise(got, want)


class _PixelNet(torch.nn.Module):
    """Stand-ins for YOLOXL / RTMPose with their input and output layouts:
    outputs computed from the NCHW input, so a wrong permute shows."""

    def __init__(self, det: bool):
        super().__init__()
        self.det = det
        self.w = torch.nn.Parameter(torch.tensor([0.3, -0.2, 0.1]))

    def forward(self, x):
        assert x.shape[1] == 3
        if self.det:
            assert x.shape[2:] == (640, 640)
            raw = torch.zeros(x.shape[0], 8400, 85)
            v = (x[:, :, ::8, ::8] * self.w[:, None, None]).sum(1).flatten(1)  # (B, 6400)
            raw[:, :6400, 4:6] = torch.sigmoid(v / 100.0)[..., None]
            raw[:, :6400, 2:4] = 2.0
            return raw
        feat = (x * self.w[:, None, None]).mean((2, 3)).sum(1)  # (B,)
        pos_x = torch.arange(576.0)[None, None] * feat[:, None, None]
        pos_y = torch.arange(768.0)[None, None] * feat[:, None, None]
        k = torch.arange(133.0)[None, :, None]
        return torch.cos(pos_x / 50 + k), torch.sin(pos_y / 70 - k)


def test_detector_from_modules_matches_jax_around_the_same_nets():
    """`from_modules` wraps NCHW modules; JAX's detector takes NHWC
    functions: the same nets behind both give the same keypoints."""
    det, pose = _PixelNet(True).eval(), _PixelNet(False).eval()

    def det_np(img):
        with torch.no_grad():
            return det(torch.from_numpy(np.asarray(img, np.float32)).permute(0, 3, 1, 2)).numpy()

    def pose_np(crops):
        with torch.no_grad():
            sx, sy = pose(torch.from_numpy(np.asarray(crops, np.float32)).permute(0, 3, 1, 2))
        return sx.numpy(), sy.numpy()

    img = np.random.default_rng(1).integers(0, 255, (400, 520, 3)).astype(np.uint8)
    want = jdi.DWPoseDetector(det_np, pose_np)(img)
    got = tdi.DWPoseDetector.from_modules(det, pose)(img)
    _bitwise(got, want)


def _onnx_graphs(tmp_path):
    """Synthetic graphs with the geometry of yolox_l.onnx and
    dw-ll_ucoco_384.onnx (as `tests/test_dwpose.py`'s): the detector's
    person score answers red minus green, so a red patch on a grey
    letterbox gives one cluster of 160-px boxes, which NMS thins to a few."""
    rng = np.random.default_rng(0)
    tensors, nodes, parts = [], [], []
    for s in (8, 16, 32):
        w = np.zeros((85, 3, 1, 1), np.float32)
        w[:4] = rng.standard_normal((4, 3, 1, 1)) * 1e-4
        w[4:6, :, 0, 0] = [0.02, -0.02, 0.0]
        b = np.zeros(85, np.float32)
        b[2:4] = np.log(160.0 / s)
        tensors += [_tensor(f"w{s}", w), _tensor(f"b{s}", b),
                    _tensor(f"sh{s}", np.asarray([1, 85, (640 // s) ** 2], np.int64))]
        nodes += [
            _node_a("AveragePool", ["img"], [f"p{s}"], {"kernel_shape": [s, s], "strides": [s, s]}),
            _node_a("Conv", [f"p{s}", f"w{s}", f"b{s}"], [f"c{s}"], {}),
            _node_a("Reshape", [f"c{s}", f"sh{s}"], [f"r{s}"]),
        ]
        parts.append(f"r{s}")
    nodes += [_node_a("Concat", parts, ["cat"], {"axis": 2}),
              _node_a("Transpose", ["cat"], ["dets"], {"perm": [0, 2, 1]})]
    det_blob = _model_io(tensors, nodes, ["img"], ["dets"])
    wx = (rng.standard_normal((3, 133 * 576)) * 0.1).astype(np.float32)
    wy = (rng.standard_normal((3, 133 * 768)) * 0.1).astype(np.float32)
    pose_blob = _model_io(
        [_tensor("wx", wx), _tensor("wy", wy),
         _tensor("shx", np.asarray([0, 133, 576], np.int64)),
         _tensor("shy", np.asarray([0, 133, 768], np.int64))],
        [_node_a("GlobalAveragePool", ["crop"], ["g"]),
         _node_a("Flatten", ["g"], ["f"], {"axis": 1}),
         _node_a("MatMul", ["f", "wx"], ["mx"]),
         _node_a("Reshape", ["mx", "shx"], ["simcc_x"]),
         _node_a("MatMul", ["f", "wy"], ["my"]),
         _node_a("Reshape", ["my", "shy"], ["simcc_y"])],
        ["crop"], ["simcc_x", "simcc_y"])
    dp, pp = tmp_path / "yolox.onnx", tmp_path / "rtmpose.onnx"
    dp.write_bytes(det_blob)
    pp.write_bytes(pose_blob)
    return str(dp), str(pp)


def test_detector_from_onnx_matches_jax(tmp_path):
    dp, pp = _onnx_graphs(tmp_path)
    img = np.random.default_rng(0).integers(0, 40, (480, 360, 3)).astype(np.uint8)
    img[100:220, 80:200, 0] = 220
    want = jdi.DWPoseDetector.from_onnx(dp, pp)(img)
    got = tdi.DWPoseDetector.from_onnx(dp, pp, device="cpu")(img)
    assert got.shape == (134, 3) and got.dtype == np.float32
    np.testing.assert_allclose(got[:, :2], want[:, :2], rtol=0, atol=1e-3)
    np.testing.assert_allclose(got[:, 2], want[:, 2], rtol=0, atol=1e-4 * np.abs(want[:, 2]).max())


def test_portrait_keypoints_with_the_detector_matches_jax():
    """JAX's `portrait_keypoints` hands the detector's (134, 3) to
    `mask_leg`, which wants (..., 402), and raises (ROADMAP §3); the port
    flattens it first. Held to JAX's `mask_leg` of JAX's detector output."""
    img = np.random.default_rng(3).integers(0, 255, (512, 512, 3)).astype(np.uint8)
    jdet = jdi.DWPoseDetector(*_stub_nets(30))
    with pytest.raises(ValueError):
        jpi.portrait_keypoints(img, detector=jdet)
    want = np.asarray(jcond.mask_leg(jdet(img).reshape(1, 402)))[0]
    got = tpi.portrait_keypoints(img, detector=tdi.DWPoseDetector(*_stub_nets(30)))
    assert got.shape == (402,) and (got.reshape(134, 3)[[9, 10, 12, 13]] == 0).all()
    _bitwise(got, want)


# ---------------------------------------------------------------- weights
@pytest.mark.parametrize("prefix", ["", "model."])
def test_load_dwpose_weights_matches_jax(tmp_path, prefix):
    """A synthetic RTMPose blob (`tests/test_convert.py`'s): the port's
    module holds every tensor JAX's converter puts in its tree, bitwise."""
    m = jdw.RTMPose()
    tree = jax.eval_shape(lambda: m.init(jax.random.PRNGKey(0), jnp.zeros((1, 384, 288, 3))))
    flat = traverse_util.flatten_dict(tree, sep="/")
    tensors = []
    for k, leaf in flat.items():
        _, tv = _inverse_tensor(k, leaf.shape)
        key = jcv.map_rtmpose(k.replace("params/", "", 1))
        tensors.append(_tensor(prefix + key, np.ascontiguousarray(tv)))
    p = tmp_path / "dw-ll_test.onnx"
    p.write_bytes(_model(tensors))

    want, jrep = jcv.load_dwpose_weights(str(p), tree, "rtmpose")
    port = tdw.RTMPose()
    rep = tcv.load_dwpose_weights(str(p), port)
    assert rep == {"missing": [], "unexpected": []} and not jrep["missing"]
    sd = port.state_dict()
    for k, v in traverse_util.flatten_dict(want, sep="/").items():
        tkey = jcv.map_rtmpose(k.replace("params/", "", 1))
        ref = tcv.from_flax_tensor(k, v, sd[tkey].shape)
        assert sd[tkey].numpy().tobytes() == ref.astype(np.float32).tobytes(), tkey


def test_load_dwpose_weights_reports_missing_and_unexpected(tmp_path):
    port = tdw.RTMPose(input_wh=(96, 128))
    sd = {k: v.numpy() for k, v in port.state_dict().items()}
    gone = "head.gau.gamma"
    tensors = [_tensor(k, np.ascontiguousarray(v)) for k, v in sd.items() if k != gone]
    tensors.append(_tensor("module.extra.weight", np.zeros(3, np.float32)))
    p = tmp_path / "partial.onnx"
    p.write_bytes(_model(tensors))
    with pytest.raises(KeyError, match="1 params missing"):
        tcv.load_dwpose_weights(str(p), port)
    tensors.append(_tensor(gone, sd[gone]))
    p.write_bytes(_model(tensors))
    assert tcv.load_dwpose_weights(str(p), port)["unexpected"] == ["extra.weight"]
