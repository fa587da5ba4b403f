"""DWPose inference pre/post-processing (`mmgt_tpu/data/dwpose_infer.py`):
the host code copied (numpy; cv2 imported where it resizes and warps),
and `DWPoseDetector` over the port's nets or its ONNX runner on the card.

It rebuilds the reference's onnxruntime-side logic
(src/dwpose/onnxdet.py:7-103 YOLOX decode+NMS,
src/dwpose/onnxpose.py:9-363 top-down affine + SimCC decode,
src/dwpose/wholebody.py:29-51 neck synthesis + mmpose->openpose remap).
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np
import torch

from mmgt_tpu_torch.utils.onnx_exec import OnnxRunner

# ----------------------------------------------------------------- detector
def yolox_preprocess(img: np.ndarray, input_size=(640, 640)) -> Tuple[np.ndarray, float]:
    """Letterbox resize with 114-padding (onnxdet.py:84-101). img: uint8 RGB."""
    padded = np.full((*input_size, 3), 114, np.float32)
    r = min(input_size[0] / img.shape[0], input_size[1] / img.shape[1])
    nh, nw = int(img.shape[0] * r), int(img.shape[1] * r)
    import cv2

    resized = cv2.resize(img, (nw, nh), interpolation=cv2.INTER_LINEAR)
    padded[:nh, :nw] = resized
    return padded, r


def yolox_decode(outputs: np.ndarray, img_size=(640, 640)) -> np.ndarray:
    """Raw head outputs (1, N, 85) -> absolute xywh (onnxdet.py:61-81)."""
    grids, strides_all = [], []
    for stride in (8, 16, 32):
        hs, ws = img_size[0] // stride, img_size[1] // stride
        xv, yv = np.meshgrid(np.arange(ws), np.arange(hs))
        grid = np.stack((xv, yv), 2).reshape(1, -1, 2)
        grids.append(grid)
        strides_all.append(np.full((1, grid.shape[1], 1), stride))
    grids = np.concatenate(grids, 1).astype(np.float32)
    strides_all = np.concatenate(strides_all, 1).astype(np.float32)
    out = outputs.copy()
    out[..., :2] = (out[..., :2] + grids) * strides_all
    out[..., 2:4] = np.exp(out[..., 2:4]) * strides_all
    return out


def nms(boxes: np.ndarray, scores: np.ndarray, thr: float) -> List[int]:
    """Greedy single-class NMS (onnxdet.py:7-34 semantics)."""
    x1, y1, x2, y2 = boxes.T
    areas = (x2 - x1 + 1) * (y2 - y1 + 1)
    order = scores.argsort()[::-1]
    keep = []
    while order.size > 0:
        i = order[0]
        keep.append(int(i))
        xx1 = np.maximum(x1[i], x1[order[1:]])
        yy1 = np.maximum(y1[i], y1[order[1:]])
        xx2 = np.minimum(x2[i], x2[order[1:]])
        yy2 = np.minimum(y2[i], y2[order[1:]])
        inter = np.maximum(0, xx2 - xx1 + 1) * np.maximum(0, yy2 - yy1 + 1)
        iou = inter / (areas[i] + areas[order[1:]] - inter)
        order = order[1:][iou <= thr]
    return keep


def detect_person_boxes(
    raw_outputs: np.ndarray, ratio: float,
    score_thr: float = 0.1, nms_thr: float = 0.45, final_thr: float = 0.3,
) -> np.ndarray:
    """(1, N, 85) raw head output -> (M, 4) person xyxy boxes in original
    image coords (inference_detector, onnxdet.py:103-137)."""
    preds = yolox_decode(raw_outputs)[0]
    boxes_xywh = preds[:, :4]
    scores = preds[:, 4:5] * preds[:, 5:]
    boxes = np.empty_like(boxes_xywh)
    boxes[:, 0] = boxes_xywh[:, 0] - boxes_xywh[:, 2] / 2
    boxes[:, 1] = boxes_xywh[:, 1] - boxes_xywh[:, 3] / 2
    boxes[:, 2] = boxes_xywh[:, 0] + boxes_xywh[:, 2] / 2
    boxes[:, 3] = boxes_xywh[:, 1] + boxes_xywh[:, 3] / 2
    boxes /= ratio
    person_scores = scores[:, 0]
    mask = person_scores > score_thr
    if not mask.any():
        return np.zeros((0, 4), np.float32)
    b, s = boxes[mask], person_scores[mask]
    keep = nms(b, s, nms_thr)
    dets = np.concatenate([b[keep], s[keep, None]], 1)
    return dets[dets[:, 4] > final_thr][:, :4].astype(np.float32)


# --------------------------------------------------------------------- pose
def bbox_xyxy2cs(bbox: np.ndarray, padding: float = 1.25):
    """xyxy -> (center, scale) (onnxpose.py:118-151)."""
    x1, y1, x2, y2 = bbox[:4]
    center = np.array([(x1 + x2) / 2, (y1 + y2) / 2], np.float32)
    scale = np.array([x2 - x1, y2 - y1], np.float32) * padding
    return center, scale


def fix_aspect_ratio(scale: np.ndarray, aspect: float) -> np.ndarray:
    w, h = scale
    if w > h * aspect:
        return np.array([w, w / aspect], np.float32)
    return np.array([h * aspect, h], np.float32)


def crop_affine(img: np.ndarray, center, scale, out_wh=(288, 384)) -> np.ndarray:
    """Top-down affine crop (onnxpose.py:206-294) via cv2 warp."""
    import cv2

    w, h = out_wh
    scale = fix_aspect_ratio(scale, w / h)
    src = np.array(
        [
            center - scale / 2,
            [center[0] + scale[0] / 2, center[1] - scale[1] / 2],
            center + scale / 2,
        ],
        np.float32,
    )
    dst = np.array([[0, 0], [w, 0], [w, h]], np.float32)
    m = cv2.getAffineTransform(src, dst)
    return cv2.warpAffine(img, m, (w, h), flags=cv2.INTER_LINEAR), scale


# RTMPose input normalization (mmdeploy defaults)
POSE_MEAN = np.array([123.675, 116.28, 103.53], np.float32)
POSE_STD = np.array([58.395, 57.12, 57.375], np.float32)


def simcc_decode(
    simcc_x: np.ndarray, simcc_y: np.ndarray, split_ratio: float = 2.0
) -> Tuple[np.ndarray, np.ndarray]:
    """(N, K, Wx), (N, K, Wy) -> keypoints (N, K, 2), scores (N, K)
    (onnxpose.py:296-361)."""
    n, k, wx = simcc_x.shape
    sx = simcc_x.reshape(n * k, -1)
    sy = simcc_y.reshape(n * k, -1)
    locs = np.stack([sx.argmax(1), sy.argmax(1)], -1).astype(np.float32)
    vals = np.minimum(sx.max(1), sy.max(1))
    locs[vals <= 0.0] = -1
    return locs.reshape(n, k, 2) / split_ratio, vals.reshape(n, k)


def keypoints_to_image(
    kpts: np.ndarray, model_input=(288, 384), scale=None, center=None
) -> np.ndarray:
    """SimCC coords -> original-image coords (onnxpose.py:111)."""
    return kpts / np.asarray(model_input) * scale + center - scale / 2


def to_openpose_134(keypoints: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """(N, 133, 2) mmpose wholebody + scores -> (N, 134, 3) openpose layout
    with synthesized neck (wholebody.py:35-51)."""
    info = np.concatenate([keypoints, scores[..., None]], -1)
    neck = info[:, [5, 6]].mean(1)
    neck[:, 2] = (
        np.logical_and(info[:, 5, 2] > 0.3, info[:, 6, 2] > 0.3)
    ).astype(np.float32)
    out = np.insert(info, 17, neck, axis=1)
    mmpose_idx = [17, 6, 8, 10, 7, 9, 12, 14, 16, 13, 15, 2, 1, 4, 3]
    openpose_idx = [1, 2, 3, 4, 6, 7, 8, 9, 10, 12, 13, 14, 15, 16, 17]
    out[:, openpose_idx] = out[:, mmpose_idx]
    return out


def _host(y) -> np.ndarray:
    """A net's output as a host array (one copy off the card, as JAX's
    `np.asarray` of a device array)."""
    return y.detach().cpu().numpy() if isinstance(y, torch.Tensor) else np.asarray(y)


class DWPoseDetector:
    """Full detector: image -> (134, 3) best-person keypoints.

    `det_fn(img_640_nhwc) -> (1, N, 85)` and `pose_fn(crops_nhwc) ->
    (simcc_x, simcc_y)` run the nets: `from_modules` wraps the port's
    YOLOXL / RTMPose (`mmgt_tpu_torch.models.dwpose`), `from_onnx` the
    published .onnx graphs through the port's OnnxRunner; both on the
    card unless the caller asks for the CPU. Injectable for testing.
    """

    def __init__(self, det_fn, pose_fn, pose_input=(288, 384)):
        self.det_fn = det_fn
        self.pose_fn = pose_fn
        self.pose_input = pose_input

    @classmethod
    def from_modules(cls, yolox, rtmpose, pose_input=(288, 384)) -> "DWPoseDetector":
        """The nets on their own device (f32): each call moves the NHWC
        host batch there as NCHW and copies the raw outputs back."""
        dev = next(yolox.parameters()).device

        def to_nchw(x):
            x = torch.from_numpy(np.ascontiguousarray(x, np.float32))
            return x.to(dev).permute(0, 3, 1, 2)

        @torch.no_grad()
        def det_fn(img_nhwc):
            return _host(yolox(to_nchw(img_nhwc)))

        @torch.no_grad()
        def pose_fn(crops_nhwc):
            sx, sy = rtmpose(to_nchw(crops_nhwc))
            return _host(sx), _host(sy)

        return cls(det_fn, pose_fn, pose_input)

    @classmethod
    def from_onnx(
        cls, yolox_path: str, rtmpose_path: str, pose_input=(288, 384), device=None
    ) -> "DWPoseDetector":
        """Run the reference's exact .onnx graphs (yolox_l.onnx +
        dw-ll_ucoco_384.onnx, src/dwpose/wholebody.py:14-27) through the
        port's ONNX executor on `device`: no weight-name conversion
        involved, so this is also the oracle for the nets once the files
        are present. The graphs are NCHW; inputs are adapted from this
        module's channel-last convention."""
        det = OnnxRunner.from_file(yolox_path, device)
        pose = OnnxRunner.from_file(rtmpose_path, device)

        def det_fn(img_nhwc):
            (out,) = det(np.transpose(np.asarray(img_nhwc), (0, 3, 1, 2))).values()
            return _host(out)

        def pose_fn(crops_nhwc):
            outs = list(pose(np.transpose(np.asarray(crops_nhwc), (0, 3, 1, 2))).values())
            return _host(outs[0]), _host(outs[1])

        return cls(det_fn, pose_fn, pose_input)

    def __call__(self, img: np.ndarray) -> np.ndarray:
        """img: (H, W, 3) uint8 RGB -> (134, 3) x,y abs coords + score."""
        padded, ratio = yolox_preprocess(img)
        raw = np.asarray(self.det_fn(padded[None]))
        boxes = detect_person_boxes(raw, ratio)
        if len(boxes) == 0:
            # full-image fallback box (onnxpose.py:27-28 uses [0,0,W,H])
            boxes = np.array(
                [[0, 0, img.shape[1], img.shape[0]]], np.float32
            )
        crops, centers, scales = [], [], []
        for b in boxes:
            center, scale = bbox_xyxy2cs(b)
            crop, scale = crop_affine(img, center, scale, self.pose_input)
            crops.append((crop - POSE_MEAN) / POSE_STD)
            centers.append(center)
            scales.append(scale)
        sx, sy = self.pose_fn(np.stack(crops))
        kpts, scores = simcc_decode(np.asarray(sx), np.asarray(sy))
        for i in range(len(kpts)):
            kpts[i] = keypoints_to_image(
                kpts[i], self.pose_input, scales[i], centers[i]
            )
        info = to_openpose_134(kpts, scores)
        # best person by mean body score (dwpose/__init__.py:228-233)
        best = info[:, :18, 2].mean(-1).argmax()
        return info[best].astype(np.float32)
