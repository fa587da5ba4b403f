"""Keypoint -> pose-skeleton / motion-mask rasterizer
(`mmgt_tpu/data/rasterize.py`), on the pipeline's device.

Every primitive is an analytic coverage test on the pixel grid, evaluated
for all frames of a clip at once: (T, H, W) per primitive. The 185
primitives are painted one after another over the (T, H, W, 3) canvas, in
the JAX loop's order (stacking them would take tens of GB at 80 frames of
512^2).

Keypoint layout (402 = 134 x (x, y, score), normalised to [0, 1]):
  body 0:18, feet 18:24, face 24:92 (lips 72:92, eyes 60:72),
  hands 92:113 + 113:134.
Outputs: the pose map (body ellipses, hand skeletons, face dots; the
canvas is dimmed by 0.9 after the limbs, hand edge colours are the
reference's BGR-reversed HSV spread), and the hands, lips and face masks
(bounding-box fills).
"""
from __future__ import annotations

import colorsys
from typing import Dict

import numpy as np
import torch

VIS_THRESH = 0.3

# openpose 18-kpt limb sequence (1-indexed pairs; first 17 drawn)
LIMB_SEQ = np.array(
    [
        [2, 3], [2, 6], [3, 4], [4, 5], [6, 7], [7, 8], [2, 9], [9, 10],
        [10, 11], [2, 12], [12, 13], [13, 14], [2, 1], [1, 15], [15, 17],
        [1, 16], [16, 18],
    ]
) - 1

BODY_COLORS = np.array(
    [
        [255, 0, 0], [255, 85, 0], [255, 170, 0], [255, 255, 0],
        [170, 255, 0], [85, 255, 0], [0, 255, 0], [0, 255, 85],
        [0, 255, 170], [0, 255, 255], [0, 170, 255], [0, 85, 255],
        [0, 0, 255], [85, 0, 255], [170, 0, 255], [255, 0, 255],
        [255, 0, 170], [255, 0, 85],
    ],
    np.float32,
) / 255.0

HAND_EDGES = np.array(
    [
        (0, 1), (1, 2), (2, 3), (3, 4), (0, 5), (5, 6), (6, 7), (7, 8),
        (0, 9), (9, 10), (10, 11), (11, 12), (0, 13), (13, 14), (14, 15),
        (15, 16), (0, 17), (17, 18), (18, 19), (19, 20),
    ]
)

# hsv-spread edge colours in BGR order: the reference draws BGR into a canvas
# later read as RGB (util.py:179-183)
HAND_COLORS = np.array(
    [colorsys.hsv_to_rgb(i / len(HAND_EDGES), 1.0, 1.0)[::-1] for i in range(len(HAND_EDGES))],
    np.float32,
)


def _col(p):
    """(T,) -> (T, 1, 1) for broadcasting over the pixel grid."""
    return p[:, None, None]


def _ellipse_mask(r, c, p0, p1, half_width, valid):
    """Coverage of the cv2.ellipse2Poly limb capsule: an ellipse centred at
    the midpoint, semi-major half the limb length, semi-minor half_width.
    p0, p1 (T, 2); valid (T,)."""
    m = (p0 + p1) / 2.0
    d = p1 - p0
    length = torch.sqrt(torch.sum(d**2, -1) + 1e-8)
    e = d / length[:, None]
    a = torch.clamp(length / 2.0, min=0.5)
    dx, dy = c - _col(m[:, 0]), r - _col(m[:, 1])
    u = dx * _col(e[:, 0]) + dy * _col(e[:, 1])
    v = -dx * _col(e[:, 1]) + dy * _col(e[:, 0])
    inside = (u / _col(a)) ** 2 + (v / half_width) ** 2 <= 1.0
    return inside & _col(valid)


def _segment_mask(r, c, p0, p1, radius, valid):
    d = p1 - p0
    len2 = torch.sum(d**2, -1) + 1e-8
    t = torch.clamp(((c - _col(p0[:, 0])) * _col(d[:, 0]) + (r - _col(p0[:, 1])) * _col(d[:, 1]))
                    / _col(len2), 0.0, 1.0)
    px = _col(p0[:, 0]) + t * _col(d[:, 0])
    py = _col(p0[:, 1]) + t * _col(d[:, 1])
    dist2 = (c - px) ** 2 + (r - py) ** 2
    return (dist2 <= radius**2) & _col(valid)


def _circle_mask(r, c, p, radius, valid):
    return (((c - _col(p[:, 0])) ** 2 + (r - _col(p[:, 1])) ** 2) <= radius**2) & _col(valid)


def _bbox_mask(r, c, pts, valid):
    """Axis-aligned bbox over the valid points of each frame; coordinates
    truncated before min/max and the box filled [min, max), as the
    reference's drawing (util.py:208-233,349-380). pts (T, n, 2)."""
    big = 1e9
    px, py = torch.floor(pts[..., 0]), torch.floor(pts[..., 1])
    min_x = torch.where(valid, px, torch.full_like(px, big)).amin(-1)
    min_y = torch.where(valid, py, torch.full_like(py, big)).amin(-1)
    max_x = torch.where(valid, px, torch.full_like(px, -big)).amax(-1)
    max_y = torch.where(valid, py, torch.full_like(py, -big)).amax(-1)
    ok = (min_x < max_x) & (min_y < max_y)
    inside = ((c >= _col(min_x)) & (c < _col(max_x)) & (r >= _col(min_y))
              & (r < _col(max_y)))
    return inside & _col(ok)


def rasterize_clip(keypoints: torch.Tensor, h: int = 512, w: int = 512
                   ) -> Dict[str, torch.Tensor]:
    """keypoints (T, 134, 3) normalised (x, y, score) -> pose (T, H, W, 3) in
    [0, 1] and hands/lips/face masks (T, H, W) in {0, 1}, on the keypoints'
    device, f32."""
    dev = keypoints.device
    kpts = keypoints.float()
    r = torch.arange(h, dtype=torch.float32, device=dev)[:, None]
    c = torch.arange(w, dtype=torch.float32, device=dev)[None, :]
    xy = kpts[..., :2] * torch.tensor([w, h], dtype=torch.float32, device=dev)
    vis = kpts[..., 2] >= VIS_THRESH
    body_rgb = torch.from_numpy(BODY_COLORS).to(dev)
    hand_rgb = torch.from_numpy(HAND_COLORS).to(dev)
    blue, white = body_rgb.new_tensor((0.0, 0.0, 1.0)), body_rgb.new_tensor((1.0, 1.0, 1.0))
    canvas = torch.zeros((kpts.shape[0], h, w, 3), dtype=torch.float32, device=dev)

    def paint(mask, rgb):
        return torch.where(mask[..., None], rgb, canvas)

    # half-width 4.5 ~ cv2.fillConvexPoly of ellipse2Poly(.., 4, ..), whose
    # fill is boundary-inclusive
    for i in range(17):
        a, b = LIMB_SEQ[i]
        canvas = paint(_ellipse_mask(r, c, xy[:, a], xy[:, b], 4.5, vis[:, a] & vis[:, b]),
                       body_rgb[i])
    canvas = canvas * 0.9
    for i in range(18):
        canvas = paint(_circle_mask(r, c, xy[:, i], 4.0, vis[:, i]), body_rgb[i])
    for hand0 in (92, 113):
        pts, hvis = xy[:, hand0:hand0 + 21], vis[:, hand0:hand0 + 21]
        for ei, (a, b) in enumerate(HAND_EDGES):
            # radius 1.5 ~ cv2.line thickness=2 (boundary-inclusive)
            canvas = paint(_segment_mask(r, c, pts[:, a], pts[:, b], 1.5, hvis[:, a] & hvis[:, b]),
                           hand_rgb[ei])
        for j in range(21):
            canvas = paint(_circle_mask(r, c, pts[:, j], 4.0, hvis[:, j]), blue)
    for j in range(24, 92):
        canvas = paint(_circle_mask(r, c, xy[:, j], 3.0, vis[:, j]), white)

    hands = (_bbox_mask(r, c, xy[:, 92:113], vis[:, 92:113])
             | _bbox_mask(r, c, xy[:, 113:134], vis[:, 113:134])).float()
    lips = _bbox_mask(r, c, xy[:, 72:92], vis[:, 72:92]).float()
    face = torch.clamp(_bbox_mask(r, c, xy[:, 24:92], vis[:, 24:92]).float() + hands, 0.0, 1.0)
    return {"pose": canvas, "hands_mask": hands, "lips_mask": lips, "face_mask": face}


def rasterize_frame(kpts: torch.Tensor, h: int = 512, w: int = 512) -> Dict[str, torch.Tensor]:
    """kpts (134, 3) -> pose (H, W, 3) and the three masks (H, W)."""
    return {k: v[0] for k, v in rasterize_clip(kpts[None], h, w).items()}
