"""Portrait -> initial 402-d keypoint vector (`mmgt_tpu/data/pose_init.py`).

A deterministic default upper-body skeleton (a centred speaker pose), so
the pipeline runs without detector weights; a DWPose detector
(`data/dwpose_infer.DWPoseDetector`) may be passed in.
"""
from __future__ import annotations

import numpy as np
import torch

from mmgt_tpu_torch.data.conditioning import mask_leg


def default_skeleton(height: int = 512, width: int = 512) -> np.ndarray:
    """Plausible frontal upper-body speaker pose, absolute coords, (402,)."""
    kp = np.zeros((134, 3), np.float32)
    cx, top = 0.5, 0.18
    body = {
        0: (cx, top + 0.08),          # nose
        1: (cx, top + 0.22),          # neck
        2: (cx - 0.12, top + 0.22),   # r shoulder
        3: (cx - 0.16, top + 0.38),   # r elbow
        4: (cx - 0.18, top + 0.52),   # r wrist
        5: (cx + 0.12, top + 0.22),   # l shoulder
        6: (cx + 0.16, top + 0.38),   # l elbow
        7: (cx + 0.18, top + 0.52),   # l wrist
        8: (cx - 0.08, top + 0.55),   # r hip
        11: (cx + 0.08, top + 0.55),  # l hip
        14: (cx - 0.03, top + 0.06),  # r eye
        15: (cx + 0.03, top + 0.06),  # l eye
        16: (cx - 0.06, top + 0.08),  # r ear
        17: (cx + 0.06, top + 0.08),  # l ear
    }
    for idx, (x, y) in body.items():
        kp[idx] = (x, y, 1.0)
    # face oval + features around the nose
    ang = np.linspace(-np.pi, np.pi, 68)
    kp[24:92, 0] = cx + 0.07 * np.cos(ang)
    kp[24:92, 1] = top + 0.08 + 0.09 * np.sin(ang) * 0.8
    kp[24:92, 2] = 1.0
    # lips cluster (72:92)
    kp[72:92, 0] = cx + 0.02 * np.cos(np.linspace(-np.pi, np.pi, 20))
    kp[72:92, 1] = top + 0.13 + 0.01 * np.sin(np.linspace(-np.pi, np.pi, 20))
    kp[72:92, 2] = 1.0
    # hands around the wrists
    for hand0, wrist in ((92, 4), (113, 7)):
        wx, wy = kp[wrist, :2]
        kp[hand0 : hand0 + 21, 0] = wx + np.linspace(-0.02, 0.04, 21)
        kp[hand0 : hand0 + 21, 1] = wy + np.linspace(0.0, 0.06, 21)
        kp[hand0 : hand0 + 21, 2] = 1.0
    kp[:, 0] *= width
    kp[:, 1] *= height
    return kp.reshape(-1)


def portrait_keypoints(image01: np.ndarray, height: int = 512, width: int = 512,
                       detector=None) -> np.ndarray:
    """(H, W, 3) image -> (402,) keypoints; uses the detector when provided
    (a `DWPoseDetector` takes the image as uint8 RGB and gives (134, 3),
    flattened here: the JAX package passes the (134, 3) on and raises),
    else the default skeleton. Legs are always masked
    (audio2vid.py:319-321)."""
    kp = (np.asarray(detector(image01)).reshape(-1) if detector is not None
          else default_skeleton(height, width))
    return mask_leg(torch.from_numpy(np.asarray(kp, np.float32))[None])[0].numpy()
