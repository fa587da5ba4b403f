"""Stage-2 conditioning (`mmgt_tpu/data/conditioning.py`): keypoints ->
pose video + mask pyramids, on the keypoints' device; or, for pose2vid,
mask videos -> mask pyramids (`masks_from_videos`).

Mask semantics follow scripts/pose2vid.py:265-271 (full = clamp(1 - face
+ lips + hands, 0, 1)), as the JAX package does.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch

from mmgt_tpu_torch.data.rasterize import rasterize_clip
from mmgt_tpu_torch.ops.image import gaussian_blur, mask_pyramid, normalize_minmax, resize_bilinear

KP_MIN, KP_MAX = -200.0, 800.0  # global keypoint range (extract_movment_mask_all.py:121-132)
LEG_KPTS = tuple(range(9, 11)) + tuple(range(12, 14))


def normalize_keypoints(kp):
    """absolute pixel coords -> [-1, 1] (tensor or array)."""
    return (kp - KP_MIN) / (KP_MAX - KP_MIN) * 2.0 - 1.0


def denormalize_keypoints(kp):
    return (kp + 1.0) / 2.0 * (KP_MAX - KP_MIN) + KP_MIN


def mask_leg(kp402: torch.Tensor) -> torch.Tensor:
    """Zero the leg keypoints of (..., 402) (always masked,
    extract_movment_mask_all.py:67-95)."""
    kp = kp402.reshape(*kp402.shape[:-1], 134, 3)
    keep = torch.ones(134, dtype=kp.dtype, device=kp.device)
    keep[list(LEG_KPTS)] = 0.0
    return (kp * keep[:, None]).reshape(kp402.shape)


def _blur_norm(mask: torch.Tensor, ksize: int, base: int = 64) -> torch.Tensor:
    """{0,1} mask -> blurred, per-frame min-max-normalised (base, base)
    attention mask (blur_mask, scripts/audio2vid.py:133-153)."""
    if base < ksize:
        ksize = base if base % 2 == 1 else base - 1
    m = gaussian_blur(resize_bilinear(mask, (base, base)), ksize)
    return normalize_minmax(m, axis=(-2, -1))


def prepare_conditioning_from_keypoints(keypoints_abs: torch.Tensor, height: int = 512,
                                        width: int = 512, levels: int = 3) -> Dict:
    """(T, 402) absolute pixel coords -> {pose_video (1, T, H, W, 3), masks:
    levels x (full, face, lip) each (1, T, L_level), mask_videos}; `masks`
    and `pose_video` feed `Pose2VideoPipeline.__call__` unchanged."""
    kp = keypoints_abs.float().reshape(-1, 134, 3)
    scale = torch.tensor([width, height], dtype=torch.float32, device=kp.device)
    kp_norm = torch.cat([kp[..., :2] / scale, kp[..., 2:]], -1)
    ras = rasterize_clip(kp_norm, height, width)

    base = height // 8
    face64 = _blur_norm(ras["face_mask"], 31, base)
    lips64 = _blur_norm(ras["lips_mask"], 21, base)
    hands64 = _blur_norm(ras["hands_mask"], 21, base)
    full64 = torch.clamp(1.0 - face64 + lips64 + hands64, 0.0, 1.0)

    full_p, face_p, lips_p = (mask_pyramid(m, levels) for m in (full64, face64, lips64))
    masks = [(full_p[lv][None], face_p[lv][None], lips_p[lv][None]) for lv in range(levels)]
    return {
        "pose_video": ras["pose"][None],
        "masks": masks,
        "mask_videos": {"face": ras["face_mask"], "lips": ras["lips_mask"],
                        "hands": ras["hands_mask"]},
    }


def masks_from_videos(face: torch.Tensor, lips: torch.Tensor,
                      hands: Optional[torch.Tensor] = None, levels: int = 3,
                      base: int = 64) -> list:
    """pose2vid's user-given mask videos, each (T, H, W) in [0, 1] ->
    levels x (full, face, lip) pyramid conditioning, each (1, T, L_level)
    (`mmgt_tpu/data/conditioning.py:masks_from_videos`)."""
    face64 = _blur_norm(face, 31, base)
    lips64 = _blur_norm(lips, 21, base)
    hands64 = _blur_norm(hands, 21, base) if hands is not None else torch.zeros_like(face64)
    full64 = torch.clamp(1.0 - face64 + lips64 + hands64, 0.0, 1.0)
    full_p, face_p, lips_p = (mask_pyramid(m, levels) for m in (full64, face64, lips64))
    return [(full_p[lv][None], face_p[lv][None], lips_p[lv][None]) for lv in range(levels)]
