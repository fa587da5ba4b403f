"""Training datasets / input pipelines: a copy of `mmgt_tpu/data/datasets.py`
(numpy only), with `VIS_THRESH` from this package's `data/rasterize.py`.

Replaces the reference's torch Dataset + decord stack (SURVEY §2.4):
  * GestureDataset (Stage 1): aligned keypoint/audio-feature npy pairs
    (src/dataset/gesture_dataset.py:13-138; cache semantics of
    SMGA.py:140-184 are unnecessary — npy mmap loading is already fast)
  * TalkingVideoDataset (Stage 2): packed per-clip .npz records produced
    by tools/prepare_stage2.py (video/pose/mask frames + audio embeds),
    random 12-frame windows with audio margin, random reference frame,
    blurred mask pyramids (src/dataset/talk_video.py:124-477)

All yield numpy batches; the training CLIs move them to the card.
"""
from __future__ import annotations

import json
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np

from mmgt_tpu_torch.data.rasterize import VIS_THRESH  # noqa: F401  (re-export)


def _epoch_order(rng: np.random.Generator, n: int, batch_size: int) -> np.ndarray:
    """Shuffled index order, oversampled (with reshuffles) when the dataset
    is smaller than one batch — a 1-record dataset must still yield batches
    (previously `range(0, n - batch_size + 1)` was empty and the epoch loop
    spun forever)."""
    parts = [rng.permutation(n)]
    while sum(len(p) for p in parts) < batch_size:
        parts.append(rng.permutation(n))
    return np.concatenate(parts) if len(parts) > 1 else parts[0]


class GestureDataset:
    """Stage-1 items: (keypoints (T,402), cond_frame (402,), features (T,Dc))."""

    def __init__(self, data_dir: str, feature_type: str = "wavlm",
                 horizon: int = 80):
        root = Path(data_dir)
        feat_dir = "wavlm_feats" if feature_type == "wavlm" else "baseline_feats"
        self.items: List[Dict[str, Path]] = []
        for kp_path in sorted((root / "keypoints").glob("*.npy")):
            fp = root / feat_dir / kp_path.name
            if fp.exists():
                self.items.append({"kps": kp_path, "feat": fp})
        if not self.items:
            raise FileNotFoundError(f"no aligned items under {data_dir}")
        self.horizon = horizon

    def __len__(self):
        return len(self.items)

    def __getitem__(self, i: int) -> Dict[str, np.ndarray]:
        kps = np.load(self.items[i]["kps"]).astype(np.float32)[: self.horizon]
        feat = np.load(self.items[i]["feat"]).astype(np.float32)[: self.horizon]
        t = min(len(kps), len(feat), self.horizon)
        assert t == self.horizon, (
            f"clip shorter than horizon: {self.items[i]['kps']}"
        )
        return {
            "keypoints": kps[:t],
            "cond_frame": kps[0],
            "audio_features": feat[:t],
        }

    def batches(self, batch_size: int, seed: int = 0,
                drop_last: bool = True) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        while True:
            order = _epoch_order(rng, len(self.items), batch_size)
            for s in range(0, len(order) - batch_size + 1, batch_size):
                idx = order[s : s + batch_size]
                items = [self[int(i)] for i in idx]
                yield {
                    k: np.stack([it[k] for it in items]) for k in items[0]
                }


def _triangle_weights(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) antialiased-bilinear (triangle-filter) resize weights —
    the same kernel jax.image.resize("bilinear") and PIL BILINEAR use for
    downscales (filter support scaled by the ratio)."""
    scale = n_in / n_out
    support = max(scale, 1.0)
    centers = (np.arange(n_out) + 0.5) * scale - 0.5
    x = (np.arange(n_in)[None, :] - centers[:, None]) / support
    w = np.clip(1.0 - np.abs(x), 0.0, None)
    return w / w.sum(axis=1, keepdims=True)


def _resize_area_bilinear(m: np.ndarray, out_hw: int) -> np.ndarray:
    """(T, H, W) -> (T, out_hw, out_hw), antialiased bilinear."""
    wh = _triangle_weights(m.shape[1], out_hw)
    ww = _triangle_weights(m.shape[2], out_hw)
    return np.einsum("oh,thw,pw->top", wh, m, ww, optimize=True)


def _crop_resize(img: np.ndarray, box, out_h: int, out_w: int) -> np.ndarray:
    """(..., H, W, C) crop to box=(top, left, h, w) then antialiased-bilinear
    resize to (out_h, out_w) — the numpy equivalent of torchvision's
    RandomResizedCrop apply step."""
    t, l, h, w = box
    crop = img[..., t : t + h, l : l + w, :]
    wh = _triangle_weights(h, out_h)
    ww = _triangle_weights(w, out_w)
    return np.einsum("oh,...hwc,pw->...opc", wh, crop, ww, optimize=True)


def _sample_crop_box(rng: np.random.Generator, h: int, w: int,
                     scale=(1.0, 1.0), ratio=(0.9, 1.0)):
    """torchvision RandomResizedCrop box sampling (area scale + log-uniform
    aspect ratio, 10 tries then center fallback)."""
    area = h * w
    for _ in range(10):
        target = area * rng.uniform(*scale)
        ar = float(np.exp(rng.uniform(np.log(ratio[0]), np.log(ratio[1]))))
        cw = int(round(np.sqrt(target * ar)))
        ch = int(round(np.sqrt(target / ar)))
        if 0 < cw <= w and 0 < ch <= h:
            top = int(rng.integers(0, h - ch + 1))
            left = int(rng.integers(0, w - cw + 1))
            return top, left, ch, cw
    side = min(h, w)
    return (h - side) // 2, (w - side) // 2, side, side


class TalkingVideoDataset:
    """Stage-2 items from packed .npz clip records.

    Record fields (see tools/prepare_stage2.py):
      frames      (T, H, W, 3) uint8     target video
      pose        (T, H, W, 3) uint8     pose skeleton video
      face_mask   (T, h8, h8) uint8      pre-blurred 0-255 attention masks
      lips_mask   (T, h8, h8) uint8
      hands_mask  (T, h8, h8) uint8      (optional; zeros if absent)
      audio_emb   (T, 12, 768) float16   wav2vec per-frame embeddings
    """

    def __init__(self, meta_paths: Sequence[str], n_sample_frames: int = 12,
                 audio_margin: int = 2, levels: int = 3,
                 pyramid_mode: str = "resize", with_audio: bool = True,
                 explicit_full_mask: bool = False):
        self.records: List[Path] = []
        for mp in meta_paths:
            meta = json.loads(Path(mp).read_text())
            for entry in meta:
                p = Path(entry["record"] if isinstance(entry, dict) else entry)
                if p.exists():
                    self.records.append(p)
        if not self.records:
            raise FileNotFoundError(f"no records from {meta_paths}")
        self.n_frames = n_sample_frames
        self.margin = audio_margin
        self.levels = levels
        if pyramid_mode not in ("resize", "meanpool"):
            raise ValueError(pyramid_mode)
        self.pyramid_mode = pyramid_mode
        # with_audio=False reproduces TalkingVideoDataset_move_mask_no_audio
        # (reference talk_video.py:931-1264: same windows/masks, zero audio);
        # explicit_full_mask=True reproduces the _pats variant's contract
        # (talk_video.py:482-930: the full/background mask is a stored
        # segmentation channel, not derived 1-face+lips+hands)
        self.with_audio = with_audio
        self.explicit_full_mask = explicit_full_mask

    def __len__(self):
        return len(self.records)

    def _pyramid(self, m01: np.ndarray) -> List[np.ndarray]:
        """(T, h8, h8) float -> levels x (T, tokens).

        Default "resize": antialiased-bilinear downscales of the blurred
        base mask — matching both the reference's attn_transform_{64..8}
        stack (PIL Resize applies the antialiased triangle filter on
        downscale, image_processor.py:57-104) and this framework's
        on-device inference pyramid (ops/image.mask_pyramid via
        jax.image.resize). "meanpool" keeps the r1 box-average behavior.
        """
        out = []
        t, h = m01.shape[0], m01.shape[1]
        for l in range(self.levels):
            if l == 0:
                ml = m01
            elif self.pyramid_mode == "resize":
                ml = _resize_area_bilinear(m01, h >> l)
            else:
                k = 1 << l
                ml = m01.reshape(t, h // k, k, h // k, k).mean((2, 4))
            out.append(ml.reshape(t, -1).astype(np.float32))
        return out

    def sample(self, i: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        with np.load(self.records[i]) as z:
            total = z["frames"].shape[0]
            f = self.n_frames
            lo = self.margin
            hi = total - f - self.margin
            if hi <= lo:
                raise ValueError(f"clip too short: {self.records[i]}")
            start = int(rng.integers(lo, hi))
            sl = slice(start, start + f)
            frames = z["frames"][sl].astype(np.float32) / 255.0
            pose = z["pose"][sl].astype(np.float32) / 255.0
            face = z["face_mask"][sl].astype(np.float32) / 255.0
            lips = z["lips_mask"][sl].astype(np.float32) / 255.0
            if "hands_mask" in z:
                hands = z["hands_mask"][sl].astype(np.float32) / 255.0
            else:
                hands = np.zeros_like(face)
            # ±margin audio window gather (talk_video.py:385-393)
            idx = np.clip(
                np.arange(start, start + f)[:, None]
                + np.arange(-self.margin, self.margin + 1)[None, :],
                0,
                total - 1,
            )
            if self.with_audio:
                audio = z["audio_emb"][idx].astype(np.float32)  # (f, 5, 12, 768)
            else:
                d = z["audio_emb"].shape[-1] if "audio_emb" in z else 768
                audio = np.zeros((f, 2 * self.margin + 1, 12, d), np.float32)
            # random reference frame outside the window (talk_video.py:395-401)
            ref_choices = [j for j in range(total) if j < start or j >= start + f]
            ref_idx = int(rng.choice(ref_choices)) if ref_choices else 0
            ref = z["frames"][ref_idx].astype(np.float32) / 255.0
            if self.explicit_full_mask:
                if "full_mask" not in z:
                    raise ValueError(
                        f"explicit_full_mask needs a 'full_mask' field: "
                        f"{self.records[i]}"
                    )
                full = z["full_mask"][sl].astype(np.float32) / 255.0

        if not self.explicit_full_mask:
            full = np.clip(1.0 - face + lips + hands, 0.0, 1.0)
        masks = [
            (fp, fa, li)
            for fp, fa, li in zip(
                self._pyramid(full), self._pyramid(face), self._pyramid(lips)
            )
        ]
        return {
            "pixel_values": frames * 2.0 - 1.0,
            "ref_image": ref * 2.0 - 1.0,
            "clip_image": ref,  # encoded by CLIP in the trainer loop
            "audio_embeds": audio,
            "pose_video": pose,
            "masks": masks,
        }

    def batches(self, batch_size: int, seed: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        while True:
            idx = _epoch_order(rng, len(self.records), batch_size)
            for s in range(0, len(idx) - batch_size + 1, batch_size):
                items = []
                for i in idx[s : s + batch_size]:
                    try:
                        items.append(self.sample(int(i), rng))
                    except ValueError:
                        continue  # resample-on-bad-clip (talk_video.py:471-477)
                if len(items) < batch_size:
                    continue
                batch = {}
                for k in ("pixel_values", "ref_image", "clip_image",
                          "audio_embeds", "pose_video"):
                    batch[k] = np.stack([it[k] for it in items])
                batch["masks"] = [
                    tuple(
                        np.stack([it["masks"][l][j] for it in items])
                        for j in range(3)
                    )
                    for l in range(self.levels)
                ]
                yield batch


class HumanDanceDataset:
    """Stage-2 process-1 items: (ref frame, target frame, target pose) pairs
    with a minimum frame separation (reference src/dataset/dance_image.py:
    12-124, sample_margin from config/train/stage1.yaml:8).

    Reads the same packed .npz/.mmr records as TalkingVideoDataset.
    """

    def __init__(self, meta_paths: Sequence[str], sample_margin: int = 30):
        self.records: List[Path] = []
        for mp in meta_paths:
            meta = json.loads(Path(mp).read_text())
            for entry in meta:
                p = Path(entry["record"] if isinstance(entry, dict) else entry)
                if p.exists():
                    self.records.append(p)
        if not self.records:
            raise FileNotFoundError(f"no records from {meta_paths}")
        self.margin = sample_margin

    def __len__(self):
        return len(self.records)

    def sample(self, i: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        with np.load(self.records[i]) as z:
            total = z["frames"].shape[0]
            tgt = int(rng.integers(0, total))
            # ref at least `margin` frames away when possible (dance_image.py:60-76)
            lo, hi = tgt - self.margin, tgt + self.margin
            choices = [j for j in range(total) if j <= lo or j >= hi]
            ref = int(rng.choice(choices)) if choices else int(rng.integers(0, total))
            frames = z["frames"]
            pose = z["pose"]
            return {
                "tgt_image": frames[tgt].astype(np.float32) / 127.5 - 1.0,
                "ref_image": frames[ref].astype(np.float32) / 127.5 - 1.0,
                "tgt_pose": pose[tgt].astype(np.float32) / 255.0,
                "clip_image": frames[ref].astype(np.float32) / 255.0,
            }

    def batches(self, batch_size: int, seed: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        while True:
            idx = _epoch_order(rng, len(self.records), batch_size)
            for s in range(0, len(idx) - batch_size + 1, batch_size):
                items = [self.sample(int(i), rng) for i in idx[s : s + batch_size]]
                yield {k: np.stack([it[k] for it in items]) for k in items[0]}


class HumanDanceVideoDataset:
    """Stage-2 process-2 pretraining items WITHOUT audio/masks (reference
    src/dataset/dance_video.py:15-141): temporally strided n-frame windows
    (`sample_rate`), a random reference frame from anywhere in the clip,
    and ONE shared random-resized-crop applied identically to the target
    and pose streams (the reference replays the torch RNG state across the
    two transforms; here one sampled crop box is reused).

    Reads the same packed .npz records as TalkingVideoDataset.
    """

    def __init__(self, meta_paths: Sequence[str], n_sample_frames: int = 24,
                 sample_rate: int = 4, width: int = 512, height: int = 512,
                 img_scale=(1.0, 1.0), img_ratio=(0.9, 1.0)):
        self.records: List[Path] = []
        for mp in meta_paths:
            meta = json.loads(Path(mp).read_text())
            for entry in meta:
                p = Path(entry["record"] if isinstance(entry, dict) else entry)
                if p.exists():
                    self.records.append(p)
        if not self.records:
            raise FileNotFoundError(f"no records from {meta_paths}")
        self.n_frames = n_sample_frames
        self.rate = sample_rate
        self.out_hw = (height, width)
        self.img_scale = tuple(img_scale)
        self.img_ratio = tuple(img_ratio)

    def __len__(self):
        return len(self.records)

    def sample(self, i: int, rng: np.random.Generator) -> Dict[str, np.ndarray]:
        with np.load(self.records[i]) as z:
            total = z["frames"].shape[0]
            # strided window: linspace over min(total, (f-1)*rate+1) frames
            # (dance_video.py:93-99)
            clip_len = min(total, (self.n_frames - 1) * self.rate + 1)
            start = int(rng.integers(0, total - clip_len + 1))
            idx = np.linspace(start, start + clip_len - 1, self.n_frames)
            idx = idx.astype(np.int64)
            frames = z["frames"][idx].astype(np.float32) / 255.0
            pose = z["pose"][idx].astype(np.float32) / 255.0
            ref_idx = int(rng.integers(0, total))  # anywhere (line 110)
            ref = z["frames"][ref_idx].astype(np.float32) / 255.0

        h, w = frames.shape[1], frames.shape[2]
        box = _sample_crop_box(rng, h, w, self.img_scale, self.img_ratio)
        oh, ow = self.out_hw
        frames = _crop_resize(frames, box, oh, ow)
        pose = _crop_resize(pose, box, oh, ow)
        ref_c = _crop_resize(ref[None], box, oh, ow)[0]
        return {
            "pixel_values": frames * 2.0 - 1.0,
            "pose_video": np.clip(pose, 0.0, 1.0),
            "ref_image": ref_c * 2.0 - 1.0,
            "clip_image": ref,  # CLIP sees the un-cropped reference (line 122)
        }

    def batches(self, batch_size: int, seed: int = 0
                ) -> Iterator[Dict[str, np.ndarray]]:
        rng = np.random.default_rng(seed)
        while True:
            idx = _epoch_order(rng, len(self.records), batch_size)
            for s in range(0, len(idx) - batch_size + 1, batch_size):
                items = [self.sample(int(i), rng) for i in idx[s : s + batch_size]]
                yield {k: np.stack([it[k] for it in items]) for k in items[0]}
