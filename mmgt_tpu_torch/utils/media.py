"""Host-side media I/O (a copy of `mmgt_tpu/utils/media.py`): video
read/write, frame helpers, seeding. cv2 and PyAV stay optional imports.

Replaces the reference's PyAV/decord/ffmpeg stack
(src/utils/util.py:76-192: read_frames, get_fps, save_videos_from_pil,
tensor_to_video, resample_audio) with cv2 (the only codec-capable library
in this image). Audio muxing into mp4 is unavailable without ffmpeg; the
wav is written alongside the video instead.
"""
from __future__ import annotations

import random
from pathlib import Path
from typing import Optional

import numpy as np

try:
    import cv2
except ImportError:  # pragma: no cover
    cv2 = None


def seed_everything(seed: int) -> None:
    """Seed Python, numpy and torch (the port's draws take explicit
    `torch.Generator`s; this covers everything else)."""
    import torch

    random.seed(seed)
    np.random.seed(seed % (2**32))
    torch.manual_seed(seed)


def read_frames(path: str, max_frames: Optional[int] = None) -> np.ndarray:
    """mp4 -> (T, H, W, 3) uint8 RGB."""
    cap = cv2.VideoCapture(str(path))
    if not cap.isOpened():
        raise FileNotFoundError(path)
    frames = []
    while True:
        ok, frame = cap.read()
        if not ok:
            break
        frames.append(cv2.cvtColor(frame, cv2.COLOR_BGR2RGB))
        if max_frames is not None and len(frames) >= max_frames:
            break
    cap.release()
    if not frames:
        raise ValueError(f"no frames decoded from {path}")
    return np.stack(frames)


def get_fps(path: str) -> float:
    cap = cv2.VideoCapture(str(path))
    fps = cap.get(cv2.CAP_PROP_FPS)
    cap.release()
    return float(fps)


def save_video(
    frames: np.ndarray, path: str, fps: float = 25.0, audio_wav: Optional[str] = None
) -> str:
    """(T, H, W, 3) float [0,1] or uint8 RGB -> mp4. If audio_wav is given
    it is copied next to the video (no ffmpeg muxer in this image)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if frames.dtype != np.uint8:
        frames = (np.clip(frames, 0, 1) * 255).astype(np.uint8)
    t, h, w = frames.shape[:3]
    writer = cv2.VideoWriter(
        str(path), cv2.VideoWriter_fourcc(*"mp4v"), fps, (w, h)
    )
    if not writer.isOpened():
        raise RuntimeError(f"cannot open video writer for {path}")
    for f in frames:
        writer.write(cv2.cvtColor(f, cv2.COLOR_RGB2BGR))
    writer.release()
    if audio_wav is not None:
        mux_audio(path, audio_wav)
    return path


def mux_audio(video_path: str, audio_wav: str) -> str:
    """Mux a wav track into an mp4 (reference tensor_to_video,
    src/utils/util.py:119-146). Runtime-optional backends, tried in order:
    PyAV, the ffmpeg binary, and finally copying the wav alongside the
    video (this image ships neither PyAV nor ffmpeg)."""
    out = str(video_path)
    try:
        import av  # noqa: F401

        tmp = str(Path(out).with_suffix(".mux.mp4"))
        with av.open(out) as vin, av.open(audio_wav) as ain, av.open(
            tmp, "w"
        ) as o:
            vs = o.add_stream_from_template(vin.streams.video[0])
            audio_in = ain.streams.audio[0]
            aus = o.add_stream("aac", rate=audio_in.rate)
            for packet in vin.demux(vin.streams.video[0]):
                if packet.dts is not None:
                    packet.stream = vs
                    o.mux(packet)
            for frame in ain.decode(audio_in):
                for packet in aus.encode(frame):
                    o.mux(packet)
            for packet in aus.encode():
                o.mux(packet)
        Path(tmp).replace(out)
        return out
    except ImportError:
        pass
    except Exception as e:  # pragma: no cover - av present but failed
        print(f"[media] PyAV mux failed ({e}); trying ffmpeg")
    import shutil
    import subprocess

    ffmpeg = shutil.which("ffmpeg")
    if ffmpeg is not None:
        tmp = str(Path(out).with_suffix(".mux.mp4"))
        r = subprocess.run(
            [ffmpeg, "-y", "-loglevel", "error", "-i", out, "-i", audio_wav,
             "-c:v", "copy", "-c:a", "aac", "-shortest", tmp],
            capture_output=True,
        )
        if r.returncode == 0:
            Path(tmp).replace(out)
            return out
    # last resort: ship the audio alongside the video
    shutil.copy(audio_wav, str(Path(out).with_suffix(".wav")))
    return out


def load_image(path: str, size: Optional[int] = None) -> np.ndarray:
    """(H, W, 3) float32 RGB in [0, 1]."""
    img = cv2.imread(str(path))
    if img is None:
        raise FileNotFoundError(path)
    img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
    if size is not None:
        img = cv2.resize(img, (size, size), interpolation=cv2.INTER_AREA)
    return img.astype(np.float32) / 255.0
