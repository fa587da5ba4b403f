"""Audio feature pipeline (`mmgt_tpu/data/audio.py`): wav -> model-ready
conditioning tensors.

Host side (numpy/scipy, copied): loading, slicing, normalisation, padding,
the align-corners interpolation and the Stage-1 condition. Device side:
the Wav2Vec2 (Stage 2) and WavLM (Stage 1) encoders run on their modules'
device, under no_grad.
"""
from __future__ import annotations

import math
from typing import Callable, List, Optional, Tuple

import numpy as np
import torch

from mmgt_tpu_torch.data.dsp import FPS, baseline_features, load_wav

SAMPLE_RATE = 16000


def slice_audio(wav: np.ndarray, sr: int = SAMPLE_RATE,
                window_s: float = 3.2, stride_s: float = 3.2) -> List[np.ndarray]:
    """Fixed windows; the final partial window is zero-padded."""
    win = int(window_s * sr)
    stride = int(stride_s * sr)
    out = []
    for start in range(0, max(len(wav), 1), stride):
        chunk = wav[start : start + win]
        if len(chunk) == 0:
            break
        if len(chunk) < win:
            chunk = np.pad(chunk, (0, win - len(chunk)))
        out.append(chunk.astype(np.float32))
        if start + win >= len(wav):
            break
    return out


def wav2vec_normalize(wav: np.ndarray) -> np.ndarray:
    """HF Wav2Vec2FeatureExtractor zero-mean unit-variance normalization."""
    return ((wav - wav.mean()) / np.sqrt(wav.var() + 1e-7)).astype(np.float32)


def pad_to_clip_multiple(
    wav: np.ndarray, seq_len: int, clip_length: int, sr: int = SAMPLE_RATE
) -> Tuple[np.ndarray, int]:
    """Pad so the frame count is a clip_length multiple
    (audio_processor.py:113-118)."""
    if clip_length > 0 and seq_len % clip_length != 0:
        extra = clip_length - seq_len % clip_length
        wav = np.pad(wav, (0, extra * (sr // FPS)))
        seq_len += extra
    return wav, seq_len


def stack_audio_window(audio_emb: torch.Tensor, margin: int = 2) -> torch.Tensor:
    """(T, 12, 768) -> (T, 2*margin+1, 12, 768): per-frame +-margin window
    with edge clamping (process_audio_emb, audio2vid.py:111-130)."""
    t = audio_emb.shape[0]
    idx = (torch.arange(t, device=audio_emb.device)[:, None]
           + torch.arange(-margin, margin + 1, device=audio_emb.device)[None, :])
    return audio_emb[idx.clamp(0, t - 1)]


def _module_device(model) -> torch.device:
    return next(model.parameters()).device


class AudioProcessor:
    """Stage-2 audio conditioning: wav file -> (1, T, 5, 12, 768) embeds,
    on the encoder's device."""

    def __init__(self, wav2vec_model, fps: int = FPS,
                 vocal_separator: Optional[Callable[[np.ndarray], np.ndarray]] = None):
        self.model = wav2vec_model
        self.fps = fps
        self.vocal_separator = vocal_separator

    @torch.no_grad()
    def preprocess(self, wav_path: str, clip_length: int = -1) -> Tuple[torch.Tensor, int]:
        wav = load_wav(wav_path, SAMPLE_RATE)
        if self.vocal_separator is not None:
            wav = self.vocal_separator(wav)
        wav = wav2vec_normalize(wav)
        seq_len = math.ceil(len(wav) / SAMPLE_RATE * self.fps)
        audio_length = seq_len
        wav, seq_len = pad_to_clip_multiple(wav, seq_len, clip_length)
        x = torch.from_numpy(wav)[None].to(_module_device(self.model))
        emb = self.model(x, seq_len)[0]
        return stack_audio_window(emb)[None], audio_length


def interpolate_align_corners(x: np.ndarray, out_len: int) -> np.ndarray:
    """(T, C) -> (out_len, C), linear, align_corners=True
    (wavlm_features.py:141-143)."""
    t = x.shape[0]
    if t == 1:
        return np.repeat(x, out_len, axis=0)
    pos = np.arange(out_len) * (t - 1) / (out_len - 1)
    lo = np.floor(pos).astype(int)
    hi = np.minimum(lo + 1, t - 1)
    w = (pos - lo)[:, None]
    return (1 - w) * x[lo] + w * x[hi]


class WavLMFeatureExtractor:
    """Stage-1 audio features: wav slice -> (T=80, 1024) WavLM features."""

    def __init__(self, wavlm_model):
        self.model = wavlm_model

    @torch.no_grad()
    def extract(self, wav: np.ndarray) -> np.ndarray:
        """wav: 16 kHz mono slice. Layer-norm the waveform (cfg.normalize),
        encode at ~50 fps, append last frame, 2x downsample to 25 fps."""
        w = ((wav - wav.mean()) / np.sqrt(wav.var() + 1e-5)).astype(np.float32)
        x = torch.from_numpy(w)[None].to(_module_device(self.model))
        feats = self.model(x)[0].float().cpu().numpy()
        feats = np.concatenate([feats, feats[-1:]], axis=0)
        return interpolate_align_corners(
            feats, math.ceil(feats.shape[0] / 2)
        ).astype(np.float32)


def stage1_condition(
    wav: np.ndarray,
    wavlm_extractor: Optional[WavLMFeatureExtractor],
    feature_type: str = "wavlm",
) -> np.ndarray:
    """(T=80, 1059) wavlm+baseline, or (T, 35) baseline-only features.

    With feature_type="wavlm" but no extractor (weights unavailable), the
    WavLM block is zero-padded so the conditioning width still matches a
    wavlm-configured SMGA model."""
    base = baseline_features(wav)
    if feature_type == "baseline":
        return base
    if wavlm_extractor is None:
        wl = np.zeros((len(base), 1024), np.float32)
    else:
        wl = wavlm_extractor.extract(wav)
    t = min(len(wl), len(base))
    return np.concatenate([wl[:t], base[:t]], axis=-1)
