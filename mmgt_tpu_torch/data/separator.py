"""MDX-Net vocal separator (`mmgt_tpu/data/separator.py`): plugs a
UVR/audio-separator .onnx model (e.g. Kim_Vocal_2.onnx, which the
reference loads through the `audio-separator` package,
src/dataset/audio_processor.py:56-70) into the port's
`AudioProcessor(vocal_separator=...)` hook, executed by the port's own
ONNX runner (`utils/onnx_exec.py`) on the card instead of onnxruntime.

Processing follows the published MDX inference scheme: hann STFT
(center), keep the first `dim_f` frequency bins, stack stereo re/im as 4
channels, run the net on fixed (1, 4, dim_f, 2^dim_t) chunks with
n_fft//2 edge trimming, inverse-STFT the predicted spectrogram, and apply
the model's volume compensation. Kim_Vocal_2 constants: n_fft 7680,
dim_f 3072, dim_t 8, compensation 1.009 (UVR model registry). The STFT,
iSTFT and window are the JAX package's host code, float64 numpy.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch


def _hann(n: int) -> np.ndarray:
    return 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(n) / n)


def _stft(wav: np.ndarray, n_fft: int, hop: int) -> np.ndarray:
    """(C, N) -> complex (C, n_fft//2+1, T), center-padded (reflect)."""
    win = _hann(n_fft)
    pad = n_fft // 2
    out = []
    for ch in wav:
        x = np.pad(ch, (pad, pad), mode="reflect")
        t = 1 + (len(x) - n_fft) // hop
        frames = np.lib.stride_tricks.as_strided(
            x, (t, n_fft), (x.strides[0] * hop, x.strides[0])
        )
        out.append(np.fft.rfft(frames * win, axis=-1).T)
    return np.stack(out)


def _istft(spec: np.ndarray, n_fft: int, hop: int, length: int) -> np.ndarray:
    """complex (C, n_fft//2+1, T) -> (C, length), hann overlap-add."""
    win = _hann(n_fft)
    out = []
    for ch in spec:
        frames = np.fft.irfft(ch.T, n=n_fft, axis=-1) * win
        t = frames.shape[0]
        y = np.zeros(n_fft + hop * (t - 1))
        norm = np.zeros_like(y)
        w2 = win**2
        for i in range(t):
            y[i * hop : i * hop + n_fft] += frames[i]
            norm[i * hop : i * hop + n_fft] += w2
        y = y / np.maximum(norm, 1e-8)
        pad = n_fft // 2
        out.append(y[pad : pad + length])
    return np.stack(out)


def _host(y) -> np.ndarray:
    """The net's output as a float32 host array (one copy off the card)."""
    if isinstance(y, torch.Tensor):
        return y.detach().float().cpu().numpy()
    return np.asarray(y, np.float32)


class MDXVocalSeparator:
    """Callable (N,) float mono wav -> (N,) separated vocals. The net runs
    through the port's `OnnxRunner` on `device` (the card unless the caller
    asks for the CPU), or through `runner` when one is given."""

    def __init__(
        self,
        onnx_path: str,
        n_fft: int = 7680,
        hop: int = 1024,
        dim_f: int = 3072,
        dim_t: int = 8,
        compensation: float = 1.009,
        runner: Optional[Callable] = None,
        device=None,
    ):
        if runner is None:
            from mmgt_tpu_torch.utils.onnx_exec import OnnxRunner

            runner = OnnxRunner.from_file(onnx_path, device)
        self.run = runner
        self.n_fft = n_fft
        self.hop = hop
        self.dim_f = dim_f
        self.frames = 2**dim_t
        self.compensation = compensation
        self.chunk_size = hop * (self.frames - 1)
        self.trim = n_fft // 2

    def _run_chunk(self, chunk: np.ndarray) -> np.ndarray:
        """(2, chunk_size + 2*trim) -> same, separated."""
        spec = _stft(chunk, self.n_fft, self.hop)[:, : self.dim_f, : self.frames]
        x = np.stack([spec.real, spec.imag], 1).reshape(
            1, 4, self.dim_f, self.frames
        ).astype(np.float32)
        (y,) = self.run(x).values()
        y = _host(y).reshape(2, 2, self.dim_f, -1)
        full = np.zeros(
            (2, self.n_fft // 2 + 1, y.shape[-1]), np.complex128
        )
        full[:, : self.dim_f] = y[:, 0] + 1j * y[:, 1]
        return _istft(full, self.n_fft, self.hop, chunk.shape[-1])

    def __call__(self, wav: np.ndarray) -> np.ndarray:
        mono = wav.ndim == 1
        stereo = np.stack([wav, wav]) if mono else wav
        n = stereo.shape[-1]
        gen = self.chunk_size - 2 * self.trim
        padded = np.pad(stereo, ((0, 0), (self.trim, self.trim + gen)), mode="constant")
        out = np.zeros_like(padded)
        for start in range(0, n, gen):
            chunk = padded[:, start : start + self.chunk_size]
            if chunk.shape[-1] < self.chunk_size:
                chunk = np.pad(
                    chunk, ((0, 0), (0, self.chunk_size - chunk.shape[-1]))
                )
            sep = self._run_chunk(chunk)
            out[:, start + self.trim : start + self.chunk_size - self.trim] = sep[
                :, self.trim : -self.trim
            ]
        vocals = out[:, self.trim : self.trim + n] * self.compensation
        return vocals.mean(0).astype(np.float32) if mono else vocals.astype(np.float32)
