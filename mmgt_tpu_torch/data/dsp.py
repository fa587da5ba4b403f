"""Host-side DSP: a copy of `mmgt_tpu/data/dsp.py` (numpy/scipy only).

librosa-free Stage-1 baseline audio features (reference
data/audio_extraction/baseline_features.py:41-92).
Feature vector per 25-fps frame (35-dim):
  onset envelope (1) + MFCC (20) + chroma (12) + onset-peak one-hot (1)
  + beat one-hot (1), at SR = 25 * 512 = 12800, hop 512.
"""
from __future__ import annotations

import math
from typing import Optional, Tuple

import numpy as np
import scipy.signal
from scipy.fftpack import dct
from scipy.io import wavfile

FPS = 25
HOP = 512
SR = FPS * HOP  # 12800


# ----------------------------------------------------------------- audio io
def load_wav(path: str, sr: int) -> np.ndarray:
    """Read a wav file, downmix to mono float32 in [-1, 1], resample."""
    in_sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    if data.ndim == 2:
        data = data.mean(axis=1)
    if in_sr != sr:
        g = math.gcd(in_sr, sr)
        data = scipy.signal.resample_poly(data, sr // g, in_sr // g).astype(
            np.float32
        )
    return data


def save_wav(path: str, data: np.ndarray, sr: int) -> None:
    wavfile.write(path, sr, np.clip(data, -1, 1).astype(np.float32))


# --------------------------------------------------------------------- stft
def stft(y: np.ndarray, n_fft: int = 2048, hop: int = HOP) -> np.ndarray:
    """Center-padded magnitude-complex STFT, (1+n_fft/2, frames)."""
    y = np.pad(y, n_fft // 2, mode="reflect")
    win = scipy.signal.get_window("hann", n_fft, fftbins=True)
    n_frames = 1 + (len(y) - n_fft) // hop
    idx = np.arange(n_fft)[None, :] + hop * np.arange(n_frames)[:, None]
    frames = y[idx] * win[None, :]
    return np.fft.rfft(frames, axis=-1).T


def hz_to_mel(f):
    """Slaney mel scale."""
    f = np.asanyarray(f, dtype=np.float64)
    mel = f / (200.0 / 3)
    log_t = f >= 1000.0
    mel = np.where(
        log_t, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0) / (np.log(6.4) / 27.0), mel
    )
    return mel


def mel_to_hz(m):
    m = np.asanyarray(m, dtype=np.float64)
    f = m * (200.0 / 3)
    log_t = m >= 15.0
    f = np.where(log_t, 1000.0 * np.exp((np.log(6.4) / 27.0) * (m - 15.0)), f)
    return f


def mel_filterbank(sr: int, n_fft: int, n_mels: int = 128,
                   fmin: float = 0.0, fmax: Optional[float] = None) -> np.ndarray:
    if fmax is None:
        fmax = sr / 2
    fft_freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)
    mel_pts = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    fb = np.zeros((n_mels, len(fft_freqs)))
    fdiff = np.diff(mel_pts)
    ramps = mel_pts[:, None] - fft_freqs[None, :]
    for i in range(n_mels):
        lower = -ramps[i] / fdiff[i]
        upper = ramps[i + 2] / fdiff[i + 1]
        fb[i] = np.maximum(0, np.minimum(lower, upper))
    enorm = 2.0 / (mel_pts[2 : n_mels + 2] - mel_pts[:n_mels])  # slaney norm
    return fb * enorm[:, None]


def melspectrogram(y: np.ndarray, sr: int = SR, n_fft: int = 2048,
                   hop: int = HOP, n_mels: int = 128) -> np.ndarray:
    s = np.abs(stft(y, n_fft, hop)) ** 2
    return mel_filterbank(sr, n_fft, n_mels) @ s


def power_to_db(s: np.ndarray, ref: float = 1.0, amin: float = 1e-10,
                top_db: float = 80.0) -> np.ndarray:
    db = 10.0 * np.log10(np.maximum(amin, s)) - 10.0 * np.log10(max(amin, ref))
    if top_db is not None:
        db = np.maximum(db, db.max() - top_db)
    return db


# ----------------------------------------------------------------- features
def mfcc(y: np.ndarray, sr: int = SR, n_mfcc: int = 20, hop: int = HOP
         ) -> np.ndarray:
    """(frames, n_mfcc)."""
    s = power_to_db(melspectrogram(y, sr, hop=hop))
    return dct(s, type=2, axis=0, norm="ortho")[:n_mfcc].T


def onset_strength(y: np.ndarray, sr: int = SR, hop: int = HOP) -> np.ndarray:
    """Spectral-flux onset envelope over a dB mel spectrogram, (frames,)."""
    s = power_to_db(melspectrogram(y, sr, hop=hop), ref=float(np.max(
        melspectrogram(y, sr, hop=hop)) + 1e-10))
    diff = np.maximum(0.0, s[:, 1:] - s[:, :-1])
    env = diff.mean(axis=0)
    return np.concatenate([[0.0], env]).astype(np.float32)


def chroma_filterbank(sr: int, n_fft: int, n_chroma: int = 12) -> np.ndarray:
    freqs = np.linspace(0, sr / 2, 1 + n_fft // 2)[1:]
    pitch = 12.0 * np.log2(np.maximum(freqs, 1e-10) / 440.0) + 69.0
    cls = np.mod(np.round(pitch), 12).astype(int)
    fb = np.zeros((n_chroma, 1 + n_fft // 2))
    for b, p in enumerate(cls):
        fb[p, b + 1] = 1.0
    return fb


def chroma(y: np.ndarray, sr: int = SR, hop: int = HOP,
           n_chroma: int = 12, smooth_win: int = 41) -> np.ndarray:
    """CENS-style chroma: energy-normalized, quantized, smoothed
    (approximates librosa.chroma_cens on an STFT basis). (frames, 12)."""
    s = np.abs(stft(y, 2048, hop)) ** 2
    c = chroma_filterbank(sr, 2048, n_chroma) @ s  # (12, frames)
    l1 = c.sum(axis=0, keepdims=True)
    c = c / np.maximum(l1, 1e-10)
    # CENS quantization
    q = np.zeros_like(c)
    for thresh in (0.4, 0.2, 0.1, 0.05):
        q += 0.25 * (c > thresh)
    win = scipy.signal.get_window("hann", smooth_win)
    q = scipy.signal.convolve2d(
        q, win[None, :] / win.sum(), mode="same", boundary="symm"
    )
    l2 = np.sqrt((q**2).sum(axis=0, keepdims=True))
    return (q / np.maximum(l2, 1e-10)).T.astype(np.float32)


def peak_pick(env: np.ndarray, sr: int = SR, hop: int = HOP) -> np.ndarray:
    """Onset peak indices (librosa onset_detect default windows)."""
    pre_max = int(0.03 * sr // hop)
    post_max = int(0.0 * sr // hop) + 1
    pre_avg = int(0.10 * sr // hop)
    post_avg = int(0.10 * sr // hop) + 1
    wait = int(0.03 * sr // hop)
    delta = 0.07
    peaks = []
    last = -np.inf
    for i in range(len(env)):
        lo, hi = max(0, i - pre_max), min(len(env), i + post_max)
        if env[i] != env[lo:hi].max():
            continue
        lo, hi = max(0, i - pre_avg), min(len(env), i + post_avg)
        if env[i] < env[lo:hi].mean() + delta:
            continue
        if i - last <= wait:
            continue
        last = i
        peaks.append(i)
    return np.asarray(peaks, np.int64)


def estimate_tempo(env: np.ndarray, sr: int = SR, hop: int = HOP,
                   start_bpm: float = 120.0, std_bpm: float = 1.0) -> float:
    """Autocorrelation tempo estimate with a log-normal prior."""
    if env.size < 4 or env.std() < 1e-8:
        return start_bpm
    e = env - env.mean()
    ac = np.correlate(e, e, mode="full")[len(e) - 1 :]
    ac = ac / (ac[0] + 1e-10)
    lags = np.arange(1, len(ac))
    bpms = 60.0 * sr / (hop * lags)
    valid = (bpms >= 30) & (bpms <= 300)
    if not valid.any():
        return start_bpm
    prior = np.exp(-0.5 * ((np.log2(bpms) - np.log2(start_bpm)) / std_bpm) ** 2)
    score = ac[1:] * prior
    score = np.where(valid, score, -np.inf)
    return float(bpms[np.argmax(score)])


def beat_track(env: np.ndarray, sr: int = SR, hop: int = HOP,
               start_bpm: float = 120.0, tightness: float = 100.0
               ) -> Tuple[float, np.ndarray]:
    """Ellis dynamic-programming beat tracker."""
    tempo = estimate_tempo(env, sr, hop, start_bpm)
    period = max(1, int(round(60.0 * sr / (hop * tempo))))
    n = len(env)
    if n == 0 or env.max() <= 0:
        return tempo, np.zeros(0, np.int64)
    local = env / (env.std() + 1e-10)
    backlink = np.full(n, -1, np.int64)
    cumscore = local.copy()
    prange = np.arange(-2 * period, -period // 2)
    txwt = -tightness * (np.log(-prange / period) ** 2)
    for i in range(n):
        lo = i + prange
        ok = lo >= 0
        if not ok.any():
            continue
        scores = txwt + np.where(ok, cumscore[np.maximum(lo, 0)], -np.inf)
        best = np.argmax(scores)
        if np.isfinite(scores[best]):
            cumscore[i] = local[i] + scores[best]
            backlink[i] = lo[best]
    # pick the best ending and trace back
    tail = np.argmax(cumscore[max(0, n - period) :]) + max(0, n - period)
    beats = [int(tail)]
    while backlink[beats[-1]] >= 0:
        beats.append(int(backlink[beats[-1]]))
    return tempo, np.asarray(beats[::-1], np.int64)


def baseline_features(y: np.ndarray, clip_seconds: float = 3.2) -> np.ndarray:
    """35-dim per-frame features, chopped to clip_seconds
    (baseline_features.py:41-92)."""
    env = onset_strength(y)
    m = mfcc(y)
    ch = chroma(y)
    n = min(len(env), len(m), len(ch))
    env, m, ch = env[:n], m[:n], ch[:n]
    peaks = peak_pick(env)
    peak_onehot = np.zeros(n, np.float32)
    peak_onehot[peaks[peaks < n]] = 1.0
    _, beats = beat_track(env)
    beat_onehot = np.zeros(n, np.float32)
    beat_onehot[beats[beats < n]] = 1.0
    feats = np.concatenate(
        [env[:, None], m, ch, peak_onehot[:, None], beat_onehot[:, None]], axis=-1
    )
    target = int(clip_seconds * FPS)
    if len(feats) < target:
        feats = np.pad(feats, ((0, target - len(feats)), (0, 0)))
    return feats[:target].astype(np.float32)
