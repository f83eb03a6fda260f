"""Kaldi-style log-mel front-end for the w2v-BERT semantic tower.

First-party numpy implementation of the feature recipe the released
w2v-BERT 2.0 checkpoints were trained on (the `SeamlessM4TFeatureExtractor`
recipe: 16-bit-scaled waveform, povey window 400/hop 160/fft 512, per-frame
DC removal + 0.97 preemphasis, power spectrum, 80 kaldi-mel bins
triangularized in mel space, natural log, per-mel-bin utterance
normalization, 2-frame stacking to 160 dims at 50 Hz). A copy of
`neutts_tpu.audio.mel`, which has no framework: tests/test_torch_encoder.py
holds the two equal.

This is host-side precompute (one reference clip per cloning request); the
semantic tower itself runs on the device (models/semantic.py).
"""

from __future__ import annotations

import numpy as np

SAMPLE_RATE = 16_000
N_FFT = 512
WIN = 400
HOP = 160
N_MELS = 80
MEL_FLOOR = 1.192092955078125e-07
PREEMPH = 0.97
STRIDE = 2  # 2-frame stacking: 100 Hz fbank -> 50 Hz x 160 dims


def _povey_window(n: int = WIN) -> np.ndarray:
    """Kaldi povey window: hann(periodic=False) ** 0.85."""
    i = np.arange(n, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * np.pi * i / (n - 1))
    return hann**0.85


def _kaldi_mel(f):
    return 1127.0 * np.log(1.0 + np.asarray(f, np.float64) / 700.0)


def _mel_filters(
    n_freqs: int = N_FFT // 2 + 1,
    n_mels: int = N_MELS,
    fmin: float = 20.0,
    fmax: float = SAMPLE_RATE / 2,
) -> np.ndarray:
    """[n_freqs, n_mels] triangular filters built in MEL space (kaldi scale,
    no normalization) — the `triangularize_in_mel_space` convention."""
    mel_pts = np.linspace(_kaldi_mel(fmin), _kaldi_mel(fmax), n_mels + 2)
    freqs = np.arange(n_freqs, dtype=np.float64) * SAMPLE_RATE / N_FFT
    mel_f = _kaldi_mel(freqs)  # [F]
    left = mel_pts[:-2][None, :]
    center = mel_pts[1:-1][None, :]
    right = mel_pts[2:][None, :]
    up = (mel_f[:, None] - left) / (center - left)
    down = (right - mel_f[:, None]) / (right - center)
    return np.maximum(0.0, np.minimum(up, down))  # [F, M]


_WINDOW = _povey_window()
_FILTERS = _mel_filters()


def log_mel(waveform: np.ndarray) -> np.ndarray:
    """waveform [T] float in [-1, 1] @16 kHz -> log-mel [n_frames, 80].

    snip-edges framing (center=False): n_frames = 1 + (T - 400) // 160.
    """
    x = np.asarray(waveform, np.float64).reshape(-1) * 32768.0  # 16-bit scale
    if len(x) < WIN:
        raise ValueError(f"need >= {WIN} samples, got {len(x)}")
    n_frames = 1 + (len(x) - WIN) // HOP
    idx = np.arange(WIN)[None, :] + HOP * np.arange(n_frames)[:, None]
    frames = x[idx]  # [N, WIN]
    frames = frames - frames.mean(axis=1, keepdims=True)  # remove DC offset
    pre = np.empty_like(frames)
    pre[:, 1:] = frames[:, 1:] - PREEMPH * frames[:, :-1]
    pre[:, 0] = frames[:, 0] * (1.0 - PREEMPH)
    pre = pre * _WINDOW[None, :]
    spec = np.fft.rfft(pre, n=N_FFT, axis=1)  # [N, F]
    power = np.abs(spec) ** 2.0
    mel = np.maximum(MEL_FLOOR, power @ _FILTERS)  # [N, M]
    return np.log(mel)


def semantic_features(waveform: np.ndarray) -> np.ndarray:
    """waveform [T] @16 kHz -> w2v-BERT input features [T50, 160] f32.

    Per-mel-bin zero-mean/unit-var normalization over the utterance
    (ddof=1), then 2-frame stacking (drop the odd remainder frame).
    """
    feats = log_mel(waveform)  # [N, 80]
    mu = feats.mean(axis=0, keepdims=True)
    var = feats.var(axis=0, ddof=1, keepdims=True)
    feats = (feats - mu) / np.sqrt(var + 1e-7)
    n = (feats.shape[0] // STRIDE) * STRIDE
    return feats[:n].reshape(n // STRIDE, N_MELS * STRIDE).astype(np.float32)
