"""Host-side audio I/O: WAV read/write and resampling.

Fills the librosa/soundfile role from the reference (load @16 kHz mono for
encoding, write @24 kHz — reference neutts/neutts.py:267,
examples/basic_example.py:31). Pure host-side work, a copy of
`neutts_tpu.audio.io` (no framework). A C++ path lives in
neutts_tpu_torch/native and is taken when it builds; where no compiler is
present this NumPy/stdlib implementation is.
"""

from __future__ import annotations

import wave
from pathlib import Path
from typing import Tuple

import numpy as np


def read_wav(path: str | Path) -> Tuple[np.ndarray, int]:
    """Returns (float32 samples [T] or [T, C], sample_rate)."""
    with wave.open(str(path), "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 3:
        b = np.frombuffer(raw, dtype=np.uint8).reshape(-1, 3)
        x = (
            (b[:, 0].astype(np.int32))
            | (b[:, 1].astype(np.int32) << 8)
            | (b[:, 2].astype(np.int32) << 16)
        )
        x = np.where(x >= 1 << 23, x - (1 << 24), x).astype(np.float32) / float(1 << 23)
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported WAV sample width: {width}")
    if ch > 1:
        x = x.reshape(-1, ch)
    return x, sr


def write_wav(path: str | Path, wav: np.ndarray, sample_rate: int) -> None:
    """Write mono/stereo float waveform as 16-bit PCM."""
    x = np.asarray(wav, np.float32)
    if x.ndim == 1:
        x = x[:, None]
    pcm = np.clip(np.round(x * 32767.0), -32768, 32767).astype("<i2")
    with wave.open(str(path), "wb") as w:
        w.setnchannels(x.shape[1])
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def to_mono(x: np.ndarray) -> np.ndarray:
    if x.ndim == 2:
        return x.mean(axis=1)
    return x


def resample(x: np.ndarray, sr_in: int, sr_out: int) -> np.ndarray:
    """High-quality polyphase resampling (Kaiser-windowed sinc)."""
    if sr_in == sr_out:
        return np.asarray(x, np.float32)
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr_in, sr_out)
    up, down = sr_out // g, sr_in // g
    y = resample_poly(np.asarray(x, np.float64), up, down, window=("kaiser", 12.0))
    return y.astype(np.float32)


def load_for_encoding(
    path: str | Path, target_sr: int = 16_000, prefer_native: bool = True
) -> np.ndarray:
    """librosa.load(path, sr=16000, mono=True) equivalent
    (reference neutts/neutts.py:267): mono float32 @ target_sr.

    Uses the C++ frontend (neutts_tpu_torch/native) when it builds — same
    filter design as the SciPy path (agree to ~5e-5); set prefer_native=False
    to force the pure-Python path. A native library that built but fails on
    the file raises.
    """
    if prefer_native:
        from neutts_tpu_torch import native

        if native.available():
            x, sr = native.read_wav(str(path))
            return native.resample(to_mono(x), sr, target_sr)
    x, sr = read_wav(path)
    x = to_mono(x)
    return resample(x, sr, target_sr)
