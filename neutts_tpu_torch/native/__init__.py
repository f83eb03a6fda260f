"""ctypes bindings for the native C++ audio frontend (audio.cpp), a copy of
`neutts_tpu.native` for the port.

The shared library is built on first use with `g++ -O3 -shared -fPIC` into
the git-ignored `neutts_tpu_torch/_build/`, named after a hash of the
source, so an edited source is rebuilt and nothing is written beside the
source. Without a compiler `available()` is False and callers take the
NumPy path of `audio/io.py`. Entry points mirror that module:

    from neutts_tpu_torch import native
    if native.available():
        wav, sr = native.read_wav(path)
        y = native.resample(wav, sr, 16_000)
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Optional, Tuple

import numpy as np

_SRC = Path(__file__).resolve().parent / "audio.cpp"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_failed = False


def _so_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return BUILD_DIR / f"libneutts_audio-{h.hexdigest()[:16]}.so"


def _build(so: Path) -> bool:
    """Compile into a file of this process, then rename it into place, so
    processes that build at once never load a half-written library."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.tmp")
    try:
        subprocess.run(["g++", *_FLAGS, str(_SRC), "-o", str(tmp)],
                       check=True, capture_output=True, timeout=120)
    except (OSError, subprocess.SubprocessError):
        tmp.unlink(missing_ok=True)
        return False
    os.replace(tmp, so)
    return True


def _load() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    with _lock:
        if _lib is not None or _build_failed:
            return _lib
        so = _so_path()
        if not so.exists() and not _build(so):
            _build_failed = True
            return None
        lib = ctypes.CDLL(str(so))
        f32p = ctypes.POINTER(ctypes.c_float)
        lib.ntpu_read_wav.argtypes = [
            ctypes.c_char_p, ctypes.POINTER(f32p), ctypes.POINTER(ctypes.c_int64),
            ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ]
        lib.ntpu_read_wav.restype = ctypes.c_int
        lib.ntpu_write_wav.argtypes = [
            ctypes.c_char_p, f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int,
        ]
        lib.ntpu_write_wav.restype = ctypes.c_int
        lib.ntpu_resample_len.argtypes = [ctypes.c_int64, ctypes.c_int, ctypes.c_int]
        lib.ntpu_resample_len.restype = ctypes.c_int64
        lib.ntpu_resample.argtypes = [
            f32p, ctypes.c_int64, ctypes.c_int, ctypes.c_int, ctypes.c_double, f32p,
            ctypes.c_int64,
        ]
        lib.ntpu_resample.restype = ctypes.c_int
        lib.ntpu_overlap_add.argtypes = [
            f32p, ctypes.c_int, ctypes.c_int64, ctypes.c_int64, f32p, ctypes.c_int64,
        ]
        lib.ntpu_overlap_add.restype = ctypes.c_int
        lib.ntpu_free.argtypes = [ctypes.c_void_p]
        lib.ntpu_free.restype = None
        _lib = lib
        return _lib


def available() -> bool:
    return _load() is not None


def _lib_or_raise() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError("native audio library unavailable (no g++ to build it)")
    return lib


def read_wav(path: str | Path) -> Tuple[np.ndarray, int]:
    """Returns (float32 [T] or [T, C], sample_rate)."""
    lib = _lib_or_raise()
    out = ctypes.POINTER(ctypes.c_float)()
    frames = ctypes.c_int64()
    ch = ctypes.c_int()
    sr = ctypes.c_int()
    rc = lib.ntpu_read_wav(str(path).encode(), ctypes.byref(out),
                           ctypes.byref(frames), ctypes.byref(ch), ctypes.byref(sr))
    if rc != 0:
        raise IOError(f"ntpu_read_wav({path}) failed with code {rc}")
    n = frames.value * ch.value
    arr = np.ctypeslib.as_array(out, shape=(n,)).copy()
    lib.ntpu_free(out)
    if ch.value > 1:
        arr = arr.reshape(frames.value, ch.value)
    return arr, sr.value


def write_wav(path: str | Path, wav: np.ndarray, sample_rate: int) -> None:
    lib = _lib_or_raise()
    x = np.ascontiguousarray(wav, np.float32)
    ch = 1 if x.ndim == 1 else x.shape[1]
    rc = lib.ntpu_write_wav(str(path).encode(),
                            x.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                            x.shape[0], ch, sample_rate)
    if rc != 0:
        raise IOError(f"ntpu_write_wav({path}) failed with code {rc}")


def resample(x: np.ndarray, sr_in: int, sr_out: int, beta: float = 12.0) -> np.ndarray:
    lib = _lib_or_raise()
    xin = np.ascontiguousarray(x, np.float32)
    if xin.ndim != 1:
        raise ValueError(f"resample takes a mono signal [T], got shape {xin.shape}")
    n_out = lib.ntpu_resample_len(len(xin), sr_in, sr_out)
    out = np.empty(n_out, np.float32)
    rc = lib.ntpu_resample(xin.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                           len(xin), sr_in, sr_out, beta,
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n_out)
    if rc != 0:
        raise RuntimeError(f"ntpu_resample failed with code {rc}")
    return out


def overlap_add(frames: np.ndarray, stride: int) -> np.ndarray:
    """frames: [n_frames, frame_len] equal-length chunks."""
    lib = _lib_or_raise()
    fr = np.ascontiguousarray(frames, np.float32)
    if fr.ndim != 2:
        raise ValueError(f"overlap_add takes [n_frames, frame_len], got shape {fr.shape}")
    n_frames, frame_len = fr.shape
    total = stride * (n_frames - 1) + frame_len
    out = np.empty(total, np.float32)
    rc = lib.ntpu_overlap_add(fr.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                              n_frames, frame_len, stride,
                              out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), total)
    if rc != 0:
        raise RuntimeError(f"ntpu_overlap_add failed with code {rc}")
    return out
