"""Crossfade joiner for streamed audio chunks.

Behavioral equivalent of the reference's `_linear_overlap_add`
(reference neutts/neutts.py:46-70, adapted there from encodec utils):
triangular weight `|0.5 - (t - 0.5)|` over each frame, normalized by the
summed weight. Incremental variant for true streaming (no O(n^2) re-join).
"""

from __future__ import annotations

from typing import List

import numpy as np


def linear_overlap_add(frames: List[np.ndarray], stride: int) -> np.ndarray:
    """Batch join (matches the reference function sample-for-sample)."""
    assert len(frames)
    dtype = frames[0].dtype
    total = max(stride * i + f.shape[-1] for i, f in enumerate(frames))
    out = np.zeros(total, dtype=dtype)
    sum_w = np.zeros(total, dtype=dtype)
    offset = 0
    for f in frames:
        n = f.shape[-1]
        t = np.linspace(0, 1, n + 2, dtype=dtype)[1:-1]
        w = np.abs(0.5 - (t - 0.5))
        out[offset : offset + n] += w * f
        sum_w[offset : offset + n] += w
        offset += stride
    assert sum_w.min() > 0
    return out / sum_w


class StreamingOverlapAdd:
    """Incremental overlap-add with the same weights as `linear_overlap_add`.

    The reference re-joins the entire audio cache on every chunk
    (reference neutts/neutts.py:433-440) — O(n^2) over a long stream. This
    accumulates weighted samples + weights incrementally (true O(chunk) per
    push); emitted samples are final. Supports a per-push stride so a small
    low-latency FIRST chunk can be followed by standard-cadence chunks.
    """

    def __init__(self, stride: int):
        self.stride = stride  # default advance per push
        self._out = np.zeros(0, np.float32)
        self._wsum = np.zeros(0, np.float32)
        self._offset = 0  # where the NEXT frame starts
        self._emitted = 0

    def _grow(self, n: int) -> None:
        if n > self._out.shape[0]:
            pad = n - self._out.shape[0]
            self._out = np.concatenate([self._out, np.zeros(pad, np.float32)])
            self._wsum = np.concatenate([self._wsum, np.zeros(pad, np.float32)])

    def push(self, frame: np.ndarray, stride: int | None = None) -> np.ndarray:
        """Add a chunk starting where the previous push left off, advance by
        `stride` (defaults to the constructor stride); returns newly-finalized
        samples (everything before the next frame's start is final)."""
        stride = self.stride if stride is None else stride
        f = np.asarray(frame, np.float32)
        n = f.shape[-1]
        end = self._offset + n
        self._grow(end)
        t = np.linspace(0, 1, n + 2, dtype=np.float32)[1:-1]
        w = np.abs(0.5 - (t - 0.5))
        self._out[self._offset : end] += w * f
        self._wsum[self._offset : end] += w
        self._offset += stride
        done = min(self._offset, end)
        out = self._out[self._emitted : done]
        wsum = self._wsum[self._emitted : done]
        assert wsum.size == 0 or wsum.min() > 0
        self._emitted = done
        return out / np.maximum(wsum, 1e-12)

    def flush(self) -> np.ndarray:
        valid = np.nonzero(self._wsum > 0)[0]
        hi = int(valid[-1]) + 1 if valid.size else 0
        if hi <= self._emitted:
            return np.zeros(0, np.float32)
        out = self._out[self._emitted : hi] / self._wsum[self._emitted : hi]
        self._emitted = hi
        return out
