"""Vocoder runtime: codec decoding for arbitrary code lengths (port of
`neutts_tpu.runtime.vocoder`).

* `ExactVocoder`: code lengths are padded up to a small bucket set and
  decoded through the codec's length-masked path (`codec.decode(...,
  n_valid=n)`): pad frames contribute exact zeros, so the valid samples
  match an unpadded decode to float32 rounding. Buckets keep the set of
  shapes small, as in the JAX package (there to bound compiles; here it
  keeps allocator reuse high).
* `ChunkedVocoder`: the codes are cut into the streaming windows (lookback
  50 / chunk 25 / lookforward 5 / overlap 1: 82 frames), every window is
  decoded in one batch padded to a bucket of windows, and the chunks are
  joined by the triangular overlap-add. It matches the full decode to the
  codec's receptive-field tolerance, as streaming does.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from neutts_tpu_torch.audio.overlap_add import linear_overlap_add
from neutts_tpu_torch.config import CodecConfig, StreamingConfig
from neutts_tpu_torch.models import codec as cd


class ExactVocoder:
    """Length-masked decode at bucketed shapes."""

    def __init__(self, cfg: CodecConfig, params, device="cuda",
                 buckets: Sequence[int] = (128, 512, 2048)):
        self.cfg = cfg
        self.params = params
        self.device = torch.device(device)
        self.buckets = tuple(buckets)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        top = self.buckets[-1]
        return ((n + top - 1) // top) * top

    def __call__(self, codes: Sequence[int] | np.ndarray) -> np.ndarray:
        arr = np.asarray(codes, np.int64).reshape(-1)
        n = arr.shape[0]
        padded = np.zeros(self._bucket(n), np.int64)
        padded[:n] = arr
        x = torch.as_tensor(padded, device=self.device)[None]
        wav = cd.decode(self.cfg, self.params, x, n_valid=n)
        return wav[0, : n * self.cfg.hop_out].cpu().numpy()


class ChunkedVocoder:
    """Fixed 82-frame windows decoded as one batch, then overlap-added."""

    def __init__(self, cfg: CodecConfig, params, streaming: StreamingConfig = StreamingConfig(),
                 device="cuda", batch_buckets: Sequence[int] = (1, 2, 4, 8, 16, 32, 64, 128)):
        self.cfg = cfg
        self.params = params
        self.s = streaming
        self.device = torch.device(device)
        self.window = (streaming.lookback + streaming.overlap_frames
                       + streaming.frames_per_chunk + streaming.lookforward
                       + streaming.overlap_frames)  # 82 frames
        self.buckets = tuple(batch_buckets)

    def _bucket(self, n: int) -> int:
        for b in self.buckets:
            if n <= b:
                return b
        top = self.buckets[-1]
        return ((n + top - 1) // top) * top

    def __call__(self, codes: Sequence[int] | np.ndarray) -> np.ndarray:
        s = self.s
        hop = self.cfg.hop_out
        arr = np.asarray(codes, np.int64).reshape(-1)
        n = len(arr)
        if n == 0:
            raise ValueError("No valid speech tokens found in the output.")
        lb = s.lookback + s.overlap_frames  # left context frames
        chunk = s.frames_per_chunk
        emit = chunk + 2 * s.overlap_frames  # frames emitted per window
        n_chunks = max(1, -(-n // chunk))
        # left pad with zeros (the first window's warm-up context only);
        # right pad with the last code (windows past the end are dropped)
        padded = np.concatenate([
            np.zeros(lb, np.int64), arr,
            np.full(n_chunks * chunk - n + s.lookforward + s.overlap_frames, arr[-1], np.int64),
        ])
        windows = np.zeros((self._bucket(n_chunks), self.window), np.int64)
        for i in range(n_chunks):
            windows[i] = padded[i * chunk : i * chunk + self.window]
        wavs = cd.decode(self.cfg, self.params, torch.as_tensor(windows, device=self.device))
        # emission region of window i: local frames [lb, lb + emit) ->
        # global [i*chunk, i*chunk + emit)
        a = lb * hop
        frames = list(wavs[:n_chunks, a : a + emit * hop].cpu().numpy())
        return linear_overlap_add(frames, stride=s.stride_samples)[: n * hop]
