"""Vocoder runtime: codec decoding for arbitrary code lengths (port of
`neutts_tpu.runtime.vocoder.ExactVocoder`).

Code lengths are padded up to a small bucket set and decoded through the
codec's length-masked path (`codec.decode(..., n_valid=n)`): pad frames
contribute exact zeros, so the valid samples match an unpadded decode to
float32 rounding. Buckets keep the set of shapes small, as in the JAX
package (there to bound compiles; here it keeps allocator reuse high).
The windowed `ChunkedVocoder` comes with streaming, in a later slice.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from neutts_tpu_torch.config import CodecConfig
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
