"""Plain NumPy reference of the stream's audio stages: the spread-spectrum
watermark and the streaming overlap-add, and the chunk schedule of a
stream (which codes each vocoder window takes and which samples it emits).
Frozen copies of the mathematics, written again here; nothing of the
program is imported.

Watermark: x + 10^(-34/20) * envelope(x) * hp_prn(key), clipped to [-1, 1];
hp_prn is the first difference / sqrt(2) of a +-1 sequence drawn by
`numpy.random.default_rng(key).integers(0, 2)`, whose prefix is used;
envelope is the RMS over blocks of 512 samples, held over the block.

Overlap-add: each pushed chunk is weighted by the triangle |0.5 - (t - 0.5)|,
t = linspace(0, 1, n + 2)[1:-1], summed into the output at its offset and
divided by the summed weights; a push returns every sample before the next
chunk's start.
"""

from __future__ import annotations

from typing import Callable, List

import numpy as np

REL_LEVEL = 10 ** (-34 / 20)
KEY = 0x5EED


def _hp_prn(n: int, key: int = KEY) -> np.ndarray:
    m = max(n + 1, 1 << 17)
    p = np.random.default_rng(key).integers(0, 2, size=m).astype(np.float32) * 2.0 - 1.0
    p = p[: n + 1]
    return (p[1:] - p[:-1]) * np.float32(1.0 / np.sqrt(2.0))


def watermark(x: np.ndarray, key: int = KEY) -> np.ndarray:
    x = np.asarray(x, np.float32)
    n = len(x)
    nb = -(-n // 512)
    sq = np.zeros(nb * 512, np.float32)
    sq[:n] = x * x
    env = np.repeat(np.sqrt(np.maximum(sq.reshape(nb, 512).mean(axis=1), 1e-10)), 512)[:n]
    return np.clip(x + REL_LEVEL * env * _hp_prn(n, key), -1.0, 1.0).astype(np.float32)


class OverlapAdd:
    def __init__(self):
        self.out = np.zeros(0, np.float32)
        self.wsum = np.zeros(0, np.float32)
        self.offset = 0
        self.emitted = 0

    def push(self, f: np.ndarray, stride: int) -> np.ndarray:
        n = len(f)
        end = self.offset + n
        if end > len(self.out):
            grow = end - len(self.out)
            self.out = np.concatenate([self.out, np.zeros(grow, np.float32)])
            self.wsum = np.concatenate([self.wsum, np.zeros(grow, np.float32)])
        t = np.linspace(0, 1, n + 2, dtype=np.float32)[1:-1]
        w = np.abs(0.5 - (t - 0.5))
        self.out[self.offset: end] += w * f
        self.wsum[self.offset: end] += w
        self.offset += stride
        done = min(self.offset, end)
        o = self.out[self.emitted: done] / np.maximum(self.wsum[self.emitted: done], 1e-12)
        self.emitted = done
        return o

    def flush(self) -> np.ndarray:
        valid = np.nonzero(self.wsum > 0)[0]
        hi = int(valid[-1]) + 1 if valid.size else 0
        if hi <= self.emitted:
            return np.zeros(0, np.float32)
        o = self.out[self.emitted: hi] / self.wsum[self.emitted: hi]
        self.emitted = hi
        return o


def stream_chunks(ref_codes: List[int], first: List[int], segments: List[List[int]],
                  n_chunks: int, vocode: Callable[[List[int]], np.ndarray],
                  s: dict, hop: int, ended: bool = False) -> List[np.ndarray]:
    """The first `n_chunks` audio chunks of a stream whose decode gave the
    speech codes `first` (the prefill's token, if a code) and then
    `segments` (each segment's codes), as the streaming schedule emits them:
    a chunk of `frames_per_chunk` frames is vocoded, with `lookback` frames
    of context before it and `lookforward` after, once those frames exist,
    watermarked, cut to the chunk and its overlaps, and overlap-added. A
    stream whose decode `ended` (EOS) then vocodes what is left, with its
    lookback, as one last chunk, and flushes the overlap-add."""
    cache = list(ref_codes) + list(first)
    n_dec = len(ref_codes)
    ola = OverlapAdd()
    fpc, lf, lb, ov = s["frames_per_chunk"], s["lookforward"], s["lookback"], \
        s["overlap_frames"]
    cf = min(s["first_chunk_frames"], fpc)
    out: List[np.ndarray] = []
    for seg in segments:
        cache += list(seg)
        while len(cache) - n_dec >= cf + lf and len(out) < n_chunks:
            start = max(n_dec - lb - ov, 0)
            end = min(n_dec + cf + lf + ov, len(cache))
            wav = watermark(vocode(cache[start:end]))
            a = (n_dec - start) * hop
            chunk = wav[a: a + (cf + 2 * ov) * hop]
            o = ola.push(chunk, stride=cf * hop)
            n_dec += cf
            cf = fpc
            if o.size:
                out.append(o)
        if len(out) >= n_chunks:
            break
    remaining = len(cache) - n_dec
    if ended and len(out) < n_chunks and remaining > 0:
        start = max(len(cache) - (lb + ov + remaining), 0)
        wav = watermark(vocode(cache[start:]))
        a = max((n_dec - start - ov) * hop, 0)
        o = ola.push(wav[a:], stride=s["frames_per_chunk"] * hop)
        full = np.concatenate([o, ola.flush()])
        if full.size:
            out.append(full)
    return out
