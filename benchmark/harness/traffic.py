"""The one traffic generator: it reads a mix's parameter file and the seed.

Every seed gets the same sizes, in another order: lengths and budgets are
drawn once from the mix's `base_seed`, and the run's seed permutes them and
draws the token ids. So seeds change what is said,
not how much work there is.

Parameters of an `engine` mix (serving requests):
  prompt_tokens [lo, hi]   prompt length, uniform (speech-token ids)
  budget [lo, hi]          new tokens per request, uniform
  first_wave_budget [lo, hi]  budgets of the first `n_slots` requests, which
                           fill the slots in set-up, spread so that they
                           retire at a steady rate
  backlog                  requests kept waiting beyond the slots
  n_requests               how many requests the list holds

Parameters of a `stream` mix (one interactive user):
  sentences                a file beside the mix, one sentence a line
  clip_codes [n, ...]      reference clip lengths in codes, used in turn
  seconds_per_word         audio per word: a stream closes after
                           ceil(words * seconds_per_word * 50 / frames_per_chunk) chunks
  n_streams                how many streams the list holds
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path
from typing import List

import numpy as np

from benchmark.harness.manifest import BENCH_DIR


def _rng(seed: int, *stream: int) -> np.random.Generator:
    return np.random.default_rng([int(seed) % (1 << 64), *stream])


@dataclass
class Request:
    index: int
    prompt: np.ndarray  # int32 token ids (an array: no per-id Python objects)
    budget: int


def engine_requests(t: dict, seed: int, speech_base: int, codebook: int) -> List[Request]:
    n = int(t["n_requests"])
    base = _rng(t.get("base_seed", 0), 1)
    lo, hi = t["prompt_tokens"]
    lens = base.integers(lo, hi + 1, n)
    blo, bhi = t["budget"]
    budgets = base.integers(blo, bhi + 1, n)
    run = _rng(seed, 2)
    perm = run.permutation(n)
    lens, budgets = lens[perm], budgets[perm]
    if "first_wave_budget" in t:
        k = int(t["n_slots"])
        flo, fhi = t["first_wave_budget"]
        budgets[:k] = run.permutation(base.integers(flo, fhi + 1, k))
    ids = (run.integers(0, codebook, int(lens.sum())) + speech_base).astype(np.int32)
    out, off = [], 0
    for i in range(n):
        out.append(Request(i, ids[off: off + lens[i]], int(budgets[i])))
        off += lens[i]
    return out


@dataclass
class Stream:
    index: int
    ref_codes: np.ndarray  # int32 codec codes of the reference clip
    ref_text: str
    text: str
    n_chunks: int  # the stream is closed after this many chunks


def sentences(t: dict) -> List[str]:
    path = Path(BENCH_DIR) / "traffic" / t["sentences"]
    return [s.strip() for s in path.read_text().splitlines() if s.strip()]


def stream_chunks(text: str, t: dict, frames_per_chunk: int, frame_rate: int = 50) -> int:
    frames = round(len(text.split()) * t["seconds_per_word"] * frame_rate)  # of audio
    return max(1, -(-frames // frames_per_chunk))


def streams(t: dict, seed: int, codebook: int, frames_per_chunk: int) -> List[Stream]:
    sents = sentences(t)
    clips = list(t["clip_codes"])
    n = int(t["n_streams"])
    run = _rng(seed, 3)
    texts = [sents[i] for i in np.concatenate([run.permutation(len(sents))
                                               for _ in range(-(-n // len(sents)))])]
    refs = [sents[i] for i in np.concatenate([run.permutation(len(sents))
                                              for _ in range(-(-n // len(sents)))])]
    clip_order = np.concatenate([run.permutation(len(clips))
                                 for _ in range(-(-n // len(clips)))])
    out = []
    for k in range(n):
        m = clips[clip_order[k]]
        codes = run.integers(0, codebook, m).astype(np.int32)
        out.append(Stream(k, codes, refs[k], texts[k],
                          stream_chunks(texts[k], t, frames_per_chunk)))
    return out
