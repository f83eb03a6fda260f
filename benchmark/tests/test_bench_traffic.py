"""The traffic generator: the same seed gives the same requests and
streams; sizes and budgets stay in the mix's ranges; seeds share the same
sizes in another order."""

from __future__ import annotations

import pytest

from benchmark.harness import manifest, traffic
from benchmark.tests import tiny

SEED = 3_000_000_019  # above 2**31, as the driver's seeds are


def test_engine_requests_repeat_and_stay_in_range():
    t = manifest.load_traffic("serve-backlog")
    a = traffic.engine_requests(t, SEED, 151_671, 65_536)
    b = traffic.engine_requests(t, SEED, 151_671, 65_536)
    assert [(r.prompt.tolist(), r.budget) for r in a] == \
        [(r.prompt.tolist(), r.budget) for r in b]
    lo, hi = t["prompt_tokens"]
    assert all(lo <= len(r.prompt) <= hi for r in a)
    assert all(151_671 <= x < 151_671 + 65_536 for r in a[:50] for x in r.prompt)
    k = t["n_slots"]
    flo, fhi = t["first_wave_budget"]
    assert all(flo <= r.budget <= fhi for r in a[:k])
    blo, bhi = t["budget"]
    assert all(blo <= r.budget <= bhi for r in a[k:])


def test_seeds_share_sizes_in_another_order():
    t = manifest.load_traffic("serve-backlog")
    a = traffic.engine_requests(t, 11, 100, 64)
    b = traffic.engine_requests(t, 12, 100, 64)
    assert sorted(len(r.prompt) for r in a) == sorted(len(r.prompt) for r in b)
    assert [len(r.prompt) for r in a] != [len(r.prompt) for r in b]
    k = t["n_slots"]  # the first wave, which sets the steady state, keeps its budgets
    assert sorted(r.budget for r in a[:k]) == sorted(r.budget for r in b[:k])


@pytest.mark.parametrize("seed", [11, SEED])
def test_streams_share_clips_in_another_order(seed):
    t = manifest.load_traffic("stream-closed")
    a = traffic.streams(t, seed, 65_536, 25)
    b = traffic.streams(t, seed + 1, 65_536, 25)
    assert sorted(len(s.ref_codes) for s in a) == sorted(len(s.ref_codes) for s in b)
    assert [s.text for s in a] != [s.text for s in b]


def test_streams_repeat_and_close_by_words():
    t = manifest.load_traffic("stream-closed")
    a = traffic.streams(t, SEED, 65_536, 25)
    b = traffic.streams(t, SEED, 65_536, 25)
    assert [(s.text, s.ref_text, s.ref_codes.tolist(), s.n_chunks) for s in a] == \
        [(s.text, s.ref_text, s.ref_codes.tolist(), s.n_chunks) for s in b]
    sents = traffic.sentences(t)
    assert all(5 <= len(s.split()) <= 25 for s in sents)
    for s in a:
        assert s.text in sents and s.ref_text in sents
        assert len(s.ref_codes) in t["clip_codes"]
        assert s.n_chunks == -(-len(s.text.split()) * 4 // 5)  # 0.4 s a word: 0.8 chunks
        assert 0 <= s.ref_codes.min() and s.ref_codes.max() < 65_536
    # every clip length comes round in each cycle of the list
    n = len(t["clip_codes"])
    assert sorted(len(s.ref_codes) for s in a[:n]) == sorted(t["clip_codes"])


def test_tiny_mixes_keep_the_mix_keys():
    for mix in ("serve-backlog", "stream-closed"):
        assert set(manifest.load_traffic(mix)) <= set(tiny.traffic(mix)) | {"name"}
