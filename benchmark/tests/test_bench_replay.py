"""The reader of the serving segment's CUDA graph (`decode.graph_share`) on
synthetic span records of a traced run."""

from __future__ import annotations

import pytest

from benchmark.harness import manifest
from benchmark.harness.record import Run
from benchmark.tests.test_bench_program import KERNELS, MARKS, _rec, _traced_run

SHARE = "decode.graph_share.backlog"
# two dispatches: the first segment replayed its graph (0.4 ms), the second
# ran eagerly (a generator that could not be registered); a collect between
REPLAYED = [_rec("engine.dispatch", 0, 50), _rec("batching.decode_steps", 41, 49, steps=32),
            _rec("decode.replay", 41, 41.4, steps=32), _rec("engine.collect", 50, 60),
            _rec("engine.dispatch", 60, 110), _rec("batching.decode_steps", 61, 99, steps=32),
            _rec("decode.step", 61, 80), _rec("decode.step", 80, 99)]


def test_graph_share_on_a_synthetic_run():
    assert manifest.reader(SHARE)(_traced_run(MARKS, KERNELS, REPLAYED)) == pytest.approx(50.0)
    every = [x for x in REPLAYED if x.name != "decode.step"]
    every.append(_rec("decode.replay", 61, 61.6, steps=32))
    assert manifest.reader(SHARE)(_traced_run(MARKS, KERNELS, every)) == pytest.approx(100.0)


def test_an_eager_program_reads_a_zero_share():
    """Segments without a replay, as a program without the graph path runs
    them: a share of 0."""
    eager = [x for x in REPLAYED if x.name != "decode.replay"]
    assert manifest.reader(SHARE)(_traced_run(MARKS, KERNELS, eager)) == 0.0


def test_graph_share_is_silent_without_segments_or_a_trace():
    untraced = Run(cell="t", config={}, traffic={}, sizes={})
    assert manifest.reader(SHARE)(untraced) is None
    assert manifest.reader(SHARE)(_traced_run(MARKS, KERNELS, [])) is None
