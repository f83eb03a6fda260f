"""`decode.graph_share.stream` on synthetic traced runs: the stream's
segments that replayed a graph, an eager program's 0%, and silence without
stream segments."""

from __future__ import annotations

import pytest

from benchmark.harness import manifest
from benchmark.harness.record import Run
from benchmark.harness.trace import DeviceTrace
from neutts_tpu_torch.utils import SpanRecord

MS = 1_000_000  # ns
METRIC = "decode.graph_share.stream"


def _rec(name, a, b, **attrs):
    return SpanRecord(name, a * MS, b * MS, 0, None, 1, attrs, 0)


def _run(spans) -> Run:
    """A run whose profiled sub-window holds the program's span records."""
    r = Run(cell="stream-bf16", config={}, traffic={}, sizes={})
    r.trace = DeviceTrace(r.spans)
    r.trace.window_s = 1.0
    r.program = spans
    return r


def _segment(t, inner):
    """One stream segment at t ms, its readback after it."""
    return [_rec("decode.segment", t, t + 80), *inner(t), _rec("readback.wait", t + 80, t + 81)]


def _replayed(t):
    return [_rec("decode.replay", t + 1, t + 79, steps=25)]


def _captured(t):
    return [_rec("decode.capture", t + 1, t + 79, steps=25),
            *(_rec("decode.step", t + 2 + i, t + 3 + i) for i in range(25))]


def _eager(t):
    return [_rec("decode.step", t + 2 + 3 * i, t + 4 + 3 * i) for i in range(25)]


@pytest.mark.parametrize("inners,want", [
    ([_replayed, _replayed], 100.0),  # every segment a replay
    ([_captured, _replayed, _replayed, _replayed], 75.0),  # a capture in the sub-window
    ([_eager, _eager], 0.0),  # the host loop: no graph
])
def test_graph_share_of_stream_segments(inners, want):
    spans = [r for k, inner in enumerate(inners) for r in _segment(100 * k, inner)]
    assert manifest.reader(METRIC)(_run(spans)) == pytest.approx(want)


def test_graph_share_is_silent_without_stream_segments():
    """No trace, or a serving run's replays with no `decode.segment`: None,
    and the serving metrics keep their own reader."""
    assert manifest.reader(METRIC)(_run([])) is None
    serving = [_rec("batching.decode_steps", 0, 50, steps=32), _rec("decode.replay", 1, 49)]
    assert manifest.reader(METRIC)(_run(serving)) is None
    assert manifest.reader("decode.graph_share.backlog")(_run(serving)) == pytest.approx(100.0)
    assert manifest.reader_path(METRIC).name == "decode.graph_share.stream.py"
    assert manifest.reader_path("decode.graph_share.lfm2").name == "decode.graph_share.py"
