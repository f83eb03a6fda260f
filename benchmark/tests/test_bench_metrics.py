"""The metrics' arithmetic: the rate over the window, the chunk gaps' tail
with gaps still open at the close, and a stall that moves each of them; the
host-span readers' means per segment, outside the profiled sub-window."""

from __future__ import annotations

import pytest

from benchmark.harness import manifest
from benchmark.harness.record import Run
from benchmark.harness.trace import Spans


def _run(**data) -> Run:
    r = Run(cell="t", config={}, traffic={}, sizes={})
    r.data.update(data)
    return r


def read(name, run):
    return manifest.reader(name)(run)


def test_rate_over_the_window():
    r = _run(useful_tokens=90_000)
    r.window_s = 45.0
    assert read("speech_tokens_per_s", r) == pytest.approx(2000.0)
    # a stall: the same window delivers less
    r = _run(useful_tokens=45_000)
    r.window_s = 45.0
    assert read("speech_tokens_per_s", r) == pytest.approx(1000.0)
    assert read("speech_tokens_per_s", _run()) is None


def test_chunk_gap_p90_and_a_stall():
    gaps = [0.5 + 0.01 * i for i in range(80)]
    r = _run(chunk_gaps_s=gaps, open_gaps_s=[])
    assert read("chunk_gap_p90_ms", r) == pytest.approx(1e3 * (0.5 + 0.01 * 71.1))
    stalled = _run(chunk_gaps_s=gaps, open_gaps_s=[20.0] * 10)
    assert read("chunk_gap_p90_ms", stalled) > 10_000


def test_host_span_readers():
    r = _run(segment_s=[0.5, 0.7], chunk_s=[0.1, 0.3], useful_tokens=300,
             dispatched_token_slots=400)
    r.spans.seconds["engine.step_dispatch"] = [1.0, 1.4, 1.2]
    assert read("decode.segment_ms.stream", r) == pytest.approx(600.0)
    assert read("vocoder.window_ms.stream", r) == pytest.approx(200.0)
    assert read("engine.useful_share.backlog", r) == pytest.approx(75.0)
    assert read("engine.dispatch_ms.backlog", r) == pytest.approx(1200.0)
    # twice as fast a dispatch reads half, however many fit in the window
    r.spans.seconds["engine.step_dispatch"] = [0.6] * 6
    assert read("engine.dispatch_ms.backlog", r) == pytest.approx(600.0)
    assert read("setup_s", r) is None  # never 0: nothing measured, nothing reported


def test_spans_inside_the_profiler_are_marks_not_durations():
    s = Spans()
    s.open = True
    with s.span("engine.step_dispatch"):
        pass
    s.profiling = True
    with s.span("engine.step_dispatch"):
        pass
    s.profiling = False
    assert len(s.seconds["engine.step_dispatch"]) == 1
    assert [m[0] for m in s.marks] == ["engine.step_dispatch"] and s.marks[0][1] <= s.marks[0][2]
    s.open = False
    with s.span("engine.step_dispatch"):  # after the window: nothing
        pass
    assert len(s.seconds["engine.step_dispatch"]) == 1 and len(s.marks) == 1


def test_device_readers_are_silent_without_a_trace():
    r = _run()
    for m in manifest.load_manifest()["per_layer"]:
        if m["source"] == "device_trace":
            assert read(m["name"], r) is None, m["name"]
