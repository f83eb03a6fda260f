"""The reader of the serving admission's CUDA graphs (`engine.admit_graph_share`)
on synthetic span records of a traced run: replayed groups, a capture in the
sub-window, an eager program's 0%, and silence without admissions."""

from __future__ import annotations

import pytest

from benchmark.harness import manifest
from benchmark.harness.record import Run
from benchmark.tests.test_bench_program import KERNELS, MARKS, _rec, _traced_run


def _group(t, inner, rows=4, bucket=448):
    """One prefill group at t ms and what ran inside it."""
    attrs = {"rows": rows, "bucket": bucket}
    inside = {"replay": [_rec("admit.replay", t + 1, t + 2, **attrs)],
              "capture": [_rec("admit.capture", t + 1, t + 8, **attrs)],
              "eager": []}[inner]
    return [_rec("engine.prefill_group", t, t + 9, rows=rows, bucket=bucket,
                 real_tokens=rows * 400), *inside]


def _dispatch(inners):
    spans = [_rec("engine.dispatch", 0, 50), _rec("engine.admit", 0, 40)]
    for k, inner in enumerate(inners):
        spans += _group(10 * k, inner)
    return spans + [_rec("batching.decode_steps", 41, 49, steps=32),
                    _rec("decode.replay", 41, 42, steps=32)]


@pytest.mark.parametrize("inners,want", [
    (["replay", "replay", "replay"], 100.0),  # every group a replay
    (["capture", "replay", "replay", "replay"], 75.0),  # a shape's first group in the sub-window
    (["eager", "eager"], 0.0),  # a program without admission graphs
])
@pytest.mark.parametrize("cell", ["backlog", "lfm2", "multichip"])
def test_admit_graph_share(inners, want, cell):
    run = _traced_run(MARKS, KERNELS, _dispatch(inners))
    assert manifest.reader(f"engine.admit_graph_share.{cell}")(run) == pytest.approx(want)
    assert manifest.reader_path(f"engine.admit_graph_share.{cell}").name == \
        "engine.admit_graph_share.py"


def test_admit_graph_share_is_silent_without_admissions_or_a_trace():
    """No trace, or a traced run whose ticks admitted nothing: None; the
    segments' replays are not admissions."""
    share = manifest.reader("engine.admit_graph_share.backlog")
    assert share(Run(cell="t", config={}, traffic={}, sizes={})) is None
    assert share(_traced_run(MARKS, KERNELS, _dispatch([]))) is None
    assert manifest.reader("decode.graph_share.backlog")(
        _traced_run(MARKS, KERNELS, _dispatch(["eager"]))) == pytest.approx(100.0)
