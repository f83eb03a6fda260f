"""A segment as one CUDA graph: the capture, replay and launch that the
serving segment (`batching._SegmentGraph`), the serving admission
(`batching._AdmitGraph`) and the stream segment (`decode._StreamGraph`)
share.

A segment's body runs over static buffers of its own. The first call of a
graph runs the body eagerly, which is the call's result, then captures it;
every later call replays the capture. First calls, captures and replays
run on one side stream per device, ordered after the caller's stream's
queued work and before its later work. The body's host ints are the same
in every call, and all that changes lives on the device.

Spans (`neutts_tpu_torch.utils`): a replay is one `<kind>.replay`, a first
call's run and capture one `<kind>.capture`: `decode.*` with attribute
`steps` for segments, `admit.*` with `rows` and `bucket` for admissions;
the captured body records none.
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from neutts_tpu_torch.config import SamplingConfig
from neutts_tpu_torch.ops import _build
from neutts_tpu_torch.utils import span

_capture_streams: Dict[int, "torch.cuda.Stream"] = {}  # device index -> capture stream


def _capture_stream(dev: torch.device) -> "torch.cuda.Stream":
    """The device's side stream for every graph's first call, capture and
    replay. A capture must run on a stream other than the default one; the
    replays run on the capture's stream, so the split-K workspace the graph
    baked in (`attention._split_workspace`, keyed by stream) is used by
    launches of that stream alone, in order."""
    s = _capture_streams.get(dev.index)
    if s is None:
        s = _capture_streams[dev.index] = torch.cuda.Stream(dev)
    return s


def supported(sampling: SamplingConfig) -> bool:
    """Greedy decoding draws no noise; sampling needs the generator
    registered with the graph, which this PyTorch may not offer."""
    return sampling.greedy or hasattr(torch.cuda.CUDAGraph, "register_generator_state")


class SegmentGraph:
    """A segment body over static buffers, replayable as one CUDA graph.

    A subclass makes the buffers, `static` among them (whose `generator`
    the body samples from), and gives `body(traced)`, the segment over the
    buffers, and `run(state, segment, *inputs)`, which copies a call's
    state and inputs into the buffers, calls `segment` (the body or a
    replay) and returns (state, out) with the state's `outputs` fields and
    out (a tensor, or None) new tensors that alias no buffer. The body
    bakes in `args` (config, sampling config, eos_id, then the subclass's
    own); `attrs` are its spans' attributes. `pool`: a memory pool handle
    shared with graphs that never replay at once (None: a pool of its own).
    `launches` holds the kernel wrappers' launches of one replay
    (`_build.launches`)."""

    kind = "decode"  # the spans' prefix
    outputs: Tuple[str, ...] = ()
    pool = None

    def __init__(self, *args, **attrs):
        self.args, self.attrs = args, attrs
        self.graph = None
        self.result = None  # the captured body's tensors
        self.launches: Dict[str, int] = {}

    def launch(self, state, segment, *inputs):
        """`run` on the device's capture stream, after the caller's stream's
        queued work and before its later work."""
        dev = state.token.device
        stream, here = _capture_stream(dev), torch.cuda.current_stream(dev)
        stream.wait_stream(here)
        with torch.cuda.stream(stream):
            state, out = self.run(state, segment, *inputs)
        here.wait_stream(stream)
        for t in (out, *(getattr(state, n) for n in self.outputs)):
            if t is not None:
                t.record_stream(here)
        return state, out

    def _replayed(self):
        self.graph.replay()
        for name, n in self.launches.items():
            _build.launches[name] += n
        return self.result

    def replay(self, state, *inputs):
        """A later call: the capture's replay, through `launch`."""
        with torch.cuda.device(state.token.device), span(f"{self.kind}.replay", **self.attrs):
            return self.launch(state, self._replayed, *inputs)

    def capture(self, state, *inputs):
        """The first call: one eager segment on the capture stream, which
        allocates the split-K workspace and the BLAS handle's workspace
        outside the graph's pool and is the call's result; then the body's
        capture. Non-greedy sampling registers the generator, so each
        replay draws fresh noise. The capture launches nothing, so the
        wrappers' counts of it move to the replays."""
        dev = state.token.device
        with torch.cuda.device(dev), span(f"{self.kind}.capture", **self.attrs):
            result = self.launch(state, lambda: self.body(traced=True), *inputs)
            # a graph's pool cannot take blocks the caching allocator holds
            # free (after an LFM2 admission, tens of GB): hand them back first
            # (once a graph)
            torch.cuda.empty_cache()
            graph = torch.cuda.CUDAGraph()
            if not self.args[1].greedy:
                graph.register_generator_state(self.static.generator)
            before = dict(_build.launches)
            with torch.cuda.stream(_capture_stream(dev)):
                # thread-local: other threads' CUDA calls may go on during the capture
                graph.capture_begin(pool=self.pool, capture_error_mode="thread_local")
                try:
                    self.result = self.body()
                finally:
                    graph.capture_end()
            for name, n in _build.launches.items():
                if n != before[name]:
                    self.launches[name] = n - before[name]
                    _build.launches[name] = before[name]
            self.graph = graph
        return result
