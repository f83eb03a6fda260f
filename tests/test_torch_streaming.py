"""The port's streaming path against the JAX package: segmented decode
(`prefill_init` / `decode_segment`), `ChunkedVocoder`, `vocoder_mode =
"chunked"` and `NeuTTS.infer_stream`, on one `save_pipeline` checkpoint
(TINY backbone, CODEC_TINY, f32).

Tolerances: greedy decoding, so tokens, `done` and `lengths` must be equal
(the two packages' random streams differ; only greedy runs can match token
for token). Waveforms are f32 in both, differing by summation order only:
1e-5, the bound of tests/test_torch_pipeline.py's infer_batch test.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from neutts_tpu import config as jcfg
from neutts_tpu.models import backbone as jbb
from neutts_tpu.models import checkpoint as jckpt
from neutts_tpu.models import codec as jcd
from neutts_tpu.pipeline import NeuTTS as JNeuTTS
from neutts_tpu.runtime import decode as jdec
from neutts_tpu.runtime.vocoder import ChunkedVocoder as JChunkedVocoder
from neutts_tpu.text.g2p import RuleG2P as JRuleG2P
from neutts_tpu_torch import NeuTTS, config
from neutts_tpu_torch.models import backbone as tbb
from neutts_tpu_torch.models.checkpoint import params_from_numpy
from neutts_tpu_torch.runtime import decode as tdec
from neutts_tpu_torch.runtime.vocoder import ChunkedVocoder
from neutts_tpu_torch.text.g2p import RuleG2P

import _torch_threads  # noqa: F401  (pins torch's threads in this process)

ATOL = 1e-5
REF_TEXT = "So I'm live on radio."
TEXT = "Hello there, this is a test."
EOS = config.TINY.layout.speech_gen_end


def _sampling(c, min_new_tokens=8, **kw):
    lay = c.TINY.layout
    return c.SamplingConfig(greedy=True, min_new_tokens=min_new_tokens,
                            **kw).constrained_to(lay)


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    """TINY with a 224-token window (a short stream) and CODEC_TINY."""
    path = tmp_path_factory.mktemp("stream_ckpt")
    cfg = jcfg.TINY.scaled(max_context=224)
    jckpt.save_pipeline(path, cfg, jbb.init_params(cfg, jax.random.PRNGKey(0)),
                        jcfg.CODEC_TINY, jcd.init_params(jcfg.CODEC_TINY, jax.random.PRNGKey(1)))
    return path


def _pair(path, **kw):
    j = JNeuTTS.from_checkpoint(path, g2p=JRuleG2P(), watermarker=None,
                                sampling=_sampling(jcfg, max_context=224),
                                streaming=jcfg.StreamingConfig(**kw))
    t = NeuTTS.from_checkpoint(path, device="cpu", g2p=RuleG2P(), watermarker=None,
                               sampling=_sampling(config, max_context=224),
                               streaming=config.StreamingConfig(**kw))
    return j, t


@pytest.fixture(scope="module")
def ref_codes():
    return np.random.default_rng(0).integers(0, 64, size=24).astype(np.int32)


# --- segmented decode ------------------------------------------------------------


@pytest.fixture(scope="module")
def jparams():
    return jbb.init_params(jcfg.TINY, jax.random.PRNGKey(2), dtype=jnp.float32)


def _segments_both(jparams, kv_dtype, max_context, segs, speech_head=False, prompts=None):
    """prefill_init, then decode_segment of each length in `segs`, in both
    packages, EOS suppressed so rows run to their caps; returns per-segment
    (tokens, done, lengths) of each."""
    jc = jcfg.TINY.scaled(kv_dtype=kv_dtype, max_context=max_context)
    tc = config.TINY.scaled(kv_dtype=kv_dtype, max_context=max_context)
    js = _sampling(jcfg, 10_000, max_context=max_context)
    ts = _sampling(config, 10_000, max_context=max_context)
    jp = jparams
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    if speech_head:
        jp, tp = jbb.add_speech_head(jc, jp), tbb.add_speech_head(tc, tp)
    prompts = prompts or [[3, 1, 4, 1, 5, 9, 2, 6, 5, 3, 5, 8, 9, 7, 9, 3], [2, 7, 1, 8]]
    jt, jl = jdec.pad_prompts(prompts, pad_id=0, bucket=16)
    tt, tl = tdec.pad_prompts(prompts, pad_id=0, bucket=16, device="cpu")
    jstate, jfirst = jdec.prefill_init(jc, js, EOS, jp, jt, jl, jax.random.PRNGKey(0))
    tstate, tfirst = tdec.prefill_init(tc, ts, EOS, tp, tt, tl)
    assert tstate.cache.max_len == jstate.cache.max_len
    jout = [(np.asarray(jfirst), np.asarray(jstate.done), np.asarray(jstate.lengths))]
    tout = [(tfirst.numpy(), tstate.done.numpy(), tstate.lengths.numpy())]
    for n in segs:
        jstate, jseg = jdec.decode_segment(jc, js, EOS, n, jp, jstate)
        tstate, tseg = tdec.decode_segment(tc, ts, EOS, n, tp, tstate)
        jout.append((np.asarray(jseg), np.asarray(jstate.done), np.asarray(jstate.lengths)))
        tout.append((tseg.numpy(), tstate.done.numpy(), tstate.lengths.numpy()))
        assert tstate.step == int(jstate.step)
    return jout, tout, tstate


@pytest.mark.parametrize("kv_dtype", ["float32", "int8", "auto"])
def test_decode_segment_matches_jax(jparams, kv_dtype):
    """Tokens, done and lengths after each segment; the two rows reach the
    window's end (224 real tokens) at different steps, the later segments
    emit EOS only. A row's length counts its closing EOS."""
    jout, tout, state = _segments_both(jparams, kv_dtype, 224, [25, 7, 100, 100, 40])
    if kv_dtype == "auto":
        assert state.cache.int4  # "auto" resolves against max_context: int4
    for (jt, jd, jl), (tt, td, tl) in zip(jout, tout):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
    assert tout[-1][1].all() and (tout[-1][0] == EOS).all()
    assert tout[-1][2].tolist() == [225 - 16, 225 - 4]  # capped by REAL length


def test_decode_segment_past_the_physical_cache(jparams):
    """max_context 256 with a full 16-token bucket: the cache has exactly
    256 slots, the real cap and the physical one meet, and a segment runs
    on past both (JAX clamps those writes; the port skips the steps)."""
    jout, tout, state = _segments_both(jparams, "float32", 256, [200, 60],
                                       prompts=[list(range(3, 19)), [2, 7, 1, 8]])
    assert state.cache.max_len == 256
    for (jt, jd, jl), (tt, td, tl) in zip(jout, tout):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_array_equal(tl, jl)
    assert tout[-1][2].tolist() == [241, 241]


def test_decode_segment_speech_head_matches_jax(jparams):
    """The first token and every later one go through the attached speech
    head when sampling is constrained to it."""
    jout, tout, _ = _segments_both(jparams, "float32", 224, [30, 30], speech_head=True)
    for (jt, jd, jl), (tt, td, tl) in zip(jout, tout):
        np.testing.assert_array_equal(tt, jt)
        np.testing.assert_array_equal(tl, jl)


def test_decode_segment_reads_nothing_from_the_device(jparams, monkeypatch):
    """A segment makes no host read: no tensor is turned into a Python
    value while it runs (the CUDA card test checks it for syncs)."""
    tc = config.TINY.scaled(kv_dtype="int8", max_context=224)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tt, tl = tdec.pad_prompts([[3, 1, 4, 1, 5], [9, 2]], pad_id=0, bucket=16, device="cpu")
    s = _sampling(config, max_context=224)
    state, _ = tdec.prefill_init(tc, s, EOS, tp, tt, tl)

    def refuse(*a, **k):
        raise AssertionError("host read inside decode_segment")

    for name in ("item", "tolist", "__bool__", "__int__", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    state, seg = tdec.decode_segment(tc, s, EOS, 12, tp, state)
    monkeypatch.undo()
    assert seg.shape == (2, 12) and state.step == 13


# --- the device-index segment over a graph's static buffers ------------------------------
#
# On a CUDA device every float or int8 segment replays `_StreamGraph`'s captured
# body; here its `run` executes the same body eagerly over the same static buffers,
# with the same copy-in and clone-out as a replay.

def _stream_model(kv_dtype, max_context=224):
    """A TINY model (bf16 weights and activations for a bf16 cache), EOS held off."""
    dtype = "bfloat16" if kv_dtype == "bfloat16" else "float32"
    tc = config.TINY.scaled(kv_dtype=kv_dtype, dtype=dtype, max_context=max_context)
    return tc, _sampling(config, 10_000, max_context=max_context), tbb.init_params(tc, seed=4,
                                                                                   device="cpu")


def _prefilled(tc, s, tp, prompts, bucket=16):
    tt, tl = tdec.pad_prompts(prompts, pad_id=0, bucket=bucket, device="cpu")
    return tdec.prefill_init(tc, s, EOS, tp, tt, tl)[0]


def _twin(state):
    """A state with copies of every tensor of `state`."""
    cache = tbb.KVCache(*(t.clone() for t in tdec._cache_tensors(state.cache)))
    return dataclasses.replace(state, cache=cache, token=state.token.clone(),
                               done=state.done.clone(), lengths=state.lengths.clone())


def _run(graph, state):
    """A replay's `run`, with the eager body in the replay's place."""
    with torch.inference_mode():
        return graph.run(state, graph.body)


def _held(graph):
    """data_ptrs of a graph's static buffers."""
    st = graph.static
    return {t.data_ptr() for t in (*tdec._cache_tensors(st.cache), graph.index,
                                   *(getattr(st, n) for n in tdec._STREAM_INPUTS))}


@pytest.mark.parametrize("kv_dtype", ["bfloat16", "int8"])
def test_stream_graph_body_matches_host_loop(kv_dtype):
    """Three 10-step segments of the device-index body over a graph's static
    buffers equal the host-index loop's: tokens, done, lengths and the cache
    bytes (int8: values and scales)."""
    tc, s, tp = _stream_model(kv_dtype)
    host = _prefilled(tc, s, tp, [[3, 1, 4, 1, 5, 9, 2, 6], [2, 7, 1]])
    dev = _twin(host)
    graph = tdec._StreamGraph(tc, s, EOS, 10, tp, dev)
    for r in range(3):
        with torch.inference_mode():
            host, want = tdec._segment_host(tc, s, EOS, 10, tp, host)
        dev, got = _run(graph, dev)
        assert torch.equal(got, want), r
        for n in ("token", "done", "lengths"):
            assert torch.equal(getattr(dev, n), getattr(host, n)), (r, n)
        assert (dev.step, dev.prompt_end) == (host.step, host.prompt_end)
        for a, b in zip(tdec._cache_tensors(dev.cache), tdec._cache_tensors(host.cache)):
            assert torch.equal(a, b), r
    assert len(tdec._cache_tensors(dev.cache)) == (4 if kv_dtype == "int8" else 2)
    assert not dev.done.any() and dev.lengths.tolist() == [31, 31]


def test_stream_graph_serves_interleaved_streams():
    """Two streams of other prompt buckets (16 and 32) take turns, segment by
    segment, on one graph: each gets the tokens, lengths and cache it gets
    alone through `decode_segment`."""
    tc, s, tp = _stream_model("bfloat16")
    alone, shared = [], []
    for prompts, bucket in (([[3, 1, 4, 1, 5]], 16), ([list(range(3, 23))], 32)):
        st = _prefilled(tc, s, tp, prompts, bucket)
        shared.append(_twin(st))
        outs = []
        for _ in range(3):
            st, out = tdec.decode_segment(tc, s, EOS, 8, tp, st)
            outs.append(out)
        alone.append((st, outs))
    graph = tdec._StreamGraph(tc, s, EOS, 8, tp, shared[0])
    got = [[], []]
    for _ in range(3):
        for j in (0, 1):
            shared[j], out = _run(graph, shared[j])
            got[j].append(out)
    for j, (st, outs) in enumerate(alone):
        assert shared[j].prompt_end == (16, 32)[j]
        assert all(torch.equal(a, b) for a, b in zip(got[j], outs)), j
        assert torch.equal(shared[j].lengths, st.lengths)
        for a, b in zip(tdec._cache_tensors(shared[j].cache), tdec._cache_tensors(st.cache)):
            assert torch.equal(a, b), j
    assert not torch.equal(got[0][0], got[1][0])


def test_stream_graph_past_the_physical_cache(jparams):
    """`test_decode_segment_past_the_physical_cache` through a graph's static
    buffers: segments of 200 and 60 steps run past the 256-slot cache, whose
    steps past its end clamp their write to the last slot and emit EOS."""
    jout, _, _ = _segments_both(jparams, "float32", 256, [200, 60],
                                prompts=[list(range(3, 19)), [2, 7, 1, 8]])
    tc = config.TINY.scaled(kv_dtype="float32", max_context=256)
    ts = _sampling(config, 10_000, max_context=256)
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jparams), "cpu")
    tt, tl = tdec.pad_prompts([list(range(3, 19)), [2, 7, 1, 8]], pad_id=0, bucket=16,
                              device="cpu")
    state, _ = tdec.prefill_init(tc, ts, EOS, tp, tt, tl)
    assert state.cache.max_len == 256
    for n, (jt, jd, jl) in zip((200, 60), jout[1:]):
        graph = tdec._StreamGraph(tc, ts, EOS, n, tp, state)
        state, seg = _run(graph, state)
        np.testing.assert_array_equal(seg.numpy(), jt)
        np.testing.assert_array_equal(state.done.numpy(), jd)
        np.testing.assert_array_equal(state.lengths.numpy(), jl)
    assert state.lengths.tolist() == [241, 241] and (seg[:, -10:] == EOS).all()


def test_stream_graph_returns_fresh_tensors():
    """No returned tensor aliases a static buffer, and a later run leaves
    an earlier run's tensors as they were (the benchmark keeps every
    segment's tokens until its window ends)."""
    tc, s, tp = _stream_model("int8")
    state = _prefilled(tc, s, tp, [[3, 1, 4, 1, 5], [9, 2]])
    graph = tdec._StreamGraph(tc, s, EOS, 6, tp, state)
    first, out = _run(graph, state)
    kept = [t.clone() for t in (out, first.token, first.done, first.lengths)]
    returned = (out, first.token, first.done, first.lengths)
    assert not _held(graph) & {t.data_ptr() for t in returned}
    assert first.cache is state.cache and first.pad is state.pad
    second, out2 = _run(graph, first)
    assert not _held(graph) & {t.data_ptr() for t in (out2, second.token, second.done,
                                                     second.lengths)}
    assert all(torch.equal(a, b) for a, b in zip(returned, kept))
    assert second.step == first.step + 6


def test_stream_graph_run_reads_nothing_from_the_device(monkeypatch):
    """Making a graph's buffers, copying a state in, filling the index, the
    body and the copy back out turn no tensor into a Python value."""
    tc, s, tp = _stream_model("bfloat16")
    state = _prefilled(tc, s, tp, [[3, 1, 4, 1, 5], [9, 2]])

    def refuse(*a, **k):
        raise AssertionError("host read inside a stream segment")

    for name in ("item", "tolist", "__bool__", "__int__", "numpy"):
        monkeypatch.setattr(torch.Tensor, name, refuse)
    graph = tdec._StreamGraph(tc, s, EOS, 12, tp, state)
    state, seg = _run(graph, state)
    monkeypatch.undo()
    assert seg.shape == (2, 12) and state.step == 13
    assert graph.index.tolist() == [16, 1]  # (slot of the first fed token, step)


# --- chunked vocoder ------------------------------------------------------------------


def test_chunked_vocoder_matches_jax():
    jp = jcd.init_params(jcfg.CODEC_TINY, jax.random.PRNGKey(3))
    tp = params_from_numpy(jax.tree_util.tree_map(np.asarray, jp), "cpu")
    jv = JChunkedVocoder(jcfg.CODEC_TINY, jp)
    tv = ChunkedVocoder(config.CODEC_TINY, tp, device="cpu")
    assert tv.window == jv.window == 82
    rng = np.random.default_rng(3)
    for n in (1, 24, 25, 73, 140):  # one window; partial; exact; several (batch bucket 8)
        codes = rng.integers(0, 65_536, n).astype(np.int32)
        want = jv(codes)
        got = tv(codes)
        assert got.shape == want.shape == (n * 480,) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=ATOL)
    with pytest.raises(ValueError, match="No valid speech tokens"):
        tv([])


def test_vocoder_mode_chunked_matches_jax(ckpt, ref_codes):
    j, t = _pair(ckpt)
    j.vocoder_mode = t.vocoder_mode = "chunked"
    want = j.infer(TEXT, ref_codes, REF_TEXT)
    got = t.infer(TEXT, ref_codes, REF_TEXT)
    assert got.shape == want.shape and got.size > 0
    np.testing.assert_allclose(got, want, atol=ATOL)


# --- infer_stream -------------------------------------------------------------------------


@pytest.mark.parametrize("first_chunk_frames", [25, 10])
def test_infer_stream_matches_jax(ckpt, ref_codes, first_chunk_frames):
    """Chunk for chunk: the same sizes and samples to 1e-5, for the default
    first chunk and the low-latency one (STREAMING_LOW_LATENCY_FIRST)."""
    j, t = _pair(ckpt, first_chunk_frames=first_chunk_frames)
    want = list(j.infer_stream(TEXT, ref_codes, REF_TEXT))
    got = list(t.infer_stream(TEXT, ref_codes, REF_TEXT))
    assert len(got) == len(want) >= 3
    for g, w in zip(got, want):
        assert g.dtype == np.float32 and g.shape == w.shape
        np.testing.assert_allclose(g, w, atol=ATOL)
    st = t.last_stats
    assert st["first_audio_s"] is not None and st["n_codes"] > 0
    assert len(st["chunk_s"]) == len(got) and len(st["segment_s"]) >= 1


def test_low_latency_first_chunk_is_smaller(ckpt, ref_codes):
    _, t25 = _pair(ckpt)
    _, t10 = _pair(ckpt, first_chunk_frames=config.STREAMING_LOW_LATENCY_FIRST)
    a = next(iter(t25.infer_stream(TEXT, ref_codes, REF_TEXT)))
    b = next(iter(t10.infer_stream(TEXT, ref_codes, REF_TEXT)))
    assert a.size == 25 * 480 and b.size == 10 * 480


def test_stream_matches_batch_duration(ckpt, ref_codes):
    """Stream and batch synthesize the same tokens under greedy decoding:
    durations agree within one chunk of samples (the stream emits whole
    frames; the batch path vocodes all frames at once; and the stream's
    cache is round_up(max_context) slots, of which the prompt bucket takes
    its share, so a long bucket ends the stream first, in both packages)."""
    _, t = _pair(ckpt)
    wav = t.infer(TEXT, ref_codes, REF_TEXT)
    stream = np.concatenate(list(t.infer_stream(TEXT, ref_codes, REF_TEXT)))
    assert np.isfinite(stream).all()
    assert abs(stream.size - wav.size) <= 480 * 31
    assert 0 < t.last_stats["n_codes"] * 480 <= wav.size


def test_streaming_config_copy_matches_jax():
    assert dataclasses.asdict(config.STREAMING) == dataclasses.asdict(jcfg.STREAMING)
    assert config.STREAMING_LOW_LATENCY_FIRST == jcfg.STREAMING_LOW_LATENCY_FIRST
