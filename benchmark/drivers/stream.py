"""Streaming cells: one interactive user, `NeuTTS.infer_stream`, in a closed
loop: a stream begins when the last one closed. Each stream takes its
reference clip, the clip's transcript and a sentence from the mix, and is
closed after the mix's number of chunks for the sentence (random weights
emit no end of speech; `min_new_tokens` holds EOS off past that point).

The first chunk's time runs from the call to `infer_stream` to the chunk's
delivery; a chunk gap from one delivery to the next in the same stream.

Set-up makes the model, warms the prefill at every prompt bucket the mix's
streams use, and runs one whole stream (the decode segment and the
vocoder's windows). The window opens as the next stream begins. A traced
run profiles `trace_chunks` chunks of the first stream long enough to hold
them, from its second chunk on.

The harness keeps what each stream decoded, for the check, by wrapping the
decode runtime's `prefill_init` and `decode_segment` (their outputs are
device tensors the program does not write again).
"""

from __future__ import annotations

import gc
import math
import time
from typing import Dict, List

import numpy as np
import torch

from benchmark.harness import check, counts, model, weights
from benchmark.harness import traffic as trafficlib
from benchmark.harness.record import Run
from benchmark.harness.trace import DeviceTrace


class _Tap:
    """Keeps the tokens each stream's decode produced (device tensors, read
    after the window), and the inputs of the decode segments run while the
    device trace is on."""

    def __init__(self):
        from neutts_tpu_torch.runtime import decode as dec

        self.mod = dec
        self.orig = (dec.prefill_init, dec.decode_segment)
        self.current: Dict[str, object] = {}
        self.watch = False
        self.segments: List[tuple] = []  # (n_steps, step, prompt_end, pad)
        self.prefills: List[tuple] = []  # (true lens)

    def new_stream(self) -> Dict[str, object]:
        self.current = {"prompt": None, "first": None, "segments": []}
        return self.current

    def __enter__(self):
        pre, seg = self.orig

        def prefill_init(cfg, sampling, eos_id, params, tokens, prompt_lens, generator=None):
            state, first = pre(cfg, sampling, eos_id, params, tokens, prompt_lens, generator)
            self.current["prompt"] = (tokens, prompt_lens)
            self.current["first"] = first
            if self.watch:
                self.prefills.append(prompt_lens)
            return state, first

        def decode_segment(cfg, sampling, eos_id, n_steps, params, state):
            if self.watch:
                self.segments.append((n_steps, state.step, state.prompt_end, state.pad))
            state, out = seg(cfg, sampling, eos_id, n_steps, params, state)
            self.current["segments"].append(out)
            return state, out

        self.mod.prefill_init, self.mod.decode_segment = prefill_init, decode_segment
        return self

    def __exit__(self, *exc):
        self.mod.prefill_init, self.mod.decode_segment = self.orig

    def counts(self, m: dict, head_columns: int) -> Dict[str, float]:
        L = m["num_hidden_layers"]
        flops = attn_bytes = 0.0
        decoded = 0
        for S, step, Lp, pad in self.segments:
            real0 = Lp - int(pad.cpu()[0])  # real tokens before the first fed one
            # step i feeds the token at slot Lp + step + i - 1 and attends
            # [pad, that slot]: real0 + step + i tokens
            keys = sum(real0 + step + i for i in range(S))
            decoded += S
            flops += S * counts.dense_flops_per_token(m, head_columns)
            flops += counts.attention_flops(m, keys)
            attn_bytes += L * counts.decode_attention_bytes(m, keys, S)
        for lens in self.prefills:
            n = float(lens.cpu()[0])
            flops += n * counts.dense_flops_per_token(m, 0) + 2.0 * m["hidden_size"] * head_columns
            flops += counts.attention_flops(m, counts.prefill_attention_keys(n))
        return {"model_flops": flops, "decode_attention_bytes": attn_bytes,
                "decoded_rows": decoded}


def build(c: dict, seed: int, device):
    from neutts_tpu_torch.audio.watermark import SpreadSpectrumWatermarker
    from neutts_tpu_torch.config import StreamingConfig
    from neutts_tpu_torch.pipeline import NeuTTS
    from neutts_tpu_torch.text.g2p import RuleG2P

    model.set_precision_flags(c)
    cfg = model.backbone_config(c)
    ccfg = model.codec_config(c)
    if c["weights"] != "bf16" or c["watermark"] != "spread-spectrum":
        raise ValueError(f"{c['name']}: the stream driver runs bf16 weights with the "
                         "spread-spectrum watermark")
    params = weights.backbone_params(model.sizes(c), seed, device, model.weight_dtype(c))
    codec_params = weights.codec_decoder_params(c["codec"], seed, device)
    sampling = model.sampling_config(c, cfg, min_new_tokens=c["sampling"]["min_new_tokens"])
    return NeuTTS(cfg, params, ccfg, codec_params, g2p=RuleG2P(),
                  watermarker=SpreadSpectrumWatermarker(), sampling=sampling,
                  streaming=StreamingConfig(**c["streaming"]), device=device,
                  seed=int(seed) % (1 << 63))


def warm_up(tts, items) -> None:
    """The prefill at every prompt bucket of the mix's streams (the whole
    stream that set-up runs next warms the decode segment and the vocoder)."""
    from neutts_tpu_torch.runtime import decode as dec
    from neutts_tpu_torch.text import prompt as prompt_lib

    pad_id = getattr(tts.tokenizer, "pad_id", 0)
    eos = tts.backbone_cfg.layout.speech_gen_end
    seen = set()
    for it in items:
        p = prompt_lib.build_prompt_ids(tts.tokenizer, tts.g2p, it.ref_codes.tolist(),
                                        it.ref_text, it.text)
        b = dec.bucket_length(len(p))
        if b in seen:
            continue
        seen.add(b)
        toks, lens = dec.pad_prompts([p], pad_id=pad_id, bucket=b, device=tts.device)
        dec.prefill_init(tts.backbone_cfg, tts.sampling, eos, tts.backbone_params, toks, lens)
    if tts.device.type == "cuda":
        torch.cuda.synchronize(tts.device)


def run(cell, seed: int, seconds: float, trace: bool, device, t_start: float) -> Run:
    c, t = cell.config, cell.traffic
    rec = Run(cell=cell.name, config=c, traffic=t, sizes=model.sizes(c))
    tts = build(c, seed, device)
    lay = tts.backbone_cfg.layout
    s = tts.streaming
    items = trafficlib.streams(t, seed, lay.codebook_size, s.frames_per_chunk)
    warm_up(tts, items)
    spans = rec.spans
    clock = time.perf_counter
    is_cuda = tts.device.type == "cuda"
    tracer = DeviceTrace(spans) if trace and is_cuda else None
    trace_chunks = int(t.get("trace_chunks", 2))
    done: List[dict] = []
    tap = _Tap()

    def stage_counts():
        st = tts.last_stats
        return len(st["segment_s"]), len(st["chunk_s"])

    def stop_trace(rec_s):
        tap.watch = False
        tracer.stop()
        tracer.notes.update(tap.counts(rec.sizes, c["vocab_size"]))
        rec_s["traced"] = (rec_s["traced"], stage_counts())

    def one_stream(it, t_close=None, trace_from=None):
        """Runs a stream until its chunks are out or the window closes."""
        rec_s = {"item": it, "tap": tap.new_stream(), "t_call": clock(), "chunks": [],
                 "times": [], "traced": None}
        gen = tts.infer_stream(it.text, it.ref_codes, it.ref_text)
        try:
            while len(rec_s["chunks"]) < it.n_chunks:
                if tracer is not None and trace_from is not None and \
                        len(rec_s["chunks"]) == trace_from and tracer.window_s is None:
                    rec_s["traced"] = stage_counts()
                    tracer.start()
                    tap.watch = True
                with spans.span("stream.next_chunk"):
                    ch = next(gen, None)
                now = clock()
                if ch is None:
                    break
                rec_s["chunks"].append(ch)
                rec_s["times"].append(now)
                if tap.watch and len(rec_s["chunks"]) == trace_from + trace_chunks:
                    stop_trace(rec_s)
                if t_close is not None and now >= t_close:
                    break
        finally:
            gen.close()
            if tap.watch:  # the stream ended inside the traced chunks
                stop_trace(rec_s)
        rec_s["stats"] = dict(tts.last_stats)
        return rec_s

    with tap:
        one_stream(items[0])  # a whole stream in set-up
        k = 1
        gc.freeze()  # set-up's objects stay out of the window's collections
        t_open = clock()
        rec.setup_s = t_open - t_start
        t_close = t_open + seconds
        spans.open = True
        while clock() < t_close:
            if k >= len(items):
                raise RuntimeError(f"{t['name']}: the stream list ran out; raise n_streams")
            it = items[k]
            k += 1
            # trace the middle of the first stream long enough to hold it
            tf = None
            if tracer is not None and tracer.window_s is None and \
                    it.n_chunks >= 2 + trace_chunks:
                tf = 1
            done.append(one_stream(it, t_close, tf))
        t_end = clock()
        spans.open = False
    rec.window_s = t_close - t_open
    rec.data["t_close"] = t_close
    rec.data["t_end"] = t_end
    _summarise(rec, done, t_close)
    if tracer is not None:
        tracer.finish()
    rec.trace = tracer
    if is_cuda:
        torch.cuda.synchronize(tts.device)
        rec.memory_peak_bytes = int(torch.cuda.max_memory_allocated(tts.device))
    # what the check reads, on the host; then the program is freed
    rec.data["check_streams"] = [_served(r, lay) for r in done]
    rec.failed = sum(1 for r in done if not _audio_ok(r))
    rec.attempted = len(done)
    del tts, tap
    gc.unfreeze()
    gc.collect()
    if is_cuda:
        torch.cuda.empty_cache()
    return rec


def _audio_ok(r: dict) -> bool:
    return all(isinstance(ch, np.ndarray) and ch.dtype == np.float32 and ch.ndim == 1
               and ch.size > 0 and np.isfinite(ch).all() for ch in r["chunks"])


def _summarise(rec: Run, done: List[dict], t_close: float) -> None:
    first, gaps, open_gaps, open_first = [], [], [], []
    prompt_s, prefill_s, segment_s, chunk_s = [], [], [], []
    for r in done:
        st = r["stats"]
        times = r["times"]
        if times:
            first.append(times[0] - r["t_call"])
        else:
            open_first.append(t_close - r["t_call"])
        gaps += [b - a for a, b in zip(times, times[1:])]
        if times and len(times) < r["item"].n_chunks and times[-1] < t_close:
            open_gaps.append(t_close - times[-1])
        prompt_s.append(st.get("prompt_s", 0.0))
        prefill_s.append(st.get("prefill_s", 0.0))
        seg, ch = list(st.get("segment_s", [])), list(st.get("chunk_s", []))
        if r["traced"] is not None:  # the stages the profiler saw are left out
            (s0, c0), (s1, c1) = r["traced"]
            seg, ch = seg[:s0] + seg[s1:], ch[:c0] + ch[c1:]
        segment_s += seg
        chunk_s += ch
    rec.data.update(first_audio_s=first, open_first_s=open_first, chunk_gaps_s=gaps,
                    open_gaps_s=open_gaps, prompt_s=prompt_s, prefill_s=prefill_s,
                    segment_s=segment_s, chunk_s=chunk_s, streams=len(done))


def _served(r: dict, lay) -> dict:
    """A stream's prompt ids, served tokens (the first and every segment's,
    each to its first EOS), their codes, and the audio it yielded."""
    tap = r["tap"]
    toks, lens = tap["prompt"]
    n = int(lens.cpu()[0])
    prompt = toks[0, toks.shape[1] - n:].cpu().tolist()
    first = [int(tap["first"].cpu()[0])]
    segs = [x[0].cpu().tolist() for x in tap["segments"]]
    eos = lay.speech_gen_end
    served, ended = [], False
    for part in [first] + segs:
        for tok in part:
            if tok == eos:
                ended = True
                break
            served.append(tok)
        if ended:
            break

    def codes(part):
        return [tk - lay.speech_base for tk in part if 0 <= tk - lay.speech_base
                < lay.codebook_size]

    return {"prompt": prompt, "served": served, "ref_codes": r["item"].ref_codes.tolist(),
            "first": codes(first), "segments": [codes(p) for p in segs],
            "ended": ended, "chunks": r["chunks"]}


def compare(rec: Run, seed: int, device, control: dict | None = None) -> Dict[str, float]:
    c = rec.config
    streams = rec.data["check_streams"]
    if not streams:
        return {"token_gap": math.inf, "wave_gap": math.inf}
    raw = weights.backbone_params(rec.sizes, seed, device, model.weight_dtype(c))
    base = c["text_tokens"] + c["special_tokens"]
    bad_prompt = any(
        s["prompt"][-len(s["ref_codes"]) - 1:] != [base - 2] + [base + x for x in s["ref_codes"]]
        for s in streams)
    out = check.token_gaps(rec.sizes, raw, [(s["prompt"], s["served"]) for s in streams],
                           check.reference_precision(c), base, c["vocab_size"],
                           control=control)
    if bad_prompt:  # the prompt must end in <|SPEECH_GENERATION_START|> and the clip's codes
        out["token_gap"] = math.inf
    del raw
    dec = weights.codec_decoder_params(c["codec"], seed, device)["dec"]
    out.update(check.wave_gap(c["codec"], dec, streams, c["streaming"]))
    if control is not None:
        ctl = [dict(s, chunks=None) for s in streams]
        from benchmark.reference.audio import stream_chunks
        from benchmark.reference.codec import decode as ref_decode

        with check.float32_exact(tf32=True):
            for s, orig in zip(ctl, streams):
                s["chunks"] = stream_chunks(
                    s["ref_codes"], s["first"], s["segments"], len(orig["chunks"]),
                    lambda cd: ref_decode(c["codec"], dec, cd).cpu().numpy(), c["streaming"],
                    c["codec"]["hop_out"], s["ended"])
        out["control_wave_gap"] = check.wave_gap(c["codec"], dec, ctl,
                                                 c["streaming"])["wave_gap"]
    return out
