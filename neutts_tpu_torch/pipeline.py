"""Public synthesis API of the PyTorch/CUDA port: `NeuTTS` (port of
`neutts_tpu.pipeline.NeuTTS`).

  * `infer` / `infer_batch`: text + reference codes/text -> G2P -> prompt
    ids -> left-padded bucket -> runtime.decode.generate (prefill + decode
    loop with sampling) -> speech codes -> vocoder -> watermark -> waveform;
  * `infer_stream`: the same prompt, prefilled once, then decoded one
    segment per chunk (runtime.decode.decode_segment) and vocoded in the
    reference's windows (lookback 50, chunk 25, lookforward 5, overlap 1),
    joined by a streaming overlap-add;
  * `encode_reference`: a 16 kHz mono clip -> codec codes (voice cloning).

Every entry point takes `device=` and defaults to "cuda": without a GPU the
default raises, and only an explicit device="cpu" runs on the CPU (where
each kernel runs its plain PyTorch version).
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Generator, List, Optional, Sequence

import numpy as np
import torch

from neutts_tpu_torch import config as cfglib
from neutts_tpu_torch.audio import io as audio_io
from neutts_tpu_torch.audio import mel
from neutts_tpu_torch.audio.overlap_add import StreamingOverlapAdd
from neutts_tpu_torch.audio.watermark import get_watermarker
from neutts_tpu_torch.models import backbone as bb
from neutts_tpu_torch.models import checkpoint as ckpt
from neutts_tpu_torch.models import codec as cd
from neutts_tpu_torch.runtime import decode as dec
from neutts_tpu_torch.runtime.vocoder import ChunkedVocoder, ExactVocoder
from neutts_tpu_torch.text import g2p as g2p_lib
from neutts_tpu_torch.text import prompt as prompt_lib
from neutts_tpu_torch.text.tokenizer import ByteTokenizer, extract_speech_codes


def resolve_device(device) -> torch.device:
    """The device to run on; a CUDA device without a usable GPU raises
    instead of falling back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "NeuTTS runs on a CUDA device by default and none is available; "
            "pass device='cpu' to run on the CPU")
    return dev


class NeuTTS:
    """End-to-end voice-cloning TTS pipeline on a CUDA GPU (or the CPU)."""

    def __init__(
        self,
        backbone_cfg: cfglib.BackboneConfig,
        backbone_params,
        codec_cfg: cfglib.CodecConfig,
        codec_params,
        tokenizer=None,
        g2p=None,
        watermarker="auto",
        sampling: Optional[cfglib.SamplingConfig] = None,
        streaming: cfglib.StreamingConfig = cfglib.STREAMING,
        quantize: Optional[str] = None,  # None | "int8" — W8A8 backbone weights
        device="cuda",
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r} (expected None or 'int8')")
        backbone_params = bb.prepare_params(backbone_params, self.device)
        if quantize == "int8" and not bb.quantized_weights(backbone_params):
            backbone_params = bb.quantize_params(backbone_params)
        self.backbone_cfg = backbone_cfg
        self.backbone_params = backbone_params
        self.codec_cfg = codec_cfg
        self.codec_params = ckpt.tree_to(codec_params, self.device)
        self.tokenizer = tokenizer or ByteTokenizer(backbone_cfg.layout)
        self.g2p = g2p or g2p_lib.get_g2p()
        self.watermarker = get_watermarker() if watermarker == "auto" else watermarker
        self.sampling = sampling or cfglib.SamplingConfig(max_context=backbone_cfg.max_context)
        self.streaming = streaming
        self._vocoder_exact = ExactVocoder(codec_cfg, self.codec_params, device=self.device)
        self._vocoder_chunked = ChunkedVocoder(codec_cfg, self.codec_params, streaming,
                                               device=self.device)
        self.vocoder_mode = "exact"  # "exact" (bucketed) | "chunked" (windows)
        self.sample_rate = codec_cfg.sample_rate_out  # 24_000
        self.hop_length = codec_cfg.hop_out  # 480
        self.max_context = backbone_cfg.max_context  # 2048
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._eos = self.tokenizer.layout.speech_gen_end
        # what the last infer_batch, infer_stream or encode_reference did:
        # sizes and per-stage seconds (each stage ends in a host read)
        self.last_stats: dict = {}

    # --- constructors -----------------------------------------------------------

    @classmethod
    def initialize_random(
        cls,
        backbone_cfg: cfglib.BackboneConfig = cfglib.TINY,
        codec_cfg: cfglib.CodecConfig = cfglib.CODEC_TINY,
        seed: int = 0,
        device="cuda",
        **kw,
    ) -> "NeuTTS":
        """Seeded random weights made on `device` (synthetic models: tests,
        benches). Its random streams differ from the JAX package's."""
        dev = resolve_device(device)
        return cls(
            backbone_cfg, bb.init_params(backbone_cfg, seed=2 * seed, device=dev),
            codec_cfg, cd.init_params(codec_cfg, seed=2 * seed + 1, device=dev),
            device=dev, seed=seed, **kw,
        )

    @classmethod
    def from_checkpoint(cls, path: str | Path, device="cuda", **kw) -> "NeuTTS":
        """Load a checkpoint directory written by either package's
        `save_pipeline` (or by `models.convert_cli`)."""
        dev = resolve_device(device)
        backbone_cfg, backbone_params, codec_cfg, codec_params = ckpt.load_pipeline(path, dev)
        return cls(backbone_cfg, backbone_params, codec_cfg, codec_params, device=dev, **kw)

    # --- helpers ----------------------------------------------------------------

    def _codes_to_list(self, ref_codes) -> List[int]:
        if isinstance(ref_codes, torch.Tensor):
            ref_codes = ref_codes.detach().cpu().numpy()
        return [int(c) for c in np.asarray(ref_codes).reshape(-1)]

    def _build_prompt(self, text: str, ref_codes, ref_text: str) -> List[int]:
        return prompt_lib.build_prompt_ids(
            self.tokenizer, self.g2p, self._codes_to_list(ref_codes), ref_text, text
        )

    def _pick_bucket(self, longest: int) -> int:
        """Smallest padding bucket that still leaves generation room; near
        the window edge, the exact prompt length rounded up to even while
        that fits under max_context."""
        def even(n: int) -> int:
            return n + (n & 1) if n + (n & 1) < self.max_context else n

        try:
            b = dec.bucket_length(longest)
        except ValueError:
            return even(longest)
        return b if b < self.max_context else even(longest)

    def _vocode(self, codes: Sequence[int]) -> np.ndarray:
        if len(codes) == 0:
            raise ValueError("No valid speech tokens found in the output.")
        if self.vocoder_mode == "chunked":
            return self._vocoder_chunked(codes)
        return self._vocoder_exact(codes)

    def _watermark(self, wav: np.ndarray) -> np.ndarray:
        if self.watermarker is None:
            return wav
        return self.watermarker.apply_watermark(wav, sample_rate=self.sample_rate)

    # --- public API ---------------------------------------------------------------

    def infer(self, text: str, ref_codes, ref_text: str) -> np.ndarray:
        """Synthesize `text` in the reference speaker's voice. [T@24k] f32."""
        return self.infer_batch([text], [ref_codes], [ref_text])[0]

    def infer_batch(self, texts: Sequence[str], ref_codes_batch: Sequence,
                    ref_texts: Sequence[str]) -> List[np.ndarray]:
        """Batched synthesis: one prefill and one decode loop for N utterances."""
        prompts = [
            self._build_prompt(t, rc, rt)
            for t, rc, rt in zip(texts, ref_codes_batch, ref_texts)
        ]
        pad_id = getattr(self.tokenizer, "pad_id", 0)
        longest = max(len(p) for p in prompts)
        if longest >= self.max_context:
            raise ValueError(
                f"prompt of {longest} tokens does not fit the {self.max_context}-token "
                "context window; shorten the input text or the reference clip")
        bucket = self._pick_bucket(longest)
        toks, lens = dec.pad_prompts(prompts, pad_id=pad_id, bucket=bucket, device=self.device)
        # budget by REAL length (per-row caps in generate stop each row at
        # max_context), rounded up to 256 as the JAX package does
        max_new = min(
            cfglib.round_up(self.max_context - min(len(p) for p in prompts), 256),
            self.max_context - 1,
        )
        result = dec.generate(self.backbone_cfg, self.sampling, self._eos, max_new,
                              self.backbone_params, toks, lens, self._generator)
        t0 = time.perf_counter()
        wavs, all_codes = [], []
        for i in range(len(prompts)):
            codes = extract_speech_codes(dec.extract(result, i, self._eos),
                                         self.tokenizer.layout)
            all_codes.append(codes)
            wavs.append(self._watermark(self._vocode(codes)))
        self.last_stats = {
            "bucket": bucket,
            "steps": result.steps,
            "codes": all_codes,
            "n_codes": [len(c) for c in all_codes],
            "prefill_s": result.prefill_s,
            "decode_s": result.decode_s,
            "vocode_s": time.perf_counter() - t0,
        }
        return wavs

    def infer_stream(self, text: str, ref_codes, ref_text: str
                     ) -> Generator[np.ndarray, None, None]:
        """Streaming synthesis with the reference's chunk geometry: a chunk
        of `frames_per_chunk` frames (the first of `first_chunk_frames`) is
        vocoded once `lookforward` frames past it are decoded, in a window
        with `lookback` frames of context, and joined by overlap-add.
        Yields float32 chunks at 24 kHz. `last_stats` fills as it runs."""
        t_call = time.perf_counter()
        s = self.streaming
        lay = self.tokenizer.layout
        prompt = self._build_prompt(text, ref_codes, ref_text)
        pad_id = getattr(self.tokenizer, "pad_id", 0)
        if len(prompt) >= self.max_context:
            raise ValueError(f"prompt of {len(prompt)} tokens does not fit the "
                             f"{self.max_context}-token context window")
        bucket = self._pick_bucket(len(prompt))
        toks, lens = dec.pad_prompts([prompt], pad_id=pad_id, bucket=bucket, device=self.device)
        stats = {"bucket": bucket, "prompt_s": time.perf_counter() - t_call, "prefill_s": 0.0,
                 "segment_s": [], "chunk_s": [], "first_audio_s": None, "n_codes": 0}
        self.last_stats = stats

        t0 = time.perf_counter()
        state, first = dec.prefill_init(self.backbone_cfg, self.sampling, self._eos,
                                        self.backbone_params, toks, lens, self._generator)
        first_tok = int(first[0])  # the host read that ends the prefill
        stats["prefill_s"] = time.perf_counter() - t0
        ref_code_list = self._codes_to_list(ref_codes)
        token_cache: List[int] = list(ref_code_list)  # codes incl. the reference's
        if first_tok != self._eos:
            c = first_tok - lay.speech_base
            if 0 <= c < lay.codebook_size:
                token_cache.append(c)

        n_decoded = len(ref_code_list)
        ola = StreamingOverlapAdd(stride=s.stride_samples)
        # the first chunk may be smaller than the steady cadence: first audio
        # after cf + lookforward frames instead of 25 + 5
        cf = min(s.first_chunk_frames, s.frames_per_chunk)
        seg_steps = cf + s.lookforward if cf < s.frames_per_chunk else s.frames_per_chunk

        def vocode_window(start: int, end: int, lo_emit: int, n_frames: int) -> np.ndarray:
            wav = self._watermark(self._vocode(token_cache[start:end]))
            a = (lo_emit - start) * self.hop_length
            return wav[a : a + n_frames * self.hop_length]

        def emitted(out: np.ndarray) -> np.ndarray:
            if stats["first_audio_s"] is None:
                stats["first_audio_s"] = time.perf_counter() - t_call
                stats["first_audio_segments"] = len(stats["segment_s"])
            return out

        while not bool(state.done[0]):  # one host read per segment
            t0 = time.perf_counter()
            state, seg = dec.decode_segment(self.backbone_cfg, self.sampling, self._eos,
                                            seg_steps, self.backbone_params, state)
            seg_np = seg[0].cpu().numpy()
            stats["segment_s"].append(time.perf_counter() - t0)
            for t in seg_np:
                t = int(t)
                if t == self._eos:
                    break
                c = t - lay.speech_base
                if 0 <= c < lay.codebook_size:
                    token_cache.append(c)
            while len(token_cache) - n_decoded >= cf + s.lookforward:
                t0 = time.perf_counter()
                start = max(n_decoded - s.lookback - s.overlap_frames, 0)
                end = n_decoded + cf + s.lookforward + s.overlap_frames
                chunk = vocode_window(start, min(end, len(token_cache)), n_decoded,
                                      cf + 2 * s.overlap_frames)
                out = ola.push(chunk, stride=cf * self.hop_length)
                stats["chunk_s"].append(time.perf_counter() - t0)
                n_decoded += cf
                cf = seg_steps = s.frames_per_chunk  # steady cadence after the first
                if out.size:
                    yield emitted(out)

        # tail flush
        stats["n_codes"] = len(token_cache) - len(ref_code_list)
        remaining = len(token_cache) - n_decoded
        if remaining > 0:
            t0 = time.perf_counter()
            start = max(len(token_cache) - (s.lookback + s.overlap_frames + remaining), 0)
            wav = self._watermark(self._vocode(token_cache[start:]))
            a = max((n_decoded - start - s.overlap_frames) * self.hop_length, 0)
            out = ola.push(wav[a:])
            tail = ola.flush()
            full = np.concatenate([out, tail]) if tail.size else out
            stats["chunk_s"].append(time.perf_counter() - t0)
            if full.size:
                yield emitted(full)

    def encode_reference(self, ref_audio_path: str | Path) -> np.ndarray:
        """Audio file -> int32 codec codes [floor(T16k / 320)] (the cloning
        prompt). The w2v-BERT branch's log-mel front end runs on the host
        over the waveform padded by 160 samples each side (aligning the
        50 Hz fbank grid with the acoustic hop); the codec runs on the
        device."""
        t0 = time.perf_counter()
        wav = audio_io.load_for_encoding(ref_audio_path, self.codec_cfg.sample_rate_in)
        t1 = time.perf_counter()
        sem_feats = None
        if self.codec_cfg.semantic is not None:
            feats = mel.semantic_features(np.pad(np.asarray(wav), (160, 160)))
            sem_feats = torch.as_tensor(feats, device=self.device)[None]
        t2 = time.perf_counter()
        x = torch.as_tensor(np.asarray(wav, np.float32), device=self.device)[None]
        codes = cd.encode(self.codec_cfg, self.codec_params, x, sem_feats=sem_feats)
        out = codes[0].cpu().numpy().astype(np.int32)
        self.last_stats = {"samples": int(x.shape[1]), "load_s": t1 - t0, "mel_s": t2 - t1,
                           "encode_s": time.perf_counter() - t2}
        return out
