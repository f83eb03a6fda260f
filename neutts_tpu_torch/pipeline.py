"""Public synthesis API of the PyTorch/CUDA port: `NeuTTS` (port of
`neutts_tpu.pipeline.NeuTTS`, the `infer` / `infer_batch` path).

    text + reference codes/text -> G2P -> prompt ids -> left-padded bucket
    -> runtime.decode.generate (prefill + decode loop with sampling)
    -> speech codes -> ExactVocoder (codec decode) -> watermark -> waveform

Every entry point takes `device=` and defaults to "cuda": without a GPU the
default raises, and only an explicit device="cpu" runs on the CPU (where
each kernel runs its plain PyTorch version).

Not ported yet (later slices): `infer_stream` and `encode_reference`.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import List, Optional, Sequence

import numpy as np
import torch

from neutts_tpu_torch import config as cfglib
from neutts_tpu_torch.audio.watermark import get_watermarker
from neutts_tpu_torch.models import backbone as bb
from neutts_tpu_torch.models import checkpoint as ckpt
from neutts_tpu_torch.models import codec as cd
from neutts_tpu_torch.runtime import decode as dec
from neutts_tpu_torch.runtime.vocoder import ExactVocoder
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
        quantize: Optional[str] = None,  # None | "int8" — W8A8 backbone weights
        device="cuda",
        seed: int = 0,
    ):
        self.device = resolve_device(device)
        if quantize not in (None, "int8"):
            raise ValueError(f"unknown quantize mode {quantize!r} (expected None or 'int8')")
        backbone_params = ckpt.tree_to(backbone_params, self.device)
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
        self._vocoder_exact = ExactVocoder(codec_cfg, self.codec_params, device=self.device)
        self.sample_rate = codec_cfg.sample_rate_out  # 24_000
        self.hop_length = codec_cfg.hop_out  # 480
        self.max_context = backbone_cfg.max_context  # 2048
        self._generator = torch.Generator(device=self.device).manual_seed(seed)
        self._eos = self.tokenizer.layout.speech_gen_end
        # what the last infer_batch did: codes per row and per-stage seconds
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
        `save_pipeline`."""
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
        wavs, n_codes = [], []
        for i in range(len(prompts)):
            codes = extract_speech_codes(dec.extract(result, i, self._eos),
                                         self.tokenizer.layout)
            n_codes.append(len(codes))
            wavs.append(self._watermark(self._vocode(codes)))
        self.last_stats = {
            "bucket": bucket,
            "steps": result.steps,
            "n_codes": n_codes,
            "prefill_s": result.prefill_s,
            "decode_s": result.decode_s,
            "vocode_s": time.perf_counter() - t0,
        }
        return wavs

    def infer_stream(self, text: str, ref_codes, ref_text: str):
        raise NotImplementedError(
            "infer_stream (segmented decode + chunked vocoder) comes in a later slice "
            "of the PyTorch port")

    def encode_reference(self, ref_audio_path):
        raise NotImplementedError(
            "encode_reference (the codec encoder) comes in a later slice of the "
            "PyTorch port")
