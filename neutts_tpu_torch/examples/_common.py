"""Shared helpers for the port's example CLIs (port of examples/_common.py)."""

from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def add_model_args(ap: argparse.ArgumentParser) -> None:
    ap.add_argument("--checkpoint", default=None,
                    help="converted checkpoint dir (neutts_tpu_torch.models.convert_cli)")
    ap.add_argument("--synthetic", action="store_true", help="random tiny model (demo/test)")
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')


def read_text_arg(value: str) -> str:
    p = Path(value)
    if p.suffix == ".txt" and p.exists():
        return p.read_text().strip()
    return value


def build_tts(args):
    from neutts_tpu_torch import NeuTTS, config

    if args.checkpoint:
        return NeuTTS.from_checkpoint(args.checkpoint, device=args.device)
    if args.synthetic:
        print("Using a SYNTHETIC random model (demo mode — output is noise).")
        # tiny geometry but the full 2048-token window so real reference
        # clips (codes + phonemes) fit the prompt
        tts = NeuTTS.initialize_random(backbone_cfg=config.TINY.scaled(max_context=2048),
                                       device=args.device)
        tts.sampling = config.SamplingConfig(min_new_tokens=25)
        return tts
    raise SystemExit("Provide --checkpoint DIR or --synthetic")


def load_ref_codes(path: str, tts) -> np.ndarray:
    """Load pre-encoded reference codes: .npy, or torch .pt (int32 [T], the
    reference's samples/*.pt layout)."""
    p = Path(path)
    if p.suffix == ".npy":
        codes = np.load(p)
    elif p.suffix == ".pt":
        import torch

        codes = torch.load(p, map_location="cpu", weights_only=True).numpy()
    else:
        raise SystemExit(f"unsupported ref codes format: {p.suffix}")
    return _fit_codebook(codes, tts)


def _fit_codebook(codes, tts) -> np.ndarray:
    """Codes folded into the backbone's speech codebook: a synthetic tiny
    model has 64 codes where the codec and real clips have 65,536."""
    codes = np.asarray(codes, np.int64).reshape(-1)
    cb = tts.tokenizer.layout.codebook_size
    if codes.max() >= cb:
        print(f"NOTE: clamping codes into the model's {cb}-entry codebook")
        codes = codes % cb
    return codes.astype(np.int32)


def ref_codes_from_args(args, tts) -> np.ndarray:
    """--ref_codes if given, else the codes of --ref_audio (encode_reference)."""
    if args.ref_codes:
        return load_ref_codes(args.ref_codes, tts)
    if not args.ref_audio:
        raise SystemExit("Provide --ref_codes or --ref_audio")
    print(f"Encoding reference: {args.ref_audio}")
    return _fit_codebook(tts.encode_reference(args.ref_audio), tts)
