"""Pre-encode a reference speaker wav to codec codes (port of
examples/encode_reference.py). Saves .npy, or .pt when the output path
ends in .pt (the reference's sample artifacts).

    python -m neutts_tpu_torch.examples.encode_reference --checkpoint CKPT \
        --ref_audio samples/demo.wav --output_path ref_codes.npy
"""

import argparse
from pathlib import Path

import numpy as np

from neutts_tpu_torch.examples._common import add_model_args, build_tts


def main(argv=None):
    ap = argparse.ArgumentParser(description="Encode a reference wav to codes (PyTorch port)")
    ap.add_argument("--ref_audio", required=True)
    ap.add_argument("--output_path", default="ref_codes.npy")
    add_model_args(ap)
    args = ap.parse_args(argv)

    tts = build_tts(args)
    codes = tts.encode_reference(args.ref_audio)
    out = Path(args.output_path)
    if out.suffix == ".pt":
        import torch

        torch.save(torch.from_numpy(np.asarray(codes, np.int32)), out)
    else:
        np.save(out, codes)
    print(f"{len(codes)} codes ({len(codes)/50:.2f}s @50Hz) -> {out}")


if __name__ == "__main__":
    main()
