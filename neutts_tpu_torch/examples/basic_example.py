"""Batch synthesis CLI (port of examples/basic_example.py).

    python -m neutts_tpu_torch.examples.basic_example \
        --input_text "My name is Dave, and um, I'm from London" \
        --ref_audio samples/demo.wav --ref_text samples/demo.txt \
        --checkpoint CKPT            # or --synthetic for a random model
        [--device cpu] --output_path output.wav
"""

import argparse

from neutts_tpu_torch.examples._common import (add_model_args, build_tts, read_text_arg,
                                               ref_codes_from_args)


def main(argv=None):
    ap = argparse.ArgumentParser(description="NeuTTS batch synthesis (PyTorch port)")
    ap.add_argument("--input_text", required=True, help="text to synthesize (or a .txt path)")
    ap.add_argument("--ref_audio", default=None, help="reference speaker wav")
    ap.add_argument("--ref_codes", default=None, help="pre-encoded codes (.pt/.npy)")
    ap.add_argument("--ref_text", required=True, help="reference transcript (or a .txt path)")
    ap.add_argument("--output_path", default="output.wav")
    add_model_args(ap)
    args = ap.parse_args(argv)

    tts = build_tts(args)
    ref_codes = ref_codes_from_args(args, tts)
    input_text = read_text_arg(args.input_text)
    print(f"Generating audio for: {input_text!r}")
    wav = tts.infer(input_text, ref_codes, read_text_arg(args.ref_text))

    from neutts_tpu_torch.audio import io as audio_io

    audio_io.write_wav(args.output_path, wav, tts.sample_rate)
    print(f"Saved {len(wav)/tts.sample_rate:.2f}s to {args.output_path}")


if __name__ == "__main__":
    main()
