"""Decode-only deployment: pre-encoded reference codes, no codec encoder
(port of examples/decoder_only_example.py; the reference pairs a GGUF
backbone with its ONNX codec decoder for this mode, reference
examples/onnx_example.py). A decoder-only codec converted with
`convert_cli --codec-src decoder.onnx` serves it.

    python -m neutts_tpu_torch.examples.decoder_only_example --checkpoint CKPT \
        --input_text "Hello." --ref_codes samples/demo_codes.npy --ref_text samples/demo.txt
"""

import argparse

from neutts_tpu_torch.examples._common import (add_model_args, build_tts, load_ref_codes,
                                               read_text_arg)


def main(argv=None):
    ap = argparse.ArgumentParser(description="NeuTTS decoder-only synthesis (PyTorch port)")
    ap.add_argument("--input_text", required=True)
    ap.add_argument("--ref_codes", required=True, help=".pt or .npy pre-encoded codes")
    ap.add_argument("--ref_text", required=True)
    ap.add_argument("--output_path", default="output.wav")
    add_model_args(ap)
    args = ap.parse_args(argv)

    tts = build_tts(args)
    wav = tts.infer(read_text_arg(args.input_text), load_ref_codes(args.ref_codes, tts),
                    read_text_arg(args.ref_text))
    from neutts_tpu_torch.audio import io as audio_io

    audio_io.write_wav(args.output_path, wav, tts.sample_rate)
    print(f"Saved {len(wav)/tts.sample_rate:.2f}s to {args.output_path}")


if __name__ == "__main__":
    main()
