"""Streaming synthesis CLI (port of examples/basic_streaming_example.py).

Chunks are written to the output file as one wav at the end; with --play
and a working pyaudio install they are played live as they come.

    python -m neutts_tpu_torch.examples.basic_streaming_example --checkpoint CKPT \
        --input_text "Hello." --ref_codes samples/demo_codes.npy --ref_text samples/demo.txt
"""

import argparse
import dataclasses
import time

import numpy as np

from neutts_tpu_torch.examples._common import (add_model_args, build_tts, read_text_arg,
                                               ref_codes_from_args)


def main(argv=None):
    ap = argparse.ArgumentParser(description="NeuTTS streaming synthesis (PyTorch port)")
    ap.add_argument("--input_text", required=True)
    ap.add_argument("--ref_audio", default=None)
    ap.add_argument("--ref_codes", default=None)
    ap.add_argument("--ref_text", required=True)
    ap.add_argument("--output_path", default="output_streaming.wav")
    ap.add_argument("--play", action="store_true", help="play via pyaudio")
    ap.add_argument(
        "--first_chunk_frames", type=int, default=None,
        help="frames in the FIRST emitted chunk (a low-latency knob, e.g. 10; later "
        "chunks use the standard 25-frame cadence)",
    )
    add_model_args(ap)
    args = ap.parse_args(argv)

    tts = build_tts(args)
    if args.first_chunk_frames is not None:
        tts.streaming = dataclasses.replace(tts.streaming,
                                            first_chunk_frames=args.first_chunk_frames)
    ref_codes = ref_codes_from_args(args, tts)

    sink = None
    if args.play:
        try:
            import pyaudio

            pa = pyaudio.PyAudio()
            sink = pa.open(format=pyaudio.paInt16, channels=1, rate=tts.sample_rate,
                           output=True)
        except (ImportError, OSError) as e:  # pyaudio is optional (host playback only)
            print(f"pyaudio unavailable ({e}); writing to file instead")

    chunks = []
    t0 = time.time()
    stream = tts.infer_stream(read_text_arg(args.input_text), ref_codes,
                              read_text_arg(args.ref_text))
    for i, chunk in enumerate(stream):
        if i == 0:
            print(f"first audio after {time.time()-t0:.2f}s")
        chunks.append(chunk)
        if sink is not None:
            pcm = np.clip(chunk * 32767, -32768, 32767).astype(np.int16)
            sink.write(pcm.tobytes())

    wav = np.concatenate(chunks) if chunks else np.zeros(0, np.float32)
    from neutts_tpu_torch.audio import io as audio_io

    audio_io.write_wav(args.output_path, wav, tts.sample_rate)
    print(f"{len(chunks)} chunks, {len(wav)/tts.sample_rate:.2f}s audio in "
          f"{time.time()-t0:.2f}s -> {args.output_path}")


if __name__ == "__main__":
    main()
