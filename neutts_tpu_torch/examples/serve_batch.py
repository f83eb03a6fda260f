"""Continuous-batching synthesis demo (port of examples/serve_batch.py):
several utterances decoded together through the serving Engine's slots,
then each vocoded to a wav.

    python -m neutts_tpu_torch.examples.serve_batch --checkpoint CKPT \
        --ref_codes samples/demo_codes.npy --ref_text samples/demo.txt --n_slots 4
"""

import argparse
import time

from neutts_tpu_torch.examples._common import (add_model_args, build_tts, read_text_arg,
                                               ref_codes_from_args)

SENTENCES = [
    "The quick brown fox jumps over the lazy dog.",
    "Parallel synthesis keeps every slot of the card busy.",
    "Continuous batching admits new work as slots free up.",
    "This sentence is short.",
    "Speech models decode fifty codec tokens for every second of audio.",
]


def main(argv=None):
    ap = argparse.ArgumentParser(description="NeuTTS continuous batching demo (PyTorch port)")
    ap.add_argument("--ref_audio", default=None)
    ap.add_argument("--ref_codes", default=None)
    ap.add_argument("--ref_text", required=True)
    ap.add_argument("--n_slots", type=int, default=4)
    ap.add_argument("--out_prefix", default="served_")
    add_model_args(ap)
    args = ap.parse_args(argv)

    tts = build_tts(args)
    ref_text = read_text_arg(args.ref_text)
    ref_codes = ref_codes_from_args(args, tts)

    from neutts_tpu_torch.audio import io as audio_io
    from neutts_tpu_torch.serving import Engine
    from neutts_tpu_torch.text.prompt import build_prompt_ids
    from neutts_tpu_torch.text.tokenizer import extract_speech_codes

    eng = Engine(tts.backbone_cfg, tts.backbone_params,
                 eos_id=tts.tokenizer.layout.speech_gen_end, n_slots=args.n_slots,
                 sampling=tts.sampling, device=tts.device)
    t0 = time.time()
    rids = {}
    for i, s in enumerate(SENTENCES):
        ids = build_prompt_ids(tts.tokenizer, tts.g2p, list(ref_codes), ref_text, s)
        rids[eng.submit(ids)] = i
    results = eng.run()
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in results.values())
    print(f"{len(results)} utterances, {total_tokens} tokens in {dt:.2f}s "
          f"({total_tokens/dt:,.0f} tok/s)")

    for rid, toks in results.items():
        codes = extract_speech_codes(toks, tts.tokenizer.layout)
        if not codes:
            continue
        wav = tts._watermark(tts._vocode(codes))
        path = f"{args.out_prefix}{rids[rid]}.wav"
        audio_io.write_wav(path, wav, tts.sample_rate)
        print(f"  {path}: {len(wav)/tts.sample_rate:.2f}s")


if __name__ == "__main__":
    main()
