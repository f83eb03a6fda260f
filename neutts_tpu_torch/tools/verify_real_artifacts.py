"""One-command real-artifact verification runner of the PyTorch port (port
of tools/verify_real_artifacts.py).

With real NeuTTS weights in hand, this chains what the parity story needs:

  1. convert     backbone (--hf dir or --gguf file) [+ codec --codec-src]
                 -> an npz checkpoint dir (models/convert.py, convert_codec.py)
  2. hf-forward  converted forward == transformers forward (argmax-exact)
  3. greedy      bit-exact greedy codec tokens vs HF `generate` on the
                 samples' cloning prompts (reference neutts/neutts.py:334-352)
  4. waveform    codec decode of the first sample's codes vs --golden-wav
                 (.npy of the torch reference's decode_code output), allclose
                 1e-3 (reference neutts/neutts.py:273-295)
  5. tap-sweep   semantic_output_layer sweep 14..18: encode_reference on the
                 first sample's wav vs its codes — only the true tap matches
                 (convert_codec.py TAKEN-ON-CONVENTION)
  6. encode      encode_reference code match vs every sample's codes at the
                 configured tap (reference neutts/neutts.py:266-271)

A sample NAME in --samples DIR is NAME.wav, NAME.txt and its codes, NAME.pt
(the reference's layout) or NAME_codes.npy (this repository's samples/).
Stages 2-3 need `transformers`: without it they FAIL with that reason when
an HF backbone is given; they are never passed over.

Usage (real artifacts, on the GPU by default):
    python -m neutts_tpu_torch.tools.verify_real_artifacts --hf /path/air_hf \
        --codec-src /path/neucodec.safetensors --samples /path/samples \
        --names dave,jo [--golden-wav dave_ref.npy] [--out /tmp/ckpt_air]

Dry run (no weights needed; exercised by the CPU test suite):
    python -m neutts_tpu_torch.tools.verify_real_artifacts --dry-run --device cpu
synthesizes a tiny HF-format checkpoint and a from-scratch codec, takes its
clip, transcript and codes from the repository's samples/demo.*, and runs the
same chain, asserting the MACHINERY (conversion round trip, token-level HF
equality on synthetic weights, code-rate sanity) instead of real-weight
parity.
"""

from __future__ import annotations

import argparse
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent.parent


class SkipStage(Exception):
    pass


def run_stage(results: list, name, fn):
    """Run one stage, print and record (name, PASS | SKIP | FAIL, detail)."""
    try:
        detail = fn()
        results.append((name, "PASS", detail or ""))
        print(f"[PASS] {name}: {detail or ''}")
    except SkipStage as e:
        results.append((name, "SKIP", str(e)))
        print(f"[skip] {name}: {e}")
    except Exception as e:  # noqa: BLE001 — a failed stage is reported, the next one runs
        results.append((name, "FAIL", f"{type(e).__name__}: {e}"))
        print(f"[FAIL] {name}: {type(e).__name__}: {e}")


def _transformers():
    try:
        import transformers
    except ImportError as e:
        raise RuntimeError(f"this stage needs the transformers package: {e}") from e
    return transformers


def load_sample(samples: Path, name: str):
    """(codes int32 [T], transcript) of sample `name`."""
    if (samples / f"{name}.pt").exists():
        import torch

        codes = torch.load(samples / f"{name}.pt", map_location="cpu",
                           weights_only=True).numpy()
    else:
        codes = np.load(samples / f"{name}_codes.npy")
    return np.asarray(codes, np.int32).reshape(-1), (samples / f"{name}.txt").read_text().strip()


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--hf", help="HF backbone checkpoint dir")
    ap.add_argument("--gguf", help="GGUF backbone file")
    ap.add_argument("--codec-src", help="real codec artifact (state dict / onnx)")
    ap.add_argument("--golden-wav", help=".npy of torch decode_code(first sample's codes)")
    ap.add_argument("--samples", default=str(ROOT / "samples"),
                    help="directory of NAME.wav / NAME.txt / NAME.pt or NAME_codes.npy")
    ap.add_argument("--names", default=None,
                    help="comma-separated sample names (default dave,jo; demo in a dry run)")
    ap.add_argument("--out", help="checkpoint output dir (default: temp)")
    ap.add_argument("--device", default="cuda", help='"cuda" (default) or "cpu"')
    ap.add_argument("--dry-run", action="store_true",
                    help="synthetic tiny artifacts; asserts machinery only")
    args = ap.parse_args(argv)

    import torch

    from neutts_tpu_torch import config as cfglib
    from neutts_tpu_torch.models import backbone as bb
    from neutts_tpu_torch.models import checkpoint as ckpt
    from neutts_tpu_torch.models import codec as cd
    from neutts_tpu_torch.models import convert
    from neutts_tpu_torch.models.convert_codec import convert_codec
    from neutts_tpu_torch.pipeline import NeuTTS, resolve_device
    from neutts_tpu_torch.runtime import decode as dec

    dev = resolve_device(args.device)
    samples = Path(args.samples)
    names = (args.names or ("demo" if args.dry_run else "dave,jo")).split(",")
    out_dir = Path(args.out or tempfile.mkdtemp(prefix="neutts_verify_"))
    state = {}
    results: list = []

    def stage(name, fn):
        run_stage(results, name, fn)

    # ---- dry-run artifact synthesis ----------------------------------------
    if args.dry_run:
        cfg0 = cfglib.TINY
        params0 = bb.init_params(cfg0, seed=11, device="cpu")
        gen = torch.Generator().manual_seed(11)
        for b in ("bq", "bk", "bv"):  # nonzero biases, so that their mapping counts
            params0["layers"][b].copy_(0.02 * torch.randn(params0["layers"][b].shape,
                                                          generator=gen))
        convert.write_hf_dir(out_dir / "hf", cfg0, params0)
        state["syn_cfg"] = cfg0
        args.hf = str(out_dir / "hf")

    def hf_model():
        return _transformers().AutoModelForCausalLM.from_pretrained(args.hf)

    # ---- 1. convert --------------------------------------------------------
    def do_convert():
        # the dry run's TINY runs in f32 and its layout is not derivable from
        # the synthetic vocab size: pass the config explicitly (as tests do)
        dtype = "float32" if args.dry_run else "bfloat16"
        if args.hf:
            cfg, params = convert.from_hf(args.hf, cfg=state.get("syn_cfg"), dtype=dtype,
                                          device=dev)
        elif args.gguf:
            cfg, params = convert.from_gguf(args.gguf, dtype=dtype, device=dev)
        else:
            raise SkipStage("no --hf/--gguf given")
        if args.codec_src:
            ccfg, cparams = convert_codec(args.codec_src, device=dev)
        else:
            ccfg = cfglib.CODEC_TINY if args.dry_run else cfglib.CODEC
            cparams = cd.init_params(ccfg, seed=0, device=dev)
        ckpt.save_pipeline(out_dir / "ckpt", cfg, params, ccfg, cparams)
        state.update(cfg=cfg, params=params, ccfg=ccfg, cparams=cparams)
        return f"{cfg.name}: {cfg.n_layers}L x {cfg.hidden_size}d -> {out_dir}/ckpt"

    stage("convert", do_convert)

    # ---- 2. hf-forward (argmax-exact logits parity) ------------------------
    def do_hf_forward():
        if "cfg" not in state or not args.hf:
            raise SkipStage("needs a converted --hf backbone")
        _transformers()
        cfg, params = state["cfg"], state["params"]
        ids = list(range(4, 20))
        with torch.no_grad():
            ref = hf_model()(torch.tensor([ids])).logits[0].float().numpy()
            toks = torch.tensor([ids], dtype=torch.int32, device=dev)
            ours = bb.forward_train(cfg, params, toks, torch.ones_like(toks, dtype=torch.bool))
        ours = ours[0, :, : ref.shape[1]].float().cpu().numpy()
        agree = float(np.mean(ours.argmax(-1) == ref.argmax(-1)))
        if agree != 1.0:
            raise AssertionError(f"argmax agreement {agree:.4f} != 1.0")
        return f"argmax-exact over {len(ids)} positions"

    stage("hf-forward", do_hf_forward)

    # ---- 3. greedy token parity vs HF generate -----------------------------
    def do_greedy():
        if "cfg" not in state or not args.hf:
            raise SkipStage("needs a converted --hf backbone")
        _transformers()
        cfg, params = state["cfg"], state["params"]
        eos = cfg.layout.speech_gen_end
        if args.dry_run:
            prompts = [[5, 6, 7, 8, 9], [10, 11, 12]]
            max_new = 48
        else:
            # the real cloning prompts (both sides consume the SAME ids, so
            # parity holds with either G2P; espeak matches the reference's
            # exact prompts when present)
            from neutts_tpu_torch.text.g2p import get_g2p
            from neutts_tpu_torch.text.prompt import build_prompt_ids
            from neutts_tpu_torch.text.tokenizer import HFTokenizer

            tok = HFTokenizer(args.hf)
            g2p = get_g2p(prefer="espeak")
            prompts = []
            for name in names:
                codes, text = load_sample(samples, name)
                prompts.append(build_prompt_ids(tok, g2p, list(codes), text, "Hello world."))
            max_new = 1024
        scfg = cfglib.SamplingConfig(greedy=True, min_new_tokens=8)
        model = hf_model()
        n_match = 0
        for ids in prompts:
            toks, lens = dec.pad_prompts([ids], pad_id=0, device=dev,
                                         bucket=32 if args.dry_run else None)
            res = dec.generate(cfg, scfg, eos, max_new, params, toks, lens)
            ours = dec.extract(res, 0, eos)
            with torch.no_grad():
                out = model.generate(
                    torch.tensor([ids]),
                    max_length=min(len(ids) + max_new, cfg.max_context),
                    do_sample=False, min_new_tokens=8, eos_token_id=eos,
                )
            theirs = out[0, len(ids):].tolist()
            if theirs and theirs[-1] == eos:
                theirs = theirs[:-1]
            if ours != theirs:
                k = next((i for i, (a, b) in enumerate(zip(ours, theirs)) if a != b),
                         min(len(ours), len(theirs)))
                raise AssertionError(
                    f"token divergence at step {k}: ours {ours[k:k+4]} vs "
                    f"HF {theirs[k:k+4]} (lens {len(ours)}/{len(theirs)})")
            n_match += len(ours)
        return f"bit-exact over {n_match} greedy tokens ({len(prompts)} prompts)"

    stage("greedy-parity", do_greedy)

    # ---- 4. waveform allclose ----------------------------------------------
    def do_waveform():
        if "ccfg" not in state:
            raise SkipStage("no codec converted")
        ccfg, cparams = state["ccfg"], state["cparams"]
        if args.dry_run:
            codes = np.arange(40) % ccfg.codebook_size
        else:
            codes, _ = load_sample(samples, names[0])
        wav = cd.decode(ccfg, cparams, torch.as_tensor(codes, device=dev)[None])[0].cpu().numpy()
        assert wav.shape == (len(codes) * ccfg.hop_out,), wav.shape
        assert np.isfinite(wav).all()
        if not args.golden_wav:
            return (f"decode ran: {wav.shape[0]} samples, finite "
                    "(no --golden-wav for allclose)")
        np.testing.assert_allclose(wav, np.load(args.golden_wav), atol=1e-3)
        return f"allclose(1e-3) vs {args.golden_wav}"

    stage("waveform", do_waveform)

    # ---- 5+6. encode path: tap sweep + code match --------------------------
    def make_pipeline(tap=None):
        ccfg = state["ccfg"]
        if tap is not None and ccfg.semantic is not None:
            import dataclasses

            ccfg = ccfg.scaled(semantic=dataclasses.replace(ccfg.semantic, output_layer=tap))
        return NeuTTS(state["cfg"], state["params"], ccfg, state["cparams"], device=dev)

    def do_tap_sweep():
        if "ccfg" not in state:
            raise SkipStage("no codec converted")
        if state["ccfg"].semantic is None:
            raise SkipStage("codec has no semantic tower (from-scratch/dry-run "
                            "config) — sweep needs a converted real encoder")
        want, _ = load_sample(samples, names[0])
        rates = {}
        for tap in (14, 15, 16, 17, 18):
            got = make_pipeline(tap=tap).encode_reference(samples / f"{names[0]}.wav")
            n = min(len(got), len(want))
            rates[tap] = float(np.mean(got[:n] == want[:n]))
        best = max(rates, key=rates.get)
        detail = ", ".join(f"L{t}={r:.3f}" for t, r in rates.items())
        if rates[best] < 0.99:
            raise AssertionError(
                f"no tap layer matches {names[0]}'s codes ({detail}) — check the "
                "semantic front-end conventions (convert_codec.py docstring)")
        return f"true tap = layer {best} ({detail})"

    stage("tap-sweep", do_tap_sweep)

    def do_encode():
        if "ccfg" not in state:
            raise SkipStage("no codec converted")
        tts = make_pipeline()
        if args.dry_run or state["ccfg"].semantic is None:
            # machinery check: 16 kHz sample -> 50 Hz code rate
            codes, _ = load_sample(samples, names[0])
            got = tts.encode_reference(samples / f"{names[0]}.wav")
            assert abs(len(got) - len(codes)) <= 2, (len(got), len(codes))
            return (f"code rate ok ({len(got)} codes for {names[0]}.wav; "
                    "real-artifact mode would assert exact code match)")
        n_ok = 0
        for name in names:
            want, _ = load_sample(samples, name)
            got = tts.encode_reference(samples / f"{name}.wav")
            n = min(len(got), len(want))
            rate = float(np.mean(got[:n] == want[:n]))
            if rate < 0.99 or abs(len(got) - len(want)) > 1:
                raise AssertionError(
                    f"{name}: code match {rate:.4f}, lens {len(got)}/{len(want)}")
            n_ok += n
        return f"codes match the samples' codes ({n_ok} codes)"

    stage("encode-parity", do_encode)

    print("\n== summary ==")
    failed = False
    for name, status, detail in results:
        print(f"  {status:4s} {name}" + (f" — {detail}" if detail else ""))
        failed |= status == "FAIL"
    sys.exit(1 if failed else 0)


if __name__ == "__main__":
    main()
