"""Checkpoint conversion CLI (port of `neutts_tpu.models.convert_cli`).

    python -m neutts_tpu_torch.models.convert_cli --hf   /path/to/hf_dir   --out ckpt/air
    python -m neutts_tpu_torch.models.convert_cli --gguf /path/to/model.gguf --out ckpt/air-q4
    # with a real codec artifact (torch/safetensors state dict or the shipped
    # ONNX decoder — reference neutts/neutts.py:168-214):
    python -m neutts_tpu_torch.models.convert_cli --hf <dir> --codec-src neucodec.safetensors --out ckpt/air

Produces the npz checkpoint directory (models/checkpoint.py format) that
both packages' `load_pipeline` read, with the backbone weights in --dtype
and a config whose `dtype` says so (the JAX package's CLI leaves it
"bfloat16" after a float32 conversion); the codec
section is a real converted codec (--codec-src, shape-driven recovery via
models/convert_codec.py), an existing checkpoint's codec (--codec), or a
fresh init (`codec.init_params(config.CODEC, seed=0)`).

Unlike the port's other entry points, which run on the GPU unless asked for
the CPU, this one converts on the CPU: its output is a file, so it needs and
touches no GPU.
"""

from __future__ import annotations

import argparse


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Convert checkpoints to the neutts npz format")
    src = ap.add_mutually_exclusive_group(required=True)
    src.add_argument("--hf", help="HF checkpoint directory (safetensors)")
    src.add_argument("--gguf", help="GGUF file (F32/F16/BF16/Q8_0/Q4_0)")
    ap.add_argument("--out", required=True, help="output checkpoint dir")
    ap.add_argument("--codec", default=None, help="existing converted codec dir to reuse")
    ap.add_argument(
        "--codec-src", default=None,
        help="real codec artifact (.pt/.bin/.safetensors state dict or .onnx "
        "decoder) to ingest via shape-driven recovery",
    )
    ap.add_argument("--codec-heads", type=int, default=16,
                    help="attention head count for the codec decoder backbone "
                    "(not recoverable from fused projection shapes)")
    ap.add_argument("--dtype", default="bfloat16", choices=["bfloat16", "float32"])
    args = ap.parse_args(argv)

    from neutts_tpu_torch import config as cfglib
    from neutts_tpu_torch.models import checkpoint as ckpt
    from neutts_tpu_torch.models import codec as cd
    from neutts_tpu_torch.models import convert

    if args.hf:
        cfg, params = convert.from_hf(args.hf, dtype=args.dtype, device="cpu")
        print(f"converted HF checkpoint: {cfg.name} ({cfg.n_layers}L, {cfg.hidden_size}d)")
    else:
        cfg, params = convert.from_gguf(args.gguf, dtype=args.dtype, device="cpu")
        print(f"converted GGUF: {cfg.name} ({cfg.n_layers}L, {cfg.hidden_size}d)")
    # the stored config names the weights' dtype (the converters' configs
    # keep the JAX package's "bfloat16" whatever --dtype is)
    cfg = cfg.scaled(dtype=args.dtype)

    if args.codec_src:
        from neutts_tpu_torch.models.convert_codec import convert_codec

        codec_cfg, codec_params = convert_codec(
            args.codec_src, heads=args.codec_heads, device="cpu"
        )
        print(
            f"converted codec: {codec_cfg.dec_backbone} "
            f"{codec_cfg.dec_layers}L x {codec_cfg.dec_dim}d, "
            f"n_fft {codec_cfg.n_fft}, hop {codec_cfg.hop_out} "
            f"({'decoder-only' if codec_params['enc'] is None else 'with encoder'})"
        )
    elif args.codec:
        _, _, codec_cfg, codec_params = ckpt.load_pipeline(args.codec, device="cpu")
    else:
        codec_cfg = cfglib.CODEC
        codec_params = cd.init_params(codec_cfg, seed=0, device="cpu")
        print("NOTE: codec weights are fresh-initialized (pass --codec-src to ingest real ones)")

    ckpt.save_pipeline(args.out, cfg, params, codec_cfg, codec_params)
    print(f"saved to {args.out}")


if __name__ == "__main__":
    main()
