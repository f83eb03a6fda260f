"""Example CLIs of the PyTorch/CUDA port (ports of the repository's
`examples/`), run from the repository root as modules:

    python -m neutts_tpu_torch.examples.basic_example --checkpoint CKPT \\
        --input_text "Hello." --ref_audio samples/demo.wav --ref_text samples/demo.txt

Each takes `--checkpoint DIR` (a checkpoint written by
`neutts_tpu_torch.models.convert_cli` or either package's `save_pipeline`)
or `--synthetic` (a random tiny model), and `--device` ("cuda" by default;
"cpu" runs the kernels' plain versions).
"""
