"""neutts_tpu_torch — the PyTorch/CUDA port of neutts-tpu for NVIDIA Hopper.

A package of its own beside `neutts_tpu` (the JAX reference, untouched).
It imports torch and never jax or `neutts_tpu`. The TPU's Pallas kernels on
its path are hand-written CUDA kernels under `csrc/`, built with nvcc at
first use (`ops/_build.py`); each has a plain PyTorch version beside it,
which runs whenever the tensors lie on the CPU.

    from neutts_tpu_torch import NeuTTS, config
    tts = NeuTTS.initialize_random(config.AIR, config.CODEC)   # device="cuda"
    wav = tts.infer(text, ref_codes, ref_text)
"""

from neutts_tpu_torch import config
from neutts_tpu_torch.pipeline import NeuTTS

__all__ = ["NeuTTS", "config"]
