"""The program's configuration objects, built from a configuration file.

The file holds the published sizes under their Hugging Face names
(`hidden_size`, `num_hidden_layers`, ...), the precisions the deployment
serves in, and the sampling; this module turns them into the port's
`BackboneConfig`, `CodecConfig` and `SamplingConfig`.
"""

from __future__ import annotations

import torch

SIZE_KEYS = ("hidden_size", "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
             "head_dim", "intermediate_size", "vocab_size", "rope_theta", "rms_norm_eps")


def sizes(c: dict) -> dict:
    """The sizes the weights, the reference and the counts read."""
    return {k: c[k] for k in SIZE_KEYS}


def weight_dtype(c: dict) -> torch.dtype:
    """The dtype the backbone's weights are made and served in (the compute
    dtype; W8A8 quantizes them from it)."""
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[c["compute_dtype"]]


def backbone_config(c: dict):
    from neutts_tpu_torch.config import SPECIAL_TOKEN_NAMES, BackboneConfig

    vocab = c["text_tokens"] + len(SPECIAL_TOKEN_NAMES) + c["codebook_size"]
    if vocab != c["vocab_size"]:
        raise ValueError(f"{c['name']}: vocab_size {c['vocab_size']} is not text + specials + "
                         f"codebook ({vocab})")
    return BackboneConfig(
        name=c["name"], vocab_size=c["vocab_size"], hidden_size=c["hidden_size"],
        n_layers=c["num_hidden_layers"], n_heads=c["num_attention_heads"],
        n_kv_heads=c["num_key_value_heads"], head_dim=c["head_dim"],
        intermediate_size=c["intermediate_size"], rope_theta=float(c["rope_theta"]),
        rms_norm_eps=float(c["rms_norm_eps"]), tie_embeddings=bool(c["tie_word_embeddings"]),
        max_context=c["max_context"], n_text_tokens=c["text_tokens"],
        dtype=c["compute_dtype"], kv_dtype=c["kv_dtype"])


def codec_config(c: dict):
    from neutts_tpu_torch.config import CodecConfig

    k = dict(c["codec"])
    k["fsq_levels"] = tuple(k["fsq_levels"])
    return CodecConfig(**k)


def sampling_config(c: dict, cfg, min_new_tokens: int):
    from neutts_tpu_torch.config import SamplingConfig

    s = c["sampling"]
    out = SamplingConfig(greedy=bool(s["greedy"]), temperature=float(s.get("temperature", 1.0)),
                         top_k=int(s.get("top_k", 50)), min_new_tokens=int(min_new_tokens),
                         max_context=cfg.max_context)
    return out.constrained_to(cfg.layout) if s.get("speech_only") else out


def set_precision_flags(c: dict) -> None:
    """TF32 in float32 products and convolutions, as the configuration states."""
    tf32 = bool(c.get("tf32", False))
    torch.backends.cuda.matmul.allow_tf32 = tf32
    torch.backends.cudnn.allow_tf32 = tf32
