"""Seeded random weights, made on the device in a few large calls.

Weights come from `--seed`: one `torch.randn` into one flat buffer per
model, in the dtype they are served in, then each leaf is a view of it
scaled in place. The trees have the port's layout (the backbone's stacked
`params["layers"]`, the codec's `{"dec": ...}`), so they are handed to the
port's constructors as they are. This module imports torch alone: the plain
reference regenerates the same weights from the same seed with it.

Scales: projections N(0, 1/fan_in), the embedding N(0, 0.02^2) (the port's
init), biases N(0, 0.1^2) and norm gains 1 + N(0, 0.1^2), so that biases and
gains are not the identity and the comparison sees them.
"""

from __future__ import annotations

import math
from typing import Dict, List, Tuple

import torch


def round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def _fill(specs: List[Tuple[str, tuple, str, float]], seed: int, device, dtype) -> Dict:
    """specs: (path "a/b", shape, kind, scale) with kind "w" (x scale),
    "gain" (1 + scale x), "bias" (x scale). One randn call for all."""
    gen = torch.Generator(device=device).manual_seed(int(seed) % (1 << 63))
    total = sum(math.prod(s) for _, s, _, _ in specs)
    flat = torch.randn(total, generator=gen, device=device, dtype=dtype)
    tree: Dict = {}
    off = 0
    for path, shape, kind, scale in specs:
        n = math.prod(shape)
        v = flat[off: off + n].view(shape)
        off += n
        v.mul_(scale)
        if kind == "gain":
            v.add_(1.0)
        node = tree
        *parents, leaf = path.split("/")
        for p in parents:
            node = node.setdefault(p, {})
        node[leaf] = v
    return tree


def backbone_specs(m: dict) -> List[Tuple[str, tuple, str, float]]:
    """The port's backbone tree for a configuration's sizes (`model_sizes`)."""
    D, L, F = m["hidden_size"], m["num_hidden_layers"], m["intermediate_size"]
    Q = m["num_attention_heads"] * m["head_dim"]
    KV = m["num_key_value_heads"] * m["head_dim"]
    V = round_up(m["vocab_size"], 256)
    specs = [("embed", (V, D), "w", 0.02)]
    for name, shape in (("wq", (D, Q)), ("wk", (D, KV)), ("wv", (D, KV)), ("wo", (Q, D)),
                        ("w_gate", (D, F)), ("w_up", (D, F)), ("w_down", (F, D))):
        specs.append((f"layers/{name}", (L, *shape), "w", shape[0] ** -0.5))
    for name, n in (("bq", Q), ("bk", KV), ("bv", KV)):
        specs.append((f"layers/{name}", (L, n), "bias", 0.1))
    for name in ("attn_norm", "mlp_norm"):
        specs.append((f"layers/{name}", (L, D), "gain", 0.1))
    specs.append(("final_norm", (D,), "gain", 0.1))
    return specs


def backbone_params(m: dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    return _fill(backbone_specs(m), seed, device, dtype)


def codec_decoder_specs(c: dict) -> List[Tuple[str, tuple, str, float]]:
    """The port's codec decoder tree (`{"dec": ...}`, transformer backbone)."""
    D, L, I = c["dec_dim"], c["dec_layers"], c["dec_intermediate"]
    fsq, vq, nf = len(c["fsq_levels"]), c["vq_dim"], c["n_fft"] + 2
    s = [("dec/project_out_w", (fsq, vq), "w", fsq ** -0.5),
         ("dec/project_out_b", (vq,), "bias", 0.5 * fsq ** -0.5),
         ("dec/post_a_w", (vq, D), "w", vq ** -0.5),
         ("dec/post_a_b", (D,), "bias", 0.5 * vq ** -0.5),
         ("dec/embed_w", (7, D, D), "w", (7 * D) ** -0.5),
         ("dec/embed_b", (D,), "bias", 0.5 * (7 * D) ** -0.5)]
    for name, shape in (("wq", (D, D)), ("wk", (D, D)), ("wv", (D, D)), ("wo", (D, D)),
                        ("mlp_w1", (D, I)), ("mlp_w2", (I, D))):
        s.append((f"dec/blocks/{name}", (L, *shape), "w", shape[0] ** -0.5))
    for name, n in (("bq", D), ("bk", D), ("bv", D), ("bo", D), ("mlp_b1", I), ("mlp_b2", D),
                    ("norm1_b", D), ("norm2_b", D)):
        s.append((f"dec/blocks/{name}", (L, n), "bias", 0.02))
    for name in ("norm1_s", "norm2_s"):
        s.append((f"dec/blocks/{name}", (L, D), "gain", 0.1))
    s += [("dec/final_norm_s", (D,), "gain", 0.1), ("dec/final_norm_b", (D,), "bias", 0.02),
          ("dec/head_w", (D, nf), "w", D ** -0.5), ("dec/head_b", (nf,), "bias", 0.02)]
    return s


def codec_decoder_params(c: dict, seed: int, device) -> Dict:
    # another stream than the backbone's: the same seed, offset
    return _fill(codec_decoder_specs(c), int(seed) + 1, device, torch.float32)
