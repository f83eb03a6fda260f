"""LFM2-MoE configurations: the program's config from a configuration file,
the seeded weights in the program's layout, and the operations and bytes
of the model and of its grouped expert kernel, from shapes alone.

The file holds the published sizes under their Hugging Face names
(`hidden_size`, `layer_types`, `num_experts`, ...), `vocab_size` as
published (the text tokenizer's), and the NeuTTS layout beside it:
`text_tokens` + 6 control tokens + `codebook_size` speech codes make
`extended_vocab_size`, the vocabulary the model serves.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.harness import weights

SIZE_KEYS = ("hidden_size", "num_hidden_layers", "num_attention_heads", "num_key_value_heads",
             "head_dim", "intermediate_size", "moe_intermediate_size", "num_experts",
             "num_experts_per_tok", "num_dense_layers", "conv_L_cache", "layer_types",
             "norm_topk_prob", "routed_scaling_factor", "use_expert_bias", "rope_theta",
             "norm_eps")


def sizes(c: dict) -> dict:
    """The sizes the weights, the reference and the counts read; `vocab_size`
    is the served (extended) vocabulary."""
    m = {k: c[k] for k in SIZE_KEYS}
    m["vocab_size"] = c["extended_vocab_size"]
    return m


def backbone_config(c: dict):
    from neutts_tpu_torch.config import SPECIAL_TOKEN_NAMES, Lfm2Config

    vocab = c["text_tokens"] + len(SPECIAL_TOKEN_NAMES) + c["codebook_size"]
    if vocab != c["extended_vocab_size"]:
        raise ValueError(f"{c['name']}: extended_vocab_size {c['extended_vocab_size']} is not "
                         f"text + specials + codebook ({vocab})")
    if (c["conv_bias"] or not c["tie_word_embeddings"] or not c["use_expert_bias"]
            or not c["norm_topk_prob"] or c["routed_scaling_factor"] != 1):
        raise ValueError(f"{c['name']}: the port's LFM2 block has no conv bias, a tied head, "
                         f"an expert bias and the top-k weights normalised at scale 1")
    return Lfm2Config(
        name=c["name"], vocab_size=vocab, n_text_tokens=c["text_tokens"],
        hidden_size=c["hidden_size"], n_layers=c["num_hidden_layers"],
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        head_dim=c["head_dim"], intermediate_size=c["intermediate_size"],
        rope_theta=float(c["rope_theta"]), rms_norm_eps=float(c["norm_eps"]),
        tie_embeddings=True, max_context=c["max_context"], dtype=c["compute_dtype"],
        kv_dtype=c["kv_dtype"], layer_types=tuple(c["layer_types"]),
        conv_kernel=c["conv_L_cache"], n_experts=c["num_experts"],
        n_experts_per_tok=c["num_experts_per_tok"],
        moe_intermediate_size=c["moe_intermediate_size"], n_dense_layers=c["num_dense_layers"])


def _kinds(m: dict) -> Tuple[int, int, int, int]:
    Lc = sum(t == "conv" for t in m["layer_types"])
    La = len(m["layer_types"]) - Lc
    Ld = m["num_dense_layers"]
    return Lc, La, Ld, m["num_hidden_layers"] - Ld


def specs(m: dict) -> List[Tuple[str, tuple, str, float]]:
    """The program's LFM2 tree (`models/lfm2.py`) for `weights._fill`:
    projections N(0, 1/fan_in), conv taps N(0, 1/K), the embedding
    N(0, 0.02^2), norm gains 1 + N(0, 0.1^2), expert bias N(0, 0.1^2);
    `route_by_token` then gives the router its codes."""
    D, Dh, K = m["hidden_size"], m["head_dim"], m["conv_L_cache"]
    Q, KV = m["num_attention_heads"] * Dh, m["num_key_value_heads"] * Dh
    F, Fe, E = m["intermediate_size"], m["moe_intermediate_size"], m["num_experts"]
    L, V = m["num_hidden_layers"], weights.round_up(m["vocab_size"], 256)
    Lc, La, Ld, Lm = _kinds(m)
    s = [("embed", (V, D), "w", 0.02), ("final_norm", (D,), "gain", 0.1),
         ("layers/op_norm", (L, D), "gain", 0.1), ("layers/ffn_norm", (L, D), "gain", 0.1),
         ("conv/in_proj", (Lc, D, 3 * D), "w", D ** -0.5),
         ("conv/conv_w", (Lc, K, D), "w", K ** -0.5),
         ("conv/out_proj", (Lc, D, D), "w", D ** -0.5)]
    for name, shape in (("wq", (D, Q)), ("wk", (D, KV)), ("wv", (D, KV)), ("wo", (Q, D))):
        s.append((f"attn/{name}", (La, *shape), "w", shape[0] ** -0.5))
    s += [("attn/q_norm", (La, Dh), "gain", 0.1), ("attn/k_norm", (La, Dh), "gain", 0.1)]
    for name, shape in (("w_gate", (D, F)), ("w_up", (D, F)), ("w_down", (F, D))):
        s.append((f"dense/{name}", (Ld, *shape), "w", shape[0] ** -0.5))
    s += [("moe/router", (Lm, D, E), "w", D ** -0.5), ("moe/expert_bias", (Lm, E), "bias", 0.1)]
    for name, shape in (("w_gate", (D, Fe)), ("w_up", (D, Fe)), ("w_down", (Fe, D))):
        s.append((f"moe/{name}", (Lm, E, *shape), "w", shape[0] ** -0.5))
    return s


def params(m: dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    return route_by_token(m, weights._fill(specs(m), seed, device, dtype), seed)


# the router's weight on its code dims: a chosen expert's logit is at least
# ROUTE_GAIN x gain / RMS(x) >= 4 while the residual stream's RMS stays
# below 16, and an unchosen one's as far below 0
ROUTE_GAIN = 64.0


def route_by_token(m: dict, p: Dict, seed: int) -> Dict:
    """Routing with margins, in place. A random router puts a token's 4th and
    5th expert scores within bf16 rounding of each other in a few percent
    of its (token, layer) choices, and a flipped expert changes the residual
    stream enough to flip later ones, so a bf16 program and its f32
    reference part ways on most long requests whatever the program's
    faults. Here each token id carries a code in the last `num_experts`
    hidden dims of its embedding: +1 on `num_experts_per_tok` experts drawn
    from the seed, -1 on the others. No layer writes those dims (the output
    projections' columns there are 0) and the final norm's gain there is 0,
    so the head never reads them; MoE layer j's router reads code dim s
    alone into expert perm_j[s], with weight ROUTE_GAIN. Its logits are then
    about +-ROUTE_GAIN / RMS(x) and the chosen experts' scores stand apart
    from the rest by far more than rounding, on every token: each token id
    takes its own experts in each layer, and the expert bias moves no
    choice."""
    D, E, k = m["hidden_size"], m["num_experts"], m["num_experts_per_tok"]
    Lm = m["num_hidden_layers"] - m["num_dense_layers"]
    emb = p["embed"]
    dev = emb.device
    gen = torch.Generator(device=dev).manual_seed((int(seed) + 0x9E3779B9) % (1 << 63))
    pick = torch.rand((emb.shape[0], E), generator=gen, device=dev).topk(k, dim=1).indices
    code = torch.full((emb.shape[0], E), -1.0, device=dev).scatter_(1, pick, 1.0)
    emb[:, D - E:] = code.to(emb.dtype)
    for w in (p["conv"]["out_proj"], p["attn"]["wo"], p["dense"]["w_down"],
              p["moe"]["w_down"]):
        w[..., D - E:] = 0
    p["final_norm"][D - E:] = 0
    perm = torch.rand((Lm, E), generator=gen, device=dev).argsort(dim=1)
    router = p["moe"]["router"]
    router.zero_()
    layer = torch.arange(Lm, device=dev)[:, None].expand(Lm, E)
    dim = torch.arange(D - E, D, device=dev)[None, :].expand(Lm, E)
    router[layer, dim, perm] = ROUTE_GAIN
    return p


# --- counts ----------------------------------------------------------------------


def expert_matrix_bytes(m: dict, nbytes: float = 2.0) -> float:
    """One expert's gate, up and down weights."""
    return 3.0 * m["hidden_size"] * m["moe_intermediate_size"] * nbytes


def expert_flops(m: dict, pairs: float) -> float:
    """The grouped expert kernel's FLOPs for `pairs` (token, expert) pairs:
    2 x 3 x D x Fe each."""
    return 2.0 * 3 * m["hidden_size"] * m["moe_intermediate_size"] * pairs


def expert_bytes(m: dict, touched: float, pairs: float) -> float:
    """The kernel's bytes for one call: the weights of the `touched` experts
    (those that took at least one row), once, and each pair's bf16 input row
    in and f32 output row out."""
    D = m["hidden_size"]
    return touched * expert_matrix_bytes(m) + pairs * (2.0 * D + 4.0 * D)


def flops_per_token(m: dict, head_columns: int) -> float:
    """2 x the multiply-adds of one token through every layer with its
    `num_experts_per_tok` active experts, and the LM head over
    `head_columns` columns; attention's scores apart. The conv's taps and
    the router are counted; the norms are not."""
    D, Dh, K = m["hidden_size"], m["head_dim"], m["conv_L_cache"]
    Q, KV = m["num_attention_heads"] * Dh, m["num_key_value_heads"] * Dh
    F, Fe, E, k = (m["intermediate_size"], m["moe_intermediate_size"], m["num_experts"],
                   m["num_experts_per_tok"])
    Lc, La, Ld, Lm = _kinds(m)
    conv = D * 3 * D + K * D + D * D
    attn = D * Q + 2 * D * KV + Q * D
    return 2.0 * (Lc * conv + La * attn + Ld * 3 * D * F + Lm * (D * E + k * 3 * D * Fe)
                  + D * head_columns)


def attention_flops(m: dict, attended: float) -> float:
    """QK^T and PV of one query over `attended` keys in every attention layer
    (a sum of attended counts gives the sum over tokens)."""
    _, La, _, _ = _kinds(m)
    return 4.0 * La * m["num_attention_heads"] * m["head_dim"] * attended

