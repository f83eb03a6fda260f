"""Moonlight configurations (HF `deepseek_v3`): the program's config from a
configuration file, the seeded weights in the published layout (the program
and the reference both take it), and the operations and bytes of the
model, of its multi-head latent attention decode kernel and of its grouped
expert kernel, from shapes alone.

The file holds the published sizes under their Hugging Face names
(`hidden_size`, `kv_lora_rank`, `n_routed_experts`, ...), `vocab_size` as
published (the text tokenizer's), and the NeuTTS layout beside it:
`text_tokens` + 6 control tokens + `codebook_size` speech codes make
`extended_vocab_size`, the vocabulary the model serves.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from benchmark.harness import weights
# the expert counts read the same keys as LFM2's (hidden_size, moe_intermediate_size)
from benchmark.harness.lfm2 import expert_bytes, expert_flops, expert_matrix_bytes  # noqa: F401

SIZE_KEYS = ("hidden_size", "num_hidden_layers", "num_attention_heads", "kv_lora_rank",
             "qk_nope_head_dim", "qk_rope_head_dim", "v_head_dim", "intermediate_size",
             "moe_intermediate_size", "n_routed_experts", "num_experts_per_tok",
             "n_shared_experts", "first_k_dense_replace", "norm_topk_prob",
             "routed_scaling_factor", "rope_theta", "rms_norm_eps")


def sizes(c: dict) -> dict:
    """The sizes the weights, the reference and the counts read; `vocab_size`
    is the served (extended) vocabulary."""
    m = {k: c[k] for k in SIZE_KEYS}
    m["vocab_size"] = c["extended_vocab_size"]
    return m


def backbone_config(c: dict):
    from neutts_tpu_torch.config import SPECIAL_TOKEN_NAMES, MoonlightConfig

    vocab = c["text_tokens"] + len(SPECIAL_TOKEN_NAMES) + c["codebook_size"]
    if vocab != c["extended_vocab_size"]:
        raise ValueError(f"{c['name']}: extended_vocab_size {c['extended_vocab_size']} is not "
                         f"text + specials + codebook ({vocab})")
    if (c["q_lora_rank"] is not None or c["n_group"] != 1 or c["topk_group"] != 1
            or c["scoring_func"] != "sigmoid" or c["topk_method"] != "noaux_tc"
            or not c["norm_topk_prob"] or c["tie_word_embeddings"] or c["attention_bias"]
            or c["moe_layer_freq"] != 1 or c["num_nextn_predict_layers"] != 0
            or c["num_key_value_heads"] != c["num_attention_heads"]):
        raise ValueError(f"{c['name']}: the port's Moonlight block has no query low-rank, one "
                         "routing group, sigmoid scores with a correction bias, normalised "
                         "top-k weights, an untied head and an expert layer in every layer "
                         "after the dense ones")
    return MoonlightConfig(
        name=c["name"], vocab_size=vocab, n_text_tokens=c["text_tokens"],
        hidden_size=c["hidden_size"], n_layers=c["num_hidden_layers"],
        n_heads=c["num_attention_heads"], n_kv_heads=c["num_key_value_heads"],
        head_dim=c["qk_nope_head_dim"], intermediate_size=c["intermediate_size"],
        rope_theta=float(c["rope_theta"]), rms_norm_eps=float(c["rms_norm_eps"]),
        tie_embeddings=False, max_context=c["max_context"], dtype=c["compute_dtype"],
        kv_dtype=c["kv_dtype"], kv_lora_rank=c["kv_lora_rank"],
        qk_nope_head_dim=c["qk_nope_head_dim"], qk_rope_head_dim=c["qk_rope_head_dim"],
        v_head_dim=c["v_head_dim"], n_experts=c["n_routed_experts"],
        n_experts_per_tok=c["num_experts_per_tok"], n_shared_experts=c["n_shared_experts"],
        moe_intermediate_size=c["moe_intermediate_size"],
        n_dense_layers=c["first_k_dense_replace"],
        routed_scaling_factor=float(c["routed_scaling_factor"]))


def _dims(m: dict):
    return (m["hidden_size"], m["num_attention_heads"], m["qk_nope_head_dim"],
            m["qk_rope_head_dim"], m["v_head_dim"], m["kv_lora_rank"])


def _kinds(m: dict) -> Tuple[int, int, int]:
    L, Ld = m["num_hidden_layers"], m["first_k_dense_replace"]
    return L, Ld, L - Ld


def shared_width(m: dict) -> int:
    return m["n_shared_experts"] * m["moe_intermediate_size"]


def specs(m: dict) -> List[Tuple[str, tuple, str, float]]:
    """The program's Moonlight tree in the published layout
    (`models/moonlight.py`) for `weights._fill`: projections N(0, 1/fan_in),
    the embedding and the head N(0, 0.02^2), norm gains 1 + N(0, 0.1^2),
    correction bias N(0, 0.1^2); `route_by_token` then gives the router its
    codes."""
    D, H, dn, dr, dv, r = _dims(m)
    F, Fe, E, Fs = (m["intermediate_size"], m["moe_intermediate_size"], m["n_routed_experts"],
                    shared_width(m))
    L, Ld, Lm = _kinds(m)
    V = weights.round_up(m["vocab_size"], 256)
    s = [("embed", (V, D), "w", 0.02), ("lm_head", (D, V), "w", 0.02),
         ("final_norm", (D,), "gain", 0.1),
         ("layers/attn_norm", (L, D), "gain", 0.1), ("layers/ffn_norm", (L, D), "gain", 0.1)]
    for name, shape in (("wq", (D, H * (dn + dr))), ("wkva", (D, r + dr)),
                        ("wkvb", (r, H * (dn + dv))), ("wo", (H * dv, D))):
        s.append((f"attn/{name}", (L, *shape), "w", shape[0] ** -0.5))
    s.append(("attn/kv_norm", (L, r), "gain", 0.1))
    for name, shape in (("w_gate", (D, F)), ("w_up", (D, F)), ("w_down", (F, D))):
        s.append((f"dense/{name}", (Ld, *shape), "w", shape[0] ** -0.5))
    s += [("moe/router", (Lm, D, E), "w", D ** -0.5), ("moe/expert_bias", (Lm, E), "bias", 0.1)]
    for name, shape in (("w_gate", (D, Fe)), ("w_up", (D, Fe)), ("w_down", (Fe, D))):
        s.append((f"moe/{name}", (Lm, E, *shape), "w", shape[0] ** -0.5))
    for name, shape in (("w_gate", (D, Fs)), ("w_up", (D, Fs)), ("w_down", (Fs, D))):
        s.append((f"shared/{name}", (Lm, *shape), "w", shape[0] ** -0.5))
    return s


def params(m: dict, seed: int, device, dtype=torch.bfloat16) -> Dict:
    return route_by_token(m, weights._fill(specs(m), seed, device, dtype), seed)


# the router's weight on its code dims: a chosen expert's logit is at least
# ROUTE_GAIN / RMS(x) >= 8 and an unchosen one's at most -ROUTE_GAIN x
# 6/58 / RMS(x) <= -0.8 while the residual stream's RMS stays below 16,
# so a chosen score leads an unchosen one by >= 0.69, beyond the spread of
# 64 correction biases of N(0, 0.1^2)
ROUTE_GAIN = 128.0


def route_by_token(m: dict, p: Dict, seed: int) -> Dict:
    """Routing with margins, in place, as `harness/lfm2.route_by_token` gives
    LFM2 its, with a code of mean 0: each token id carries a code in the
    last `n_routed_experts` hidden dims of its embedding, +1 on
    `num_experts_per_tok` experts drawn from the seed and -k / (E - k) on the
    others, so that each code dim averages 0 over the token ids. No layer
    writes those dims (the columns there of the attention's output
    projection, the dense down projection and the routed and shared
    experts' down projections are 0) and the final norm's gain there is 0,
    so the head never reads them; MoE layer j's router reads code dim s
    alone into expert perm_j[s] with weight ROUTE_GAIN. The chosen experts'
    scores then stand apart from the rest by far more than bf16 rounding,
    on every token, and the correction bias moves no choice. A code of +1
    and -1 would add the same vector (-0.81 on each code dim) to every
    token's embedding; on random weights that shared part survives every
    layer, greedy slots converge on the few speech codes it favours, and
    those tokens' experts take 2-4.6x the mean load. With mean 0 no vector
    is common to the codes."""
    D, E, k = m["hidden_size"], m["n_routed_experts"], m["num_experts_per_tok"]
    _, _, Lm = _kinds(m)
    emb = p["embed"]
    dev = emb.device
    gen = torch.Generator(device=dev).manual_seed((int(seed) + 0x9E3779B9) % (1 << 63))
    pick = torch.rand((emb.shape[0], E), generator=gen, device=dev).topk(k, dim=1).indices
    code = torch.full((emb.shape[0], E), -k / (E - k), device=dev).scatter_(1, pick, 1.0)
    emb[:, D - E:] = code.to(emb.dtype)
    for w in (p["attn"]["wo"], p["dense"]["w_down"], p["moe"]["w_down"], p["shared"]["w_down"]):
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


def latent_row(m: dict) -> int:
    """Values of one cached latent row: the latent, then the rotary key."""
    return m["kv_lora_rank"] + m["qk_rope_head_dim"]


def flops_per_token(m: dict, head_columns: int, decode: bool = True) -> float:
    """2 x the multiply-adds of one token through every layer, attention's
    per-key products apart: MLA's projections (q, the latent and rotary
    key, the output; a decode's absorb product W_UK^T q_nope and un-absorb
    product W_UV^T o per head, a prefill's per-head keys and values from the
    latent), the dense SwiGLU, each expert layer's router, its top-k routed
    experts and its shared experts, and the LM head over `head_columns`."""
    D, H, dn, dr, dv, r = _dims(m)
    F, Fe, E, k = (m["intermediate_size"], m["moe_intermediate_size"], m["n_routed_experts"],
                   m["num_experts_per_tok"])
    L, Ld, Lm = _kinds(m)
    mla = D * H * (dn + dr) + D * (r + dr) + H * dv * D
    mla += H * (dn * r + r * dv) if decode else r * H * (dn + dv)
    return 2.0 * (L * mla + Ld * 3 * D * F + Lm * (D * E + k * 3 * D * Fe + 3 * D * shared_width(m))
                  + D * head_columns)


def mla_decode_flops(m: dict, attended: float) -> float:
    """The absorbed attention of one decode query over `attended` keys in
    every layer: each head's score over the latent row and its sum over
    the latent (2 x H x (row + latent)); a sum of attended counts gives the
    sum over tokens."""
    D, H, dn, dr, dv, r = _dims(m)
    return 2.0 * m["num_hidden_layers"] * H * (latent_row(m) + r) * attended


def prefill_attention_flops(m: dict, attended: float) -> float:
    """A prefill's non-absorbed attention over `attended` causal keys in
    every layer: QK^T over the q/k head, PV over the value head."""
    D, H, dn, dr, dv, r = _dims(m)
    return 2.0 * m["num_hidden_layers"] * H * (dn + dr + dv) * attended


def mla_decode_bytes(m: dict, attended: float, rows: int, row_bytes: float = 1.0,
                     scale_bytes: float = 4.0, q_bytes: float = 2.0) -> float:
    """One layer of the MLA decode kernel: `attended` latent rows (the
    settled rows and the staging columns each query reads: values and
    scale), the bf16 query [H, row] in and the bf16 output [H, latent] out
    of `rows` queries."""
    D, H, dn, dr, dv, r = _dims(m)
    R = latent_row(m)
    return attended * (R * row_bytes + scale_bytes) + rows * H * (R + r) * q_bytes
