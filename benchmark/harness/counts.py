"""Operations and bytes of the model and of its kernels, from shapes alone,
and the card's published peaks.

Each input byte is counted once and each output byte once, whatever a
kernel reads again; where the work depends on the data (the live length of
a slot, the real rows of an admission group), the count is of what these
inputs need, not of what the kernel pads them to. A roofline share is then
max(operations / peak, bytes / bandwidth) over the kernel's device time.
"""

from __future__ import annotations

# NVIDIA H100 SXM data sheet, dense (no sparsity), at the 700 W limit
HBM_BYTES_PER_S = 3.35e12
PEAK_BF16 = 989e12  # tensor-core bf16 flop/s
PEAK_INT8 = 1979e12  # tensor-core int8 op/s


def peak(config: dict) -> float:
    """The tensor-core peak of the precision the configuration's weights are
    served in."""
    return PEAK_INT8 if config.get("weights") == "int8" else PEAK_BF16


def bound_s(ops: float, nbytes: float, peak: float) -> float:
    """Least seconds the work can take on the card."""
    return max(ops / peak, nbytes / HBM_BYTES_PER_S)


def sizes(m: dict):
    D, L, F = m["hidden_size"], m["num_hidden_layers"], m["intermediate_size"]
    H, K, Dh = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
    return D, L, F, H, K, Dh


def dense_flops_per_token(m: dict, head_columns: int) -> float:
    """2 x the multiply-adds of the projections, the MLP and the LM head
    (over `head_columns` real columns) for one token; attention apart."""
    D, L, F, H, K, Dh = sizes(m)
    per_layer = D * H * Dh + 2 * D * K * Dh + H * Dh * D + 3 * D * F
    return 2.0 * (L * per_layer + D * head_columns)


def attention_flops(m: dict, attended: float) -> float:
    """QK^T and PV of one query token over `attended` keys, all layers
    (a sum of attended counts gives the sum over tokens)."""
    D, L, F, H, K, Dh = sizes(m)
    return 4.0 * L * H * Dh * attended


def prefill_attention_keys(n: int) -> float:
    """Keys attended by the n causal queries of one prompt of n tokens."""
    return n * (n + 1) / 2.0


def staged_attention_bytes(m: dict, live: float, rows: int, kv_bytes: float = 1.0,
                           scale_bytes: float = 4.0, q_bytes: float = 2.0) -> float:
    """One layer of the staged decode attention (#2): `live` is the sum over
    rows of the tokens each attends (K and V values and their per-token
    scales); q in and the output out for `rows` rows."""
    D, L, F, H, K, Dh = sizes(m)
    return live * 2 * (K * Dh * kv_bytes + scale_bytes) + rows * 2 * H * Dh * q_bytes


def decode_attention_bytes(m: dict, live: float, rows: int, kv_bytes: float = 2.0,
                           q_bytes: float = 2.0) -> float:
    """One layer of the decode attention (#1) over a bf16 cache."""
    D, L, F, H, K, Dh = sizes(m)
    return live * 2 * K * Dh * kv_bytes + rows * 2 * H * Dh * q_bytes


def fused_mlp_ops(m: dict, rows: float) -> float:
    """Int8 operations of the MLP's three products (#6) for `rows` token
    rows, one layer."""
    D, L, F, H, K, Dh = sizes(m)
    return 2.0 * rows * 3 * D * F


def fused_mlp_bytes(m: dict, rows: float) -> float:
    """One layer of #6's products: the int8 weights and their scales once,
    the bf16 rows in and out once (the intermediate between the gate/up and
    the down product is the kernels' own and is not counted)."""
    D, L, F, H, K, Dh = sizes(m)
    return 3 * D * F + 4 * (2 * F + D) + rows * (2 * D + 2 * D)
