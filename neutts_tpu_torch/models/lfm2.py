"""LFM2-MoE speech-LM backbone in PyTorch (LiquidAI LFM2-8B-A1B's block, HF
`lfm2_moe`), for the serving engine. A port-only model: the JAX package
runs the Qwen2 block alone.

Each layer is `x + op(operator_norm(x))` then `x + ffn(ffn_norm(x))`, with
op one of
  * a gated short convolution: in_proj D -> 3D split into B, C, x; Bx = B * x;
    a causal depthwise convolution of `conv_kernel` taps over Bx; y = C * conv;
    out_proj. Positions of a left pad are zeroed before in_proj, so a padded
    prompt convolves as the unpadded one;
  * GQA attention with RMSNorm over each head's q and k before RoPE and no
    QKV bias;
and ffn a dense SwiGLU in the first `n_dense_layers` layers and routed
experts after them (`ops/moe.py`). A final RMSNorm, then the LM head, tied
to the embedding.

Parameters, stacked by kind on a leading axis:
  embed [V, D]; final_norm [D];
  layers/op_norm, layers/ffn_norm [L, D] (every layer);
  conv/in_proj [Lc, D, 3D], conv/conv_w [Lc, K, D] (tap j weighs the input
    K - 1 - j positions back; HF conv.weight[d, 0, j]), conv/out_proj [Lc, D, D];
  attn/wq [La, D, H*Dh], attn/wk, attn/wv [La, D, K*Dh], attn/wo [La, H*Dh, D],
    attn/q_norm, attn/k_norm [La, Dh];
  dense/w_gate, dense/w_up [Ld, D, F], dense/w_down [Ld, F, D];
  moe/router [Lm, D, E], moe/expert_bias [Lm, E] f32, moe/w_gate, moe/w_up
    [Lm, E, D, Fe], moe/w_down [Lm, E, Fe, D].

State beside the KV cache (which holds the La attention layers only): the
conv state [Lc, B, K - 1, D], each conv layer's last K - 1 gated inputs Bx
per row, in the model dtype. A decode step reads and replaces it in place.

Precision: bf16 (or f32) weights and activations; every product has an f32
result (`backbone.matmul_f32`), rounded to the model dtype where it becomes
the next product's operand (Bx, C * conv, q/k/v, the SwiGLU activation) or
the residual; the convolution's taps, the routing and the experts' combine
are f32.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from neutts_tpu_torch.config import Lfm2Config
from neutts_tpu_torch.models import backbone as bb
from neutts_tpu_torch.ops import attention as attn_ops
from neutts_tpu_torch.ops import moe as moe_ops
from neutts_tpu_torch.utils import span

Params = Dict[str, object]


def is_lfm2(cfg) -> bool:
    return isinstance(cfg, Lfm2Config)


def plan(cfg: Lfm2Config) -> Tuple[Tuple[str, int, str, int], ...]:
    """Per layer: (op kind "conv" | "attn", its index among that kind's
    stacked weights (the attention index is its KV cache layer), ffn kind
    "dense" | "moe", its index among those)."""
    out, n_conv, n_attn = [], 0, 0
    for l, t in enumerate(cfg.layer_types):
        if t == "conv":
            op, n_conv = ("conv", n_conv), n_conv + 1
        else:
            op, n_attn = ("attn", n_attn), n_attn + 1
        ffn = ("dense", l) if l < cfg.n_dense_layers else ("moe", l - cfg.n_dense_layers)
        out.append((*op, *ffn))
    return tuple(out)


def init_params(cfg: Lfm2Config, seed: int = 0, device="cuda", dtype=None) -> Params:
    """Random weights from `seed`, made on `device`: projections N(0, 1/fan_in),
    conv taps N(0, 1/K), embedding N(0, 0.02^2), unit norms, zero expert bias."""
    dtype = dtype or bb.torch_dtype(cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    D, V, Dh = cfg.hidden_size, cfg.padded_vocab, cfg.head_dim
    Lc, La = len(cfg.conv_layers), len(cfg.attn_layers)
    Ld, Lm = cfg.n_dense_layers, cfg.n_moe_layers
    E, Fe, Fd, K = cfg.n_experts, cfg.moe_intermediate_size, cfg.intermediate_size, cfg.conv_kernel

    def dense(shape, scale=None):
        scale = scale if scale is not None else shape[-2] ** -0.5
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w * scale).to(dtype)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=dtype)

    return {
        "embed": dense((V, D), scale=0.02),
        "layers": {"op_norm": ones((cfg.n_layers, D)), "ffn_norm": ones((cfg.n_layers, D))},
        "conv": {"in_proj": dense((Lc, D, 3 * D)), "conv_w": dense((Lc, K, D), scale=K ** -0.5),
                 "out_proj": dense((Lc, D, D))},
        "attn": {"wq": dense((La, D, cfg.q_dim)), "wk": dense((La, D, cfg.kv_dim)),
                 "wv": dense((La, D, cfg.kv_dim)), "wo": dense((La, cfg.q_dim, D)),
                 "q_norm": ones((La, Dh)), "k_norm": ones((La, Dh))},
        "dense": {"w_gate": dense((Ld, D, Fd)), "w_up": dense((Ld, D, Fd)),
                  "w_down": dense((Ld, Fd, D))},
        "moe": {"router": dense((Lm, D, E)),
                "expert_bias": torch.zeros((Lm, E), device=device, dtype=torch.float32),
                "w_gate": dense((Lm, E, D, Fe)), "w_up": dense((Lm, E, D, Fe)),
                "w_down": dense((Lm, E, Fe, D))},
        "final_norm": ones((D,)),
    }


def layer_params(cfg: Lfm2Config, params: Params) -> List[Params]:
    """Each layer's weights (views, no copy) with its plan: "kind", "i",
    "ffn", "j"."""
    if any(isinstance(v, dict) for v in params["attn"].values()):
        raise NotImplementedError(f"{cfg.name}: the LFM2 block serves bf16 or f32 weights, "
                                  "not quantized ones")
    out = []
    for l, (kind, i, ffn, j) in enumerate(plan(cfg)):
        lp = {"kind": kind, "i": i, "ffn": ffn, "j": j,
              "op_norm": params["layers"]["op_norm"][l],
              "ffn_norm": params["layers"]["ffn_norm"][l]}
        lp.update({k: v[i] for k, v in params[kind].items()})
        lp.update({f"{ffn}_{k}": v[j] for k, v in params[ffn].items()})
        out.append(lp)
    return out


# --- the operators ------------------------------------------------------------


def _conv_in(lp: Params, h: torch.Tensor):
    """h [B, S, D] normed -> (Bx [B, S, D] in h's dtype, C [B, S, D] f32)."""
    b, c, xx = bb.matmul_f32(h, lp["in_proj"]).chunk(3, dim=-1)
    return (b * xx).to(h.dtype), c


def _taps(window: torch.Tensor, w: torch.Tensor, S: int) -> torch.Tensor:
    """Causal depthwise convolution: window [B, S + K - 1, D] (the K - 1
    inputs before the first output, then S inputs), w [K, D] -> f32
    [B, S, D], taps summed first to last."""
    out = window[:, 0:S].float() * w[0].float()
    for j in range(1, w.shape[0]):
        out = out + window[:, j:j + S].float() * w[j].float()
    return out


def _conv_out(lp: Params, c: torch.Tensor, conv: torch.Tensor, dtype) -> torch.Tensor:
    return bb.matmul_f32((c * conv).to(dtype), lp["out_proj"])


def conv_fresh(cfg: Lfm2Config, lp: Params, h: torch.Tensor, valid: torch.Tensor):
    """The conv operator over a fresh left-padded window h [B, S, D] (valid
    [B, S] False on the pad). Returns (out [B, S, D] f32, state [B, K-1, D]:
    the last K - 1 gated inputs, zeros before the prompt)."""
    S = h.shape[1]
    bx, c = _conv_in(lp, torch.where(valid[..., None], h, torch.zeros_like(h)))
    window = F.pad(bx, (0, 0, cfg.conv_kernel - 1, 0))
    return _conv_out(lp, c, _taps(window, lp["conv_w"], S), h.dtype), window[:, S:]


def conv_step(lp: Params, h: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """The conv operator for one token h [B, 1, D]; replaces `state`
    [B, K-1, D] in place by its window's last K - 1 inputs."""
    bx, c = _conv_in(lp, h)
    window = torch.cat([state, bx], dim=1)
    out = _conv_out(lp, c, _taps(window, lp["conv_w"], 1), h.dtype)
    state.copy_(window[:, 1:])
    return out


def _qkv(cfg: Lfm2Config, lp: Params, h, cos, sin):
    """h [B, S, D] -> q [B, S, H, Dh], k/v [B, S, K, Dh]: per-head RMSNorm of
    q and k, then RoPE on both."""
    B, S, _ = h.shape
    Dh, eps = cfg.head_dim, cfg.rms_norm_eps
    q = bb.matmul_f32(h, lp["wq"]).to(h.dtype).reshape(B, S, -1, Dh)
    k = bb.matmul_f32(h, lp["wk"]).to(h.dtype).reshape(B, S, -1, Dh)
    v = bb.matmul_f32(h, lp["wv"]).to(h.dtype).reshape(B, S, -1, Dh)
    q = bb.apply_rope(bb.rms_norm(q, lp["q_norm"], eps), cos, sin)
    k = bb.apply_rope(bb.rms_norm(k, lp["k_norm"], eps), cos, sin)
    return q, k, v


def moe(cfg: Lfm2Config, lp: Params, h: torch.Tensor,
        expert_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Routed experts over h [B, S, D] normed -> f32 [B, S, D]: each token's
    top-k experts' outputs weighted by the router. `expert_rows` [2, E], when
    given, gains the rows routed to each expert and a 1 for each expert
    that took any (on the device)."""
    B, S, D = h.shape
    k, E = cfg.n_experts_per_tok, cfg.n_experts
    flat = h.reshape(-1, D)
    with span("moe.route", rows=B * S):
        idx, w = moe_ops.route(bb.matmul_f32(flat, lp["moe_router"]), lp["moe_expert_bias"], k)
        perm, offsets, counts = moe_ops.sort_pairs(idx, E)
        if expert_rows is not None:
            expert_rows[0].add_(counts)
            expert_rows[1].add_(counts.clamp(max=1))
    with span("moe.experts", rows=B * S):
        y = moe_ops.grouped_swiglu(flat, perm, offsets, lp["moe_w_gate"], lp["moe_w_up"],
                                   lp["moe_w_down"], k)
    return (y.view(-1, k, D) * w[..., None]).sum(dim=1).reshape(B, S, D)


# token rows of a prefill's FFN at a time: bounds an admission's f32
# intermediates (a 256 x 512 group's whole would take ~20 GB)
FFN_CHUNK = 32768


def _ffn(cfg: Lfm2Config, lp: Params, x: torch.Tensor,
         expert_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, S, D = x.shape
    if B * S > FFN_CHUNK:
        flat = x.reshape(1, B * S, D)
        return torch.cat([_ffn(cfg, lp, flat[:, i:i + FFN_CHUNK], expert_rows)
                          for i in range(0, B * S, FFN_CHUNK)], dim=1).reshape(B, S, D)
    h = bb.rms_norm(x, lp["ffn_norm"], cfg.rms_norm_eps)
    if lp["ffn"] == "dense":
        gate, up = bb.matmul_f32(h, lp["dense_w_gate"]), bb.matmul_f32(h, lp["dense_w_up"])
        y = bb.matmul_f32((F.silu(gate) * up).to(x.dtype), lp["dense_w_down"])
    else:
        y = moe(cfg, lp, h, None if expert_rows is None else expert_rows[lp["j"]])
    return x + y.to(x.dtype)


# --- prefill and decode -------------------------------------------------------


def prefill_hidden(cfg: Lfm2Config, params: Params, tokens: torch.Tensor,
                   prompt_lens: torch.Tensor, store, conv_store) -> torch.Tensor:
    """Every layer over left-padded prompts [B, Lp] (true lengths
    prompt_lens [B]); store(i, k, v) keeps attention layer i's K/V [B, Lp, KD]
    and conv_store(i, state) conv layer i's state [B, K-1, D] where the
    caller holds them. Returns the final-normed hidden state of the last
    position [B, D]."""
    B, Lp = tokens.shape
    dev = tokens.device
    pad = (Lp - prompt_lens).to(torch.int32)
    idx = torch.arange(Lp, dtype=torch.int32, device=dev)
    positions = torch.clamp(idx[None, :] - pad[:, None], min=0)
    valid = idx[None, :] >= pad[:, None]
    cos, sin = bb.rope_tables(cfg.head_dim, cfg.rope_theta, positions)
    x = params["embed"].to(bb.torch_dtype(cfg.dtype))[tokens.long()]
    for lp in layer_params(cfg, params):
        h = bb.rms_norm(x, lp["op_norm"], cfg.rms_norm_eps)
        if lp["kind"] == "conv":
            out, state = conv_fresh(cfg, lp, h, valid)
            conv_store(lp["i"], state)
        else:
            q, k, v = _qkv(cfg, lp, h, cos, sin)
            attn = attn_ops.prefill_attention(q.contiguous(), k.contiguous(), v.contiguous(), pad)
            out = bb.matmul_f32(attn.reshape(B, Lp, -1), lp["wo"])
            store(lp["i"], k.reshape(B, Lp, -1), v.reshape(B, Lp, -1))
        x = _ffn(cfg, lp, x + out.to(x.dtype))
    return bb.rms_norm(x[:, -1, :], params["final_norm"], cfg.rms_norm_eps)


def decode_hidden(cfg: Lfm2Config, params: Params, layers: List[Params], token: torch.Tensor,
                  positions: torch.Tensor, attend, conv: torch.Tensor,
                  expert_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Every layer of one decode step: token [B] at RoPE positions [B].
    `layers` holds `layer_params`. attend(i, q [B,K,G,Dh], k [B,KD], v [B,KD])
    stores attention layer i's K/V where the caller keeps the cache and
    returns the attention [B,K,G,Dh]; conv [Lc, B, K-1, D] is the conv state,
    updated in place; expert_rows [Lm, 2, E] gains each MoE layer's routed
    rows and touched experts. Returns the final-normed hidden state [B, D]."""
    B = token.shape[0]
    cos, sin = bb.rope_tables(cfg.head_dim, cfg.rope_theta, positions[:, None])
    x = params["embed"].to(bb.torch_dtype(cfg.dtype))[token.long()[:, None]]
    for lp in layers:
        h = bb.rms_norm(x, lp["op_norm"], cfg.rms_norm_eps)
        if lp["kind"] == "conv":
            out = conv_step(lp, h, conv[lp["i"]])
        else:
            q, k, v = _qkv(cfg, lp, h, cos, sin)
            a = attend(lp["i"], q[:, 0].reshape(B, cfg.n_kv_heads, -1, cfg.head_dim).contiguous(),
                       k[:, 0].reshape(B, -1), v[:, 0].reshape(B, -1))
            out = bb.matmul_f32(a.to(x.dtype).reshape(B, 1, -1), lp["wo"])
        x = _ffn(cfg, lp, x + out.to(x.dtype), expert_rows)
    return bb.rms_norm(x[:, 0, :], params["final_norm"], cfg.rms_norm_eps)


def conv_state_shape(cfg: Lfm2Config, batch: int) -> Tuple[int, ...]:
    return (len(cfg.conv_layers), batch, cfg.conv_kernel - 1, cfg.hidden_size)
