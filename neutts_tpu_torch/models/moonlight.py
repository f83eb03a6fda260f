"""Moonlight speech-LM backbone in PyTorch (moonshotai Moonlight-16B-A3B's
block, HF `deepseek_v3`), for the serving engine. A port-only model: the
JAX package runs the Qwen2 block alone.

Each layer is `x + mla(attn_norm(x))` then `x + ffn(ffn_norm(x))`; a final
RMSNorm, then an untied LM head.

Multi-head latent attention (MLA), with no query low-rank: q = h Wq, per
head [nope (qk_nope_head_dim) | rope (qk_rope_head_dim)]; [c | k_pe] =
h Wkva with c the latent (kv_lora_rank) and k_pe one rotary key shared by
every head; c = RMSNorm(c); per head [k_nope | v] = c Wkvb. RoPE on q's
rope part and k_pe; score = (q_nope . k_nope + q_pe . k_pe) / sqrt(nope +
rope), a causal softmax, o = sum p v, out = [o_1 .. o_H] Wo.
  * A prefill takes that form through the prefill kernel (#5): k is
    [k_nope | k_pe] for each head, and v, 128 wide, is zero-padded to the
    192-wide q/k head the kernel takes; the padding's output columns are
    dropped.
  * A decode step takes the absorbed form, the same function: with Wkvb's
    head blocks [W_UK | W_UV], q~ = q_nope W_UK^T (the latent query),
    score = (q~ . c + q_pe . k_pe) x scale and o = (sum p c) W_UV. So a
    token's cache is its latent row [c | k_pe] (576 values at Moonlight's
    widths), kept once for all heads (`backbone.KVCache` in latent mode),
    and the attention over it is the MLA kernel
    (`ops/attention.mla_decode_staged`). The absorb and un-absorb products
    are batched bf16 products with f32 results (`backbone.bmm_f32`).
  * RoPE: the published weights put each rotary pair (2i, 2i+1) side by
    side and HF de-interleaves them before a half-split rotation.
    `prepare_params` permutes the rope columns of Wq and Wkva once, so that
    the port's half-split `backbone.apply_rope` gives the same scores.

FFN: a dense SwiGLU (`intermediate_size`) in the first `n_dense_layers`
layers; after them the routed experts (`ops/moe.py`: sigmoid scores, top-k
of score + correction bias, weights normalised and scaled by
`routed_scaling_factor`) through the grouped expert kernel, plus the shared
experts as one dense SwiGLU of n_shared_experts x moe_intermediate_size.

Parameters as published (the plain reference reads this tree), stacked by
kind on a leading axis:
  embed [V, D]; lm_head [D, V]; final_norm [D];
  layers/attn_norm, layers/ffn_norm [L, D];
  attn/wq [L, D, H*(dn+dr)], attn/wkva [L, D, r+dr], attn/kv_norm [L, r],
    attn/wkvb [L, r, H*(dn+dv)], attn/wo [L, H*dv, D];
  dense/w_gate, dense/w_up [Ld, D, F], dense/w_down [Ld, F, D];
  moe/router [Lm, D, E], moe/expert_bias [Lm, E] f32, moe/w_gate, moe/w_up
    [Lm, E, D, Fe], moe/w_down [Lm, E, Fe, D];
  shared/w_gate, shared/w_up [Lm, D, Fs], shared/w_down [Lm, Fs, D].
`prepare_params` moves Wq and Wkva to "mla" with their rope columns
permuted, beside W_UK^T [L, H, dn, r] and W_UV [L, H, r, dv].

Precision: bf16 (or f32) weights and activations; every product has an f32
result, rounded to the model dtype where it becomes the next product's
operand or the residual; the routing and the experts' combine are f32.

Spans: `mla.absorb` (the absorb and un-absorb products) and `mla.attend`
in a decode step; `moe.route`, `moe.experts` (`models/lfm2.moe`) and
`moe.shared` in an expert layer.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F

from neutts_tpu_torch.config import MoonlightConfig
from neutts_tpu_torch.models import backbone as bb
from neutts_tpu_torch.models import lfm2
from neutts_tpu_torch.ops import attention as attn_ops
from neutts_tpu_torch.utils import span

Params = Dict[str, object]


def init_params(cfg: MoonlightConfig, seed: int = 0, device="cuda", dtype=None) -> Params:
    """Random weights from `seed`, made on `device`, in the published layout:
    projections N(0, 1/fan_in), embedding and head N(0, 0.02^2), unit norms,
    zero expert bias."""
    dtype = dtype or bb.torch_dtype(cfg.dtype)
    gen = torch.Generator(device=device).manual_seed(seed)
    D, V, L, H = cfg.hidden_size, cfg.padded_vocab, cfg.n_layers, cfg.n_heads
    dn, dr, dv, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    Ld, Lm, E = cfg.n_dense_layers, cfg.n_moe_layers, cfg.n_experts
    Fd, Fe, Fs = cfg.intermediate_size, cfg.moe_intermediate_size, shared_width(cfg)

    def dense(shape, scale=None):
        scale = scale if scale is not None else shape[-2] ** -0.5
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return (w * scale).to(dtype)

    def ones(shape):
        return torch.ones(shape, device=device, dtype=dtype)

    return {
        "embed": dense((V, D), scale=0.02),
        "lm_head": dense((D, V), scale=0.02),
        "layers": {"attn_norm": ones((L, D)), "ffn_norm": ones((L, D))},
        "attn": {"wq": dense((L, D, H * (dn + dr))), "wkva": dense((L, D, r + dr)),
                 "kv_norm": ones((L, r)), "wkvb": dense((L, r, H * (dn + dv))),
                 "wo": dense((L, H * dv, D))},
        "dense": {"w_gate": dense((Ld, D, Fd)), "w_up": dense((Ld, D, Fd)),
                  "w_down": dense((Ld, Fd, D))},
        "moe": {"router": dense((Lm, D, E)),
                "expert_bias": torch.zeros((Lm, E), device=device, dtype=torch.float32),
                "w_gate": dense((Lm, E, D, Fe)), "w_up": dense((Lm, E, D, Fe)),
                "w_down": dense((Lm, E, Fe, D))},
        "shared": {"w_gate": dense((Lm, D, Fs)), "w_up": dense((Lm, D, Fs)),
                   "w_down": dense((Lm, Fs, D))},
        "final_norm": ones((D,)),
    }


def shared_width(cfg: MoonlightConfig) -> int:
    return cfg.n_shared_experts * cfg.moe_intermediate_size


def rope_permutation(dr: int) -> torch.Tensor:
    """The rope columns' order that de-interleaves pairs (2i, 2i+1) into
    halves: [0, 2, .., dr-2, 1, 3, .., dr-1]."""
    return torch.cat([torch.arange(0, dr, 2), torch.arange(1, dr, 2)])


def prepare_params(cfg: MoonlightConfig, params: Params) -> Params:
    """`params` with "mla": Wq and Wkva with their rope columns permuted
    (`rope_permutation`; they leave "attn"), and Wkvb's head blocks split
    into W_UK^T [L, H, dn, r] and W_UV [L, H, r, dv] for the absorbed
    decode. A tree that has them already is returned as it is."""
    if "mla" in params:
        return params
    a = params["attn"]
    L, H = cfg.n_layers, cfg.n_heads
    dn, dr, dv, r = cfg.qk_nope_head_dim, cfg.qk_rope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    perm = rope_permutation(dr).to(a["wq"].device)
    wq = a["wq"].view(L, -1, H, dn + dr)
    wq = torch.cat([wq[..., :dn], wq[..., dn:].index_select(-1, perm)], dim=-1)
    wkva = torch.cat([a["wkva"][..., :r], a["wkva"][..., r:].index_select(-1, perm)], dim=-1)
    kvb = a["wkvb"].view(L, r, H, dn + dv)
    attn = {k: v for k, v in a.items() if k not in ("wq", "wkva")}  # replaced by "mla"'s
    return {**params, "attn": attn, "mla": {
        "wq": wq.reshape(L, -1, H * (dn + dr)).contiguous(), "wkva": wkva.contiguous(),
        "w_ukt": kvb[..., :dn].permute(0, 2, 3, 1).contiguous(),
        "w_uv": kvb[..., dn:].permute(0, 2, 1, 3).contiguous()}}


def layer_params(cfg: MoonlightConfig, params: Params) -> List[Params]:
    """Each layer's weights (views, no copy) from `prepare_params`' tree,
    with "i" (the layer, its cache layer), "ffn" ("dense" | "moe") and "j"
    (its index among those)."""
    mla = params.get("mla")
    if mla is None:
        raise ValueError(f"{cfg.name}: run moonlight.prepare_params on the weights first")
    if any(isinstance(v, dict) for v in params["attn"].values()):
        raise NotImplementedError(f"{cfg.name}: the Moonlight block serves bf16 or f32 "
                                  "weights, not quantized ones")
    out = []
    for l in range(cfg.n_layers):
        ffn, j = ("dense", l) if l < cfg.n_dense_layers else ("moe", l - cfg.n_dense_layers)
        lp = {"i": l, "ffn": ffn, "j": j,
              "attn_norm": params["layers"]["attn_norm"][l],
              "ffn_norm": params["layers"]["ffn_norm"][l],
              "kv_norm": params["attn"]["kv_norm"][l], "wkvb": params["attn"]["wkvb"][l],
              "wo": params["attn"]["wo"][l]}
        lp.update({k: v[l] for k, v in mla.items()})
        groups = ("dense",) if ffn == "dense" else ("moe", "shared")
        for g in groups:
            lp.update({f"{g}_{k}": v[j] for k, v in params[g].items()})
        out.append(lp)
    return out


def state_shapes(cfg: MoonlightConfig, n_slots: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """Device state beside the latent cache: the expert counts [Lm, 2, E]
    (see `runtime/batching.SlotState`)."""
    return {"expert_rows": ((cfg.n_moe_layers, 2, cfg.n_experts), torch.int64)}


# --- the operators ------------------------------------------------------------


def _project(cfg: MoonlightConfig, lp: Params, h: torch.Tensor, cos, sin):
    """h [B, S, D] normed -> (q [B, S, H, dn+dr] with RoPE on its rope part,
    latent rows [B, S, r+dr]: the normed latent, then the rotary key)."""
    B, S, _ = h.shape
    dn, r = cfg.qk_nope_head_dim, cfg.kv_lora_rank
    q = bb.matmul_f32(h, lp["wq"]).to(h.dtype).view(B, S, cfg.n_heads, -1)
    q = torch.cat([q[..., :dn], bb.apply_rope(q[..., dn:], cos, sin)], dim=-1)
    kva = bb.matmul_f32(h, lp["wkva"])
    c = bb.rms_norm(kva[..., :r], lp["kv_norm"], cfg.rms_norm_eps).to(h.dtype)
    k_pe = bb.apply_rope(kva[..., None, r:].to(h.dtype), cos, sin)[..., 0, :]
    return q, torch.cat([c, k_pe], dim=-1)


def _swiglu(h: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    gate, up = bb.matmul_f32(h, w_gate), bb.matmul_f32(h, w_up)
    return bb.matmul_f32((F.silu(gate) * up).to(h.dtype), w_down)


def _ffn(cfg: MoonlightConfig, lp: Params, x: torch.Tensor,
         expert_rows: Optional[torch.Tensor] = None) -> torch.Tensor:
    B, S, D = x.shape
    h = bb.rms_norm(x, lp["ffn_norm"], cfg.rms_norm_eps)
    if lp["ffn"] == "dense":
        y = _swiglu(h, lp["dense_w_gate"], lp["dense_w_up"], lp["dense_w_down"])
    else:
        y = lfm2.moe(cfg, lp, h, None if expert_rows is None else expert_rows[lp["j"]],
                     scale=cfg.routed_scaling_factor)
        with span("moe.shared", rows=B * S):
            y = y + _swiglu(h, lp["shared_w_gate"], lp["shared_w_up"], lp["shared_w_down"])
    return x + y.to(x.dtype)


# --- prefill and decode -------------------------------------------------------


# prompt tokens of an admission group taken through a layer at a time, in
# whole rows (prompts are independent): bounds a layer's intermediates (the
# dense SwiGLU's 11,264-wide f32 gate and up, the experts' 6 rows a token,
# each head's keys and values from the latent) to ~1.5 GB whatever the
# group's rows, so that the admission graphs' one memory pool, which holds
# each captured shape's own peak, fits beside the weights and the latent
# cache at the engine's widest group (256 x 512)
PREFILL_TOKENS = 8192


def prefill_hidden(cfg: MoonlightConfig, params: Params, tokens: torch.Tensor,
                   prompt_lens: torch.Tensor, store, state_store=None) -> torch.Tensor:
    """Every layer over left-padded prompts [B, Lp] (true lengths
    prompt_lens [B]), attention in the non-absorbed form, PREFILL_TOKENS
    tokens of whole rows at a time; store(l, rows, None) keeps layer l's
    latent rows [B, Lp, r+dr] where the caller holds the cache. No recurrent
    state (`state_store` is unused). Returns the final-normed hidden state
    of the last position [B, D]."""
    B, Lp = tokens.shape
    H, dn, dv, r = cfg.n_heads, cfg.qk_nope_head_dim, cfg.v_head_dim, cfg.kv_lora_rank
    dq = cfg.qk_head_dim
    pad = (Lp - prompt_lens).to(torch.int32)
    idx = torch.arange(Lp, dtype=torch.int32, device=tokens.device)
    positions = torch.clamp(idx[None, :] - pad[:, None], min=0)
    cos, sin = bb.rope_tables(cfg.qk_rope_head_dim, cfg.rope_theta, positions)
    x = params["embed"].to(bb.torch_dtype(cfg.dtype))[tokens.long()]
    step = max(1, PREFILL_TOKENS // Lp)
    chunks = [slice(b, b + step) for b in range(0, B, step)]
    for lp in layer_params(cfg, params):
        latent, outs = [], []
        for sl in chunks:
            xs = x[sl]
            n = xs.shape[0]
            q, rows = _project(cfg, lp, bb.rms_norm(xs, lp["attn_norm"], cfg.rms_norm_eps),
                               cos[sl], sin[sl])
            latent.append(rows)
            kv = bb.matmul_f32(rows[..., :r], lp["wkvb"]).to(x.dtype).view(n, Lp, H, dn + dv)
            k = torch.cat([kv[..., :dn], rows[:, :, None, r:].expand(n, Lp, H, dq - dn)], dim=-1)
            v = F.pad(kv[..., dn:], (0, dq - dv))  # zeros to the q/k head width
            attn = attn_ops.prefill_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                              pad[sl])
            out = bb.matmul_f32(attn[..., :dv].reshape(n, Lp, H * dv), lp["wo"])
            outs.append(_ffn(cfg, lp, xs + out.to(x.dtype)))
        store(lp["i"], latent[0] if len(latent) == 1 else torch.cat(latent), None)
        x = outs[0] if len(outs) == 1 else torch.cat(outs)
    return bb.rms_norm(x[:, -1, :], params["final_norm"], cfg.rms_norm_eps)


def decode_hidden(cfg: MoonlightConfig, params: Params, layers: List[Params],
                  token: torch.Tensor, positions: torch.Tensor, attend, state) -> torch.Tensor:
    """Every layer of one decode step, attention in the absorbed form: token
    [B] at RoPE positions [B]. `layers` holds `layer_params`. attend(l,
    q [B, H, r+dr], rows [B, r+dr], None) stores layer l's latent row where
    the caller keeps the cache and returns the attention over the latent
    [B, H, r]; state.expert_rows [Lm, 2, E], when not None, gains each MoE
    layer's routed rows and touched experts. Returns the final-normed
    hidden state [B, D]."""
    B = token.shape[0]
    dn = cfg.qk_nope_head_dim
    cos, sin = bb.rope_tables(cfg.qk_rope_head_dim, cfg.rope_theta, positions[:, None])
    x = params["embed"].to(bb.torch_dtype(cfg.dtype))[token.long()[:, None]]
    for lp in layers:
        h = bb.rms_norm(x, lp["attn_norm"], cfg.rms_norm_eps)
        q, rows = _project(cfg, lp, h, cos, sin)
        with span("mla.absorb", rows=B):
            q_lat = bb.bmm_f32(q[:, 0, :, :dn].transpose(0, 1).contiguous(),
                               lp["w_ukt"]).to(x.dtype)
            q_full = torch.cat([q_lat.transpose(0, 1), q[:, 0, :, dn:]], dim=-1).contiguous()
        with span("mla.attend", rows=B):
            o_lat = attend(lp["i"], q_full, rows[:, 0].contiguous(), None)
        with span("mla.absorb", rows=B):
            o = bb.bmm_f32(o_lat.to(x.dtype).transpose(0, 1).contiguous(),
                           lp["w_uv"]).to(x.dtype)
        out = bb.matmul_f32(o.transpose(0, 1).reshape(B, 1, -1), lp["wo"])
        x = _ffn(cfg, lp, x + out.to(x.dtype), state.expert_rows)
    return bb.rms_norm(x[:, 0, :], params["final_norm"], cfg.rms_norm_eps)
