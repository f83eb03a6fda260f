"""Plain PyTorch reference of the Moonlight speech LM (moonshotai
Moonlight-16B-A3B's block, HF `deepseek_v3`), in float32, one sequence at a
time, with no kernel, cache or batching, for the port's tests. It imports
nothing of the port.

The block (transformers' `modeling_deepseek_v3.py`, and the configuration
at huggingface.co/moonshotai/Moonlight-16B-A3B): token embedding; per layer
x + MLA(input_layernorm(x)), then x + FFN(post_attention_layernorm(x)); a
final RMSNorm and an untied LM head.
  * MLA without a query low-rank: q = x Wq per head [nope | rope];
    [c | k_pe] = x Wkva; c = RMSNorm(c); per head [k_nope | v] = c Wkvb;
    rotary embedding on q_pe and the one shared k_pe, in HF's interleaved
    layout (pairs (2i, 2i+1), de-interleaved inside the rotation,
    `apply_rotary_pos_emb_interleave`), base `rope_theta`, no scaling;
    scores (q_nope . k_nope + q_pe . k_pe) / sqrt(nope + rope), causal
    softmax, o = p v per head, output projection.
  * FFN: a dense SwiGLU (`intermediate_size`) in the first
    `first_k_dense_replace` layers; after them sigmoid router scores, the
    top `num_experts_per_tok` of score + `e_score_correction_bias` (one
    group: `n_group` 1, `topk_group` 1), the chosen scores normalised to
    sum 1 and multiplied by `routed_scaling_factor`, the chosen experts'
    SwiGLU outputs so weighted and summed, plus the shared experts' SwiGLU
    (`n_shared_experts` x `moe_intermediate_size` wide).

Departures from the published description: none in the equations. The
weights are the port's stacked tree in the published layout
(`models/moonlight.init_params`), read in float32. `kv="int8"` quantizes
each token's latent row [c | k_pe after RoPE] per token (amax / 127) for
the positions answered through a cache: a served token is predicted by the
prompt's last position through the prefill (unquantized) and by every later
position through the decode (the cached, quantized rows).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def rope_interleaved(x, positions, theta):
    """x [N, n, d] with rotary pairs (2i, 2i+1) -> rotated, in the
    de-interleaved order (HF `apply_rotary_pos_emb_interleave`)."""
    N, n, d = x.shape
    x = x.view(N, n, d // 2, 2).transpose(-1, -2).reshape(N, n, d)
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32) / d)
    ang = positions.float()[:, None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], dim=-1)[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], dim=-1)[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + rot * sin


def quant_int8(x):
    """Per-token symmetric int8 over the last axis, dequantized."""
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    return torch.clamp(torch.round(x / s), -127, 127) * s


def swiglu(h, wg, wu, wd):
    return (F.silu(h @ wg.float()) * (h @ wu.float())) @ wd.float()


def mla(m, a, l, h, positions, kv: Optional[str] = None, decode_from: int = 0):
    """One MLA layer over a whole sequence h [N, D] (f32); with `kv`, the
    positions from `decode_from` on attend the quantized latent rows.
    Returns (output [N, D], latent rows [N, r + dr] after the norm and
    RoPE)."""
    N = h.shape[0]
    H, dn, dr, dv = (m["num_attention_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                     m["v_head_dim"])
    r = m["kv_lora_rank"]
    q = (h @ a["wq"][l].float()).view(N, H, dn + dr)
    kva = h @ a["wkva"][l].float()
    c = rms(kva[:, :r], a["kv_norm"][l], m["rms_norm_eps"])
    q_pe = rope_interleaved(q[..., dn:], positions, float(m["rope_theta"]))
    k_pe = rope_interleaved(kva[:, None, r:], positions, float(m["rope_theta"]))[:, 0]
    rows = torch.cat([c, k_pe], dim=-1)
    causal = positions[None, :] <= positions[:, None]

    def attend(rows_kv):
        cc, kp = rows_kv[:, :r], rows_kv[:, r:]
        kvb = (cc @ a["wkvb"][l].float()).view(N, H, dn + dv)
        k = torch.cat([kvb[..., :dn], kp[:, None].expand(N, H, dr)], dim=-1)
        qq = torch.cat([q[..., :dn], q_pe], dim=-1)
        s = torch.einsum("qhd,thd->hqt", qq, k) * (dn + dr) ** -0.5
        s = s.masked_fill(~causal[None], float("-inf"))
        return torch.einsum("hqt,thd->qhd", torch.softmax(s, dim=-1), kvb[..., dn:])

    o = attend(rows)
    if kv == "int8":
        o_q = attend(quant_int8(rows))
        o = torch.where((positions >= decode_from)[:, None, None], o_q, o)
    return o.reshape(N, H * dv) @ a["wo"][l].float(), rows


def moe(m, w, j, h):
    mw, sw = w["moe"], w["shared"]
    scores = torch.sigmoid(h @ mw["router"][j].float())
    choice = scores + mw["expert_bias"][j].float()
    idx = torch.topk(choice, m["num_experts_per_tok"], dim=-1).indices
    wt = torch.gather(scores, 1, idx)
    if m["norm_topk_prob"]:
        wt = wt / wt.sum(dim=-1, keepdim=True)
    wt = wt * m["routed_scaling_factor"]
    out = torch.zeros_like(h)
    for e in range(m["n_routed_experts"]):
        tok, slot = torch.nonzero(idx == e, as_tuple=True)
        if tok.numel():
            y = swiglu(h[tok], mw["w_gate"][j, e], mw["w_up"][j, e], mw["w_down"][j, e])
            out.index_add_(0, tok, y * wt[tok, slot][:, None])
    return out + swiglu(h, sw["w_gate"][j], sw["w_up"][j], sw["w_down"][j])


@torch.no_grad()
def logits(m: dict, w: dict, ids, n_prompt: int, kv: Optional[str] = None) -> torch.Tensor:
    """Logits [len(ids) - n_prompt + 1, vocab] at positions n_prompt - 1 ..
    len(ids) - 1: the predictions of the tokens after the prompt. `kv`:
    None, or "int8" for the cached positions n_prompt .. (see the module
    docstring)."""
    eps = m["rms_norm_eps"]
    ids_t = torch.as_tensor(ids, dtype=torch.long)
    N = ids_t.shape[0]
    pos = torch.arange(N)
    x = w["embed"][ids_t].float()
    for l in range(m["num_hidden_layers"]):
        h = rms(x, w["layers"]["attn_norm"][l], eps)
        o, _ = mla(m, w["attn"], l, h, pos, kv, n_prompt)
        x = x + o
        h = rms(x, w["layers"]["ffn_norm"][l], eps)
        Ld = m["first_k_dense_replace"]
        if l < Ld:
            d = w["dense"]
            x = x + swiglu(h, d["w_gate"][l], d["w_up"][l], d["w_down"][l])
        else:
            x = x + moe(m, w, l - Ld, h)
    x = rms(x[n_prompt - 1:], w["final_norm"], eps)
    return (x @ w["lm_head"].float())[:, : m["vocab_size"]]
