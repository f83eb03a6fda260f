"""Plain PyTorch reference of the LFM2-MoE speech LM (LiquidAI LFM2-8B-A1B's
block), in float32, one sequence at a time, with no kernel, cache or
batching, for the port's tests. It imports nothing of the port.

The block (transformers' `modeling_lfm2.py` for the conv and attention
operators; LiquidAI's published `lfm2_moe` router): token embedding; per
layer x + op(operator_norm(x)), then x + ffn(ffn_norm(x)); a final RMSNorm
and the LM head tied to the embedding.
  * conv: in_proj D -> 3D split into B, C, x; Bx = B * x; a causal depthwise
    convolution of K taps over Bx (zeros before the first token); C * conv;
    out_proj.
  * attention: q/k/v projections without bias, RMSNorm over each head's q
    and k, rotary embedding (half-split pairs), causal GQA, output projection.
  * ffn: dense SwiGLU in the first `num_dense_layers` layers; after them
    sigmoid router scores, the top-k experts of score + expert bias, their
    scores (without the bias) normalised to sum 1 and scaled, and the sum
    of the chosen experts' SwiGLU outputs so weighted.

Departures from the published description: none in the equations. The
weights are the port's stacked tree (`models/lfm2.py`), read in float32.
`kv="int8"` quantizes K and V per token over all KV heads (amax / 127) for
the positions answered through a cache: a served token is predicted by the
prompt's last position through the prefill (unquantized K/V) and by every
later position through the decode (the cached, quantized K/V).
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F


def _rms(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w.float()


def _rope(x, positions, theta):
    half = x.shape[-1] // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32) / half)
    ang = positions.float()[:, None] * freqs[None, :]
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


def _int8(x):
    s = torch.clamp(x.abs().amax(dim=-1, keepdim=True), min=1e-8) / 127.0
    return torch.clamp(torch.round(x / s), -127, 127) * s


def _attend(q, k, v, causal):
    N, H, Dh = q.shape
    K = k.shape[1]
    qg = q.view(N, K, H // K, Dh)
    s = torch.einsum("qkgd,tkd->kgqt", qg, k) * Dh ** -0.5
    s = s.masked_fill(~causal[None, None], float("-inf"))
    return torch.einsum("kgqt,tkd->qkgd", torch.softmax(s, dim=-1), v).reshape(N, H * Dh)


def _swiglu(h, wg, wu, wd):
    return (F.silu(h @ wg.float()) * (h @ wu.float())) @ wd.float()


@torch.no_grad()
def logits(m: dict, w: dict, ids, n_prompt: int, kv: Optional[str] = None) -> torch.Tensor:
    """Logits over the vocabulary at positions n_prompt - 1 .. len(ids) - 1.
    m: the sizes under Hugging Face names (`hidden_size`, `layer_types`,
    `conv_L_cache`, `num_experts`, `num_experts_per_tok`, `num_dense_layers`,
    `norm_topk_prob`, `routed_scaling_factor`, `num_attention_heads`,
    `num_key_value_heads`, `head_dim`, `rope_theta`, `norm_eps`,
    `vocab_size`)."""
    ids_t = torch.as_tensor(ids, dtype=torch.long)
    N = ids_t.shape[0]
    pos = torch.arange(N)
    eps, theta = m["norm_eps"], float(m["rope_theta"])
    H, KH, Dh = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
    K, E, top = m["conv_L_cache"], m["num_experts"], m["num_experts_per_tok"]
    causal = pos[None, :] <= pos[:, None]
    decode_q = pos >= n_prompt
    x = w["embed"][ids_t].float()
    ic = ia = 0
    for l, kind in enumerate(m["layer_types"]):
        h = _rms(x, w["layers"]["op_norm"][l], eps)
        if kind == "conv":
            cw = w["conv"]
            b, c, xx = (h @ cw["in_proj"][ic].float()).chunk(3, dim=-1)
            bx = F.pad(b * xx, (0, 0, K - 1, 0))
            taps = cw["conv_w"][ic].float()  # [K, D]: tap j weighs the input K - 1 - j back
            conv = sum(bx[j:j + N] * taps[j] for j in range(K))
            x = x + (c * conv) @ cw["out_proj"][ic].float()
            ic += 1
        else:
            aw = w["attn"]
            q = (h @ aw["wq"][ia].float()).view(N, H, Dh)
            k = (h @ aw["wk"][ia].float()).view(N, KH, Dh)
            v = (h @ aw["wv"][ia].float()).view(N, KH, Dh)
            q = _rope(_rms(q, aw["q_norm"][ia], eps), pos, theta)
            k = _rope(_rms(k, aw["k_norm"][ia], eps), pos, theta)
            o = _attend(q, k, v, causal)
            if kv == "int8" and bool(decode_q.any()):
                kq = _int8(k.reshape(N, -1)).view_as(k)
                vq = _int8(v.reshape(N, -1)).view_as(v)
                o = torch.where(decode_q[:, None], _attend(q, kq, vq, causal), o)
            elif kv is not None:
                raise ValueError(f"unknown kv precision {kv!r}")
            x = x + o @ aw["wo"][ia].float()
            ia += 1
        h = _rms(x, w["layers"]["ffn_norm"][l], eps)
        if l < m["num_dense_layers"]:
            d = w["dense"]
            x = x + _swiglu(h, d["w_gate"][l], d["w_up"][l], d["w_down"][l])
        else:
            mw, j = w["moe"], l - m["num_dense_layers"]
            scores = torch.sigmoid(h @ mw["router"][j].float())
            idx = torch.topk(scores + mw["expert_bias"][j].float(), top, dim=-1).indices
            wt = torch.gather(scores, 1, idx)
            if m["norm_topk_prob"]:
                wt = wt / wt.sum(dim=-1, keepdim=True)
            wt = wt * m["routed_scaling_factor"]
            out = torch.zeros_like(x)
            for e in range(E):
                tok, slot = torch.nonzero(idx == e, as_tuple=True)
                if tok.numel():
                    y = _swiglu(h[tok], mw["w_gate"][j, e], mw["w_up"][j, e], mw["w_down"][j, e])
                    out.index_add_(0, tok, y * wt[tok, slot][:, None])
            x = x + out
    x = _rms(x[n_prompt - 1:], w["final_norm"], eps)
    return x @ w["embed"][: m["vocab_size"]].float().T
