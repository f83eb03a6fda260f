"""Plain PyTorch reference of the Moonlight speech LM (moonshotai
Moonlight-16B-A3B's block as a NeuTTS backbone), in float32, one sequence
at a time, with no kernel, cache or batching, and its token gap. It imports
nothing of the program.

The block (transformers' `modeling_deepseek_v3.py`, the configuration at
huggingface.co/moonshotai/Moonlight-16B-A3B): token embedding; per layer
x + MLA(input_layernorm(x)), then x + FFN(post_attention_layernorm(x)); a
final RMSNorm and an untied LM head.
  * MLA without a query low-rank: q = x Wq per head [nope | rope];
    [c | k_pe] = x Wkva; c = RMSNorm(c); per head [k_nope | v] = c Wkvb;
    rotary embedding on q_pe and the one shared k_pe in HF's interleaved
    layout (pairs (2i, 2i+1) de-interleaved inside the rotation), base
    `rope_theta`, no scaling; scores (q_nope . k_nope + q_pe . k_pe) /
    sqrt(nope + rope), causal softmax, o = p v per head, output projection.
  * FFN: a dense SwiGLU in the first `first_k_dense_replace` layers; after
    them sigmoid router scores, the top `num_experts_per_tok` of score +
    `e_score_correction_bias` (one group), the chosen scores normalised to
    sum 1 (`norm_topk_prob`) and multiplied by `routed_scaling_factor`, the
    chosen experts' SwiGLU outputs so weighted and summed, plus the shared
    experts' SwiGLU (`n_shared_experts` x `moe_intermediate_size`).

Departures from the published description: the vocabulary is the
configuration's extended one (163,840 text ids, 6 control tokens, 65,536
speech codes) with the untied head over it. The weights are the program's
stacked tree in the published layout (`models/moonlight.py` of the port),
made again from the seed: held in bf16 as made, each product's weight is
cast to float32 as it is used (exact), so the reference of a 16B model
fits the card once the program is freed.

Precision, as `reference/backbone.py` states it: `weights` "bf16" (as made)
or "int8" / "int4" / "fp8" (one scale per output column), `act` the inputs
of every product quantized per token, `kv` each token's latent row [c |
k_pe after RoPE] quantized per token at the positions answered through the
cache (a served token is predicted by the prompt's last position through
the prefill and by every later position through the decode). The router's
product keeps the configuration's precision too. TF32 is off while the
reference runs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.backbone import fake_quant, rms_norm


def rope_interleaved(x, positions, theta):
    """x [N, n, d] with rotary pairs (2i, 2i+1) -> rotated, in the
    de-interleaved order (HF `apply_rotary_pos_emb_interleave`)."""
    N, n, d = x.shape
    x = x.view(N, n, d // 2, 2).transpose(-1, -2).reshape(N, n, d)
    inv = theta ** (-torch.arange(0, d, 2, dtype=torch.float32, device=x.device) / d)
    ang = positions.float()[:, None] * inv
    cos = torch.cat([ang.cos(), ang.cos()], dim=-1)[:, None]
    sin = torch.cat([ang.sin(), ang.sin()], dim=-1)[:, None]
    rot = torch.cat([-x[..., d // 2:], x[..., : d // 2]], dim=-1)
    return x * cos + rot * sin


class Reference:
    def __init__(self, m: dict, weights: dict, weights_mode: str = "bf16",
                 act: Optional[str] = None, kv: Optional[str] = None):
        self.m = m
        self.w = weights
        self.weights_mode = weights_mode
        self.act = act
        self.kv = kv

    def _mm(self, x, w):
        """x [N, K] f32 @ w [K, N'] with the stated precisions."""
        return fake_quant(x, self.act, dim=-1) @ fake_quant(w.float(), self.weights_mode, dim=0)

    def _swiglu(self, h, wg, wu, wd):
        return self._mm(F.silu(self._mm(h, wg)) * self._mm(h, wu), wd)

    def _mla(self, l, h, pos, causal, decode_q):
        m, a = self.m, self.w["attn"]
        N = h.shape[0]
        H, dn, dr, dv = (m["num_attention_heads"], m["qk_nope_head_dim"], m["qk_rope_head_dim"],
                         m["v_head_dim"])
        r, theta = m["kv_lora_rank"], float(m["rope_theta"])
        q = self._mm(h, a["wq"][l]).view(N, H, dn + dr)
        q = torch.cat([q[..., :dn], rope_interleaved(q[..., dn:], pos, theta)], dim=-1)
        kva = self._mm(h, a["wkva"][l])
        c = rms_norm(kva[:, :r], a["kv_norm"][l].float(), m["rms_norm_eps"])
        rows = torch.cat([c, rope_interleaved(kva[:, None, r:], pos, theta)[:, 0]], dim=-1)

        def attend(rows_kv):
            kvb = self._mm(rows_kv[:, :r], a["wkvb"][l]).view(N, H, dn + dv)
            k = torch.cat([kvb[..., :dn], rows_kv[:, None, r:].expand(N, H, dr)], dim=-1)
            s = torch.einsum("qhd,thd->hqt", q, k) * (dn + dr) ** -0.5
            s = s.masked_fill(~causal[None], float("-inf"))
            return torch.einsum("hqt,thd->qhd", torch.softmax(s, dim=-1), kvb[..., dn:])

        o = attend(rows)
        if self.kv is not None and bool(decode_q.any()):
            o = torch.where(decode_q[:, None, None], attend(fake_quant(rows, self.kv, dim=-1)), o)
        return self._mm(o.reshape(N, H * dv), a["wo"][l])

    def _moe(self, h, j):
        m, mw, sw = self.m, self.w["moe"], self.w["shared"]
        scores = torch.sigmoid(self._mm(h, mw["router"][j]))
        idx = torch.topk(scores + mw["expert_bias"][j].float(), m["num_experts_per_tok"],
                         dim=-1).indices
        wt = torch.gather(scores, 1, idx)
        if m["norm_topk_prob"]:
            wt = wt / wt.sum(dim=-1, keepdim=True)
        wt = wt * m["routed_scaling_factor"]
        out = self._swiglu(h, sw["w_gate"][j], sw["w_up"][j], sw["w_down"][j])
        for e in range(m["n_routed_experts"]):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel():
                y = self._swiglu(h[tok], mw["w_gate"][j, e], mw["w_up"][j, e], mw["w_down"][j, e])
                out.index_add_(0, tok, y * wt[tok, slot][:, None])
        return out

    @torch.no_grad()
    def logits(self, ids, n_prompt: int, col_lo: int, col_hi: int) -> torch.Tensor:
        """Logits over vocab columns [col_lo, col_hi) at positions
        n_prompt - 1 .. len(ids) - 1: the predictions of the tokens that
        follow the prompt."""
        old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
        try:
            return self._logits(ids, n_prompt, col_lo, col_hi)
        finally:
            torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    def _logits(self, ids, n_prompt, col_lo, col_hi):
        m, w = self.m, self.w
        dev = w["embed"].device
        eps, Ld = m["rms_norm_eps"], m["first_k_dense_replace"]
        ids_t = torch.as_tensor(ids, dtype=torch.long, device=dev)
        N = ids_t.shape[0]
        pos = torch.arange(N, device=dev)
        causal = pos[None, :] <= pos[:, None]
        decode_q = pos >= n_prompt
        x = w["embed"][ids_t].float()
        for l in range(m["num_hidden_layers"]):
            h = rms_norm(x, w["layers"]["attn_norm"][l].float(), eps)
            x = x + self._mla(l, h, pos, causal, decode_q)
            h = rms_norm(x, w["layers"]["ffn_norm"][l].float(), eps)
            if l < Ld:
                d = w["dense"]
                x = x + self._swiglu(h, d["w_gate"][l], d["w_up"][l], d["w_down"][l])
            else:
                x = x + self._moe(h, l - Ld)
        x = rms_norm(x[n_prompt - 1:], w["final_norm"].float(), eps)
        return self._mm(x, w["lm_head"][:, col_lo:col_hi])


def token_gaps(m: dict, weights: dict, seqs: Sequence[Tuple[List[int], List[int]]],
               prec: dict, col_lo: int, col_hi: int,
               control: Optional[dict] = None) -> Dict[str, float]:
    """Widest gap of the served tokens (and, given a control precision, of
    the tokens the control puts first) below the reference's best logit at
    their position, over the speech columns [col_lo, col_hi); as the Qwen2
    cells' `check.token_gaps`."""
    ref = Reference(m, weights, **prec)
    ctl = Reference(m, weights, **control) if control else None
    worst, worst_ctl, n = 0.0, 0.0, 0
    for prompt, served in seqs:
        if not served:
            continue
        ids = list(prompt) + list(served[:-1])
        lg = ref.logits(ids, len(prompt), col_lo, col_hi)
        best = lg.max(dim=1).values
        idx = torch.as_tensor(served, device=lg.device, dtype=torch.long) - col_lo
        if bool(((idx < 0) | (idx >= lg.shape[1])).any()):
            return {"token_gap": math.inf, "tokens": n + len(served)}
        ar = torch.arange(len(served), device=lg.device)
        worst = max(worst, float((best - lg[ar, idx]).max()))
        n += len(served)
        if ctl is not None:
            pick = ctl.logits(ids, len(prompt), col_lo, col_hi).argmax(dim=1)
            worst_ctl = max(worst_ctl, float((best - lg[ar, pick]).max()))
        del lg
    out = {"token_gap": worst, "tokens": n}
    if ctl is not None:
        out["control_token_gap"] = worst_ctl
    return out
