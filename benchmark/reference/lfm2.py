"""Plain PyTorch reference of the LFM2-MoE speech LM (LiquidAI LFM2-8B-A1B's
block as a NeuTTS backbone), in float32, one sequence at a time, with no
kernel, cache or batching, and its token gap. It imports nothing of the
program.

The block (transformers' `modeling_lfm2.py` for the conv and attention
operators, LiquidAI's published `lfm2_moe` router): token embedding; per
layer x + op(operator_norm(x)), then x + ffn(ffn_norm(x)); a final RMSNorm
(`embedding_norm`) and the LM head tied to the embedding.
  * conv: in_proj D -> 3D split into B, C, x; Bx = B * x; a causal depthwise
    convolution of `conv_L_cache` taps over Bx, no bias (zeros before the
    first token); y = C * conv; out_proj.
  * attention: q/k/v projections without bias, RMSNorm over each head's q
    and k (`q_layernorm`, `k_layernorm`), rotary embedding (half-split pairs,
    base `rope_theta`), causal GQA, output projection.
  * ffn: dense SwiGLU (`intermediate_size`) in the first `num_dense_layers`
    layers; after them the router: sigmoid scores, the top
    `num_experts_per_tok` experts of score + `expert_bias`, their scores
    without the bias normalised to sum 1 (`norm_topk_prob`) and scaled by
    `routed_scaling_factor`, and the chosen experts' SwiGLU
    (`moe_intermediate_size`) outputs so weighted and summed.

Departures from the published description: the vocabulary is the
configuration's extended one (65,536 text ids, 6 control tokens, 65,536
speech codes) with the head tied to it; the router's equations are
LiquidAI's as published, which no source in this repository confirms. The
weights are the program's stacked tree (`models/lfm2.py` of the port),
made again from the seed and read in float32.

Precision, as `reference/backbone.py` states it: `weights` "bf16" (as made)
or "int8" / "int4" / "fp8" (one scale per output column), `act` the inputs
of every product quantized per token, `kv` K and V quantized per token over
all KV heads at the positions answered through the cache (a served token is
predicted by the prompt's last position through the prefill and by every
later position through the decode). The router's product keeps the
configuration's precision too. TF32 is off while the reference runs.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from benchmark.reference.backbone import fake_quant, rms_norm, rope


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

    def _attend(self, q, k, v, causal):
        N, H, Dh = q.shape
        K = k.shape[1]
        qg = q.view(N, K, H // K, Dh)
        s = torch.einsum("qkgd,tkd->kgqt", qg, k) * Dh ** -0.5
        s = s.masked_fill(~causal[None, None], float("-inf"))
        return torch.einsum("kgqt,tkd->qkgd", torch.softmax(s, dim=-1), v).reshape(N, H * Dh)

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
        H, KH, Dh = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
        K, E, top = m["conv_L_cache"], m["num_experts"], m["num_experts_per_tok"]
        eps, theta = m["norm_eps"], float(m["rope_theta"])
        ids_t = torch.as_tensor(ids, dtype=torch.long, device=dev)
        N = ids_t.shape[0]
        pos = torch.arange(N, device=dev)
        causal = pos[None, :] <= pos[:, None]
        decode_q = pos >= n_prompt
        x = w["embed"][ids_t].float()
        ic = ia = 0
        for l, kind in enumerate(m["layer_types"]):
            h = rms_norm(x, w["layers"]["op_norm"][l].float(), eps)
            if kind == "conv":
                cw = w["conv"]
                b, c, xx = self._mm(h, cw["in_proj"][ic]).chunk(3, dim=-1)
                bx = F.pad(b * xx, (0, 0, K - 1, 0))
                taps = cw["conv_w"][ic].float()  # [K, D]: tap j weighs the input K - 1 - j back
                conv = sum(bx[j:j + N] * taps[j] for j in range(K))
                x = x + self._mm(c * conv, cw["out_proj"][ic])
                ic += 1
            else:
                aw = w["attn"]
                q = self._mm(h, aw["wq"][ia]).view(N, H, Dh)
                k = self._mm(h, aw["wk"][ia]).view(N, KH, Dh)
                v = self._mm(h, aw["wv"][ia]).view(N, KH, Dh)
                q = rope(rms_norm(q, aw["q_norm"][ia].float(), eps), pos, theta)
                k = rope(rms_norm(k, aw["k_norm"][ia].float(), eps), pos, theta)
                o = self._attend(q, k, v, causal)
                if self.kv is not None and bool(decode_q.any()):
                    kq = fake_quant(k.reshape(N, -1), self.kv, dim=-1).view_as(k)
                    vq = fake_quant(v.reshape(N, -1), self.kv, dim=-1).view_as(v)
                    o = torch.where(decode_q[:, None], self._attend(q, kq, vq, causal), o)
                x = x + self._mm(o, aw["wo"][ia])
                ia += 1
            h = rms_norm(x, w["layers"]["ffn_norm"][l].float(), eps)
            if l < m["num_dense_layers"]:
                d = w["dense"]
                x = x + self._swiglu(h, d["w_gate"][l], d["w_up"][l], d["w_down"][l])
            else:
                x = x + self._moe(h, l - m["num_dense_layers"], E, top)
        x = rms_norm(x[n_prompt - 1:], w["final_norm"].float(), eps)
        return self._mm(x, w["embed"][col_lo:col_hi].T)

    def _moe(self, h, j, E, top):
        m, mw = self.m, self.w["moe"]
        scores = torch.sigmoid(self._mm(h, mw["router"][j]))
        choice = scores + mw["expert_bias"][j].float() if m["use_expert_bias"] else scores
        idx = torch.topk(choice, top, dim=-1).indices
        wt = torch.gather(scores, 1, idx)
        if m["norm_topk_prob"]:
            wt = wt / wt.sum(dim=-1, keepdim=True)
        wt = wt * m["routed_scaling_factor"]
        out = torch.zeros_like(h)
        for e in range(E):
            tok, slot = torch.nonzero(idx == e, as_tuple=True)
            if tok.numel():
                y = self._swiglu(h[tok], mw["w_gate"][j, e], mw["w_up"][j, e], mw["w_down"][j, e])
                out.index_add_(0, tok, y * wt[tok, slot][:, None])
        return out


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
