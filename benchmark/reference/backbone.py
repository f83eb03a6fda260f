"""Plain PyTorch reference of the Qwen2-architecture speech LM (NeuTTS-Air's
backbone), in float32, one sequence at a time, with no kernel, cache or
batching. It imports nothing of the program.

Qwen2 (HF `Qwen2ForCausalLM`): token embedding; per layer RMSNorm, q/k/v
projections with bias, rotary embedding on q and k (half-split pairs, base
`rope_theta`), grouped-query causal attention, output projection, residual;
RMSNorm, SwiGLU MLP (silu(gate) * up, down), residual; final RMSNorm; LM head
tied to the embedding. Weights are the raw tree the benchmark made, in the
port's layout (`layers/wq` [L, D, H*Dh], ...).

Precision is a stated part of the configuration and the reference works it
out again from the raw weights, never from the program's tensors:

* `weights`: "bf16" (as made) or "int8" / "int4" (symmetric, one scale per
  output column, amax / 127 or amax / 7) or "fp8" (e4m3, one scale per
  output column);
* `act`: None or "int8" / "int4" / "fp8": the input of every product
  (q/k/v, o, gate/up, down, the head) quantized per token;
* `kv`: None or "int8" / "int4" / "fp8": K and V quantized per token over
  all KV heads. A served token is predicted by the prompt's last position
  through the prefill (which attends the unquantized K/V) and by every later
  position through the decode (which attends the cached, quantized K/V).

A lower precision than the configuration's is the control of the check.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

_LEVELS = {"int8": 127.0, "int4": 7.0}
_FP8_MAX = 448.0


def fake_quant(x: torch.Tensor, mode: Optional[str], dim: int) -> torch.Tensor:
    """x rounded as `mode` stores it, with one symmetric scale per slice
    along the other axes (amax over `dim`), back in float32."""
    if mode is None or mode == "bf16":
        return x
    amax = torch.clamp(x.abs().amax(dim=dim, keepdim=True), min=1e-8)
    if mode in _LEVELS:
        lev = _LEVELS[mode]
        s = amax / lev
        return torch.clamp(torch.round(x / s), -lev, lev) * s
    if mode == "fp8":
        s = amax / _FP8_MAX
        return (x / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    raise ValueError(f"unknown precision {mode!r}")


def rms_norm(x, w, eps):
    return x * torch.rsqrt((x * x).mean(dim=-1, keepdim=True) + eps) * w


def rope(x, positions, theta):
    """x [N, heads, Dh]; pairs (i, i + Dh/2)."""
    Dh = x.shape[-1]
    half = Dh // 2
    freqs = theta ** (-torch.arange(half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[:, None] * freqs[None, :]
    c, s = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


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
        wf = fake_quant(w.float(), self.weights_mode, dim=0)
        return fake_quant(x, self.act, dim=-1) @ wf

    @torch.no_grad()
    def logits(self, ids, n_prompt: int, col_lo: int, col_hi: int) -> torch.Tensor:
        """Logits over vocab columns [col_lo, col_hi) at positions
        n_prompt - 1 .. len(ids) - 1: the predictions of the tokens that
        follow the prompt. ids: prompt then served tokens (the last served
        token may be left out)."""
        m, w = self.m, self.w
        dev = w["embed"].device
        H, K, Dh = m["num_attention_heads"], m["num_key_value_heads"], m["head_dim"]
        eps, theta = m["rms_norm_eps"], float(m["rope_theta"])
        ids_t = torch.as_tensor(ids, dtype=torch.long, device=dev)
        N = ids_t.shape[0]
        pos = torch.arange(N, device=dev)
        x = w["embed"][ids_t].float()
        causal = pos[None, :] <= pos[:, None]  # [q, k]
        decode_q = pos >= n_prompt  # queries answered through the cache
        lw = w["layers"]
        for l in range(m["num_hidden_layers"]):
            h = rms_norm(x, lw["attn_norm"][l].float(), eps)
            q = (self._mm(h, lw["wq"][l]) + lw["bq"][l].float()).view(N, H, Dh)
            k = (self._mm(h, lw["wk"][l]) + lw["bk"][l].float()).view(N, K, Dh)
            v = (self._mm(h, lw["wv"][l]) + lw["bv"][l].float()).view(N, K, Dh)
            q, k = rope(q, pos, theta), rope(k, pos, theta)
            o = self._attend(q, k, v, causal, decode_q)
            x = x + self._mm(o.reshape(N, H * Dh), lw["wo"][l])
            h = rms_norm(x, lw["mlp_norm"][l].float(), eps)
            ff = F.silu(self._mm(h, lw["w_gate"][l])) * self._mm(h, lw["w_up"][l])
            x = x + self._mm(ff, lw["w_down"][l])
        x = rms_norm(x[n_prompt - 1:], w["final_norm"].float(), eps)
        head = w["embed"][col_lo:col_hi].T  # tied: [D, cols]
        return self._mm(x, head)

    def _attend(self, q, k, v, causal, decode_q):
        N, H, Dh = q.shape
        K = k.shape[1]
        G = H // K
        qg = q.view(N, K, G, Dh)

        def attend(kk, vv):
            s = torch.einsum("qkgd,tkd->kgqt", qg, kk) * Dh ** -0.5
            s = s.masked_fill(~causal[None, None], float("-inf"))
            return torch.einsum("kgqt,tkd->qkgd", torch.softmax(s, dim=-1), vv)

        out = attend(k, v)
        if self.kv is not None and bool(decode_q.any()):
            kq = fake_quant(k.reshape(N, K * Dh), self.kv, dim=-1).view(N, K, Dh)
            vq = fake_quant(v.reshape(N, K * Dh), self.kv, dim=-1).view(N, K, Dh)
            out = torch.where(decode_q[:, None, None, None], attend(kq, vq), out)
        return out.reshape(N, H, Dh)
