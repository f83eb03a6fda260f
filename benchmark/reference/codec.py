"""Plain PyTorch reference of the codec decoder (NeuCodec's Vocos-family
decoder as the port's `CodecConfig` describes it, transformer backbone), in
float32, for an exact number of codes: no bucket padding, no masking.

Codes -> FSQ digits (little-endian mixed radix) -> lattice values
(d - h) / h -> project_out -> post_a -> conv (kernel 7, "same") -> pre-norm
bidirectional transformer with interleaved-pair RoPE and exact GELU ->
LayerNorm -> linear head -> magnitude exp(min(., ln 100)) and phase ->
inverse STFT ("same" padding, periodic Hann, window-square normalisation).
A frozen copy of the mathematics, written again here; it imports nothing of
the program. Weights are the raw `{"dec": ...}` tree the benchmark made.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F


def _digits(codes: torch.Tensor, levels) -> torch.Tensor:
    out, rem = [], codes.long()
    for L in levels:
        out.append(rem % L)
        rem = rem // L
    return torch.stack(out, dim=-1).float()


def _layer_norm(x, s, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) / torch.sqrt(var + eps) * s + b


def _conv_same(x, w, b):
    """x [T, C], w [K, Cin, Cout]: stride 1, zero "same" padding."""
    Kw = w.shape[0]
    total = Kw - 1
    xt = F.pad(x.T[None], (total // 2, total - total // 2))
    return F.conv1d(xt, w.permute(2, 1, 0))[0].T + b


def _istft(real, imag, n_fft: int, hop: int):
    T = real.shape[0]
    frames = torch.fft.irfft(torch.complex(real, imag), n=n_fft, dim=-1)  # [T, n_fft]
    i = torch.arange(n_fft, dtype=torch.float32, device=real.device)
    win = 0.5 * (1.0 - torch.cos(2.0 * math.pi * i / n_fft))
    total = (T - 1) * hop + n_fft
    y = torch.zeros(total, dtype=torch.float32, device=real.device)
    env = torch.zeros(total, dtype=torch.float32, device=real.device)
    for t in range(T):
        y[t * hop: t * hop + n_fft] += frames[t] * win
        env[t * hop: t * hop + n_fft] += win * win
    pad = (n_fft - hop) // 2
    return y[pad: pad + T * hop] / torch.clamp(env[pad: pad + T * hop], min=1e-11)


@torch.no_grad()
def decode(c: dict, dec: dict, codes) -> torch.Tensor:
    """codes [n] ints -> waveform [n * hop_out] float32."""
    dev = dec["head_w"].device
    levels = c["fsq_levels"]
    codes = torch.as_tensor(codes, device=dev)
    h = torch.floor(torch.tensor(levels, dtype=torch.float32, device=dev) / 2.0)
    z = (_digits(codes, levels) - h) / h
    x = z @ dec["project_out_w"] + dec["project_out_b"]
    x = x @ dec["post_a_w"] + dec["post_a_b"]
    x = _conv_same(x, dec["embed_w"], dec["embed_b"])
    T, D = x.shape
    H = c["dec_heads"]
    hd = D // H
    inv = c["dec_rope_theta"] ** (-torch.arange(0, hd, 2, dtype=torch.float32, device=dev) / hd)
    ang = torch.arange(T, dtype=torch.float32, device=dev)[:, None] * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]

    def rot(t):
        a, b = t[..., 0::2], t[..., 1::2]
        return torch.stack([a * cos - b * sin, b * cos + a * sin], dim=-1).reshape(t.shape)

    blk = dec["blocks"]
    eps = c["norm_eps"]
    for l in range(c["dec_layers"]):
        g = _layer_norm(x, blk["norm1_s"][l], blk["norm1_b"][l], eps)
        q = rot((g @ blk["wq"][l] + blk["bq"][l]).view(T, H, hd))
        k = rot((g @ blk["wk"][l] + blk["bk"][l]).view(T, H, hd))
        v = (g @ blk["wv"][l] + blk["bv"][l]).view(T, H, hd)
        a = torch.softmax(torch.einsum("thd,shd->hts", q, k) * hd ** -0.5, dim=-1)
        o = torch.einsum("hts,shd->thd", a, v).reshape(T, D)
        x = x + o @ blk["wo"][l] + blk["bo"][l]
        g = _layer_norm(x, blk["norm2_s"][l], blk["norm2_b"][l], eps)
        x = x + F.gelu(g @ blk["mlp_w1"][l] + blk["mlp_b1"][l]) @ blk["mlp_w2"][l] \
            + blk["mlp_b2"][l]
    x = _layer_norm(x, dec["final_norm_s"], dec["final_norm_b"], eps)
    y = x @ dec["head_w"] + dec["head_b"]
    Fr = c["n_fft"] // 2 + 1
    mag = torch.exp(torch.clamp(y[:, :Fr], max=math.log(1e2)))
    ph = y[:, Fr:]
    return _istft(mag * torch.cos(ph), mag * torch.sin(ph), c["n_fft"], c["hop_out"])
