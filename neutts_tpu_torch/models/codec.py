"""NeuCodec-equivalent codec in PyTorch (port of `neutts_tpu.models.codec`).

Encode (voice cloning):

    wav [B, T@16k] -> acoustic branch ("ours": conv stem + strided residual
    stages; "codecenc": the XCodec2/DAC stack, models/codecenc.py)
    [+ w2v-BERT semantic branch over host log-mel features, models/semantic.py,
    concatenated SEMANTIC-FIRST] -> fc_prior -> project_in -> FSQ bound ->
    digits -> codes [B, floor(T/320)] int32

Decode:

    codes [B, N] -> FSQ digits -> lattice values -> project_out -> fc_post_a
    -> embed conv (k7) -> transformer or ConvNeXt backbone over the 50 Hz
    frames -> ISTFT head ("same" padding, hop 480, n_fft 1920) -> [B, N*480]

Layouts are the JAX package's, so its checkpoints load as they are:
activations [B, T, C] (NWC) and conv weights [K, Cin/groups, Cout] (WIO).
`conv1d` transposes to torch's NCW / [Cout, Cin/groups, K] at the call and
pads like XLA's "SAME" (the extra sample of an odd total on the right).
All compute is float32. The codec's attention is plain torch ops written as
the JAX code writes it, with its own RoPE on INTERLEAVED pairs (2i, 2i+1),
unlike the backbone's half-split pairs.

`n_valid` (length-masked decode): frames >= n_valid contribute exact zeros,
so a bucket-padded decode matches the exact-length one on valid samples.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neutts_tpu_torch.config import CodecConfig
from neutts_tpu_torch.models import codecenc, semantic

Params = Dict[str, Any]


# --- conv / norm helpers ----------------------------------------------------------


def conv1d(x, w, b=None, stride: int = 1, dilation: int = 1, groups: int = 1):
    """x [B, T, Cin], w [K, Cin/groups, Cout] (the JAX layouts), "SAME"
    padding -> [B, ceil(T/stride), Cout]."""
    Kw = w.shape[0]
    T = x.shape[1]
    out_len = -(-T // stride)
    total = max((out_len - 1) * stride + (Kw - 1) * dilation + 1 - T, 0)
    xt = F.pad(x.transpose(1, 2), (total // 2, total - total // 2))
    y = F.conv1d(xt, w.permute(2, 1, 0), None, stride=stride, dilation=dilation, groups=groups)
    y = y.transpose(1, 2)
    return y + b if b is not None else y


def layer_norm(x, scale, bias, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * scale + bias


# --- FSQ (lucidrains conventions) ----------------------------------------------------
#
# For level L: half_width h = L // 2, half_l = (L-1)(1+eps)/2, offset
# o = 0.5 if L even else 0, shift = atanh(o / half_l). Bounded latent
# (normalized): (tanh(z + shift) * half_l - o) / h; lattice points are
# {(d - h)/h : d in [0, L)}. Index packing is little-endian mixed radix.

_FSQ_EPS = 1e-3  # lucidrains FSQ bound epsilon


def _fsq_consts(levels: Tuple[int, ...], device):
    """(half_width, half_l, offset, shift), each [len(levels)] f32."""
    lv = torch.tensor(levels, dtype=torch.float32, device=device)
    half_width = torch.floor(lv / 2.0)
    half_l = (lv - 1.0) * (1.0 + _FSQ_EPS) / 2.0
    offset = torch.where(lv % 2 == 0, 0.5, 0.0)
    shift = torch.atanh(offset / half_l)
    return half_width, half_l, offset, shift


def fsq_bound(z: torch.Tensor, levels: Tuple[int, ...]) -> torch.Tensor:
    """Raw latent [..., D] -> bounded NORMALIZED latent (quantizer domain)."""
    h, half_l, offset, shift = _fsq_consts(levels, z.device)
    return (torch.tanh(z + shift) * half_l - offset) / h


def fsq_quantize(zb: torch.Tensor, levels: Tuple[int, ...]) -> torch.Tensor:
    """Bounded normalized latent [..., D] -> integer digits [..., D] in [0, L)
    (round half to even, as jnp.round)."""
    lv = torch.tensor(levels, dtype=torch.float32, device=zb.device)
    h = torch.floor(lv / 2.0)
    digits = torch.round(zb * h) + h
    return torch.minimum(torch.clamp(digits, min=0), lv - 1).to(torch.int32)


def digits_to_code(digits: torch.Tensor, levels: Tuple[int, ...]) -> torch.Tensor:
    """Mixed-radix pack: code = sum_i digit_i * prod(levels[:i]). [..., D] -> [...]."""
    base = 1
    code = torch.zeros(digits.shape[:-1], dtype=torch.int32, device=digits.device)
    for i, L in enumerate(levels):
        code = code + digits[..., i] * base
        base *= L
    return code


def code_to_digits(code: torch.Tensor, levels: Tuple[int, ...]) -> torch.Tensor:
    """Little-endian mixed-radix unpack: [...] -> [..., len(levels)] int32."""
    digits = []
    rem = code.long()
    for L in levels:
        digits.append(rem % L)
        rem = rem // L
    return torch.stack(digits, dim=-1).to(torch.int32)


def fsq_dequantize(digits: torch.Tensor, levels: Tuple[int, ...]) -> torch.Tensor:
    """Digits -> normalized lattice values (d - h) / h, h = floor(L / 2)."""
    h = torch.floor(torch.tensor(levels, dtype=torch.float32, device=digits.device) / 2.0)
    return (digits.float() - h) / h


# --- ISTFT head --------------------------------------------------------------------


def hann_window(n: int, device=None) -> torch.Tensor:
    """Periodic Hann window (torch.hann_window default), f32."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return 0.5 * (1.0 - torch.cos(2.0 * math.pi * i / n))


def istft_same(spec_real, spec_imag, n_fft: int, hop: int, n_valid=None):
    """Inverse STFT with "same" padding: [B, T, n_fft//2+1] -> [B, T*hop].

    irfft, periodic Hann window, overlap-add as R = n_fft/hop shifted adds,
    window-square envelope normalization, crop of (n_fft-hop)/2 each side.
    n_valid: frames >= n_valid contribute nothing (spectra and envelope)."""
    assert n_fft % hop == 0, (n_fft, hop)
    R = n_fft // hop
    B, T, Fr = spec_real.shape
    assert Fr == n_fft // 2 + 1, (Fr, n_fft)
    dev = spec_real.device
    tmask = torch.ones(T, dtype=torch.float32, device=dev)
    if n_valid is not None:
        tmask = (torch.arange(T, device=dev) < n_valid).float()
        spec_real = spec_real * tmask[None, :, None]
        spec_imag = spec_imag * tmask[None, :, None]
    frames = torch.fft.irfft(torch.complex(spec_real, spec_imag), n=n_fft, dim=-1)
    win = hann_window(n_fft, dev)
    fr = (frames * win).reshape(B, T, R, hop)
    acc = torch.zeros(B, T + R - 1, hop, dtype=torch.float32, device=dev)
    for j in range(R):
        acc[:, j : j + T] += fr[:, :, j]
    y = acc.reshape(B, (T + R - 1) * hop)
    w2 = (win * win).reshape(R, hop)
    env = torch.zeros(T + R - 1, hop, dtype=torch.float32, device=dev)
    for j in range(R):
        env[j : j + T] += w2[j] * tmask[:, None]
    env = env.reshape(-1)
    pad = (n_fft - hop) // 2
    return y[:, pad : pad + T * hop] / torch.clamp(env[pad : pad + T * hop], min=1e-11)


# --- parameter init ------------------------------------------------------------------


def init_params(cfg: CodecConfig, seed: int = 0, device="cuda") -> Params:
    """Random weights from `seed` on `device`, with the JAX init's tree,
    shapes and scales: "dec", then "enc" (acoustic branch of
    `cfg.enc_family`, the semantic branch when `cfg.semantic` is set,
    fc_prior and project_in). The random streams differ from jax.random's."""
    gen = torch.Generator(device=device).manual_seed(seed)

    def winit(shape, gain=1.0):
        fan_in = int(np.prod(shape[:-1]))
        w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return w * (gain / math.sqrt(fan_in))

    def binit(n, fan_in):
        bound = 1.0 / math.sqrt(max(fan_in, 1))
        u = torch.rand(n, generator=gen, device=device, dtype=torch.float32)
        return u * (2 * bound) - bound

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ones(*shape):
        return torch.ones(shape, device=device)

    D, I, L = cfg.dec_dim, cfg.dec_intermediate, cfg.dec_layers

    def stack(shape):
        return torch.stack([winit(shape) for _ in range(L)])

    d: Params = {
        "project_out_w": winit((cfg.fsq_dim, cfg.vq_dim)),
        "project_out_b": binit(cfg.vq_dim, cfg.fsq_dim),
        "post_a_w": winit((cfg.vq_dim, D)),
        "post_a_b": binit(D, cfg.vq_dim),
        "embed_w": winit((7, D, D)),
        "embed_b": binit(D, 7 * D),
    }
    if cfg.dec_backbone == "transformer":
        d["blocks"] = {
            "norm1_s": ones(L, D), "norm1_b": zeros(L, D),
            "wq": stack((D, D)), "bq": zeros(L, D),
            "wk": stack((D, D)), "bk": zeros(L, D),
            "wv": stack((D, D)), "bv": zeros(L, D),
            "wo": stack((D, D)), "bo": zeros(L, D),
            "norm2_s": ones(L, D), "norm2_b": zeros(L, D),
            "mlp_w1": stack((D, I)), "mlp_b1": zeros(L, I),
            "mlp_w2": stack((I, D)), "mlp_b2": zeros(L, D),
        }
    elif cfg.dec_backbone == "convnext":
        d["embed_norm_s"] = ones(D)
        d["embed_norm_b"] = zeros(D)
        d["blocks"] = {
            "dw_w": stack((7, 1, D)), "dw_b": zeros(L, D),
            "norm_s": ones(L, D), "norm_b": zeros(L, D),
            "pw1_w": stack((D, I)), "pw1_b": zeros(L, I),
            "pw2_w": stack((I, D)), "pw2_b": zeros(L, D),
            "gamma": torch.full((L, D), 1e-2, device=device),
        }
    else:
        raise ValueError(f"unknown dec_backbone {cfg.dec_backbone!r}")
    d["final_norm_s"] = ones(D)
    d["final_norm_b"] = zeros(D)
    d["head_w"] = winit((D, cfg.n_fft + 2))
    d["head_b"] = zeros(cfg.n_fft + 2)

    # encoder: the acoustic branch, then the optional semantic branch
    e: Params = {}
    if cfg.enc_family == "codecenc":
        e["acoustic"] = codecenc.init_params(cfg.codecenc, gen, device)
        prior_in = cfg.codecenc.out_channels
    else:
        c0 = cfg.enc_channels[0]
        e["stem_w"] = winit((7, 1, c0))
        e["stem_b"] = zeros(c0)
        stages = []
        cin = c0
        for st, cout in zip(cfg.enc_strides, cfg.enc_channels):
            stages.append({
                "res1_w1": winit((3, cin, cin)), "res1_b1": zeros(cin),
                "res1_w2": winit((1, cin, cin)), "res1_b2": zeros(cin),
                "down_w": winit((2 * st, cin, cout)), "down_b": zeros(cout),
            })
            cin = cout
        e["stages"] = stages
        e["post_w"] = winit((3, cin, cfg.enc_hidden))
        e["post_b"] = zeros(cfg.enc_hidden)
        prior_in = cfg.enc_hidden
    if cfg.semantic is not None:
        e["semantic"] = semantic.init_params(cfg.semantic, gen, device)
        if cfg.sem_encoder == "conv":
            e["sem_enc"] = codecenc.init_semantic_encoder(
                gen, cfg.semantic.hidden, cfg.sem_proj_dim, device=device)
        else:
            e["sem_proj_w"] = winit((cfg.semantic.hidden, cfg.sem_proj_dim))
            e["sem_proj_b"] = zeros(cfg.sem_proj_dim)
        prior_in += cfg.sem_proj_dim
    # project_in gain 6: the raw latent must span the FSQ lattice cells at
    # init, or every frame lands in the center cell
    e["prior_w"] = winit((prior_in, cfg.vq_dim))
    e["prior_b"] = binit(cfg.vq_dim, prior_in)
    e["project_in_w"] = winit((cfg.vq_dim, cfg.fsq_dim), gain=6.0)
    e["project_in_b"] = binit(cfg.fsq_dim, cfg.vq_dim)
    return {"enc": e, "dec": d}


# --- encoder ----------------------------------------------------------------------


def _act(x):
    return F.leaky_relu(x, 0.1)


def acoustic_features(cfg: CodecConfig, params: Params, wav: torch.Tensor) -> torch.Tensor:
    """wav [B, T] 16 kHz mono in [-1, 1] -> acoustic branch [B, T/320, H]:
    the XCodec2/DAC stack ("codecenc") or the from-scratch stages ("ours")."""
    e = params["enc"]
    if cfg.enc_family == "codecenc":
        return codecenc.forward(cfg.codecenc, e["acoustic"], wav)
    x = conv1d(wav[..., None], e["stem_w"], e["stem_b"])
    for st, s in zip(e["stages"], cfg.enc_strides):
        r = conv1d(_act(x), st["res1_w1"], st["res1_b1"])
        x = x + conv1d(_act(r), st["res1_w2"], st["res1_b2"])
        x = conv1d(_act(x), st["down_w"], st["down_b"], stride=s)
    return conv1d(_act(x), e["post_w"], e["post_b"])


def encode_features(cfg: CodecConfig, params: Params, wav: torch.Tensor,
                    sem_feats=None) -> torch.Tensor:
    """wav [B, T] -> features [B, T/320, vq_dim]. With `cfg.semantic` set,
    sem_feats [B, T/320, semantic.input_dim] (audio/mel.py
    `semantic_features` of the 160-padded waveform) go through the w2v-BERT
    tower and its projection, and are concatenated SEMANTIC-FIRST with the
    acoustic branch, trimmed to the shorter length, before fc_prior."""
    e = params.get("enc")
    if e is None:
        raise ValueError("decoder-only codec checkpoint: encoding reference audio needs "
                         "encoder weights (params['enc'])")
    x = acoustic_features(cfg, params, wav)
    if cfg.semantic is not None:
        if "semantic" not in e:
            raise ValueError("cfg.semantic is set but the checkpoint has no semantic-tower "
                             "weights (params['enc']['semantic'])")
        if sem_feats is None:
            raise ValueError("cfg.semantic is set: pass sem_feats (audio/mel.py "
                             "semantic_features of the 160-padded waveform)")
        sem = semantic.forward(cfg.semantic, e["semantic"], sem_feats)
        if cfg.sem_encoder == "conv":
            sem = codecenc.semantic_encoder(e["sem_enc"], sem)
        else:
            sem = sem @ e["sem_proj_w"] + e["sem_proj_b"]
        n = min(x.shape[1], sem.shape[1])
        x = torch.cat([sem[:, :n], x[:, :n]], dim=-1)
    return x @ e["prior_w"] + e["prior_b"]


def encode_latent(cfg: CodecConfig, params: Params, wav: torch.Tensor,
                  sem_feats=None) -> torch.Tensor:
    """wav [B, T] -> raw FSQ latent [B, T/320, fsq_dim] (before the bound)."""
    feats = encode_features(cfg, params, wav, sem_feats)
    return feats @ params["enc"]["project_in_w"] + params["enc"]["project_in_b"]


@torch.inference_mode()
def encode(cfg: CodecConfig, params: Params, wav: torch.Tensor, sem_feats=None) -> torch.Tensor:
    """wav [B, T@16k] -> int32 codes [B, floor(T/320)] in [0, 65536): the
    input is cut to whole 320-sample frames first."""
    T = wav.shape[-1]
    wav = wav[..., : (T // cfg.hop_in) * cfg.hop_in]
    zb = fsq_bound(encode_latent(cfg, params, wav, sem_feats), cfg.fsq_levels)
    return digits_to_code(fsq_quantize(zb, cfg.fsq_levels), cfg.fsq_levels)


# --- decoder ------------------------------------------------------------------------


def _rope_tables(cfg: CodecConfig, t: int, device):
    hd = cfg.head_dim
    inv = torch.pow(torch.tensor(cfg.dec_rope_theta, dtype=torch.float32, device=device),
                    -torch.arange(0, hd, 2, dtype=torch.float32, device=device) / hd)
    ang = torch.arange(t, dtype=torch.float32, device=device)[:, None] * inv[None, :]
    return torch.cos(ang), torch.sin(ang)


def _apply_rope(x, cos, sin):
    """x [B, T, H, hd]; rotation of INTERLEAVED pairs (2i, 2i+1)."""
    x1, x2 = x[..., 0::2], x[..., 1::2]
    c = cos[None, :, None, :]
    s = sin[None, :, None, :]
    return torch.stack([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1).reshape(x.shape)


def _block(blocks: Params, l: int) -> Params:
    return {k: v[l] for k, v in blocks.items()}


def _transformer_backbone(cfg: CodecConfig, d: Params, x, n_valid=None):
    """Pre-norm bidirectional transformer over [B, T, D]; keys >= n_valid
    are masked out."""
    B, T, D = x.shape
    H, hd = cfg.dec_heads, cfg.head_dim
    scale = hd**-0.5
    cos, sin = _rope_tables(cfg, T, x.device) if cfg.dec_rope else (None, None)
    kmask = None
    if n_valid is not None:
        kmask = (torch.arange(T, device=x.device) < n_valid)[None, None, None, :]
    for l in range(cfg.dec_layers):
        lp = _block(d["blocks"], l)
        h = layer_norm(x, lp["norm1_s"], lp["norm1_b"], cfg.norm_eps)
        q = (h @ lp["wq"] + lp["bq"]).reshape(B, T, H, hd)
        k = (h @ lp["wk"] + lp["bk"]).reshape(B, T, H, hd)
        v = (h @ lp["wv"] + lp["bv"]).reshape(B, T, H, hd)
        if cfg.dec_rope:
            q = _apply_rope(q, cos, sin)
            k = _apply_rope(k, cos, sin)
        s = torch.einsum("bthd,bshd->bhts", q, k) * scale
        if kmask is not None:
            s = s.masked_fill(~kmask, float("-inf"))
        a = torch.softmax(s, dim=-1)
        if kmask is not None:
            a = a.masked_fill(~kmask, 0.0)
        o = torch.einsum("bhts,bshd->bthd", a, v).reshape(B, T, D)
        x = x + (o @ lp["wo"] + lp["bo"])
        h = layer_norm(x, lp["norm2_s"], lp["norm2_b"], cfg.norm_eps)
        h = F.gelu(h @ lp["mlp_w1"] + lp["mlp_b1"], approximate="none")
        x = x + (h @ lp["mlp_w2"] + lp["mlp_b2"])
    return x


def _convnext_backbone(cfg: CodecConfig, d: Params, x, n_valid=None):
    """Vocos ConvNeXt backbone; frames >= n_valid are zeroed before every
    depthwise conv (the zero "same" padding of an exact-length call)."""
    vmask = None
    if n_valid is not None:
        vmask = (torch.arange(x.shape[1], device=x.device) < n_valid)[None, :, None]
    x = layer_norm(x, d["embed_norm_s"], d["embed_norm_b"], cfg.norm_eps)
    for l in range(cfg.dec_layers):
        lp = _block(d["blocks"], l)
        xin = x if vmask is None else torch.where(vmask, x, 0.0)
        h = conv1d(xin, lp["dw_w"], lp["dw_b"], groups=x.shape[-1])
        h = layer_norm(h, lp["norm_s"], lp["norm_b"], cfg.norm_eps)
        h = F.gelu(h @ lp["pw1_w"] + lp["pw1_b"], approximate="none")
        h = h @ lp["pw2_w"] + lp["pw2_b"]
        x = x + lp["gamma"] * h
    return x


def decode_from_latent(cfg: CodecConfig, params: Params, zq, n_valid=None):
    """zq [B, T, fsq_dim] lattice values -> wav [B, T*480] (24 kHz)."""
    d = params["dec"]
    vmask = None
    if n_valid is not None:
        vmask = (torch.arange(zq.shape[1], device=zq.device) < n_valid)[None, :, None]
        zq = torch.where(vmask, zq, 0.0)
    x = zq @ d["project_out_w"] + d["project_out_b"]
    x = x @ d["post_a_w"] + d["post_a_b"]
    if vmask is not None:
        x = torch.where(vmask, x, 0.0)
    x = conv1d(x, d["embed_w"], d["embed_b"])
    if cfg.dec_backbone == "transformer":
        x = _transformer_backbone(cfg, d, x, n_valid=n_valid)
    else:
        x = _convnext_backbone(cfg, d, x, n_valid=n_valid)
    x = layer_norm(x, d["final_norm_s"], d["final_norm_b"], cfg.norm_eps)
    h = x @ d["head_w"] + d["head_b"]
    Fr = cfg.n_fft // 2 + 1
    mag = torch.exp(torch.clamp(h[..., :Fr], max=math.log(1e2)))
    phase = h[..., Fr:]
    return istft_same(mag * torch.cos(phase), mag * torch.sin(phase), cfg.n_fft,
                      cfg.hop_out, n_valid=n_valid)


@torch.inference_mode()
def decode(cfg: CodecConfig, params: Params, codes: torch.Tensor, n_valid=None):
    """codes [B, N] int -> wav [B, N*480] f32 at 24 kHz."""
    zq = fsq_dequantize(code_to_digits(codes, cfg.fsq_levels), cfg.fsq_levels)
    return decode_from_latent(cfg, params, zq, n_valid=n_valid)
