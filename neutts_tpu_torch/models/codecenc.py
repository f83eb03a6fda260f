"""XCodec2-lineage acoustic CodecEncoder + conv SemanticEncoder in PyTorch
(port of `neutts_tpu.models.codecenc`).

    CodecEnc:  WN conv stem (k7)
               -> one EncoderBlock per stride (channels double per block):
                    ResidualUnit x len(dilations)  (snake -> k7 dilated
                                                    -> snake -> k1, skip)
                    snake -> downsample conv (k = 2*stride)
               -> optional stacked unidirectional LSTM with skip (EnCodec
                  SLSTM convention)
               -> snake -> out conv (k3) to out_channels

    SemanticEncoder (conv variant): initial k3 conv (no bias)
               -> [ReLU -> k3 conv -> ReLU -> k3 conv] + skip of relu(x)
               -> final k3 conv (no bias)

Activations are SnakeBeta (x + sin^2(alpha x)/beta), optionally wrapped in
the BigVGAN alias-free Activation1d (kaiser-sinc 2x upsample -> snake -> 2x
lowpass downsample). Layouts are the JAX package's, so its parameter trees
load as they are: activations [B, T, C] and conv weights [K, Cin, Cout];
each conv transposes to torch's NCW at the call. All compute is float32,
in plain torch ops (the JAX package leaves all of it to XLA: no kernel).
"""

from __future__ import annotations

import functools
import math
from typing import Any, Dict, List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from neutts_tpu_torch.config import CodecEncConfig

Params = Dict[str, Any]

_SNAKE_EPS = 1e-9  # BigVGAN no_div_by_zero


# --- alias-free resampling (BigVGAN alias_free_torch semantics) -----------------


def kaiser_sinc_filter1d(cutoff: float, half_width: float, kernel_size: int) -> np.ndarray:
    """Kaiser-windowed sinc lowpass (symmetric kaiser window, even kernels
    sampled at half-integer times, sum-normalized), float32 [K]."""
    even = kernel_size % 2 == 0
    half_size = kernel_size // 2
    delta_f = 4.0 * half_width
    a = 2.285 * (half_size - 1) * math.pi * delta_f + 7.95
    if a > 50.0:
        beta = 0.1102 * (a - 8.7)
    elif a >= 21.0:
        beta = 0.5842 * (a - 21.0) ** 0.4 + 0.07886 * (a - 21.0)
    else:
        beta = 0.0
    window = np.kaiser(kernel_size, beta)
    if even:
        time = np.arange(-half_size, half_size) + 0.5
    else:
        time = np.arange(kernel_size) - half_size
    if cutoff == 0:
        f = np.zeros(kernel_size)
    else:
        f = 2.0 * cutoff * window * np.sinc(2.0 * cutoff * time)
        f = f / f.sum()
    return f.astype(np.float32)


@functools.lru_cache(maxsize=None)
def _lowpass2(kernel_size: int, device: torch.device) -> torch.Tensor:
    """The ratio-2 kaiser-sinc filter [K] on `device`, made once per device:
    a copy from the host in every activation would wait for the stream."""
    return torch.as_tensor(kaiser_sinc_filter1d(0.25, 0.3, kernel_size), device=device)


def _depthwise(kernel_size: int, channels: int, device) -> torch.Tensor:
    """[C, 1, K] depthwise weight: the lowpass filter for every channel."""
    k = _lowpass2(kernel_size, torch.device(device))
    return k[None, None, :].expand(channels, 1, kernel_size)


def upsample2(x: torch.Tensor, kernel_size: int = 12) -> torch.Tensor:
    """[B, T, C] -> [B, 2T, C]: replicate pad, kaiser-sinc transposed conv
    (stride 2, x2 gain), crop of pad_left / pad_right — UpSample1d(ratio=2)."""
    ratio = 2  # the filter's cutoff 0.5 / ratio, half width 0.6 / ratio
    pad = kernel_size // ratio - 1
    pad_left = pad * ratio + (kernel_size - ratio) // 2
    pad_right = pad * ratio + (kernel_size - ratio + 1) // 2
    c = x.shape[-1]
    xp = F.pad(x.transpose(1, 2), (pad, pad), mode="replicate")
    y = ratio * F.conv_transpose1d(xp, _depthwise(kernel_size, c, x.device), stride=ratio,
                                   groups=c)
    return y[:, :, pad_left : y.shape[2] - pad_right].transpose(1, 2)


def downsample2(x: torch.Tensor, kernel_size: int = 12) -> torch.Tensor:
    """[B, 2T, C] -> [B, T, C]: replicate pad (K/2 - 1 left, K/2 right for an
    even K) + strided kaiser-sinc lowpass — DownSample1d(ratio=2)."""
    even = kernel_size % 2 == 0
    pad_left = kernel_size // 2 - int(even)
    pad_right = kernel_size // 2
    c = x.shape[-1]
    xp = F.pad(x.transpose(1, 2), (pad_left, pad_right), mode="replicate")
    return F.conv1d(xp, _depthwise(kernel_size, c, x.device), stride=2,
                    groups=c).transpose(1, 2)


# --- snake activations ------------------------------------------------------------


def snake(cfg: CodecEncConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Per-channel snake: x + sin^2(alpha x) / (beta + eps). `beta` absent
    (plain DAC Snake1d) -> beta = alpha; cfg.snake_logscale -> the params
    are log(alpha) / log(beta)."""
    alpha = p["alpha"].reshape(1, 1, -1)
    beta = p.get("beta")
    beta = alpha if beta is None else beta.reshape(1, 1, -1)
    if cfg.snake_logscale:
        alpha, beta = torch.exp(alpha), torch.exp(beta)
    return x + torch.sin(alpha * x) ** 2 / (beta + _SNAKE_EPS)


def act1d(cfg: CodecEncConfig, p: Params, x: torch.Tensor) -> torch.Tensor:
    """Snake, optionally anti-aliased (up2 -> snake -> down2)."""
    if not cfg.alias_free:
        return snake(cfg, p, x)
    return downsample2(snake(cfg, p, upsample2(x, cfg.act_kernel)), cfg.act_kernel)


# --- conv / lstm building blocks ------------------------------------------------------


def conv(x, w, b=None, *, stride: int = 1, dilation: int = 1, pad: int = 0):
    """torch Conv1d semantics on the JAX layouts: x [B, T, Cin], w [K, Cin,
    Cout], symmetric explicit padding."""
    y = F.conv1d(x.transpose(1, 2), w.permute(2, 1, 0), b, stride=stride, padding=pad,
                 dilation=dilation)
    return y.transpose(1, 2)


def residual_unit(cfg: CodecEncConfig, p: Params, x: torch.Tensor, dilation: int):
    y = act1d(cfg, p["act1"], x)
    k = p["w1"].shape[0]
    y = conv(y, p["w1"], p["b1"], dilation=dilation, pad=((k - 1) * dilation) // 2)
    y = act1d(cfg, p["act2"], y)
    return x + conv(y, p["w2"], p["b2"])


def encoder_block(cfg: CodecEncConfig, p: Params, x: torch.Tensor, stride: int):
    for up, d in zip(p["units"], cfg.dilations):
        x = residual_unit(cfg, up, x, d)
    x = act1d(cfg, p["act"], x)
    return conv(x, p["down_w"], p["down_b"], stride=stride, pad=math.ceil(stride / 2))


def lstm_layer(p: Params, x: torch.Tensor) -> torch.Tensor:
    """One torch nn.LSTM layer over [B, T, C]: unidirectional, zero initial
    state, gate order i, f, g, o, both biases added. The input projection is
    one [B*T, 4H] product; the loop carries the [B, H] recurrence."""
    b, t, _ = x.shape
    h_dim = p["w_hh"].shape[1]
    xg = x @ p["w_ih"].T + (p["b_ih"] + p["b_hh"])
    w_hh_t = p["w_hh"].T
    h = x.new_zeros(b, h_dim)
    c = x.new_zeros(b, h_dim)
    ys = []
    for i in range(t):
        g = xg[:, i] + h @ w_hh_t
        gi, gf, gg, go = g.chunk(4, dim=-1)
        c = torch.sigmoid(gf) * c + torch.sigmoid(gi) * torch.tanh(gg)
        h = torch.sigmoid(go) * torch.tanh(c)
        ys.append(h)
    return torch.stack(ys, dim=1)


def slstm(p_layers: List[Params], x: torch.Tensor) -> torch.Tensor:
    """EnCodec SLSTM: stacked LSTM layers + skip from the stack input."""
    y = x
    for lp in p_layers:
        y = lstm_layer(lp, y)
    return x + y


# --- full encoder forward ---------------------------------------------------------------


def forward(cfg: CodecEncConfig, p: Params, wav: torch.Tensor) -> torch.Tensor:
    """wav [B, T@16k] -> acoustic features [B, T/prod(up_ratios), out_channels]."""
    x = wav[..., None]
    k = p["stem_w"].shape[0]
    x = conv(x, p["stem_w"], p["stem_b"], pad=(k - 1) // 2)
    for blk, s in zip(p["blocks"], cfg.up_ratios):
        x = encoder_block(cfg, blk, x, s)
    if cfg.rnn_layers:
        x = slstm(p["lstm"], x)
    x = act1d(cfg, p["post_act"], x)
    k = p["post_w"].shape[0]
    return conv(x, p["post_w"], p["post_b"], pad=(k - 1) // 2)


def semantic_encoder(p: Params, x: torch.Tensor) -> torch.Tensor:
    """Conv SemanticEncoder (XCodec2): [B, T, Cin] tower features ->
    [B, T, code_dim]. The skip adds relu(x), not x: upstream's first
    residual-block ReLU is in place, so the skip tensor is already
    rectified when `residual_blocks(x) + x` runs."""
    k = p["init_w"].shape[0]
    x = torch.relu(conv(x, p["init_w"], pad=(k - 1) // 2))
    y = torch.relu(conv(x, p["res1_w"], p.get("res1_b"), pad=(k - 1) // 2))
    y = conv(y, p["res2_w"], p.get("res2_b"), pad=(k - 1) // 2)
    return conv(x + y, p["final_w"], pad=(k - 1) // 2)


# --- init (seeded random weights with the JAX init's shapes and scales) -------------------


def _winit(gen: torch.Generator, shape, device, gain: float = 1.0) -> torch.Tensor:
    fan_in = int(np.prod(shape[:-1]))
    w = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
    return w * (gain / math.sqrt(fan_in))


def _snake_init(c: int, cfg: CodecEncConfig, device) -> Params:
    # logscale: exp(0) = 1; plain: alpha = beta = 1
    v = 0.0 if cfg.snake_logscale else 1.0
    return {"alpha": torch.full((c,), v, device=device),
            "beta": torch.full((c,), v, device=device)}


def init_params(cfg: CodecEncConfig, gen: torch.Generator, device="cuda") -> Params:
    """Random acoustic-stack weights drawn from `gen` on `device`."""
    d = cfg.ngf

    def zeros(n):
        return torch.zeros(n, device=device)

    p: Params = {"stem_w": _winit(gen, (7, 1, d), device), "stem_b": zeros(d)}
    blocks = []
    for s in cfg.up_ratios:
        units = [{
            "act1": _snake_init(d, cfg, device),
            "w1": _winit(gen, (7, d, d), device),
            "b1": zeros(d),
            "act2": _snake_init(d, cfg, device),
            "w2": _winit(gen, (1, d, d), device),
            "b2": zeros(d),
        } for _ in cfg.dilations]
        blocks.append({
            "units": units,
            "act": _snake_init(d, cfg, device),
            "down_w": _winit(gen, (2 * s, d, 2 * d), device),
            "down_b": zeros(2 * d),
        })
        d *= 2
    p["blocks"] = blocks
    if cfg.rnn_layers:
        p["lstm"] = [{
            "w_ih": _winit(gen, (d, 4 * d), device).T.contiguous(),
            "w_hh": _winit(gen, (d, 4 * d), device).T.contiguous(),
            "b_ih": zeros(4 * d),
            "b_hh": zeros(4 * d),
        } for _ in range(cfg.rnn_layers)]
    p["post_act"] = _snake_init(d, cfg, device)
    p["post_w"] = _winit(gen, (3, d, cfg.out_channels), device)
    p["post_b"] = zeros(cfg.out_channels)
    return p


def init_semantic_encoder(gen: torch.Generator, in_dim: int, code_dim: int,
                          hidden: Optional[int] = None, kernel: int = 3,
                          device="cuda") -> Params:
    hidden = code_dim if hidden is None else hidden
    return {
        "init_w": _winit(gen, (kernel, in_dim, hidden), device),
        "res1_w": _winit(gen, (kernel, hidden, hidden), device),
        "res1_b": torch.zeros(hidden, device=device),
        "res2_w": _winit(gen, (kernel, hidden, hidden), device),
        "res2_b": torch.zeros(hidden, device=device),
        "final_w": _winit(gen, (kernel, hidden, code_dim), device),
    }
