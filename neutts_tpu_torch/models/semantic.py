"""w2v-BERT 2.0 semantic tower (Conformer encoder) in PyTorch (port of
`neutts_tpu.models.semantic`: `init_params`, `forward` and the HF
checkpoint mapping `from_hf_state_dict`).

    feature_projection: LayerNorm(input_dim) -> Linear(input_dim, hidden)
    N x Conformer layer:
        x += 0.5 * FFN1(LN(x))                 (Linear -> swish -> Linear)
        x += SelfAttn(LN(x))                   (relative_key position bias)
        x += ConvModule(x)                     (LN -> pw-conv -> GLU ->
                                                CAUSAL depthwise k31 -> LN ->
                                                swish -> pw-conv)
        x += 0.5 * FFN2(LN(x));  x = LN(x)

relative_key attention: scores = (q k^T + q . E[clip(j - i)]) / sqrt(d) with
the distance clipped to [-left_max, right_max] and a per-layer table E of
[left_max + right_max + 1, head_dim]. The output is tapped after layer
`output_layer`; the layers after the tap do not change it, so they are not
run. Parameter trees are the JAX package's (layers stacked on a leading
axis). All compute is float32 in plain torch ops, as XLA runs it on the TPU.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from neutts_tpu_torch.config import SemanticConfig
from neutts_tpu_torch.models.checkpoint import params_from_numpy

Params = Dict[str, Any]


def _ln(x, s, b, eps):
    mu = x.mean(dim=-1, keepdim=True)
    var = ((x - mu) ** 2).mean(dim=-1, keepdim=True)
    return (x - mu) * torch.rsqrt(var + eps) * s + b


def _swish(x):
    return x * torch.sigmoid(x)


def init_params(cfg: SemanticConfig, gen: torch.Generator, device="cuda") -> Params:
    """Random tower weights drawn from `gen` on `device`, with the JAX init's
    shapes and scales."""
    H, I, L = cfg.hidden, cfg.intermediate, cfg.n_layers

    def w(shape):
        fan_in = int(np.prod(shape[:-1]))
        x = torch.randn(shape, generator=gen, device=device, dtype=torch.float32)
        return x / math.sqrt(max(fan_in, 1))

    def stack(shape):
        return torch.stack([w(shape) for _ in range(L)])

    def ones(*shape):
        return torch.ones(shape, device=device)

    def zeros(*shape):
        return torch.zeros(shape, device=device)

    def ffn():
        return {"ln_s": ones(L, H), "ln_b": zeros(L, H), "w1": stack((H, I)), "b1": zeros(L, I),
                "w2": stack((I, H)), "b2": zeros(L, H)}

    return {
        "proj_ln_s": ones(cfg.input_dim),
        "proj_ln_b": zeros(cfg.input_dim),
        "proj_w": w((cfg.input_dim, H)),
        "proj_b": zeros(H),
        "layers": {
            "ffn1": ffn(),
            "attn_ln_s": ones(L, H), "attn_ln_b": zeros(L, H),
            "wq": stack((H, H)), "bq": zeros(L, H),
            "wk": stack((H, H)), "bk": zeros(L, H),
            "wv": stack((H, H)), "bv": zeros(L, H),
            "wo": stack((H, H)), "bo": zeros(L, H),
            "dist_emb": stack((cfg.n_positions, cfg.head_dim)),
            "conv_ln_s": ones(L, H), "conv_ln_b": zeros(L, H),
            "conv_pw1": stack((H, 2 * H)),  # no bias
            "conv_dw": stack((cfg.conv_kernel, H)),  # depthwise, no bias
            "conv_dw_ln_s": ones(L, H), "conv_dw_ln_b": zeros(L, H),
            "conv_pw2": stack((H, H)),
            "ffn2": ffn(),
            "final_ln_s": ones(L, H), "final_ln_b": zeros(L, H),
        },
    }


def _take(tree, l: int):
    """Layer l of a tree stacked on a leading axis."""
    if isinstance(tree, dict):
        return {k: _take(v, l) for k, v in tree.items()}
    return tree[l]


def _ffn(p, x, eps):
    h = _ln(x, p["ln_s"], p["ln_b"], eps)
    return _swish(h @ p["w1"] + p["b1"]) @ p["w2"] + p["b2"]


def _rel_bias_index(cfg: SemanticConfig, T: int, device) -> torch.Tensor:
    """[T, T] clipped-distance indices into a layer's embedding table."""
    i = torch.arange(T, device=device)
    d = torch.clamp(i[None, :] - i[:, None], -cfg.left_max, cfg.right_max)
    return d + cfg.left_max


@torch.inference_mode()
def forward(cfg: SemanticConfig, params: Params, feats: torch.Tensor) -> torch.Tensor:
    """feats [B, T, input_dim] log-mel stacks -> semantic features
    [B, T, hidden], the output of layer `cfg.output_layer` (1-indexed)."""
    B, T, fd = feats.shape
    if fd != cfg.input_dim:
        raise ValueError(f"semantic features have dim {fd}, tower expects {cfg.input_dim} "
                         "(audio/mel.py produces 160 = 80 mels x 2)")
    eps = cfg.eps
    Hh, Dh = cfg.n_heads, cfg.head_dim
    x = _ln(feats, params["proj_ln_s"], params["proj_ln_b"], eps)
    x = x @ params["proj_w"] + params["proj_b"]
    dist_idx = _rel_bias_index(cfg, T, feats.device)
    scale = Dh**-0.5
    for l in range(min(cfg.output_layer, cfg.n_layers)):
        lp = _take(params["layers"], l)
        x = x + 0.5 * _ffn(lp["ffn1"], x, eps)
        # self-attention with the relative_key position bias
        h = _ln(x, lp["attn_ln_s"], lp["attn_ln_b"], eps)
        q = (h @ lp["wq"] + lp["bq"]).reshape(B, T, Hh, Dh)
        k = (h @ lp["wk"] + lp["bk"]).reshape(B, T, Hh, Dh)
        v = (h @ lp["wv"] + lp["bv"]).reshape(B, T, Hh, Dh)
        scores = torch.einsum("bthd,bshd->bhts", q, k)
        pos = lp["dist_emb"][dist_idx]  # [T, T, Dh]
        scores = scores + torch.einsum("bthd,tsd->bhts", q, pos)
        del pos
        probs = torch.softmax(scores * scale, dim=-1)
        o = torch.einsum("bhts,bshd->bthd", probs, v).reshape(B, T, cfg.hidden)
        x = x + (o @ lp["wo"] + lp["bo"])
        # conformer conv module: GLU, then the CAUSAL depthwise conv (K-1
        # zeros on the left)
        h = _ln(x, lp["conv_ln_s"], lp["conv_ln_b"], eps) @ lp["conv_pw1"]
        a, g = h.chunk(2, dim=-1)
        h = F.pad((a * torch.sigmoid(g)).transpose(1, 2), (cfg.conv_kernel - 1, 0))
        h = F.conv1d(h, lp["conv_dw"].T[:, None, :], groups=cfg.hidden).transpose(1, 2)
        h = _swish(_ln(h, lp["conv_dw_ln_s"], lp["conv_dw_ln_b"], eps))
        x = x + h @ lp["conv_pw2"]
        x = x + 0.5 * _ffn(lp["ffn2"], x, eps)
        x = _ln(x, lp["final_ln_s"], lp["final_ln_b"], eps)
    return x


# --- HF checkpoint mapping ------------------------------------------------------


def from_hf_state_dict(
    state: Dict[str, np.ndarray], prefix: str = "",
    left_max: int | None = None, right_max: int | None = None, device="cuda",
) -> Tuple[SemanticConfig, Params]:
    """Map a transformers Wav2Vec2BertModel state dict (numpy values) into
    (SemanticConfig, params), the params float32 tensors on `device`.
    Shape-driven: geometry comes from the tensors. `prefix` strips a
    container path (e.g. "semantic_model.").

    left_max/right_max: the distance-embedding table only reveals the TOTAL
    left_max + right_max + 1; the split is a config choice. Default follows
    the released w2v-bert-2.0 convention (right_max = 8, rest left); pass
    both explicitly for other checkpoints."""
    from neutts_tpu_torch.pipeline import resolve_device  # the pipeline imports this module

    cfg, params = hf_state_dict_arrays(state, prefix, left_max, right_max)
    return cfg, params_from_numpy(params, resolve_device(device))


def hf_state_dict_arrays(
    state: Dict[str, np.ndarray], prefix: str = "",
    left_max: int | None = None, right_max: int | None = None,
) -> Tuple[SemanticConfig, Params]:
    """`from_hf_state_dict`'s mapping with the params left as float32 numpy
    arrays on the host (the codec converter's tree)."""
    s = {k[len(prefix):]: np.asarray(v, np.float32)
         for k, v in state.items() if k.startswith(prefix)}

    def get(name):
        if name not in s:
            raise KeyError(
                f"semantic tower mapping: missing {prefix + name!r}; "
                f"have {sorted(s)[:8]}..."
            )
        return s[name]

    proj_w = get("feature_projection.projection.weight")  # [H, input_dim]
    H, input_dim = proj_w.shape
    n_layers = 1 + max(
        int(k.split(".")[2]) for k in s if k.startswith("encoder.layers.")
    )
    l0 = "encoder.layers.0."
    inter = get(l0 + "ffn1.intermediate_dense.weight").shape[0]
    dist = get(l0 + "self_attn.distance_embedding.weight")  # [P, Dh]
    head_dim = dist.shape[1]
    n_heads = H // head_dim
    kernel = get(l0 + "conv_module.depthwise_conv.weight").shape[2]
    P = dist.shape[0]
    if (left_max is None) != (right_max is None):
        raise ValueError("pass both left_max and right_max, or neither")
    if left_max is None:
        right = min(8, P - 1)  # released w2v-bert-2.0: left 64 / right 8
        left = P - 1 - right
    else:
        left, right = left_max, right_max
    if left + right + 1 != P:
        raise ValueError(
            f"left_max + right_max + 1 = {left + right + 1} does not match "
            f"the distance-embedding table size {P}"
        )
    cfg = SemanticConfig(
        input_dim=input_dim, hidden=H, n_layers=n_layers, n_heads=n_heads,
        intermediate=inter, conv_kernel=kernel, left_max=left, right_max=right,
    )

    def L(name):  # stack per-layer tensors
        return np.stack([s[f"encoder.layers.{i}.{name}"] for i in range(n_layers)])

    def ffn(tag):
        return {
            "ln_s": L(f"{tag}_layer_norm.weight"),
            "ln_b": L(f"{tag}_layer_norm.bias"),
            "w1": np.stack([s[f"encoder.layers.{i}.{tag}.intermediate_dense.weight"].T
                            for i in range(n_layers)]),
            "b1": L(f"{tag}.intermediate_dense.bias"),
            "w2": np.stack([s[f"encoder.layers.{i}.{tag}.output_dense.weight"].T
                            for i in range(n_layers)]),
            "b2": L(f"{tag}.output_dense.bias"),
        }

    def LT(name):  # stacked + transposed (torch Linear [out, in] -> [in, out])
        return np.stack([s[f"encoder.layers.{i}.{name}"].T for i in range(n_layers)])

    params: Params = {
        "proj_ln_s": get("feature_projection.layer_norm.weight"),
        "proj_ln_b": get("feature_projection.layer_norm.bias"),
        "proj_w": proj_w.T,
        "proj_b": get("feature_projection.projection.bias"),
        "layers": {
            "ffn1": ffn("ffn1"),
            "attn_ln_s": L("self_attn_layer_norm.weight"),
            "attn_ln_b": L("self_attn_layer_norm.bias"),
            "wq": LT("self_attn.linear_q.weight"),
            "bq": L("self_attn.linear_q.bias"),
            "wk": LT("self_attn.linear_k.weight"),
            "bk": L("self_attn.linear_k.bias"),
            "wv": LT("self_attn.linear_v.weight"),
            "bv": L("self_attn.linear_v.bias"),
            "wo": LT("self_attn.linear_out.weight"),
            "bo": L("self_attn.linear_out.bias"),
            "dist_emb": L("self_attn.distance_embedding.weight"),
            "conv_ln_s": L("conv_module.layer_norm.weight"),
            "conv_ln_b": L("conv_module.layer_norm.bias"),
            # torch Conv1d weight [out, in, k]: pw k=1 -> [in, out];
            # depthwise [H, 1, K] -> [K, H]
            "conv_pw1": np.stack([
                s[f"encoder.layers.{i}.conv_module.pointwise_conv1.weight"][:, :, 0].T
                for i in range(n_layers)]),
            "conv_dw": np.stack([
                s[f"encoder.layers.{i}.conv_module.depthwise_conv.weight"][:, 0, :].T
                for i in range(n_layers)]),
            "conv_dw_ln_s": L("conv_module.depthwise_layer_norm.weight"),
            "conv_dw_ln_b": L("conv_module.depthwise_layer_norm.bias"),
            "conv_pw2": np.stack([
                s[f"encoder.layers.{i}.conv_module.pointwise_conv2.weight"][:, :, 0].T
                for i in range(n_layers)]),
            "ffn2": ffn("ffn2"),
            "final_ln_s": L("final_layer_norm.weight"),
            "final_ln_b": L("final_layer_norm.bias"),
        },
    }
    return cfg, params
