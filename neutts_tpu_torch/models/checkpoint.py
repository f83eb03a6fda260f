"""Checkpoint save/load for the pipeline, in the JAX package's format.

A checkpoint is a directory with
  * `backbone.npz` / `codec.npz` — flattened parameter trees ('/'-joined key
    paths; lists become numeric path parts);
  * `config.json` — the dataclass configs.

bfloat16 arrays are stored as their raw uint16 bits under a `.bf16` key tag
(npz has no bfloat16). They are read back without `ml_dtypes`: the bits are
viewed as int16 and the tensor is reinterpreted with
`torch.Tensor.view(torch.bfloat16)`.

`params_from_numpy` turns an in-memory tree of numpy arrays (for example the
JAX package's parameters after `np.asarray`, quantized `{"q", "s"}` dicts and
the fused `wqkv` included) into the same tree of torch tensors.
"""

from __future__ import annotations

import dataclasses
import json
from pathlib import Path
from typing import Any, Dict, Tuple

import numpy as np
import torch

from neutts_tpu_torch import config as cfglib


def _bf16_from_bits(bits: np.ndarray) -> torch.Tensor:
    return torch.from_numpy(np.array(bits, dtype=np.uint16).view(np.int16)).view(torch.bfloat16)


def _to_tensor(arr: np.ndarray, device) -> torch.Tensor:
    if arr.dtype.name == "bfloat16":  # ml_dtypes arrays from the JAX side
        return _bf16_from_bits(arr.view(np.uint16)).to(device)
    arr = np.ascontiguousarray(arr)
    if not arr.flags.writeable:  # e.g. views of JAX arrays
        arr = arr.copy()
    return torch.from_numpy(arr).to(device)


def params_from_numpy(tree, device="cuda"):
    """Nested dicts/lists of numpy arrays (or array-likes) -> the same tree of
    torch tensors on `device`. Python scalars and None pass through."""
    if tree is None or isinstance(tree, (int, float)):
        return tree
    if isinstance(tree, dict):
        return {k: params_from_numpy(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [params_from_numpy(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return _to_tensor(np.asarray(tree), device)


def tree_to(tree, device):
    """Move every tensor of a parameter tree to `device` (no copy if there)."""
    if isinstance(tree, dict):
        return {k: tree_to(v, device) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [tree_to(v, device) for v in tree]
    if isinstance(tree, torch.Tensor):
        return tree.to(device)
    return tree


def _flatten(tree, prefix="") -> Dict[str, np.ndarray]:
    out: Dict[str, np.ndarray] = {}
    if tree is None:
        return out
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    elif isinstance(tree, (int, float)):
        out[prefix[:-1] + ".scalar"] = np.asarray(tree)
    else:
        t = tree.detach().cpu()
        if t.dtype == torch.bfloat16:
            out[prefix[:-1] + ".bf16"] = t.view(torch.int16).numpy().view(np.uint16)
        else:
            out[prefix[:-1]] = t.numpy()
    return out


def _unflatten(flat: Dict[str, np.ndarray], device):
    root: Dict[str, Any] = {}
    for key, val in flat.items():
        scalar = key.endswith(".scalar")
        if scalar:
            key = key[: -len(".scalar")]
            leaf = val.item()
        elif key.endswith(".bf16"):
            key = key[: -len(".bf16")]
            leaf = _bf16_from_bits(val).to(device)
        else:
            leaf = _to_tensor(val, device)
        parts = key.split("/")
        node = root
        for p in parts[:-1]:
            node = node.setdefault(p, {})
        node[parts[-1]] = leaf

    def listify(node):
        if isinstance(node, dict):
            if node and all(k.isdigit() for k in node):
                return [listify(node[str(i)]) for i in range(len(node))]
            return {k: listify(v) for k, v in node.items()}
        return node

    return listify(root)


def save_params(path: str | Path, params) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez(path, **_flatten(params))


def load_params(path: str | Path, device="cuda"):
    with np.load(path, allow_pickle=False) as z:
        return _unflatten({k: z[k] for k in z.files}, device)


def save_pipeline(path, backbone_cfg, backbone_params, codec_cfg, codec_params) -> None:
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    save_params(p / "backbone.npz", backbone_params)
    save_params(p / "codec.npz", codec_params)
    cfg = {
        "backbone": dataclasses.asdict(backbone_cfg),
        "codec": dataclasses.asdict(codec_cfg),
        "format_version": 1,
    }
    (p / "config.json").write_text(json.dumps(cfg, indent=2))


def load_configs(path: str | Path) -> Tuple[cfglib.BackboneConfig, cfglib.CodecConfig]:
    cfg = json.loads((Path(path) / "config.json").read_text())
    bc, cc = cfg["backbone"], cfg["codec"]
    # drop fields from older format revisions; coerce lists back to tuples
    known = {f.name for f in dataclasses.fields(cfglib.CodecConfig)}
    cc = {k: v for k, v in cc.items() if k in known}
    for key in ("fsq_levels", "enc_strides", "enc_channels"):
        if key in cc:
            cc[key] = tuple(cc[key])
    if isinstance(cc.get("semantic"), dict):
        cc["semantic"] = cfglib.SemanticConfig(**cc["semantic"])
    if isinstance(cc.get("codecenc"), dict):
        ce = dict(cc["codecenc"])
        for key in ("up_ratios", "dilations"):
            if key in ce:
                ce[key] = tuple(ce[key])
        cc["codecenc"] = cfglib.CodecEncConfig(**ce)
    return cfglib.BackboneConfig(**bc), cfglib.CodecConfig(**cc)


def load_pipeline(path: str | Path, device="cuda"):
    """-> (backbone_cfg, backbone_params, codec_cfg, codec_params), the
    parameters as torch tensors on `device`."""
    p = Path(path)
    backbone_cfg, codec_cfg = load_configs(p)
    return (
        backbone_cfg,
        load_params(p / "backbone.npz", device),
        codec_cfg,
        load_params(p / "codec.npz", device),
    )
