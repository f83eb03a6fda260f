"""Checkpoint converters: HF (safetensors) and GGUF -> the port's backbone
parameter tree (port of `neutts_tpu.models.convert`).

The reference consumes two weight formats (reference neutts/neutts.py:123-166):
HF transformers checkpoints (`AutoModelForCausalLM.from_pretrained`) and GGUF
files for llama.cpp (incl. Q8_0/Q4_0 quantizations, reference README.md:51).
These converters ingest both into the stacked-layer pytree that
neutts_tpu_torch.models.backbone expects (the tree `init_params` makes), so
any released NeuTTS Air/Nano checkpoint runs in the port. No network: paths
must be local.

HF name mapping (Qwen2ForCausalLM, the Air/Nano architecture per reference
TRAINING.md:33):
    model.embed_tokens.weight                    -> embed [V, D]
    model.layers.{i}.input_layernorm.weight      -> layers.attn_norm[i]
    model.layers.{i}.self_attn.{q,k,v}_proj.*    -> layers.w{q,k,v}/b{q,k,v}
      (HF stores [out, in]; we store [in, out] so forward is x @ W)
    model.layers.{i}.self_attn.o_proj.weight     -> layers.wo
    model.layers.{i}.post_attention_layernorm    -> layers.mlp_norm
    model.layers.{i}.mlp.{gate,up,down}_proj     -> layers.w_{gate,up,down}
    model.norm.weight                            -> final_norm
    lm_head.weight (absent when tied)            -> lm_head [D, V]

HF safetensors are read by the pure reader shared with the codec converter
(`convert_codec._load_safetensors`: F32, F16, BF16 and the integer types; no
`safetensors` package). BF16 files are read too, which the JAX `from_hf`
(through `safe_open(framework="np")`) cannot.

GGUF: a self-contained pure-python parser (no `gguf` package) covering the
header/metadata spec plus dequantization of F32, F16, BF16, Q8_0 and Q4_0
tensor types — the formats NeuTTS ships (reference README.md:46-50 lists
q4/q8 GGUFs).

Mapping, transposes and dequantization are numpy on the host. A weight
becomes torch at the end: float32 numpy -> `torch.from_numpy` -> `.to(dtype)`
(round to nearest even, as ml_dtypes rounds on the JAX side, so a bf16
conversion is bit-equal to the JAX package's), then moves to the caller's
`device` (default "cuda").
"""

from __future__ import annotations

import json
import mmap
import struct
from pathlib import Path
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from neutts_tpu_torch.config import SPECIAL_TOKEN_NAMES, BackboneConfig, TokenLayout
from neutts_tpu_torch.models.convert_codec import (_bf16_to_f32, _load_safetensors,
                                                  write_safetensors)
from neutts_tpu_torch.pipeline import resolve_device
from neutts_tpu_torch.text.bpe import bytes_to_unicode

_DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}


def _caster(dtype: str, device):
    """x -> float32 numpy -> torch -> `dtype` (round to nearest even) on
    `device`."""
    dt, dev = _DTYPES[dtype], resolve_device(device)

    def cast(x):
        arr = np.ascontiguousarray(np.asarray(x, np.float32))
        if not arr.flags.writeable:  # a view of the file's bytes: own a copy
            arr = arr.copy()
        return torch.from_numpy(arr).to(dt).to(dev)

    return cast


# Tree key -> (HF name, GGUF name) of every backbone tensor; "{i}" is the
# layer. The projections are [out, in] in both files and [in, out] in the
# tree. One table for the readers and the writers below.
_NAMES = {
    "embed": ("model.embed_tokens.weight", "token_embd.weight"),
    "attn_norm": ("model.layers.{i}.input_layernorm.weight", "blk.{i}.attn_norm.weight"),
    "wq": ("model.layers.{i}.self_attn.q_proj.weight", "blk.{i}.attn_q.weight"),
    "bq": ("model.layers.{i}.self_attn.q_proj.bias", "blk.{i}.attn_q.bias"),
    "wk": ("model.layers.{i}.self_attn.k_proj.weight", "blk.{i}.attn_k.weight"),
    "bk": ("model.layers.{i}.self_attn.k_proj.bias", "blk.{i}.attn_k.bias"),
    "wv": ("model.layers.{i}.self_attn.v_proj.weight", "blk.{i}.attn_v.weight"),
    "bv": ("model.layers.{i}.self_attn.v_proj.bias", "blk.{i}.attn_v.bias"),
    "wo": ("model.layers.{i}.self_attn.o_proj.weight", "blk.{i}.attn_output.weight"),
    "mlp_norm": ("model.layers.{i}.post_attention_layernorm.weight", "blk.{i}.ffn_norm.weight"),
    "w_gate": ("model.layers.{i}.mlp.gate_proj.weight", "blk.{i}.ffn_gate.weight"),
    "w_up": ("model.layers.{i}.mlp.up_proj.weight", "blk.{i}.ffn_up.weight"),
    "w_down": ("model.layers.{i}.mlp.down_proj.weight", "blk.{i}.ffn_down.weight"),
    "final_norm": ("model.norm.weight", "output_norm.weight"),
    "lm_head": ("lm_head.weight", "output.weight"),
}
_LAYER_KEYS = ("attn_norm", "wq", "bq", "wk", "bk", "wv", "bv", "wo", "mlp_norm",
               "w_gate", "w_up", "w_down")
_PROJECTIONS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


# --- HF safetensors -----------------------------------------------------------


def _load_safetensors_dir(path: Path) -> Dict[str, np.ndarray]:
    tensors: Dict[str, np.ndarray] = {}
    files = sorted(path.glob("*.safetensors"))
    if not files:
        raise FileNotFoundError(f"no .safetensors files under {path}")
    for f in files:
        tensors.update(_load_safetensors(f))
    return tensors


def config_from_hf(path: str | Path) -> BackboneConfig:
    """Build a BackboneConfig from a local HF checkpoint's config.json."""
    p = Path(path)
    hf = json.loads((p / "config.json").read_text())
    vocab = int(hf["vocab_size"])
    layout = TokenLayout(n_text_tokens=vocab - 6 - 65_536)
    return BackboneConfig(
        name=p.name or "converted",
        vocab_size=vocab,
        n_text_tokens=layout.n_text_tokens,
        hidden_size=int(hf["hidden_size"]),
        n_layers=int(hf["num_hidden_layers"]),
        n_heads=int(hf["num_attention_heads"]),
        n_kv_heads=int(hf["num_key_value_heads"]),
        head_dim=int(hf.get("head_dim", hf["hidden_size"] // hf["num_attention_heads"])),
        intermediate_size=int(hf["intermediate_size"]),
        rope_theta=float(hf.get("rope_theta", 1e6)),
        rms_norm_eps=float(hf.get("rms_norm_eps", 1e-6)),
        tie_embeddings=bool(hf.get("tie_word_embeddings", True)),
        max_context=2048,  # reference neutts/neutts.py:85
    )


def from_hf(path: str | Path, cfg: Optional[BackboneConfig] = None, dtype="bfloat16",
            device="cuda"):
    """Convert a local HF Qwen2-style checkpoint dir. Returns (cfg, params),
    the params `dtype` tensors on `device`."""
    p = Path(path)
    cfg = cfg or config_from_hf(p)
    cast = _caster(dtype, device)
    t = _load_safetensors_dir(p)

    def get(name):
        if name in t:
            return t[name]
        raise KeyError(f"{name} missing from checkpoint (have {len(t)} tensors)")

    def lin(name_fmt, transpose=True):
        """Stack per-layer [out,in] HF mats into [L, in, out]."""
        mats = [get(name_fmt.format(i=i)) for i in range(cfg.n_layers)]
        arr = np.stack(mats, 0)
        if transpose:
            arr = arr.transpose(0, 2, 1)
        return np.ascontiguousarray(arr)

    def vec(name_fmt):
        return np.stack([get(name_fmt.format(i=i)) for i in range(cfg.n_layers)], 0)

    embed = get(_NAMES["embed"][0])  # [V, D]
    V = cfg.padded_vocab
    if embed.shape[0] < V:
        padrows = np.zeros((V - embed.shape[0], embed.shape[1]), embed.dtype)
        embed = np.concatenate([embed, padrows], 0)

    params: Dict[str, Any] = {
        "embed": cast(embed),
        "layers": {k: cast(lin(_NAMES[k][0]) if k in _PROJECTIONS else vec(_NAMES[k][0]))
                   for k in _LAYER_KEYS},
        "final_norm": cast(get(_NAMES["final_norm"][0])),
    }
    if not cfg.tie_embeddings:
        head = get(_NAMES["lm_head"][0]).T  # [D, V]
        if head.shape[1] < V:
            pad = np.zeros((head.shape[0], V - head.shape[1]), head.dtype)
            head = np.concatenate([head, pad], 1)
        params["lm_head"] = cast(head)
    return cfg, params


# --- GGUF ---------------------------------------------------------------------

_GGUF_MAGIC = 0x46554747  # "GGUF"

# metadata value types
_GV = {
    0: "u8", 1: "i8", 2: "u16", 3: "i16", 4: "u32", 5: "i32",
    6: "f32", 7: "bool", 8: "str", 9: "arr", 10: "u64", 11: "i64", 12: "f64",
}
_GV_FMT = {
    "u8": "<B", "i8": "<b", "u16": "<H", "i16": "<h", "u32": "<I",
    "i32": "<i", "f32": "<f", "u64": "<Q", "i64": "<q", "f64": "<d",
}

# tensor (ggml) dtypes: id -> (name, block_elems, block_bytes)
GGML_TYPES = {
    0: ("F32", 1, 4),
    1: ("F16", 1, 2),
    2: ("Q4_0", 32, 18),
    8: ("Q8_0", 32, 34),
    30: ("BF16", 1, 2),
}


class _Reader:
    def __init__(self, data: bytes):
        self.d = data
        self.o = 0

    def u(self, fmt):
        v = struct.unpack_from(fmt, self.d, self.o)[0]
        self.o += struct.calcsize(fmt)
        return v

    def s(self):
        n = self.u("<Q")
        v = self.d[self.o : self.o + n].decode("utf-8")
        self.o += n
        return v

    def value(self, t):
        name = _GV[t]
        if name == "str":
            return self.s()
        if name == "bool":
            return bool(self.u("<B"))
        if name == "arr":
            et = self.u("<I")
            n = self.u("<Q")
            return [self.value(et) for _ in range(n)]
        return self.u(_GV_FMT[name])


def _dequant_q8_0(raw: np.ndarray, n: int) -> np.ndarray:
    blocks = raw.reshape(-1, 34)
    scale = blocks[:, :2].copy().view("<f2").astype(np.float32)  # [NB,1]
    qs = blocks[:, 2:].view(np.int8).astype(np.float32)  # [NB,32]
    return (qs * scale).reshape(-1)[:n]


def _dequant_q4_0(raw: np.ndarray, n: int) -> np.ndarray:
    blocks = raw.reshape(-1, 18)
    scale = blocks[:, :2].copy().view("<f2").astype(np.float32)  # [NB,1]
    q = blocks[:, 2:]  # [NB,16] packed nibbles
    lo = (q & 0x0F).astype(np.int8) - 8
    hi = (q >> 4).astype(np.int8) - 8
    vals = np.concatenate([lo, hi], axis=1).astype(np.float32) * scale
    return vals.reshape(-1)[:n]


def _read_metadata(r: _Reader) -> Tuple[Dict[str, Any], int]:
    """The header and metadata of a GGUF file, leaving `r` at the tensor
    infos. Returns (metadata, number of tensors)."""
    magic = r.u("<I")
    if magic != _GGUF_MAGIC:
        raise ValueError(f"not a GGUF file (magic {magic:#x})")
    version = r.u("<I")
    if version < 2:
        raise ValueError(f"unsupported GGUF version {version}")
    n_tensors = r.u("<Q")
    n_kv = r.u("<Q")
    meta: Dict[str, Any] = {"gguf.version": version}
    for _ in range(n_kv):
        key = r.s()
        t = r.u("<I")
        meta[key] = r.value(t)
    return meta, n_tensors


def read_gguf_metadata(path: str | Path) -> Dict[str, Any]:
    """The metadata of a GGUF file (the tokenizer's among it). The file is
    mapped, and no tensor is read."""
    with open(path, "rb") as f, mmap.mmap(f.fileno(), 0, access=mmap.ACCESS_READ) as data:
        return _read_metadata(_Reader(data))[0]


def read_gguf(path: str | Path) -> Tuple[Dict[str, Any], Dict[str, np.ndarray]]:
    """Parse a GGUF file. Returns (metadata, {tensor_name: f32 ndarray})."""
    data = Path(path).read_bytes()
    r = _Reader(data)
    meta, n_tensors = _read_metadata(r)

    infos: List[Tuple[str, List[int], int, int]] = []
    for _ in range(n_tensors):
        name = r.s()
        nd = r.u("<I")
        dims = [r.u("<Q") for _ in range(nd)]  # ggml order (fastest first)
        ttype = r.u("<I")
        offset = r.u("<Q")
        infos.append((name, dims, ttype, offset))

    align = int(meta.get("general.alignment", 32))
    base = (r.o + align - 1) // align * align

    tensors: Dict[str, np.ndarray] = {}
    for name, dims, ttype, offset in infos:
        if ttype not in GGML_TYPES:
            raise NotImplementedError(f"ggml tensor type {ttype} for {name}")
        tname, belems, bbytes = GGML_TYPES[ttype]
        n = 1
        for d in dims:
            n *= d
        nbytes = (n // belems) * bbytes
        raw = np.frombuffer(data, np.uint8, count=nbytes, offset=base + offset)
        if tname == "F32":
            vals = raw.view("<f4").astype(np.float32)
        elif tname == "F16":
            vals = raw.view("<f2").astype(np.float32)
        elif tname == "BF16":
            vals = _bf16_to_f32(raw)
        elif tname == "Q8_0":
            vals = _dequant_q8_0(raw, n)
        elif tname == "Q4_0":
            vals = _dequant_q4_0(raw, n)
        # ggml dims are fastest-varying first: logical shape is reversed
        tensors[name] = vals.reshape(tuple(reversed(dims)))
    return meta, tensors


def config_from_gguf(meta: Dict[str, Any], name="converted-gguf") -> BackboneConfig:
    a = "qwen2"  # NeuTTS GGUFs are qwen2-arch
    arch = meta.get("general.architecture", a)
    g = lambda k, d=None: meta.get(f"{arch}.{k}", d)
    vocab = None
    if "tokenizer.ggml.tokens" in meta:
        vocab = len(meta["tokenizer.ggml.tokens"])
    emb = int(g("embedding_length"))
    heads = int(g("attention.head_count"))
    vocab = vocab or int(g("vocab_size", 0))
    return BackboneConfig(
        name=name,
        vocab_size=vocab,
        n_text_tokens=vocab - 6 - 65_536,
        hidden_size=emb,
        n_layers=int(g("block_count")),
        n_heads=heads,
        n_kv_heads=int(g("attention.head_count_kv", heads)),
        head_dim=int(g("attention.key_length", emb // heads)),
        intermediate_size=int(g("feed_forward_length")),
        rope_theta=float(g("rope.freq_base", 1e6)),
        rms_norm_eps=float(g("attention.layer_norm_rms_epsilon", 1e-6)),
        tie_embeddings="output.weight" not in {},  # fixed up in from_gguf
        max_context=2048,
    )


def from_gguf(path: str | Path, dtype="bfloat16", device="cuda"):
    """Convert a GGUF checkpoint (F32/F16/BF16/Q8_0/Q4_0). Returns (cfg,
    params), the params `dtype` tensors on `device`."""
    import dataclasses

    cast = _caster(dtype, device)
    meta, t = read_gguf(path)
    cfg = config_from_gguf(meta, name=Path(path).stem)
    cfg = dataclasses.replace(cfg, tie_embeddings=_NAMES["lm_head"][1] not in t)

    def lin(fmt):
        # gguf weight comes out as [out, in] after the reversed reshape
        return np.stack(
            [t[fmt.format(i=i)].transpose(1, 0) for i in range(cfg.n_layers)], 0
        )

    def vec(fmt):
        return np.stack([t[fmt.format(i=i)] for i in range(cfg.n_layers)], 0)

    embed = t[_NAMES["embed"][1]]  # [V, D]
    V = cfg.padded_vocab
    if embed.shape[0] < V:
        embed = np.concatenate(
            [embed, np.zeros((V - embed.shape[0], embed.shape[1]), embed.dtype)], 0
        )
    params: Dict[str, Any] = {
        "embed": cast(embed),
        "layers": {k: cast(lin(_NAMES[k][1]) if k in _PROJECTIONS else vec(_NAMES[k][1]))
                   for k in _LAYER_KEYS},
        "final_norm": cast(t[_NAMES["final_norm"][1]]),
    }
    if not cfg.tie_embeddings:
        head = t[_NAMES["lm_head"][1]].transpose(1, 0)
        if head.shape[1] < V:
            head = np.concatenate(
                [head, np.zeros((head.shape[0], V - head.shape[1]), head.dtype)], 1
            )
        params["lm_head"] = cast(head)
    return cfg, params


# --- writers (synthetic checkpoints, interchange) ---------------------------


def hf_config(cfg: BackboneConfig) -> Dict[str, Any]:
    """The config.json of an HF Qwen2 checkpoint with `cfg`'s geometry (what
    `config_from_hf` reads back), for synthetic checkpoints."""
    return {
        "architectures": ["Qwen2ForCausalLM"],
        "model_type": "qwen2",
        "vocab_size": cfg.vocab_size,
        "hidden_size": cfg.hidden_size,
        "num_hidden_layers": cfg.n_layers,
        "num_attention_heads": cfg.n_heads,
        "num_key_value_heads": cfg.n_kv_heads,
        "head_dim": cfg.head_dim,
        "intermediate_size": cfg.intermediate_size,
        "rope_theta": cfg.rope_theta,
        "rms_norm_eps": cfg.rms_norm_eps,
        "tie_word_embeddings": cfg.tie_embeddings,
        "torch_dtype": cfg.dtype,
    }


def to_hf_tensors(cfg: BackboneConfig, params) -> Dict[str, torch.Tensor]:
    """The backbone tree under HF Qwen2 names: projections [out, in], the
    vocabulary without its pad rows (what `from_hf` reads back). Views of
    `params`."""
    t = {_NAMES["embed"][0]: params["embed"][: cfg.vocab_size],
         _NAMES["final_norm"][0]: params["final_norm"]}
    for k in _LAYER_KEYS:
        for i in range(cfg.n_layers):
            w = params["layers"][k][i]
            t[_NAMES[k][0].format(i=i)] = w.T if k in _PROJECTIONS else w
    if not cfg.tie_embeddings:
        t[_NAMES["lm_head"][0]] = params["lm_head"][:, : cfg.vocab_size].T
    return t


def write_hf_dir(path: str | Path, cfg: BackboneConfig, params) -> None:
    """Write the backbone as an HF checkpoint directory: model.safetensors
    in the params' dtype and config.json."""
    p = Path(path)
    p.mkdir(parents=True, exist_ok=True)
    write_safetensors(p / "model.safetensors", to_hf_tensors(cfg, params))
    (p / "config.json").write_text(json.dumps(hf_config(cfg)))


def hf_to_gguf_tensors(cfg: BackboneConfig, tensors: Dict[str, Any]) -> Dict[str, Any]:
    """HF names -> GGUF names (the same arrays)."""
    names = {}
    for hf, gg in _NAMES.values():
        for i in range(cfg.n_layers) if "{i}" in hf else (0,):
            names[hf.format(i=i)] = gg.format(i=i)
    return {names[k]: v for k, v in tensors.items()}


def gguf_metadata(cfg: BackboneConfig) -> Dict[str, Any]:
    """GGUF metadata of a qwen2 backbone with `cfg`'s geometry and the
    synthetic tokenizer of `cfg.layout` (what `config_from_gguf` and
    `ByteLevelBPE.from_gguf` read back)."""
    return {
        "general.architecture": "qwen2",
        "general.alignment": 32,
        "qwen2.embedding_length": cfg.hidden_size,
        "qwen2.block_count": cfg.n_layers,
        "qwen2.attention.head_count": cfg.n_heads,
        "qwen2.attention.head_count_kv": cfg.n_kv_heads,
        "qwen2.attention.key_length": cfg.head_dim,
        "qwen2.feed_forward_length": cfg.intermediate_size,
        "qwen2.rope.freq_base": float(cfg.rope_theta),
        "qwen2.attention.layer_norm_rms_epsilon": float(cfg.rms_norm_eps),
        **synthetic_tokenizer_metadata(cfg.layout),
    }


def _quant_q8_0(x: np.ndarray) -> np.ndarray:
    """f32 [..., n%32==0] -> Q8_0 blocks [NB, 34] (llama.cpp layout: f16
    scale d = absmax/127, int8 q = round(x/d))."""
    flat = np.ascontiguousarray(x, "<f4").reshape(-1, 32)
    amax = np.max(np.abs(flat), axis=1, keepdims=True)
    d = (amax / 127.0).astype("<f2")
    df = d.astype(np.float32)
    q = np.where(df > 0, np.rint(flat / np.maximum(df, 1e-30)), 0)
    q = np.clip(q, -127, 127).astype(np.int8)
    return np.concatenate([d.view(np.uint8), q.view(np.uint8)], axis=1)


def _quant_q4_0(x: np.ndarray) -> np.ndarray:
    """f32 [..., n%32==0] -> Q4_0 blocks [NB, 18] (llama.cpp convention:
    d = signed-max / -8, nibbles = clamp(round(x/d) + 8, 0, 15); element
    i<16 in the low nibble of byte i, i>=16 in the high nibble)."""
    flat = np.ascontiguousarray(x, "<f4").reshape(-1, 32)
    idx = np.argmax(np.abs(flat), axis=1)
    m = flat[np.arange(flat.shape[0]), idx][:, None]  # signed max-magnitude
    d = (m / -8.0).astype("<f2")
    df = d.astype(np.float32)
    inv = np.where(df != 0, 1.0 / np.where(df == 0, 1, df), 0.0)
    q = np.clip(np.rint(flat * inv) + 8, 0, 15).astype(np.uint8)
    packed = (q[:, :16] | (q[:, 16:] << 4)).astype(np.uint8)
    return np.concatenate([d.view(np.uint8), packed], axis=1)


_QUANT_WRITERS = {"Q8_0": (8, _quant_q8_0), "Q4_0": (2, _quant_q4_0)}


def write_gguf(
    path: str | Path,
    meta: Dict[str, Any],
    tensors: Dict[str, np.ndarray],
    align: int = 32,
    quant: Optional[Dict[str, str]] = None,
) -> None:
    """Minimal GGUF v3 writer — used by round-trip tests and to export
    synthetic checkpoints. `quant` maps tensor names to "Q8_0"/"Q4_0"
    (llama.cpp block quantization; rows must be multiples of 32 elements);
    everything else is written F32.
    """

    def pstr(s: str) -> bytes:
        b = s.encode()
        return struct.pack("<Q", len(b)) + b

    def pval(v) -> bytes:
        if isinstance(v, bool):
            return struct.pack("<I", 7) + struct.pack("<B", int(v))
        if isinstance(v, int):
            return struct.pack("<I", 5) + struct.pack("<i", v)
        if isinstance(v, float):
            return struct.pack("<I", 6) + struct.pack("<f", v)
        if isinstance(v, str):
            return struct.pack("<I", 8) + pstr(v)
        if isinstance(v, list):
            if all(isinstance(x, str) for x in v):
                body = b"".join(pstr(x) for x in v)
                return struct.pack("<I", 9) + struct.pack("<IQ", 8, len(v)) + body
            body = b"".join(struct.pack("<i", x) for x in v)
            return struct.pack("<I", 9) + struct.pack("<IQ", 5, len(v)) + body
        raise TypeError(type(v))

    out = bytearray()
    out += struct.pack("<IIQQ", _GGUF_MAGIC, 3, len(tensors), len(meta))
    for k, v in meta.items():
        out += pstr(k) + pval(v)

    offset = 0
    blobs = []
    for name, arr in tensors.items():
        arr = np.ascontiguousarray(arr, dtype="<f4")
        dims = list(reversed(arr.shape))  # ggml order
        out += pstr(name)
        out += struct.pack("<I", len(dims))
        for d in dims:
            out += struct.pack("<Q", d)
        qt = (quant or {}).get(name)
        if qt is not None:
            tid, fn = _QUANT_WRITERS[qt]
            if arr.shape[-1] % 32:
                raise ValueError(
                    f"{name}: row length {arr.shape[-1]} not a multiple of "
                    f"32 — cannot {qt}-quantize"
                )
            blob = fn(arr).tobytes()
        else:
            tid = 0  # F32
            blob = arr.tobytes()
        out += struct.pack("<IQ", tid, offset)
        pad = (-len(blob)) % align
        blobs.append(blob + b"\x00" * pad)
        offset += len(blob) + pad

    pad = (-len(out)) % align
    out += b"\x00" * pad
    for b in blobs:
        out += b
    Path(path).write_bytes(bytes(out))


def synthetic_tokenizer_metadata(layout: TokenLayout) -> Dict[str, Any]:
    """GGUF tokenizer metadata (`tokenizer.ggml.*`) with `layout`'s ids and
    a synthetic byte-level BPE in place of a real vocabulary: the 256 byte
    tokens, merges of a space or a lowercase letter with a lowercase letter,
    filler tokens up to `n_text_tokens`, then the six specials (control) and
    the `<|speech_N|>` tokens (user-defined) at the layout's ids. For tests
    and synthetic checkpoints."""
    b2u = bytes_to_unicode()
    tokens = [b2u[b] for b in range(256)]
    letters = [b2u[b] for b in range(ord("a"), ord("z") + 1)]
    merges = [f"{a} {b}" for a in [b2u[ord(" ")]] + letters for b in letters]
    merges = merges[: max(layout.n_text_tokens - 256, 0)]
    tokens += [m.replace(" ", "") for m in merges]
    tokens += [f"<|filler_{i}|>" for i in range(len(tokens), layout.n_text_tokens)]
    types = [1] * len(tokens)
    tokens += list(SPECIAL_TOKEN_NAMES)
    types += [3] * len(SPECIAL_TOKEN_NAMES)
    tokens += [f"<|speech_{i}|>" for i in range(layout.codebook_size)]
    types += [4] * layout.codebook_size
    return {
        "tokenizer.ggml.model": "gpt2",
        "tokenizer.ggml.tokens": tokens,
        "tokenizer.ggml.merges": merges,
        "tokenizer.ggml.token_type": types,
    }
