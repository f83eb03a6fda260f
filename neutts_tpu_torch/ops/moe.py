"""Routed experts of an LFM2-MoE layer: the router, the sort of the
(token, expert) pairs by expert, and the grouped SwiGLU expert product.

`grouped_swiglu` has a CUDA kernel (`csrc/moe.cu`) and a plain PyTorch
version of the same function. The wrapper picks by the tensors' device
alone: a CPU tensor takes the plain version, a CUDA tensor launches the
kernel (or raises). It is a port-only kernel: the JAX package has no expert
layer, so no TPU kernel stands behind it.

Everything here keeps its shapes static and reads nothing back to the host
on a CUDA device (the per-expert counts and offsets stay on the device), so
a serving segment that routes tokens can be captured as a CUDA graph. Only
the plain version reads the offsets, on the CPU.

Routing (LiquidAI's LFM2-MoE router): scores = sigmoid(h @ router) in f32;
the top-k experts of score + expert bias; the weights are the chosen
experts' scores without the bias, normalised to sum 1 (LFM2-8B-A1B's
`norm_topk_prob`, at its `routed_scaling_factor` of 1).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from neutts_tpu_torch.ops import _build

# the tile sizes of csrc/moe.cu: sorted pair rows per block, and the widths
# its gate/up and down blocks cover (the expert width and the hidden size
# must be multiples of them)
BLOCK_ROWS = 64
GATE_UP_COLS = 64
DOWN_COLS = 128
K_STEP = 32


def route(logits: torch.Tensor, expert_bias, top_k: int):
    """Router logits [T, E] f32 -> (experts [T, k] int64, weights [T, k] f32)."""
    scores = torch.sigmoid(logits.float())
    choice = scores if expert_bias is None else scores + expert_bias.float()
    idx = torch.topk(choice, top_k, dim=-1).indices
    w = torch.gather(scores, 1, idx)
    return idx, w / (w.sum(dim=-1, keepdim=True) + 1e-20)


def sort_pairs(idx: torch.Tensor, n_experts: int):
    """Experts [T, k] -> (perm [T*k] int32: the pair ids t*k + j in expert
    order, stable; offsets [E + 1] int32: expert e's pairs are
    perm[offsets[e]:offsets[e+1]]; counts [E] int64). No host read."""
    flat = idx.reshape(-1)
    perm = torch.argsort(flat, stable=True).to(torch.int32)
    counts = torch.zeros(n_experts, dtype=torch.int64, device=idx.device)
    counts.scatter_add_(0, flat, torch.ones_like(flat))
    offsets = torch.zeros(n_experts + 1, dtype=torch.int32, device=idx.device)
    offsets[1:] = torch.cumsum(counts, 0).to(torch.int32)
    return perm, offsets, counts


def grouped_swiglu(x, perm, offsets, w_gate, w_up, w_down, top_k: int):
    """Each pair p = t*k + j routed to expert e: y[p] = down_e(silu(gate_e(x[t]))
    * up_e(x[t])), products with f32 accumulation, the SwiGLU activation
    rounded to x's dtype before the down product.

    x [T, D]; perm [T*k] int32 and offsets [E + 1] int32 from `sort_pairs`;
    w_gate/w_up [E, D, F] and w_down [E, F, D] in x's dtype. Returns
    y [T*k, D] f32, row p for pair p. The CUDA kernel takes bf16 with D a
    multiple of DOWN_COLS and F of GATE_UP_COLS."""
    if x.device.type == "cpu":
        return grouped_swiglu_plain(x, perm, offsets, w_gate, w_up, w_down, top_k)
    if x.device.type != "cuda":
        raise ValueError(f"grouped_swiglu: unsupported device {x.device}")
    return _grouped_swiglu_cuda(x, perm, offsets, w_gate, w_up, w_down, top_k)


def grouped_swiglu_plain(x, perm, offsets, w_gate, w_up, w_down, top_k: int):
    """The same function expert by expert in torch (reads the offsets)."""
    P, D = perm.shape[0], x.shape[1]
    y = torch.zeros((P, D), dtype=torch.float32, device=x.device)
    off = offsets.tolist()
    pairs = perm.long()
    for e in range(w_gate.shape[0]):
        a, b = off[e], off[e + 1]
        if a == b:
            continue
        rows = x[pairs[a:b] // top_k].float()
        g = rows @ w_gate[e].float()
        u = rows @ w_up[e].float()
        h = (F.silu(g) * u).to(x.dtype)
        y[pairs[a:b]] = h.float() @ w_down[e].float()
    return y


def max_tiles(n_pairs: int, n_experts: int) -> int:
    """Row tiles the kernel's grid covers: every expert's pairs in tiles of
    BLOCK_ROWS, whatever the routing (each expert adds at most one partial
    tile)."""
    return -(-n_pairs // BLOCK_ROWS) + n_experts


def _grouped_swiglu_cuda(x, perm, offsets, w_gate, w_up, w_down, top_k):
    name = "moe_experts"
    _build.check_no_grad(name, x, w_gate, w_up, w_down)
    _build.check_inputs(name, x, perm, offsets, w_gate, w_up, w_down)
    E, D, Fd = w_gate.shape
    P = perm.shape[0]
    if x.dtype != torch.bfloat16 or any(w.dtype != torch.bfloat16 for w in (w_gate, w_up, w_down)):
        raise TypeError(f"{name}: x and the expert weights must be bf16")
    if perm.dtype != torch.int32 or offsets.dtype != torch.int32 or offsets.shape != (E + 1,):
        raise TypeError(f"{name}: perm and offsets [E + 1] must be int32")
    if x.dim() != 2 or x.shape[1] != D or w_up.shape != (E, D, Fd) or \
            w_down.shape != (E, Fd, D) or P != x.shape[0] * top_k:
        raise ValueError(f"{name}: x {tuple(x.shape)}, gate {tuple(w_gate.shape)}, down "
                         f"{tuple(w_down.shape)}, {P} pairs at top {top_k}")
    if D % DOWN_COLS or Fd % GATE_UP_COLS or D % K_STEP or Fd % K_STEP:
        raise ValueError(f"{name}: D={D} must be a multiple of {DOWN_COLS} and F={Fd} of "
                         f"{GATE_UP_COLS}")
    if E > 256:
        raise ValueError(f"{name}: at most 256 experts, got {E}")
    dev = x.device
    h = torch.empty((P, Fd), dtype=torch.bfloat16, device=dev)  # sorted pair order
    y = torch.empty((P, D), dtype=torch.float32, device=dev)
    fn = _build.bind("moe.cu", "neutts_moe_experts", 8, 6)
    with torch.cuda.device(dev):
        rc = fn(x.data_ptr(), perm.data_ptr(), offsets.data_ptr(), w_gate.data_ptr(),
                w_up.data_ptr(), w_down.data_ptr(), h.data_ptr(), y.data_ptr(), P, E, D, Fd,
                top_k, max_tiles(P, E), _build.stream_of(dev))
    _build.check(rc, name)
    _build.launches[name] += 1
    return y
