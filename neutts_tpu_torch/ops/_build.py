"""Builds and loads the port's hand-written CUDA kernels.

Each `csrc/*.cu` file is compiled by `nvcc` on its own into a shared library
with a plain C interface, loaded with `ctypes` (no PyTorch headers, so a
build takes seconds). The libraries go to `neutts_tpu_torch/_build/`, named
after a hash of the source, the shared headers and the flags, so an edited
source is rebuilt and an unchanged one is reused. All missing libraries of
the Qwen2 block's kernels are built at once, one `nvcc` process per source,
started together; the expert kernel (`MOE_SOURCES`) alone, at its first use.

Nothing here runs at import time: the first kernel launch builds what it
needs. `launches` counts, per kernel, the launches made through the
wrappers in `ops/attention.py`, `ops/mlp.py` and `ops/moe.py`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, List

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "_build"
SOURCES = (
    "decode_attention.cu", "prefill_attention.cu", "w8a8.cu", "staged_attention.cu",
    "slot_copy.cu",
)
# built alone at first use, so that a model without routed experts never waits for it
MOE_SOURCES = ("moe.cu",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)

# kernel name -> launches through its wrapper (reset with reset_launches)
launches: Dict[str, int] = {
    "decode_attention_bf16": 0,  # float caches (bf16, or f32 in small tests)
    "decode_attention_int8": 0,
    "decode_attention_int4": 0,
    "prefill_attention": 0,
    "fused_qkv": 0,
    "fused_mlp": 0,
    "decode_attention_staged": 0,
    "decode_attention_staged_int4": 0,
    "reconcile_segment": 0,
    "reconcile_segment4": 0,
    "scatter_prefill": 0,
    "scatter_prefill4": 0,
    "moe_experts": 0,  # one call: the gate/up and the down kernel of csrc/moe.cu
}

# dtype codes of csrc/common.cuh; DT_I4 marks a cache of packed int4 pairs
DTYPE_CODE = {torch.float32: 0, torch.bfloat16: 1, torch.int8: 2}
DT_I4 = 3

_libs: Dict[str, ctypes.CDLL] = {}
_fns: Dict[str, object] = {}


def reset_launches() -> None:
    for k in launches:
        launches[k] = 0


def nvcc_path() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _lib_path(src: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    h.update((CSRC / src).read_bytes())
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.read_bytes())
    return BUILD_DIR / f"{Path(src).stem}-{h.hexdigest()[:16]}.so"


def build_all(sources=SOURCES) -> float:
    """Compile every source of `sources` whose library is missing, all in parallel.
    Returns the wall seconds spent; raises with nvcc's output on failure.
    Each build's ptxas report (registers, shared memory, spills) is kept
    beside its library as `<stem>.log`."""
    t0 = time.perf_counter()
    todo = [s for s in sources if not _lib_path(s).exists()]
    if not todo:
        return 0.0
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = []
    for src in todo:
        out = _lib_path(src)
        tmp = out.with_suffix(f".tmp{os.getpid()}.so")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp), str(CSRC / src)]
        p = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        procs.append((src, out, tmp, p))
    failed: List[str] = []
    for src, out, tmp, p in procs:
        log, _ = p.communicate()
        (BUILD_DIR / f"{Path(src).stem}.log").write_text(log)
        if p.returncode != 0:
            failed.append(f"--- {src} (nvcc exit {p.returncode})\n{log}")
            continue
        os.replace(tmp, out)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return time.perf_counter() - t0


def library(src: str) -> ctypes.CDLL:
    """The loaded library of one source, built first if missing."""
    lib = _libs.get(src)
    if lib is None:
        path = _lib_path(src)
        if not path.exists():
            build_all(MOE_SOURCES if src in MOE_SOURCES else SOURCES)
        lib = ctypes.CDLL(str(path))
        _libs[src] = lib
    return lib


def bind(src: str, name: str, n_ptr: int, n_int: int, n_float: int = 0):
    """A C entry point taking `n_ptr` pointers, then `n_int` ints, then
    `n_float` floats, then the stream; returns its cudaError_t as int."""
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(library(src), name)
        fn.argtypes = (
            [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * n_int
            + [ctypes.c_float] * n_float + [ctypes.c_void_p]
        )
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def check_inputs(name: str, *tensors) -> None:
    """Every given tensor on one device and contiguous (None is skipped)."""
    dev = tensors[0].device
    for t in tensors:
        if t is None:
            continue
        if t.device != dev:
            raise ValueError(f"{name}: tensors on {t.device} and {dev}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: non-contiguous input of shape {tuple(t.shape)}")


def check_no_grad(name: str, *tensors) -> None:
    """Refuse a launch that autograd would record: the kernels write their
    outputs outside autograd and have no backward, so a gradient through one
    would be silently wrong. Training runs the plain differentiable path
    (`backbone.forward_train`)."""
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise RuntimeError(f"{name}: the CUDA kernel has no backward; an input requires "
                           f"grad (run it under torch.no_grad() or inference_mode())")


def ptr(t) -> int | None:
    return None if t is None else t.data_ptr()


def stream_of(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream


def check(rc: int, name: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with cudaError_t {rc}")
