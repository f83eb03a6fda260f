#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port (neutts_tpu_torch) on one GPU.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):
  1. the card: nvidia-smi name and power limit, TF32 off (the codec's f32
     convolutions would otherwise run in TF32 through cuDNN);
  2. build every CUDA kernel of the port from csrc/ (one nvcc per source,
     all started together);
  3. each kernel mode against its plain PyTorch version at the Air shapes of
     the main paths (bf16, int8 and int4 caches): max error vs tolerance
     (exact for the four slot copies), kernel / plain / library times and
     the card's bound for the same work, and each kernel's device time
     (events around calls queued behind a spin kernel: back to back with a
     warm L2, and one at a time after an L2 flush); for decode attention
     (#1) and prefill attention (#5) also the split count NSPLIT, the prefill
     tile, and the other main-path shapes of each (#1 bf16 at B 1, T 2048
     and at B 16 of the bf16 slot cache; #5 at the admission shape B 64,
     S 512); NSPLIT of staged decode (#2), the fused MLP's (#6) GEMM tiles
     and the IMMA instructions (and no IDP4A) in the SASS of its GEMMs,
     whose library yardstick, like the fused QKV's (#7), is the products
     alone as torch._int_mm calls; then the whole backbone, and a
     small serving Engine, on the GPU against the CPU (plain versions) on a
     small f32 model, with f32, int8 and int4 caches;
  4. main path, W8A8: NeuTTS.initialize_random(AIR, CODEC, quantize="int8")
     with an int8 KV cache, infer_batch over 8 prompts (seeded random
     weights, sampling constrained to speech tokens);
  5. main path, default: bf16 weights and KV cache, one infer;
  6. serving, W8A8: Engine.run over 320 requests of 380-512 prompt tokens
     into 128 slots (int8 KV: staged decode, reconcile, scatter-prefill);
  7. serving, default: bf16 weights and KV, 16 slots, 40 requests;
  8. main path, W8A8 with kv_dtype="auto" (the int4 cache): infer_batch over
     the 8 prompts of phase 4;
  9. serving, W8A8 with kv_dtype="auto": the mix of phase 6 (int4 KV: staged
     int4 decode, reconcile4, scatter-prefill4).
Each main path runs with the launch counts set to 0 just before it and read
just after. Before the last two lines: the report, the nvidia-smi card line
and the JSON object {"kernels": [...]}; the last line is {"ok": true,
"device": {...}}. The report also goes to chiprun_out/chip_smoke.json.
It exits non-zero without a result when no CUDA device is present or when
run without the rest of the repository.
"""

from __future__ import annotations

import gc
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
HBM_BYTES_PER_S = 3.35e12  # H100 SXM: 80 GB HBM3
PEAK_BF16 = 989e12  # dense tensor-core bf16 flop/s
PEAK_INT8 = 1979e12  # dense tensor-core int8 op/s


def require(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {msg}")


def gpu_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True,
    ).stdout.strip()
    return out.splitlines()[0]


def bound(nbytes: float, ops: float, peak: float):
    """Least time in ms for the work (bytes over HBM rate vs ops over peak)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def sass_functions(lib) -> dict:
    """Function name -> its SASS lines, from `cuobjdump -sass` of a library."""
    from neutts_tpu_torch.ops import _build

    cuobjdump = Path(_build.nvcc_path()).with_name("cuobjdump")
    out = subprocess.run([str(cuobjdump), "-sass", str(lib)], check=True, capture_output=True,
                         text=True).stdout
    funcs: dict = {}
    cur = None
    for line in out.splitlines():
        if "Function :" in line:
            cur = line.split("Function :", 1)[1].strip()
            funcs[cur] = []
        elif cur is not None:
            funcs[cur].append(line)
    return funcs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from neutts_tpu_torch import NeuTTS, config
    from neutts_tpu_torch.models import backbone as bb
    from neutts_tpu_torch.models.checkpoint import tree_to
    from neutts_tpu_torch.ops import _build
    from neutts_tpu_torch.ops import attention as attn
    from neutts_tpu_torch.ops import mlp as mlp_ops
    from neutts_tpu_torch.runtime import batching
    from neutts_tpu_torch.runtime import decode as dec
    from neutts_tpu_torch.serving import Engine

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    report: dict = {"phases": {}}

    # --- 1. the card ---------------------------------------------------------------
    smi = gpu_line()
    name = torch.cuda.get_device_name(0)
    print(f"[1] gpu: {smi} | torch {torch.__version__} cuda {torch.version.cuda} | {name}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    report["gpu"] = smi

    # --- 2. build --------------------------------------------------------------------
    build_s = _build.build_all()
    for src in _build.SOURCES:
        _build.library(src)
    print(f"[2] kernels built in {build_s:.1f} s ({', '.join(_build.SOURCES)})")
    for log in sorted(_build.BUILD_DIR.glob("*.log")):
        entry = "?"
        for line in log.read_text().splitlines():
            if "Compiling entry function" in line:
                entry = line.split("'")[1] if "'" in line else line.strip()
            elif "registers" in line or "spill" in line and "0 bytes spill" not in line:
                print(f"    {log.stem}: {entry[:72]}: {line.split(':', 1)[-1].strip()}")
    report["build_s"] = build_s

    # --- 3. kernels against their plain versions ---------------------------------------
    def time_ms(fn, iters):
        for i in range(3):
            fn(i)
        torch.cuda.synchronize()
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        for i in range(iters):
            fn(i)
        e.record()
        torch.cuda.synchronize()
        return s.elapsed_time(e) / iters

    SPIN = 200_000_000  # cycles of torch.cuda._sleep: ~0.1 s on an H100
    # written between cold calls: five times the H100's 50 MB L2, so a call
    # finds none of its inputs there and reads them from HBM, as its bound
    # assumes
    l2_flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)

    def device_ms(fn, iters):
        """Device time per call, (warm L2, L2 flushed). A spin kernel holds
        the stream while the host queues the calls, so the events time the
        device, not the host's launch rate (which back-to-back calls timed by
        events alone, time_ms, read when a kernel is shorter than its
        wrapper's Python). Warm: `iters` calls back to back, inputs that fit
        in L2 served from there. Flushed: each call after a 256 MB write,
        timed alone by its own pair of events. (A torch.profiler trace also
        gives device time, but a profiling session slows every later launch
        of the process: on an H100 the host-bound main paths after it ran
        25-35% slower.)"""
        for i in range(3):
            fn(i)
        ev = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
              for _ in range(iters + 1)]
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN)
        t0 = time.perf_counter()
        ev[-1][0].record()
        for i in range(iters):
            fn(i)
        ev[-1][1].record()
        for i in range(iters):
            l2_flush.zero_()
            ev[i][0].record()
            fn(i)
            ev[i][1].record()
        queued_ms = (time.perf_counter() - t0) * 1e3
        torch.cuda.synchronize()
        require(queued_ms < 0.8 * spin_ms, f"queueing {2 * iters} calls took {queued_ms:.1f} "
                f"ms, near the {spin_ms:.1f} ms spin: device_ms would time the host")
        warm = ev[-1][0].elapsed_time(ev[-1][1]) / iters
        return warm, sum(s.elapsed_time(e) for s, e in ev[:iters]) / iters

    s0, s1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s0.record()
    torch.cuda._sleep(SPIN)
    s1.record()
    torch.cuda.synchronize()
    spin_ms = s0.elapsed_time(s1)

    gen = torch.Generator(device=dev).manual_seed(1234)

    def randn(*shape, dtype=torch.bfloat16, scale=1.0):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dtype)

    cfg = config.AIR
    B, K, G, D, L = 8, cfg.n_kv_heads, cfg.n_heads // cfg.n_kv_heads, cfg.head_dim, cfg.n_layers
    H = K * G
    results: dict = {}

    shapes: dict = {}  # kernel #1 and #5 at the other main-path shapes

    def row_tolerance(want):
        # each row within 1% of its largest |output| (about 2.5 bf16 ulp
        # there): one token or chunk dropped, misplaced, weighted wrongly in
        # a merge or read from the wrong nibble moves a row past it
        return 1e-2 * want.float().abs().amax(dim=(1, 2, 3), keepdim=True)

    def record(key, got, want, tol, ms, plain_ms, library_ms, nbytes, ops, peak, replaces,
               source, *, dev_ms, into=results):
        """One kernel's entry; got/want are a tensor or a tuple of tensors.
        tol 0 asks for equality; a tensor tol is a limit per element
        (broadcast against want), reported as its largest value. dev_ms is
        device_ms's (warm L2, L2 flushed); the flushed time is the one
        comparable with the bound. Entries of `shapes` are extra shapes of a
        kernel already in `results`."""
        pairs = list(zip(got, want)) if isinstance(got, tuple) else [(got, want)]
        diffs = [(a.float() - b.float()).abs() for a, b in pairs]
        err = max(float(d.max()) for d in diffs)
        note = ", per element" if torch.is_tensor(tol) else ""
        if not note and tol == 0:
            ok, note = all(torch.equal(a, b) for a, b in pairs), ", exact"
        else:
            ok = np.isfinite(err) and all(bool((d <= tol).all()) for d in diffs)
            tol = float(torch.as_tensor(tol).max())
        bms, by = bound(nbytes, ops, peak)
        into[key] = {
            "name": key, "route": "cuda", "source": source, "replaces": replaces,
            "launches": 0, "max_abs_err": err, "tol": tol, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bms, "bound_by": by, "library_ms": library_ms,
            "device_warm_ms": dev_ms[0], "device_ms": dev_ms[1],
        }
        lib = "n/a" if library_ms is None else f"{library_ms:.4f}"
        print(f"[3] {key}: max_abs_err {err:.3e} (tol {tol:.3e}{note}) | ms {ms:.4f} | device "
              f"{dev_ms[0]:.4f} warm L2, {dev_ms[1]:.4f} L2 flushed | plain {plain_ms:.4f} | "
              f"library {lib} | bound {bms:.4f} ({by})")
        require(ok, f"{key} disagrees with its plain version")

    # decode attention over the stacked Air cache, ragged rows
    T = 1024
    lens = torch.tensor([1000, 1024, 800, 960, 1024, 700, 1010, 900], dtype=torch.int32,
                        device=dev)
    pad = torch.tensor([0, 5, 13, 64, 0, 100, 7, 31], dtype=torch.int32, device=dev)
    live = int((lens - pad).sum())
    q = randn(B, K, G, D)
    tmask = torch.arange(T, device=dev)
    sdpa_mask = ((tmask[None] < lens[:, None]) & (tmask[None] >= pad[:, None]))[:, None, None]
    qs = q.reshape(B, 1, H, D).transpose(1, 2)
    for mode in ("bf16", "int8"):
        ck, cv = randn(L, B, T, K * D), randn(L, B, T, K * D)
        ks = vs = None
        if mode == "int8":
            (ck, ks), (cv, vs) = bb.quantize_kv(ck), bb.quantize_kv(cv)
        args = lambda i: (q, ck, cv, i % L, lens, pad, ks, vs)  # noqa: E731
        got = attn.decode_attention(*args(L // 2))
        want = attn.decode_attention_plain(*args(L // 2))
        ms = time_ms(lambda i: attn.decode_attention(*args(i)), 200)
        dms = device_ms(lambda i: attn.decode_attention(*args(i)), 50)
        plain_ms = time_ms(lambda i: attn.decode_attention_plain(*args(i)), 10)
        # library: masked SDPA on one layer (bf16; int8 dequantized outside the timing)
        lk = ck[L // 2].float() * ks[L // 2][..., None] if mode == "int8" else ck[L // 2]
        lv = cv[L // 2].float() * vs[L // 2][..., None] if mode == "int8" else cv[L // 2]
        lk = lk.to(torch.bfloat16).reshape(B, T, K, D).transpose(1, 2).repeat_interleave(G, 1)
        lv = lv.to(torch.bfloat16).reshape(B, T, K, D).transpose(1, 2).repeat_interleave(G, 1)
        lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            qs, lk, lv, attn_mask=sdpa_mask), 200)
        esz = 1 if mode == "int8" else 2
        nbytes = 2 * B * H * D * 2 + 2 * live * K * D * esz + 8 * B
        if mode == "int8":
            nbytes += 2 * live * 4
        record(f"decode_attention_{mode}", got, want, 2e-2, ms, plain_ms, lib_ms, nbytes,
               4.0 * H * D * live, PEAK_BF16, "neutts_tpu/ops/attention.py:99",
               "neutts_tpu_torch/csrc/decode_attention.cu", dev_ms=dms)
        del ck, cv, lk, lv
    print(f"[3] decode_attention B {B} T {T}: NSPLIT {attn.decode_splits(B, K, T, dev)}")

    def decode_bf16_shape(key, Bx, Tx, lens_x, pad_x):
        """Kernel #1, bf16, at another main-path shape (ragged rows)."""
        lx = torch.tensor(lens_x, dtype=torch.int32, device=dev)
        px = torch.tensor(pad_x, dtype=torch.int32, device=dev)
        qx = randn(Bx, K, G, D)
        ck, cv = randn(L, Bx, Tx, K * D), randn(L, Bx, Tx, K * D)
        args = lambda i: (qx, ck, cv, i % L, lx, px)  # noqa: E731
        got = attn.decode_attention(*args(L // 2))
        want = attn.decode_attention_plain(*args(L // 2))
        ms = time_ms(lambda i: attn.decode_attention(*args(i)), 200)
        dms = device_ms(lambda i: attn.decode_attention(*args(i)), 50)
        plain_ms = time_ms(lambda i: attn.decode_attention_plain(*args(i)), 10)
        tx = torch.arange(Tx, device=dev)
        mx = ((tx[None] < lx[:, None]) & (tx[None] >= px[:, None]))[:, None, None]
        lk = ck[L // 2].reshape(Bx, Tx, K, D).transpose(1, 2).repeat_interleave(G, 1)
        lv = cv[L // 2].reshape(Bx, Tx, K, D).transpose(1, 2).repeat_interleave(G, 1)
        lq = qx.reshape(Bx, 1, H, D).transpose(1, 2)
        lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=mx), 200)
        livex = int((lx - px).clamp(min=0).sum())
        nsplit = attn.decode_splits(Bx, K, Tx, dev)
        print(f"[3] {key}: B {Bx} T {Tx}, {livex} live tokens, NSPLIT {nsplit}")
        record(key, got, want, row_tolerance(want), ms, plain_ms, lib_ms,
               2 * Bx * H * D * 2 + 2 * livex * K * D * 2 + 8 * Bx, 4.0 * H * D * livex,
               PEAK_BF16, "neutts_tpu/ops/attention.py:99",
               "neutts_tpu_torch/csrc/decode_attention.cu", into=shapes, dev_ms=dms)
        shapes[key].update(B=Bx, T=Tx, live_tokens=livex, nsplit=nsplit)

    # the (b) path: bf16 infer, batch 1, one row of ~1,900 live tokens
    decode_bf16_shape("decode_attention_bf16@B1_T2048", 1, 2048, [1903], [5])
    # the (d) path: bf16 serving, 16 slots of the slot cache, ragged rows
    Td = batching.slot_cache_len(cfg)
    rs3 = np.random.default_rng(3)
    lens_d = rs3.integers(300, Td + 1, 16)
    decode_bf16_shape(f"decode_attention_bf16@B16_T{Td}", 16, Td, lens_d.tolist(),
                      np.minimum(lens_d, rs3.integers(0, 133, 16)).tolist())
    torch.cuda.empty_cache()

    # prefill attention, B = 8, S = 512, ragged left pads; then the
    # admission shape B = 64, S = 512 (prompts of 380-512 tokens)
    def prefill_shape(key, Bx, S, pads_x, into):
        pads = torch.tensor(pads_x, dtype=torch.int32, device=dev)
        pq, pk, pv = randn(Bx, S, H, D), randn(Bx, S, K, D), randn(Bx, S, K, D)
        got = attn.prefill_attention(pq, pk, pv, pads)
        want = attn.prefill_attention_plain(pq, pk, pv, pads)
        ms = time_ms(lambda i: attn.prefill_attention(pq, pk, pv, pads), 50)
        dms = device_ms(lambda i: attn.prefill_attention(pq, pk, pv, pads), 20)
        plain_ms = time_ms(lambda i: attn.prefill_attention_plain(pq, pk, pv, pads), 5)
        idx = torch.arange(S, device=dev)
        pmask = ((idx[None, None, :] <= idx[None, :, None])
                 & (idx[None, None, :] >= pads[:, None, None]))[:, None]
        lq = pq.transpose(1, 2)
        lk = pk.transpose(1, 2).repeat_interleave(G, 1)
        lv = pv.transpose(1, 2).repeat_interleave(G, 1)
        lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
            lq, lk, lv, attn_mask=pmask), 50)
        m = (S - pads).clamp(min=0).double()
        pairs = float((m * (m + 1) / 2).sum())
        # q, k and v are read for the live rows only (pad rows are written as
        # zeros, key tiles below the pad skipped); out is written in full
        rows = float(m.sum())
        record(key, got, want, 2e-2, ms, plain_ms, lib_ms,
               rows * (H + 2 * K) * D * 2 + Bx * S * H * D * 2 + 4 * Bx, 4.0 * H * D * pairs,
               PEAK_BF16, "neutts_tpu/ops/attention.py:1525",
               "neutts_tpu_torch/csrc/prefill_attention.cu", into=into, dev_ms=dms)

    tile = attn.prefill_tile(G, D, torch.bfloat16)
    print(f"[3] prefill_attention bf16 tile: {tile['query_positions']} query positions x "
          f"{tile['heads']} heads per block, 64-key K/V tiles, {tile['threads']} threads, "
          f"{tile['smem_bytes']} B shared")
    report["prefill_tile"] = tile
    prefill_shape("prefill_attention", B, 512, [0, 3, 100, 255, 511, 64, 17, 200], results)
    prefill_shape("prefill_attention@B64_S512", 64, 512,
                  np.random.default_rng(4).integers(0, 133, 64).tolist(), shapes)
    torch.cuda.empty_cache()

    # W8A8 projections at M = 4096 prompt tokens (B = 8 x a 512 bucket)
    M, Dm, Fm, N = 4096, cfg.hidden_size, cfg.intermediate_size, cfg.q_dim + 2 * cfg.kv_dim
    x = randn(M, Dm, scale=0.5)
    nw = (1.0 + 0.1 * randn(Dm, dtype=torch.float32)).to(torch.bfloat16)
    wqkv = bb.quantize_weight(randn(Dm, N, dtype=torch.float32, scale=Dm**-0.5))
    bias = randn(N, dtype=torch.float32, scale=0.05)
    qargs = (x, nw, wqkv["q"], wqkv["s"], bias)
    got = mlp_ops.fused_qkv(*qargs)
    want = mlp_ops.fused_qkv_plain(*qargs)
    ms = time_ms(lambda i: mlp_ops.fused_qkv(*qargs), 20)
    dms = device_ms(lambda i: mlp_ops.fused_qkv(*qargs), 20)
    plain_ms = time_ms(lambda i: mlp_ops.fused_qkv_plain(*qargs), 5)
    # library: the product alone, one torch._int_mm on the same int8 operands
    # (quantization, epilogue and the weight's K-major copy, the layout on
    # which cuBLAS takes its TN tensor-core kernel, outside the timing)
    xq8, xs8 = mlp_ops.quantize_act(mlp_ops._rms(x, nw, 1e-6))
    wqkv_k = bb.k_major(wqkv["q"])
    lib_ms = time_ms(lambda i: torch._int_mm(xq8, wqkv_k), 20)
    record("fused_qkv", got, want, 2e-2 * float(want.float().abs().max()), ms, plain_ms, lib_ms,
           M * Dm * 2 + Dm * N + 2 * N * 4 + Dm * 2 + M * N * 2, 2.0 * M * Dm * N, PEAK_INT8,
           "neutts_tpu/ops/mlp.py:234", "neutts_tpu_torch/csrc/w8a8.cu", dev_ms=dms)
    # the MLP's weights K-major, as backbone.quantize_params stores them
    wg, wu = (bb.quantize_weight(randn(Dm, Fm, dtype=torch.float32, scale=Dm**-0.5))
              for _ in range(2))
    wd = bb.quantize_weight(randn(Fm, Dm, dtype=torch.float32, scale=Fm**-0.5))
    for w in (wg, wu, wd):
        w["q"] = bb.k_major(w["q"])
    margs = (x, nw, wg["q"], wg["s"], wu["q"], wu["s"], wd["q"], wd["s"])
    tile = mlp_ops.mlp_tile()
    print(f"[3] fused_mlp int8 tensor-core tiles: gate/up {tile['gate_up_rows']} rows x "
          f"{tile['gate_up_cols']} gate + {tile['gate_up_cols']} up columns, down "
          f"{tile['down_rows']} rows x {tile['down_cols']} columns, {tile['k_bytes']}-byte k "
          f"steps in {tile['stages']} stages, {tile['threads']} threads (mma.sync m16n8k32 s8)")
    report["mlp_tile"] = tile
    got = mlp_ops.fused_mlp(*margs)
    want = mlp_ops.fused_mlp_plain(*margs)
    ms = time_ms(lambda i: mlp_ops.fused_mlp(*margs), 10)
    dms = device_ms(lambda i: mlp_ops.fused_mlp(*margs), 10)
    plain_ms = time_ms(lambda i: mlp_ops.fused_mlp_plain(*margs), 3)
    # library: the three products alone as torch._int_mm on the same operands
    # (the K-major weight views; quantizations and epilogues outside the timing)
    ffq8 = mlp_ops.quantize_act(
        torch.nn.functional.silu(mlp_ops.int8_matmul(xq8, wg["q"]).float() * xs8 * wg["s"])
        * (mlp_ops.int8_matmul(xq8, wu["q"]).float() * xs8 * wu["s"]))[0]

    def lib_mlp(i):
        torch._int_mm(xq8, wg["q"])
        torch._int_mm(xq8, wu["q"])
        torch._int_mm(ffq8, wd["q"])

    lib_ms = time_ms(lib_mlp, 20)
    record("fused_mlp", got, want, 3e-2 * float(want.float().abs().max()), ms, plain_ms, lib_ms,
           2 * M * Dm * 2 + 3 * Dm * Fm + (2 * Fm + Dm) * 4 + Dm * 2, 6.0 * M * Dm * Fm,
           PEAK_INT8, "neutts_tpu/ops/mlp.py:103", "neutts_tpu_torch/csrc/w8a8.cu", dev_ms=dms)
    del x, wqkv, wqkv_k, wg, wu, wd, got, want, xq8, xs8, ffq8

    # the MLP's GEMMs run on the int8 tensor cores: IMMA, and no IDP4A, in
    # the SASS of each of their entry functions
    sass = sass_functions(_build._lib_path("w8a8.cu"))
    gemms = {f: t for f, t in sass.items() if "imma_gemm_kernel" in f}
    require(len(gemms) == 3, f"expected 3 tensor-core GEMM functions in w8a8, got {list(gemms)}")
    for f, t in gemms.items():
        n_imma = sum(" IMMA" in ln for ln in t)
        require(n_imma > 0 and not any("IDP4A" in ln for ln in t),
                f"{f}: {n_imma} IMMA, IDP4A present: {any('IDP4A' in ln for ln in t)}")
        print(f"[3] sass {f[:60]}: {n_imma} IMMA, no IDP4A")
    report["mlp_sass_imma"] = {f: sum(" IMMA" in ln for ln in t) for f, t in gemms.items()}
    torch.cuda.empty_cache()

    # serving kernels at the W8A8 serving shapes: 128 slots of T = 2304, S = 32
    Bs, S = 128, 32
    Ts = batching.slot_cache_len(cfg)
    KD = K * D
    rng = np.random.default_rng(0)

    def quantized(*shape):
        """int8 values and f32 scales of unit-normal K/V rows, one layer at a time."""
        q8 = torch.empty(shape, dtype=torch.int8, device=dev)
        sc = torch.empty(shape[:-1], dtype=torch.float32, device=dev)
        for lyr in range(shape[0]):
            q8[lyr], sc[lyr] = bb.quantize_kv(randn(*shape[1:]))
        return q8, sc

    def staging_scales(sc):
        return torch.nn.functional.pad(sc, (0, attn.SEG_PAD - sc.shape[-1]))

    (ck, ks), (cv, vs) = quantized(L, Bs, Ts, KD), quantized(L, Bs, Ts, KD)
    (sk8, sks), (sv8, svs) = quantized(L, Bs, S, KD), quantized(L, Bs, S, KD)
    stag = (sk8, sv8, staging_scales(sks), staging_scales(svs))

    # staged decode attention: ragged settled lengths (multiples of 64 in
    # [0, 2048], some rows empty), ragged pads, staging step 17
    step = 17
    base_np = rng.integers(0, 33, Bs) * 64
    base_np[:8] = 0
    pad_np = np.minimum(base_np, rng.integers(0, 200, Bs))
    base = torch.tensor(base_np, dtype=torch.int32, device=dev)
    spad = torch.tensor(pad_np, dtype=torch.int32, device=dev)
    live = int((base_np - pad_np).sum())
    sq = randn(Bs, K, G, D)
    sargs = lambda i: (sq, ck, cv, ks, vs, *stag, i % L, step, base, spad)  # noqa: E731
    got = attn.decode_attention_staged(*sargs(L // 2))
    want = attn.decode_attention_staged_plain(*sargs(L // 2))
    ms = time_ms(lambda i: attn.decode_attention_staged(*sargs(i)), 200)
    dms = device_ms(lambda i: attn.decode_attention_staged(*sargs(i)), 20)
    plain_ms = time_ms(lambda i: attn.decode_attention_staged_plain(*sargs(i)), 5)
    # library: masked SDPA over a dequantized bf16 copy of cache + staging
    # of one layer, made outside the timing
    lyr = L // 2
    lk = torch.cat([ck[lyr].float() * ks[lyr][..., None],
                    stag[0][lyr].float() * stag[2][lyr][:, :S, None]], dim=1)
    lv = torch.cat([cv[lyr].float() * vs[lyr][..., None],
                    stag[1][lyr].float() * stag[3][lyr][:, :S, None]], dim=1)
    lk = lk.to(torch.bfloat16).reshape(Bs, Ts + S, K, D).transpose(1, 2).repeat_interleave(G, 1)
    lv = lv.to(torch.bfloat16).reshape(Bs, Ts + S, K, D).transpose(1, 2).repeat_interleave(G, 1)
    tt = torch.arange(Ts + S, device=dev)
    smask = (((tt[None] < base[:, None]) & (tt[None] >= spad[:, None]))
             | ((tt[None] >= Ts) & (tt[None] <= Ts + step)))[:, None, None]
    lq = sq.reshape(Bs, 1, H, D).transpose(1, 2)
    lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        lq, lk, lv, attn_mask=smask), 100)
    n_att = live + Bs * (step + 1)
    print(f"[3] decode_attention_staged B {Bs} T {Ts}: NSPLIT "
          f"{attn.decode_splits(Bs, K, Ts, dev)} settled chunks + 1 staging partial")
    record("decode_attention_staged", got, want, row_tolerance(want), ms, plain_ms, lib_ms,
           2 * Bs * H * D * 2 + n_att * (2 * KD + 8) + 8 * Bs, 4.0 * H * D * n_att, PEAK_BF16,
           "neutts_tpu/ops/attention.py:548", "neutts_tpu_torch/csrc/staged_attention.cu",
           dev_ms=dms)
    del lk, lv, got, want

    # segment reconcile: about half the rows active, 8-aligned bases
    bufs = (ck, cv, ks, vs)
    rbase_np = rng.integers(0, (Ts - S) // 8 + 1, Bs) * 8
    rbase = torch.tensor(rbase_np, dtype=torch.int32, device=dev)
    ract_np = rng.random(Bs) < 0.5
    ract = torch.tensor(ract_np, device=dev)
    got = attn.reconcile_segment(*(b.clone() for b in bufs), *stag, rbase, ract)
    want = attn.reconcile_segment_plain(*(b.clone() for b in bufs), *stag, rbase, ract)
    work = [b.clone() for b in bufs]
    ms = time_ms(lambda i: attn.reconcile_segment(*work, *stag, rbase, ract), 100)
    dms = device_ms(lambda i: attn.reconcile_segment(*work, *stag, rbase, ract), 20)
    plain_ms = time_ms(lambda i: attn.reconcile_segment_plain(*work, *stag, rbase, ract), 5)
    # library: scatter_ along time over the [B, S] column index; inactive rows
    # scatter their own current values (gathered outside the timing)
    cols = (rbase[:, None] + torch.arange(S, device=dev)).long()
    idx_v = cols[None, :, :, None].expand(L, Bs, S, KD)
    idx_s = cols[None].expand(L, Bs, S)
    keep = ract[None, :, None]
    src = [torch.where(keep[..., None], stag[0], work[0].gather(2, idx_v)),
           torch.where(keep[..., None], stag[1], work[1].gather(2, idx_v)),
           torch.where(keep, stag[2][..., :S], work[2].gather(2, idx_s)),
           torch.where(keep, stag[3][..., :S], work[3].gather(2, idx_s))]

    def lib_reconcile(i):
        for w, ix, sr in zip(work, (idx_v, idx_v, idx_s, idx_s), src):
            w.scatter_(2, ix, sr)

    lib_ms = time_ms(lib_reconcile, 100)
    n_act = int(ract_np.sum())
    record("reconcile_segment", got, want, 0, ms, plain_ms, lib_ms,
           2 * n_act * L * S * (2 * KD + 8) + 5 * Bs, 0.0, PEAK_INT8,
           "neutts_tpu/ops/attention.py:1039", "neutts_tpu_torch/csrc/slot_copy.cu", dev_ms=dms)
    del got, want, work, src, idx_v

    # admission write: a group of 64 rows (8 of them group padding that
    # repeats the last admission), Lp 512, into the 128-slot cache
    G8, Lp = 64, 512
    rows = rng.permutation(Bs)[: G8 - 8]
    slots_np = np.concatenate([rows, np.full(8, rows[-1])]).astype(np.int32)
    pslots = torch.tensor(slots_np, dtype=torch.int32, device=dev)
    first = [int(np.flatnonzero(slots_np == s_)[0]) for s_ in slots_np]
    primary = torch.tensor([f == j for j, f in enumerate(first)], device=dev)
    (nk8, nks), (nv8, nvs) = quantized(L, G8, Lp, KD), quantized(L, G8, Lp, KD)
    new = [nk8, nv8, nks, nvs]
    for a in new:
        a[:, G8 - 8:] = a[:, G8 - 9: G8 - 8]  # duplicates carry the same row
    got = attn.scatter_prefill(*(b.clone() for b in bufs), *new, pslots, primary)
    want = attn.scatter_prefill_plain(*(b.clone() for b in bufs), *new, pslots, primary)
    work = [b.clone() for b in bufs]
    ms = time_ms(lambda i: attn.scatter_prefill(*work, *new, pslots, primary), 100)
    dms = device_ms(lambda i: attn.scatter_prefill(*work, *new, pslots, primary), 20)
    plain_ms = time_ms(lambda i: attn.scatter_prefill_plain(*work, *new, pslots, primary), 5)
    # library: index_copy_ of the primary rows (selected outside the timing)
    prim = primary.nonzero()[:, 0]
    dst_rows = pslots[prim].long()
    psrc = [a[:, prim] for a in new]

    def lib_prefill(i):
        for w, sr in zip(work, psrc):
            w[:, :, :Lp].index_copy_(1, dst_rows, sr)

    lib_ms = time_ms(lib_prefill, 100)
    record("scatter_prefill", got, want, 0, ms, plain_ms, lib_ms,
           2 * len(prim) * L * Lp * (2 * KD + 8) + 5 * G8, 0.0, PEAK_INT8,
           "neutts_tpu/ops/attention.py:1290", "neutts_tpu_torch/csrc/slot_copy.cu", dev_ms=dms)
    del got, want, work, new, psrc, ck, cv, ks, vs, stag, bufs
    torch.cuda.empty_cache()

    # --- int4 modes: packed nibble pairs [.., T/2, KD], deinterleaved scales ---------
    def quantized4(*shape):
        """Packed int4 values [.., T/2, KD] and deinterleaved scales [.., T] of
        unit-normal K/V rows, one layer at a time."""
        p4 = torch.empty((*shape[:-2], shape[-2] // 2, shape[-1]), dtype=torch.int8, device=dev)
        sc = torch.empty(shape[:-1], dtype=torch.float32, device=dev)
        for lyr in range(shape[0]):
            q4, s4 = bb.quantize_kv4(randn(*shape[1:]))
            p4[lyr], sc[lyr] = bb.pack4_pairs(q4), bb.scales4_block(s4)
        return p4, sc

    def unquantized4(*shape):
        """Unpacked int4 values and token-order scales (staging layout)."""
        q4 = torch.empty(shape, dtype=torch.int8, device=dev)
        sc = torch.empty(shape[:-1], dtype=torch.float32, device=dev)
        for lyr in range(shape[0]):
            q4[lyr], sc[lyr] = bb.quantize_kv4(randn(*shape[1:]))
        return q4, sc

    # decode attention over the stacked int4 Air cache: odd lens and pads
    T = 1024
    lens = torch.tensor([1001, 1024, 799, 960, 1023, 700, 1010, 901], dtype=torch.int32,
                        device=dev)
    pad = torch.tensor([0, 5, 13, 64, 1, 100, 7, 31], dtype=torch.int32, device=dev)
    live = int((lens - pad).sum())
    (ck, ks), (cv, vs) = quantized4(L, B, T, K * D), quantized4(L, B, T, K * D)
    args = lambda i: (q, ck, cv, i % L, lens, pad, ks, vs)  # noqa: E731
    got = attn.decode_attention(*args(L // 2))
    want = attn.decode_attention_plain(*args(L // 2))
    ms = time_ms(lambda i: attn.decode_attention(*args(i)), 200)
    dms = device_ms(lambda i: attn.decode_attention(*args(i)), 50)
    plain_ms = time_ms(lambda i: attn.decode_attention_plain(*args(i)), 10)
    lk = bb.dequant_kv4(ck[L // 2], ks[L // 2]).to(torch.bfloat16)
    lv = bb.dequant_kv4(cv[L // 2], vs[L // 2]).to(torch.bfloat16)
    lk = lk.reshape(B, T, K, D).transpose(1, 2).repeat_interleave(G, 1)
    lv = lv.reshape(B, T, K, D).transpose(1, 2).repeat_interleave(G, 1)
    sdpa_mask = ((tmask[None] < lens[:, None]) & (tmask[None] >= pad[:, None]))[:, None, None]
    lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        qs, lk, lv, attn_mask=sdpa_mask), 200)
    # int4: half a byte per value (K and V), the same 4-byte scales as int8
    record("decode_attention_int4", got, want, row_tolerance(want), ms, plain_ms, lib_ms,
           2 * B * H * D * 2 + live * (K * D + 8) + 8 * B, 4.0 * H * D * live, PEAK_BF16,
           "neutts_tpu/ops/attention.py:99", "neutts_tpu_torch/csrc/decode_attention.cu",
           dev_ms=dms)
    del ck, cv, ks, vs, lk, lv, got, want

    # staged decode attention at the int4 serving shapes: T = 2560, ragged
    # even bases (8 rows empty), odd pads, staging step 17
    Ts4 = batching.slot_cache_len(cfg.scaled(kv_dtype="int4"))
    (ck, ks), (cv, vs) = quantized4(L, Bs, Ts4, KD), quantized4(L, Bs, Ts4, KD)
    (sk4, sks4), (sv4, svs4) = unquantized4(L, Bs, S, KD), unquantized4(L, Bs, S, KD)
    stag = (sk4, sv4, staging_scales(sks4), staging_scales(svs4))
    base_np = rng.integers(0, 1025, Bs) * 2
    base_np[:8] = 0
    pad_np = np.minimum(base_np, rng.integers(0, 100, Bs) * 2 + 1)
    base = torch.tensor(base_np, dtype=torch.int32, device=dev)
    spad = torch.tensor(pad_np, dtype=torch.int32, device=dev)
    live = int((base_np - pad_np).sum())
    sargs = lambda i: (sq, ck, cv, ks, vs, *stag, i % L, step, base, spad)  # noqa: E731
    got = attn.decode_attention_staged(*sargs(L // 2))
    want = attn.decode_attention_staged_plain(*sargs(L // 2))
    ms = time_ms(lambda i: attn.decode_attention_staged(*sargs(i)), 200)
    dms = device_ms(lambda i: attn.decode_attention_staged(*sargs(i)), 20)
    plain_ms = time_ms(lambda i: attn.decode_attention_staged_plain(*sargs(i)), 5)
    lyr = L // 2
    lk = torch.cat([bb.dequant_kv4(ck[lyr], ks[lyr]),
                    stag[0][lyr].float() * stag[2][lyr][:, :S, None]], dim=1)
    lv = torch.cat([bb.dequant_kv4(cv[lyr], vs[lyr]),
                    stag[1][lyr].float() * stag[3][lyr][:, :S, None]], dim=1)
    lk = lk.to(torch.bfloat16).reshape(Bs, Ts4 + S, K, D).transpose(1, 2).repeat_interleave(G, 1)
    lv = lv.to(torch.bfloat16).reshape(Bs, Ts4 + S, K, D).transpose(1, 2).repeat_interleave(G, 1)
    tt = torch.arange(Ts4 + S, device=dev)
    smask = (((tt[None] < base[:, None]) & (tt[None] >= spad[:, None]))
             | ((tt[None] >= Ts4) & (tt[None] <= Ts4 + step)))[:, None, None]
    lib_ms = time_ms(lambda i: torch.nn.functional.scaled_dot_product_attention(
        lq, lk, lv, attn_mask=smask), 100)
    n_stag = Bs * (step + 1)
    print(f"[3] decode_attention_staged_int4 B {Bs} T {Ts4}: NSPLIT "
          f"{attn.decode_splits(Bs, K, Ts4, dev)} settled chunks + 1 staging partial")
    record("decode_attention_staged_int4", got, want, row_tolerance(want), ms, plain_ms, lib_ms,
           2 * Bs * H * D * 2 + live * (KD + 8) + n_stag * (2 * KD + 8) + 8 * Bs,
           4.0 * H * D * (live + n_stag), PEAK_BF16, "neutts_tpu/ops/attention.py:548",
           "neutts_tpu_torch/csrc/staged_attention.cu", dev_ms=dms)
    del lk, lv, got, want

    # int4 segment reconcile: bases multiples of 16, about half the rows active
    bufs = (ck, cv, ks, vs)
    rbase_np = rng.integers(0, (Ts4 - S) // 16 + 1, Bs) * 16
    rbase = torch.tensor(rbase_np, dtype=torch.int32, device=dev)
    ract_np = rng.random(Bs) < 0.5
    ract = torch.tensor(ract_np, device=dev)
    got = attn.reconcile_segment4(*(b.clone() for b in bufs), *stag, rbase, ract)
    want = attn.reconcile_segment4_plain(*(b.clone() for b in bufs), *stag, rbase, ract)
    work = [b.clone() for b in bufs]
    ms = time_ms(lambda i: attn.reconcile_segment4(*work, *stag, rbase, ract), 100)
    dms = device_ms(lambda i: attn.reconcile_segment4(*work, *stag, rbase, ract), 20)
    plain_ms = time_ms(lambda i: attn.reconcile_segment4_plain(*work, *stag, rbase, ract), 5)
    # library: scatter_ of the packed staging bytes along the byte axis and of
    # the scales along their deinterleaved columns; inactive rows scatter
    # their own current values (packing and gathering outside the timing)
    bcols = ((rbase[:, None] >> 1) + torch.arange(S // 2, device=dev)).long()
    scols = bb.deint4_index(rbase[:, None] + torch.arange(S, device=dev), Ts4 // 2).long()
    idx_v = bcols[None, :, :, None].expand(L, Bs, S // 2, KD)
    idx_s = scols[None].expand(L, Bs, S)
    keep = ract[None, :, None]
    src = [torch.where(keep[..., None], bb.pack4_pairs(stag[0]), work[0].gather(2, idx_v)),
           torch.where(keep[..., None], bb.pack4_pairs(stag[1]), work[1].gather(2, idx_v)),
           torch.where(keep, stag[2][..., :S], work[2].gather(2, idx_s)),
           torch.where(keep, stag[3][..., :S], work[3].gather(2, idx_s))]

    def lib_reconcile4(i):
        for w, ix, sr in zip(work, (idx_v, idx_v, idx_s, idx_s), src):
            w.scatter_(2, ix, sr)

    lib_ms = time_ms(lib_reconcile4, 100)
    n_act = int(ract_np.sum())
    # per token of an active row: 2 staged values read, 1 packed byte
    # written (K and V), 4-byte scales read and written
    record("reconcile_segment4", got, want, 0, ms, plain_ms, lib_ms,
           n_act * L * S * (3 * KD + 16) + 5 * Bs, 0.0, PEAK_INT8,
           "neutts_tpu/ops/attention.py:1039", "neutts_tpu_torch/csrc/slot_copy.cu", dev_ms=dms)
    del got, want, src, idx_v

    # int4 admission write: a group of 64 rows (8 duplicates), Lp 512, into the
    # 128-slot T = 2560 cache: packed bytes and token-order scales
    (nq4, nks), (nv4, nvs) = unquantized4(L, G8, Lp, KD), unquantized4(L, G8, Lp, KD)
    new = [bb.pack4_pairs(nq4), bb.pack4_pairs(nv4), nks, nvs]
    del nq4, nv4
    for a in new:
        a[:, G8 - 8:] = a[:, G8 - 9: G8 - 8]
    got = attn.scatter_prefill4(*(b.clone() for b in bufs), *new, pslots, primary)
    want = attn.scatter_prefill4_plain(*(b.clone() for b in bufs), *new, pslots, primary)
    ms = time_ms(lambda i: attn.scatter_prefill4(*work, *new, pslots, primary), 100)
    dms = device_ms(lambda i: attn.scatter_prefill4(*work, *new, pslots, primary), 20)
    plain_ms = time_ms(lambda i: attn.scatter_prefill4_plain(*work, *new, pslots, primary), 5)
    # library: index_copy_ of the primary rows' packed bytes, scatter_ of their
    # deinterleaved scales on the flattened [L, B*T] rows (prepared outside
    # the timing)
    psrc = [a[:, prim] for a in new[:2]]
    pcols = bb.deint4_index(torch.arange(Lp, device=dev), Ts4 // 2)
    sidx = (dst_rows[:, None] * Ts4 + pcols).reshape(1, -1).expand(L, -1).contiguous()
    ssrc = [a[:, prim].reshape(L, -1) for a in new[2:]]

    def lib_prefill4(i):
        for w, sr in zip(work[:2], psrc):
            w[:, :, :Lp // 2].index_copy_(1, dst_rows, sr)
        for w, sr in zip(work[2:], ssrc):
            w.view(L, -1).scatter_(1, sidx, sr)

    lib_ms = time_ms(lib_prefill4, 100)
    record("scatter_prefill4", got, want, 0, ms, plain_ms, lib_ms,
           2 * len(prim) * L * Lp * (KD + 8) + 5 * G8, 0.0, PEAK_INT8,
           "neutts_tpu/ops/attention.py:1290", "neutts_tpu_torch/csrc/slot_copy.cu", dev_ms=dms)
    del got, want, work, new, psrc, ssrc, ck, cv, ks, vs, stag, bufs
    torch.cuda.empty_cache()

    # the whole backbone, GPU (kernels) against CPU (plain versions), small f32 model
    tiny = config.TINY
    p_cpu = bb.init_params(tiny, seed=3, device="cpu")
    p_gpu = tree_to(p_cpu, dev)
    prompts = [[5, 6, 7, 8, 9, 10, 11, 12], [13, 14, 15]]
    worst = 0.0
    for kv in ("float32", "int8", "int4"):
        c = tiny.scaled(kv_dtype=kv)
        outs = []
        for d, p in (("cpu", p_cpu), (dev, p_gpu)):
            toks, plens = dec.pad_prompts(prompts, pad_id=0, bucket=16, device=d)
            cache = bb.KVCache.create(c, 2, max_len=32, device=d, dtype=torch.float32)
            lg, cache = bb.prefill(c, p, toks, plens, cache)
            seq = [lg.float().cpu()]
            padv = (16 - plens).to(torch.int32)
            for s in range(4):
                tok = torch.tensor([20 + s, 30 + s], dtype=torch.int32, device=d)
                lg, cache = bb.decode_step(c, p, tok, cache, 16 + s, padv)
                seq.append(lg.float().cpu())
            outs.append(torch.stack(seq))
        worst = max(worst, float((outs[0] - outs[1]).abs().max()))
    print(f"[3] backbone TINY f32, GPU kernels vs CPU plain: max logit diff {worst:.3e} "
          "(tol 1e-3)")
    require(worst <= 1e-3, "TINY backbone on the GPU disagrees with the CPU")
    report["tiny_backbone_max_diff"] = worst

    # a small f32 serving Engine, GPU (kernels) against CPU (plain versions)
    eos_t = tiny.layout.speech_gen_end
    tprompts = [[3, 1, 4, 1, 5], [9, 2, 6], [2, 7, 1, 8, 2, 8], [11, 12]]
    for kv in ("int8", "float32", "int4"):  # int4 rounds the segment up to 16 steps
        toks_by_dev = []
        for d in ("cpu", dev):
            eng = Engine(tiny.scaled(kv_dtype=kv), p_cpu, eos_id=eos_t, n_slots=2,
                         sampling=config.SamplingConfig(greedy=True, min_new_tokens=2),
                         segment_steps=8, device=d)
            rids = [eng.submit(tp, max_new=24) for tp in tprompts]
            out = eng.run()
            toks_by_dev.append([out[r] for r in rids])
        print(f"[3] serving Engine TINY f32, {kv} KV, GPU vs CPU: greedy tokens equal "
              f"{toks_by_dev[0] == toks_by_dev[1]}")
        require(toks_by_dev[0] == toks_by_dev[1], f"TINY Engine ({kv} KV) GPU != CPU tokens")

    # --- 4. main path, W8A8 ------------------------------------------------------------
    codes = np.load(ROOT / "samples" / "demo_codes.npy").astype(np.int32)
    ref_text = (ROOT / "samples" / "demo.txt").read_text().strip()
    texts = [
        "Hello there, this is a test of the port.",
        "The quick brown fox jumps over the lazy dog.",
        "Short one.",
        "Synthesis on the graphics card, one batch of eight.",
        "Every kernel on this path was written by hand.",
        "Random weights still make codes to vocode.",
        "How fast does it decode?",
        "A last sentence, for the eighth row of the batch.",
    ]
    refs = [codes[: len(codes) - 6 * i] for i in range(len(texts))]

    def run_path(label, tts, batch):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        wavs = tts.infer_batch(texts[:batch], refs[:batch], [ref_text] * batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.launches)
        st = tts.last_stats
        require(len(wavs) == batch, f"{label}: {len(wavs)} waveforms for {batch} prompts")
        for w, n in zip(wavs, st["n_codes"]):
            require(isinstance(w, np.ndarray) and w.dtype == np.float32, f"{label}: dtype")
            require(n > 0 and w.shape == (n * 480,), f"{label}: length {w.shape} vs {n} codes")
            require(bool(np.isfinite(w).all()), f"{label}: non-finite samples")
        steps = st["steps"]
        tok_s = batch * (steps - 1) / st["decode_s"]
        info = {
            "batch": batch, "bucket": st["bucket"], "decode_steps": steps,
            "n_codes": st["n_codes"], "prefill_ms": st["prefill_s"] * 1e3,
            "decode_s": st["decode_s"], "decode_tok_s": tok_s,
            "decode_ms_per_step": st["decode_s"] * 1e3 / max(steps - 1, 1),
            "vocode_watermark_ms": st["vocode_s"] * 1e3, "wall_s": wall,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
        }
        print(f"[{label}] bucket {st['bucket']} x {batch} | prefill {info['prefill_ms']:.1f} ms"
              f" | decode {steps - 1} steps, {info['decode_ms_per_step']:.2f} ms/step, "
              f"{tok_s:.1f} tok/s | vocode+watermark {info['vocode_watermark_ms']:.1f} ms | "
              f"wall {wall:.1f} s | peak {info['peak_mem_gb']:.1f} GB | launches {counts}")
        return info

    layout = config.AIR.layout
    sampling = config.SamplingConfig(max_context=config.AIR.max_context).constrained_to(layout)
    tts = NeuTTS.initialize_random(config.AIR.scaled(kv_dtype="int8"), config.CODEC, seed=0,
                                   device=dev, quantize="int8", sampling=sampling)
    w8 = run_path("4", tts, 8)
    for k in ("decode_attention_int8", "prefill_attention", "fused_qkv", "fused_mlp"):
        require(w8["launches"][k] > 0, f"W8A8 main path never launched {k}")
    report["phases"]["w8a8_infer_batch"] = w8
    del tts
    torch.cuda.empty_cache()

    # --- 5. main path, default (bf16 weights, bf16 KV) ---------------------------------
    tts = NeuTTS.initialize_random(config.AIR, config.CODEC, seed=1, device=dev,
                                   sampling=sampling)
    d16 = run_path("5", tts, 1)
    for k in ("decode_attention_bf16", "prefill_attention"):
        require(d16["launches"][k] > 0, f"default main path never launched {k}")
    report["phases"]["bf16_infer"] = d16
    del tts

    # --- 6./7. serving ------------------------------------------------------------------
    def run_serving(label, bcfg, quantize, n_slots, n_req, budget_lo, budget_hi, seed):
        lay = bcfg.layout
        params = bb.init_params(bcfg, seed=seed, device=dev)
        if quantize:
            params = bb.quantize_params(params)
        scfg = config.SamplingConfig(
            min_new_tokens=budget_hi + 1, max_context=bcfg.max_context).constrained_to(lay)
        eng = Engine(bcfg, params, eos_id=lay.speech_gen_end, n_slots=n_slots, sampling=scfg,
                     segment_steps=32, seed=seed, device=dev)
        del params
        rs = np.random.default_rng(seed)
        prompts = [(lay.speech_base + rs.integers(0, lay.codebook_size, int(n))).tolist()
                   for n in rs.integers(380, 513, n_req)]  # tools/bench_serving.py prompts
        budgets = [int(b) for b in rs.integers(budget_lo, budget_hi + 1, n_req)]
        rids = [eng.submit(pr, max_new=bu) for pr, bu in zip(prompts, budgets)]
        host = {"dispatch_s": 0.0, "collect_s": 0.0, "admit_s": 0.0, "segments": 0}

        def timed(name, fn):
            def wrapper(*a):
                t0 = time.perf_counter()
                out = fn(*a)
                host[name] += time.perf_counter() - t0
                return out
            return wrapper

        eng.step_dispatch = timed("dispatch_s", eng.step_dispatch)
        eng.step_collect = timed("collect_s", eng.step_collect)
        eng._admit = timed("admit_s", eng._admit)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        t0 = time.perf_counter()
        outs = eng.run()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        counts = dict(_build.launches)
        st = dict(eng.stats)
        for rid, bu in zip(rids, budgets):
            toks = outs[rid]
            require(len(toks) == bu, f"{label}: request {rid} returned {len(toks)} of {bu}")
            require(all(lay.speech_base <= t < lay.vocab_size for t in toks),
                    f"{label}: request {rid} left the speech range")
        require(st["useful_tokens"] == sum(budgets),
                f"{label}: useful_tokens {st['useful_tokens']} != {sum(budgets)}")
        n_seg = st["dispatched_token_slots"] // (32 * n_slots)
        disp = st["dispatched_token_slots"]
        info = {
            "n_slots": n_slots, "requests": n_req, "tokens": sum(budgets), "wall_s": wall,
            "tok_s": sum(budgets) / wall, "utt_s": n_req / wall, "segments": n_seg,
            "ms_per_segment": wall * 1e3 / n_seg,
            "host_dispatch_ms_per_segment": (host["dispatch_s"] - host["admit_s"]) * 1e3 / n_seg,
            "collect_ms_per_segment": host["collect_s"] * 1e3 / n_seg,
            "admit_host_ms_total": host["admit_s"] * 1e3,
            "tax": {k: st[k] / disp for k in ("post_done_token_slots", "empty_token_slots",
                                              "post_eos_token_slots")},
            "useful_frac": st["useful_tokens"] / disp, "stats": st,
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
        }
        print(f"[{label}] {n_req} requests, {sum(budgets)} tokens in {wall:.1f} s: "
              f"{info['tok_s']:.1f} tok/s, {info['utt_s']:.2f} utt/s | {n_seg} segments, "
              f"{info['ms_per_segment']:.1f} ms/segment (host dispatch "
              f"{info['host_dispatch_ms_per_segment']:.1f}, collect wait "
              f"{info['collect_ms_per_segment']:.1f}) | admission host "
              f"{info['admit_host_ms_total']:.0f} ms | useful {info['useful_frac']:.3f}, "
              f"tax {info['tax']} | peak {info['peak_mem_gb']:.1f} GB | launches {counts}")
        # the timing wrappers stored on the engine close over its own bound
        # methods: collect the cycle, or its cache and weights stay allocated
        # and inflate the next phase's peak memory
        del eng
        gc.collect()
        torch.cuda.empty_cache()
        return info

    s8 = run_serving("6", config.AIR.scaled(kv_dtype="int8"), True, 128, 320, 150, 250, 2)
    for k in ("decode_attention_staged", "reconcile_segment", "scatter_prefill",
              "prefill_attention", "fused_qkv", "fused_mlp"):
        require(s8["launches"][k] > 0, f"W8A8 serving never launched {k}")
    for k in ("decode_attention_int8", "decode_attention_bf16"):
        require(s8["launches"][k] == 0, f"W8A8 serving launched {k}")
    report["phases"]["w8a8_serving"] = s8
    s16 = run_serving("7", config.AIR, False, 16, 40, 64, 128, 3)
    require(s16["launches"]["decode_attention_bf16"] > 0, "default serving never ran kernel #1")
    require(s16["launches"]["decode_attention_staged"] == 0, "default serving ran staged decode")
    report["phases"]["bf16_serving"] = s16

    # --- 8./9. the int4 cache: kv_dtype="auto" -------------------------------------------
    tts = NeuTTS.initialize_random(config.AIR.scaled(kv_dtype="auto"), config.CODEC, seed=4,
                                   device=dev, quantize="int8", sampling=sampling)
    w4 = run_path("8", tts, 8)
    for k in ("decode_attention_int4", "prefill_attention", "fused_qkv", "fused_mlp"):
        require(w4["launches"][k] > 0, f"W8A8 auto main path never launched {k}")
    for k in ("decode_attention_int8", "decode_attention_bf16"):
        require(w4["launches"][k] == 0, f"W8A8 auto main path launched {k}")
    report["phases"]["w8a8_auto_infer_batch"] = w4
    del tts
    torch.cuda.empty_cache()
    s4 = run_serving("9", config.AIR.scaled(kv_dtype="auto"), True, 128, 320, 150, 250, 5)
    for k in ("decode_attention_staged_int4", "reconcile_segment4", "scatter_prefill4",
              "prefill_attention", "fused_qkv", "fused_mlp"):
        require(s4["launches"][k] > 0, f"W8A8 auto serving never launched {k}")
    for k in ("decode_attention_staged", "reconcile_segment", "scatter_prefill",
              "decode_attention_int4", "decode_attention_int8", "decode_attention_bf16"):
        require(s4["launches"][k] == 0, f"W8A8 auto serving launched {k}")
    report["phases"]["w8a8_auto_serving"] = s4

    # --- report ------------------------------------------------------------------------
    paths = (w8, d16, s8, s16, w4, s4)
    for key, r in results.items():
        r["launches"] = sum(ph["launches"][key] for ph in paths)
    kernels = {"kernels": list(results.values())}
    report["kernel_shapes"] = shapes
    report["total_s"] = time.perf_counter() - t_start
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    (out_dir / "chip_smoke.json").write_text(json.dumps({**report, **kernels}, indent=1))
    print(json.dumps(report))
    print(f"total {report['total_s']:.1f} s")
    print(gpu_line())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
