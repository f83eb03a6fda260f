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
     S 512); NSPLIT of staged decode (#2); the fused QKV (#7) also at the
     admission shape M 32768, the GEMM tiles of #7 and of the fused MLP
     (#6), IMMA in the SASS of each of their GEMMs and no IDP4A anywhere in
     their library, their library yardstick the products alone as
     torch._int_mm calls; the launch geometry of the reconcile (#3); then
     the whole backbone, and a small serving Engine, on the GPU against the
     CPU (plain versions) on a small f32 model, with f32, int8 and int4
     caches;
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
     int4 decode, reconcile4, scatter-prefill4);
 10. voice cloning: NeuTTS.encode_reference with the real NeuCodec encoder
     composition at full width (XCodec2 acoustic stack, w2v-BERT 2.0 tower
     tapped after layer 16, conv SemanticEncoder, fc_prior 2048 -> 2048) on
     samples/demo.wav (2 s) and on a 10 s clip of it tiled five times:
     codes, the card against the CPU on the 2 s clip (largest latent
     difference within 1e-4 of the latent's scale, code frames that differ,
     and the same encode with TF32 allowed, which must exceed that limit),
     ms per encode (mel on the host,
     the codec on the card), peak memory;
 11. streaming: NeuTTS.infer_stream at Air width, bf16 weights and KV, the
     CODEC decoder, watermark on, phase 10's 500 codes as the reference
     (time to first audio split into prefill, first segment and first
     window vocoded with its watermark; ms per chunk against the 500 ms of
     audio it carries; peak memory), then a stream with a 10-frame first
     chunk closed after its third chunk; prefill attention (#5) against its
     plain version at the stream's prefill shape (B 1, its bucket and left
     pad); last in the script, after phase 15 (a profiling session slows
     the process's later launches), one steady chunk (a 25-step segment and
     an 82-frame window vocoded and watermarked) under torch.profiler for
     its device busy time and idle share;
 12. LM finetune: train.trainer.train_step at Air width, bf16 weights, a
     B 2 x S 2048 batch from train.data.batches over synthetic records
     (ByteTokenizer, RuleG2P), 4 steps without remat and the same 4 from the
     same start with remat (loss, grad norm, ms per step, tokens/s, peak
     memory; no kernel launched; the remat losses and grad norms within
     1e-4 and 1e-3 relative of the others); kernel #5 refusing inputs that require grad; the loss and
     global grad norm of a 2-layer f32 Air on the card against the CPU;
 13. codec reconstruction: train.codec_trainer at full CODEC width, B 2 x
     2 s of seeded sines, 3 steps (loss, ms per step, peak memory);
 14. the data-parallel LM step over NCCL at world size 1 (an explicit
     localhost address): loss and parameters equal to train_step's;
 15. MultiChipEngine over every visible card, W8A8 + int8 KV, 32 slots, 48
     requests: each replica's tokens equal to those of a lone Engine with
     its seed on its card, fed the requests routed to it; tokens/s, and the
     launches of #2-#7;
 16. load published formats at full Air width: seeded bf16 weights
     written as an HF directory (BF16 model.safetensors + config.json) and
     as GGUF Q8_0 and Q4_0 files with full-vocabulary tokenizer metadata;
     the HF directory through `python -m neutts_tpu_torch.models.convert_cli`,
     its checkpoint through load_pipeline into NeuTTS(quantize="int8",
     int8 KV): W8A8 infer_batch over phase 4's prompts (decode capped by
     max_context 512) giving the tokens of the same weights held in memory,
     with #1 int8, #5, #6 and #7 launched; the Q8_0 file through
     convert.from_gguf onto the card, every weight within half its block's
     Q8_0 step of the original, then W8A8 infer_batch; the Q4_0 file in
     bf16 and one infer through the GGUF's own tokenizer (#1 bf16 and #5
     launched), whose ids equal the layout's and whose prompt equals
     ByteLevelBPE.from_gguf_metadata's. File sizes, write, convert and load
     seconds, peak host RSS and device memory;
 17. tensor parallelism on the one card: this script started twice more
     (`--tp-rank`), a world of 2 over gloo with CUDA tensors (NCCL refuses
     two ranks on one device), Air at full width in f32 at tp 2 (each rank
     7 query heads over one KV head), greedy generate over phase 4's
     prompts for 32 tokens equal to a tp 1 run on the card (a flipped token
     prints its step and the tp 1 logit margin, and fails), each rank's
     launches of #1 and #5 in their f32 modes, and one train step of a
     2-layer Air, B 2 x S 512, whose loss is within 1e-4 of tp 1's. Run
     before phase 11's profiled chunk, which stays last;
 18. LFM2-8B-A1B (`config.LFM2_8B_A1B`: 18 conv and 6 attention layers, 32
     experts of 1,792, top 4) at its published widths: the grouped expert
     kernel (`csrc/moe.cu`, built alone) against its plain version at the
     serving decode shape (256 tokens x top 4) and an admission's (64 x 512
     x top 4), its ptxas report, ms (events around back-to-back calls) and
     device ms (as phase 3's; not with --lfm2) beside its bound and the
     plain version's ms, both shapes as rows of the `kernels` line; then the
     Engine serving the benchmark's configuration
     (`benchmark/configs/lfm2-8b-a1b-bf16-int8kv.json`, its seeded weights
     from `benchmark/harness/lfm2.py`) in bf16 with an int8 KV cache, 128
     slots, 192 requests of 380-512 prompt tokens (speech-constrained
     greedy): every request served its budget in the speech codes, the
     segments replayed from their CUDA graph, the expert kernel's launches
     in `_build.launches` (counted in the `kernels` line), tokens/s, the
     expert load, peak memory, and the token gap of four served requests
     against the plain reference (`benchmark/reference/lfm2.py`), which must
     be within the configuration's `limits.token_gap`. `python3
     chip_smoke.py --lfm2` runs phases 1 and 18 alone.
Each main path runs with the launch counts set to 0 just before it and read
just after. Before the last two lines: the report, the nvidia-smi card line
and the JSON object {"kernels": [...]}; the last line is {"ok": true,
"device": {...}}. The report also goes to chiprun_out/chip_smoke.json.
It exits non-zero without a result when no CUDA device is present or when
run without the rest of the repository.
"""

from __future__ import annotations

import dataclasses
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
PHASE4_TEXTS = [
    "Hello there, this is a test of the port.",
    "The quick brown fox jumps over the lazy dog.",
    "Short one.",
    "Synthesis on the graphics card, one batch of eight.",
    "Every kernel on this path was written by hand.",
    "Random weights still make codes to vocode.",
    "How fast does it decode?",
    "A last sentence, for the eighth row of the batch.",
]


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


def q8_0_error_ratio(orig, loaded) -> float:
    """Largest |loaded - orig| over its bound, blocks of 32 along the last
    axis (the GGUF row): half the block's Q8_0 step d = f16(amax / 127)
    (x (1 + 2^-10) for the f32 division that picks q), plus the bf16 load's
    rounding of q * d (2^-8 |loaded|). At most 1 when every weight is within
    half a step; that holds while d stays a normal f16 (block absmax >=
    7.8e-3, as for every block of these weights), else the subnormal scale's
    rounding can push q past 127."""
    import torch

    x = orig.float().reshape(-1, 32)
    y = loaded.float().reshape(-1, 32)
    d = (x.abs().amax(dim=1, keepdim=True) / 127.0).half().float()
    bound = 0.5 * d * (1 + 2**-10) + 2**-8 * y.abs()
    err = (y - x).abs()
    over = torch.where(bound > 0, err / bound.clamp_min(1e-30),
                       torch.where(err > 0, float("inf"), 0.0))
    return float(over.max())


def rss_now_gb(pid) -> float | None:
    """A process's resident set now (VmRSS) in GB; None where /proc does not
    give it."""
    try:
        for line in Path(f"/proc/{pid}/status").read_text().splitlines():
            if line.startswith("VmRSS:"):
                return int(line.split()[1]) * 1024 / 1e9
    except OSError:
        pass
    return None


def run_watching_rss(cmd, tmp: Path) -> tuple:
    """Run `cmd` to its end -> (return code, output tail, its largest RSS in
    GB, sampled from /proc every 20 ms, or None). Not getrusage: its maxrss
    carries this process's peak into a child it spawns (vfork + exec)."""
    log = tmp / "cmd.log"
    with open(log, "w") as out:
        proc = subprocess.Popen(cmd, cwd=ROOT, stdout=out, stderr=subprocess.STDOUT)
        peak = None
        while proc.poll() is None:
            now = rss_now_gb(proc.pid)
            if now is not None:
                peak = max(peak or 0.0, now)
            time.sleep(0.02)
    return proc.returncode, log.read_text()[-4000:], peak


TP_SEED, TP_STEPS = 17, 32  # phase 17: the weights' seed, greedy steps


def tp_workload(dev):
    """Phase 17's inputs, made alike by the parent and each rank: Air at
    full width in f32, phase 4's eight prompts, greedy over the full vocab
    for TP_STEPS tokens; a 2-layer Air and phase 14's B 2 x S 512 batch for
    the train step."""
    import numpy as np
    import torch

    from neutts_tpu_torch import config
    from neutts_tpu_torch.runtime import decode as dec
    from neutts_tpu_torch.text import prompt as prompt_lib
    from neutts_tpu_torch.text.g2p import get_g2p
    from neutts_tpu_torch.text.tokenizer import ByteTokenizer
    from neutts_tpu_torch.tools.profile_train import finetune_batch

    cfg = config.AIR.scaled(dtype="float32")
    tok = ByteTokenizer(cfg.layout)
    codes = np.load(ROOT / "samples" / "demo_codes.npy").astype(np.int32)
    ref_text = (ROOT / "samples" / "demo.txt").read_text().strip()
    g2p = get_g2p()
    prompts = [prompt_lib.build_prompt_ids(tok, g2p, codes[: len(codes) - 6 * i].tolist(),
                                           ref_text, t) for i, t in enumerate(PHASE4_TEXTS)]
    toks, lens = dec.pad_prompts(prompts, pad_id=tok.pad_id,
                                 bucket=dec.bucket_length(max(map(len, prompts))), device=dev)
    lm = finetune_batch(cfg.layout)
    batch = [torch.from_numpy(lm[k][:, :512]).to(dev) for k in ("tokens", "labels", "attn_mask")]
    sampling = config.SamplingConfig(greedy=True, min_new_tokens=TP_STEPS)
    return cfg, cfg.scaled(n_layers=2), toks, lens, sampling, batch


def tp_run(dev, mesh=None) -> dict:
    """Phase 17's work on one rank (mesh: the tp 2 Mesh) or at tp 1 (None):
    greedy generate with the launch counts and seconds, then one train step
    of the 2-layer model."""
    import torch

    from neutts_tpu_torch.models import backbone as bb
    from neutts_tpu_torch.ops import _build
    from neutts_tpu_torch.parallel import mesh as meshlib
    from neutts_tpu_torch.runtime import decode as dec
    from neutts_tpu_torch.train import trainer as tr

    cfg, cfg2, toks, lens, sampling, batch = tp_workload(dev)

    def place(params, c):
        return params if mesh is None else meshlib.shard_params(params, mesh, c)

    params = place(bb.init_params(cfg, seed=TP_SEED, device=dev), cfg)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    res = dec.generate(cfg, sampling, cfg.layout.speech_gen_end, TP_STEPS, params, toks, lens,
                       tp=mesh)
    torch.cuda.synchronize()
    out = {"wall_s": time.perf_counter() - t0, "prefill_s": res.prefill_s,
           "decode_s": res.decode_s, "steps": res.steps, "launches": dict(_build.launches),
           "tokens": res.tokens.tolist(), "bucket": toks.shape[1],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
    del params
    tc = tr.TrainConfig(max_steps=40)
    p2 = place(bb.init_params(cfg2, seed=TP_SEED, device=dev), cfg2)
    state = tr.TrainState(p2, tr.make_optimizer(tc).init(p2), 0)
    step = (tr.make_sharded_train_step(cfg2, tc, mesh) if mesh is not None
            else lambda s, *b: tr.train_step(cfg2, tc, s, *b))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, m = step(state, *batch)
    out["train"] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                    "ms": (time.perf_counter() - t0) * 1e3}
    return out


def tp_rank_main(argv) -> int:
    """One rank of phase 17: `chip_smoke.py --tp-rank RANK PORT OUT_JSON`.
    Joins a world of 2 over gloo with CUDA tensors on the one card (NCCL
    refuses two ranks on one device), runs `tp_run` at tp 2 and writes its
    result to OUT_JSON."""
    import torch
    import torch.distributed as dist

    sys.path.insert(0, str(ROOT))
    from neutts_tpu_torch.parallel import distributed as dist_lib

    rank, port, out = int(argv[0]), argv[1], Path(argv[2])
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                            rank=rank)
    try:
        mesh = dist_lib.global_mesh(tp=2, device=dev)
        require(mesh.shape == {"data": 1, "model": 2} and mesh.tp_rank == rank, f"mesh {mesh}")
        out.write_text(json.dumps(tp_run(dev, mesh)))
    finally:
        dist.destroy_process_group()
    return 0


def tp_logit_margin(dev, cfg, params, prompt, tokens_row, step) -> float:
    """Top-1 minus top-2 logit at greedy step `step` of one row at tp 1: its
    prompt and the tokens before `step`, prefilled."""
    import torch

    from neutts_tpu_torch.models import backbone as bb

    seq = prompt + tokens_row[:step]
    toks = torch.tensor([seq], dtype=torch.int32, device=dev)
    lens = torch.tensor([len(seq)], dtype=torch.int32, device=dev)
    cache = bb.KVCache.create(cfg, 1, max_len=len(seq) + 1, device=dev)
    logits = bb.prefill(cfg, params, toks, lens, cache)[0][0]
    top = torch.topk(logits.float(), 2).values
    return float(top[0] - top[1])


def phase_tensor_parallel(dev) -> dict:
    """Phase 17 (the module docstring)."""
    import socket

    import torch

    from neutts_tpu_torch.models import backbone as bb

    one = tp_run(dev)
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    out_dir = ROOT / "chiprun_out"
    outs = [out_dir / f"tp_rank{r}.json" for r in range(2)]
    for o in outs:
        o.unlink(missing_ok=True)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, str(Path(__file__).resolve()), "--tp-rank", str(r),
                               str(port), str(outs[r])], cwd=ROOT) for r in range(2)]
    try:
        codes = [p.wait(timeout=600) for p in procs]
    finally:
        for p in procs:
            p.kill()
            p.wait()
    wall = time.perf_counter() - t0
    require(codes == [0, 0], f"tensor-parallel ranks exited {codes}")
    ranks = [json.loads(o.read_text()) for o in outs]
    cfg, _, toks, lens, _, _ = tp_workload(dev)
    for r, run in enumerate(ranks):
        if run["tokens"] != one["tokens"]:
            row, step = next((b, t) for b, (x, y) in enumerate(zip(run["tokens"], one["tokens"]))
                             for t in range(len(x)) if x[t] != y[t])
            prompt = toks[row, toks.shape[1] - int(lens[row]):].tolist()
            margin = tp_logit_margin(dev, cfg, bb.init_params(cfg, seed=TP_SEED, device=dev),
                                     prompt, one["tokens"][row], step)
            print(f"[17] rank {r}: row {row} flips at step {step}: tp 2 {run['tokens'][row][step]}"
                  f" vs tp 1 {one['tokens'][row][step]}, tp 1 logit margin {margin:.4e}")
            require(False, "tensor-parallel greedy tokens differ from tp 1's")
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    info = {"tp1": one, "ranks": ranks, "wall_s_ranks": wall, "launches": launches}
    for r, run in enumerate(ranks):
        print(f"[17] rank {r} of tp 2 (gloo, CUDA tensors, one card): Air f32, 8 x bucket "
              f"{run['bucket']}, {TP_STEPS} greedy tokens equal tp 1's | prefill "
              f"{run['prefill_s'] * 1e3:.1f} ms, decode {run['decode_s'] * 1e3:.1f} ms "
              f"(tp 1: {one['prefill_s'] * 1e3:.1f}, {one['decode_s'] * 1e3:.1f}) | #1 f32 "
              f"(decode_attention_bf16, float caches) {run['launches']['decode_attention_bf16']}"
              f", #5 f32 {run['launches']['prefill_attention']} launches | peak "
              f"{run['peak_mem_gb']:.1f} GB (tp 1 {one['peak_mem_gb']:.1f})")
        require(run["launches"]["decode_attention_bf16"] > 0 and
                run["launches"]["prefill_attention"] > 0, f"rank {r} never launched #1 or #5")
        lt, l1 = run["train"]["loss"], one["train"]["loss"]
        print(f"[17] rank {r} train step, 2-layer Air f32 B 2 x S 512: loss {lt:.6f} vs tp 1 "
              f"{l1:.6f}, grad norm {run['train']['grad_norm']:.6f} vs "
              f"{one['train']['grad_norm']:.6f}, {run['train']['ms']:.1f} ms "
              f"(tp 1 {one['train']['ms']:.1f})")
        require(abs(lt - l1) <= 1e-4 * abs(l1), "tensor-parallel loss beyond 1e-4 of tp 1's")
    return info


def phase_converters(dev, run_path, texts, refs, ref_text) -> tuple:
    """Phase 16 (the module docstring): -> (report entry, the run_path
    results of the three converted paths)."""
    import resource
    import shutil
    import tempfile
    import types

    import numpy as np
    import torch

    from neutts_tpu_torch import NeuTTS, config
    from neutts_tpu_torch.models import backbone as bb
    from neutts_tpu_torch.models import checkpoint as ckpt
    from neutts_tpu_torch.models import codec as cd
    from neutts_tpu_torch.models import convert
    from neutts_tpu_torch.text import prompt as prompt_lib
    from neutts_tpu_torch.text.bpe import ByteLevelBPE
    from neutts_tpu_torch.text.tokenizer import HFTokenizer

    air, max_ctx = config.AIR, 512
    layout = air.layout
    sampling = config.SamplingConfig(max_context=max_ctx).constrained_to(layout)
    run_cfg = dict(kv_dtype="int8", max_context=max_ctx)
    maxrss_gb = lambda: resource.getrusage(resource.RUSAGE_SELF).ru_maxrss / 1e6  # noqa: E731
    info: dict = {"max_context": max_ctx, "files": {}, "rss_process_peak_before_gb": maxrss_gb()}
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_formats_"))
    try:
        # --- the original weights, and the three files ---------------------------
        t0 = time.perf_counter()
        params = bb.init_params(air, seed=16, device="cpu")
        params["embed"][air.vocab_size:] = 0  # from_hf / from_gguf re-pad with zeros
        gen = torch.Generator().manual_seed(16)
        for b in ("bq", "bk", "bv"):
            b_ = params["layers"][b]
            b_.copy_(0.02 * torch.randn(b_.shape, generator=gen))
        codec_params = cd.init_params(config.CODEC, seed=0, device="cpu")  # convert_cli's codec
        info["init_s"] = time.perf_counter() - t0
        hf_dir = tmp / "hf"
        t0 = time.perf_counter()
        convert.write_hf_dir(hf_dir, air, params)
        info["files"]["hf_bf16"] = {"bytes": (hf_dir / "model.safetensors").stat().st_size,
                                    "write_s": time.perf_counter() - t0}
        meta = convert.gguf_metadata(air)
        gg = {k: v.float().contiguous().numpy() for k, v in
              convert.hf_to_gguf_tensors(air, convert.to_hf_tensors(air, params)).items()}
        for qt in ("Q8_0", "Q4_0"):
            t0 = time.perf_counter()
            convert.write_gguf(tmp / f"air-{qt}.gguf", meta, gg,
                               quant={k: qt for k, v in gg.items() if v.ndim == 2})
            info["files"][qt] = {"bytes": (tmp / f"air-{qt}.gguf").stat().st_size,
                                 "write_s": time.perf_counter() - t0}
        del gg
        gc.collect()
        for k, f in info["files"].items():
            print(f"[16] wrote {k}: {f['bytes'] / 1e9:.3f} GB in {f['write_s']:.1f} s")

        # --- HF BF16 -> convert_cli -> load_pipeline, W8A8 --------------------------
        ckpt_dir = tmp / "ckpt"
        t0 = time.perf_counter()
        rc, out, cli_rss = run_watching_rss([sys.executable, "-m",
                                             "neutts_tpu_torch.models.convert_cli",
                                             "--hf", str(hf_dir), "--out", str(ckpt_dir)], tmp)
        require(rc == 0, f"convert_cli failed: {out}")
        info["files"]["hf_bf16"]["convert_s"] = time.perf_counter() - t0
        info["rss_convert_cli_gb"] = cli_rss
        info["checkpoint_bytes"] = sum(f.stat().st_size for f in ckpt_dir.iterdir())
        # device peak of the phase: each run_path resets the counter, so the
        # peak since the last reset is read before each run and at the end
        peaks = []
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        bcfg, bparams, ccfg, cparams = ckpt.load_pipeline(ckpt_dir, dev)
        tts = NeuTTS(bcfg.scaled(**run_cfg), bparams, ccfg, cparams, device=dev,
                     quantize="int8", sampling=sampling)
        del bparams, cparams
        torch.cuda.synchronize()
        info["files"]["hf_bf16"]["load_s"] = time.perf_counter() - t0
        require(dataclasses.replace(tts.backbone_cfg, name=air.name) == air.scaled(**run_cfg),
                f"converted config {tts.backbone_cfg} is not Air's")
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        hf_run = run_path("16 hf", tts, 8)
        for k in ("decode_attention_int8", "prefill_attention", "fused_qkv", "fused_mlp"):
            require(hf_run["launches"][k] > 0, f"converted W8A8 path never launched {k}")
        converted_codes = tts.last_stats["codes"]
        del tts
        torch.cuda.empty_cache()
        base = NeuTTS(air.scaled(**run_cfg), params, config.CODEC, codec_params, device=dev,
                      quantize="int8", sampling=sampling)
        run_path("16 in-memory", base, 8)
        same = base.last_stats["codes"] == converted_codes
        print(f"[16] HF BF16 -> convert_cli -> load_pipeline: tokens equal to the in-memory "
              f"weights' {same} ({sum(map(len, converted_codes))} codes)")
        require(same, "tokens of the converted HF checkpoint differ from the in-memory weights'")
        del base
        torch.cuda.empty_cache()

        # --- GGUF Q8_0 onto the card: within half a step, then W8A8 --------------
        t0 = time.perf_counter()
        qcfg, qparams = convert.from_gguf(tmp / "air-Q8_0.gguf", device=dev)
        torch.cuda.synchronize()
        info["files"]["Q8_0"]["load_s"] = time.perf_counter() - t0
        # GGUF stores rms_norm_eps as f32 (9.99999997e-07 for 1e-6)
        require(dataclasses.replace(qcfg, name=air.name, rms_norm_eps=air.rms_norm_eps) == air
                and abs(qcfg.rms_norm_eps - air.rms_norm_eps) <= 1e-6 * 2**-23,
                f"Q8_0 config {qcfg}")
        V = air.vocab_size
        worst = q8_0_error_ratio(params["embed"][:V].to(dev), qparams["embed"][:V])
        for k, w in params["layers"].items():
            if w.ndim == 3:  # the projections [L, in, out]; GGUF rows are [out, in]
                worst = max(worst, q8_0_error_ratio(w.to(dev).mT, qparams["layers"][k].mT))
        require(not bool(qparams["embed"][V:].any()), "Q8_0 embedding pad rows not zero")
        info["q8_0_worst_error_over_bound"] = worst
        print(f"[16] Q8_0: worst |w - w0| over its bound (half a step + bf16 rounding): "
              f"{worst:.4f} (must be <= 1)")
        require(worst <= 1.0, f"a Q8_0 weight lies {worst:.3f}x beyond half a step")
        tts = NeuTTS(qcfg.scaled(**run_cfg), qparams, config.CODEC, codec_params, device=dev,
                     quantize="int8", sampling=sampling)
        del qparams
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        q8_run = run_path("16 q8_0", tts, 8)
        for k in ("decode_attention_int8", "prefill_attention", "fused_qkv", "fused_mlp"):
            require(q8_run["launches"][k] > 0, f"Q8_0 W8A8 path never launched {k}")
        del tts
        torch.cuda.empty_cache()

        # --- GGUF Q4_0 in bf16 and its own tokenizer: one infer -------------------
        t0 = time.perf_counter()
        q4cfg, q4params = convert.from_gguf(tmp / "air-Q4_0.gguf", device=dev)
        torch.cuda.synchronize()
        info["files"]["Q4_0"]["load_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tok = HFTokenizer(str(tmp / "air-Q4_0.gguf"))
        info["files"]["Q4_0"]["tokenizer_s"] = time.perf_counter() - t0
        require(tok.layout == layout, f"GGUF tokenizer layout {tok.layout} != {layout}")
        ids = {"<|speech_0|>": layout.speech_base, "<|speech_65535|>": layout.vocab_size - 1}
        ids.update({n: layout.n_text_tokens + i
                    for i, n in enumerate(config.SPECIAL_TOKEN_NAMES)})
        for name, want in ids.items():
            require(tok.convert_token_to_id(name) == want, f"GGUF tokenizer id of {name}")
        bpe = ByteLevelBPE.from_gguf_metadata(meta)
        plain = types.SimpleNamespace(layout=layout, encode=bpe.encode,
                                      convert_token_to_id=bpe.convert_token_to_id)
        tts = NeuTTS(q4cfg.scaled(max_context=max_ctx), q4params, config.CODEC, codec_params,
                     device=dev, tokenizer=tok, sampling=sampling)
        del q4params
        p_tok = prompt_lib.build_prompt_ids(tok, tts.g2p, refs[0], ref_text, texts[0])
        p_ref = prompt_lib.build_prompt_ids(plain, tts.g2p, refs[0], ref_text, texts[0])
        require(p_tok == p_ref, "the GGUF tokenizer's prompt differs from from_gguf_metadata's")
        peaks.append(torch.cuda.max_memory_allocated() / 1e9)
        q4_run = run_path("16 q4_0", tts, 1)
        for k in ("decode_attention_bf16", "prefill_attention"):
            require(q4_run["launches"][k] > 0, f"Q4_0 bf16 path never launched {k}")
        print(f"[16] Q4_0 GGUF tokenizer: layout and special ids equal Air's, a {len(p_tok)}-id "
              f"prompt equal to from_gguf_metadata's")
        del tts
        info["peak_device_gb"] = max(peaks + [r["peak_mem_gb"] for r in (hf_run, q8_run, q4_run)]
                                     + [torch.cuda.max_memory_allocated() / 1e9])
        info["rss_process_peak_after_gb"] = maxrss_gb()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    for k, f in info["files"].items():
        print(f"[16] {k}: " + ", ".join(f"{a} {v / 1e9:.3f} GB" if a == "bytes" else
                                         f"{a} {v:.1f}" for a, v in f.items()))
    cli = info["rss_convert_cli_gb"]
    print(f"[16] host RSS peak of the process (getrusage): {info['rss_process_peak_before_gb']:.1f}"
          f" GB before the phase, {info['rss_process_peak_after_gb']:.1f} GB after; convert_cli's "
          f"largest sampled RSS {'not measured' if cli is None else f'{cli:.1f} GB'}; device "
          f"peak over the phase's loads and runs "
          f"{info['peak_device_gb']:.1f} GB")
    gc.collect()
    torch.cuda.empty_cache()
    return info, (hf_run, q8_run, q4_run)


def phase_lfm2(dev, device_ms=None) -> dict:
    """[18] LFM2-8B-A1B at its published widths: the expert kernel, then the
    Engine serving the model (see the module's docstring). `kernel_rows`
    holds the kernel's rows of the `kernels` line; `device_ms` is phase 3's
    timer (None: no device ms)."""
    import numpy as np
    import torch

    from benchmark.harness import lfm2 as bench_lfm2
    from neutts_tpu_torch import config
    from neutts_tpu_torch.ops import _build
    from neutts_tpu_torch.ops import moe as moe_ops
    from neutts_tpu_torch.serving import Engine
    from neutts_tpu_torch.utils import TRACER

    out: dict = {"kernel_rows": {}}
    t0 = time.perf_counter()
    _build.library("moe.cu")
    out["build_s"] = time.perf_counter() - t0
    for line in (_build.BUILD_DIR / "moe.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print(f"[18] ptxas moe.cu: {line.strip()}")
    cfg = config.LFM2_8B_A1B.scaled(kv_dtype="int8")
    E, k, D, Fe = cfg.n_experts, cfg.n_experts_per_tok, cfg.hidden_size, cfg.moe_intermediate_size
    g = torch.Generator(device=dev).manual_seed(18)
    wg, wu = (torch.randn((E, D, Fe), generator=g, device=dev).mul_(D ** -0.5).bfloat16()
              for _ in range(2))
    wd = torch.randn((E, Fe, D), generator=g, device=dev).mul_(Fe ** -0.5).bfloat16()
    for label, key, T in (("decode 256 x 4", "moe_experts", 256),
                          ("admission 64 x 512 x 4", "moe_experts@admission", 64 * 512)):
        x = torch.randn((T, D), generator=g, device=dev).bfloat16()
        idx = torch.topk(torch.randn((T, E), generator=g, device=dev), k, dim=-1).indices
        perm, offsets, counts = moe_ops.sort_pairs(idx, E)
        y = moe_ops.grouped_swiglu(x, perm, offsets, wg, wu, wd, k)
        want = moe_ops.grouped_swiglu_plain(x, perm, offsets, wg, wu, wd, k)
        torch.cuda.synchronize()
        err = (y - want).abs().max().item()
        tol = 1e-2 * want.abs().max().item()
        n = 20 if T == 256 else 5
        times = {}
        for name, fn in (("kernel", moe_ops.grouped_swiglu), ("plain", moe_ops.grouped_swiglu_plain)):
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            fn(x, perm, offsets, wg, wu, wd, k)
            ev[0].record()
            for _ in range(n):
                fn(x, perm, offsets, wg, wu, wd, k)
            ev[1].record()
            torch.cuda.synchronize()
            times[name] = ev[0].elapsed_time(ev[1]) / n
        dms = ((None, None) if device_ms is None else
               device_ms(lambda i: moe_ops.grouped_swiglu(x, perm, offsets, wg, wu, wd, k), n))
        touched = int((counts > 0).sum())
        nbytes = touched * 3 * D * Fe * 2 + T * k * 6 * D
        flops = 2 * 3 * D * Fe * T * k
        b_ms, by = bound(nbytes, flops, PEAK_BF16)
        dev_txt = ("" if dms[0] is None else
                   f" | device {dms[0]:.4f} warm L2, {dms[1]:.4f} L2 flushed")
        print(f"[18] moe_experts {label}: max_abs_err {err:.3e} (tol {tol:.3e}) | ms "
              f"{times['kernel']:.4f}{dev_txt} | bound {b_ms:.4f} ({by}, "
              f"{100 * b_ms / times['kernel']:.1f}% of it) | plain ms {times['plain']:.3f} | rows "
              f"per expert {int(counts.min())}-{int(counts.max())}")
        require(err <= tol and bool(torch.isfinite(y).all()), f"moe_experts {label}: error {err}")
        out[label] = {"max_abs_err": err, "tol": tol, "ms": times["kernel"],
                      "plain_ms": times["plain"], "bound_ms": b_ms, "bound_by": by}
        # no pallas_call site stands behind it (the JAX package has no expert layer)
        out["kernel_rows"][key] = {
            "name": key, "route": "cuda", "source": "csrc/moe.cu", "replaces": None,
            "launches": 0, "max_abs_err": err, "tol": tol, "ms": times["kernel"],
            "plain_ms": times["plain"], "bound_ms": b_ms, "bound_by": by, "library_ms": None,
            "device_warm_ms": dms[0], "device_ms": dms[1]}
        del x, y, want
    del wg, wu, wd
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.reset_peak_memory_stats(dev)
    # the benchmark's configuration and seeded weights, so that its limit holds
    c = json.loads((ROOT / "benchmark/configs/lfm2-8b-a1b-bf16-int8kv.json").read_text())
    cfg, m = bench_lfm2.backbone_config(c), bench_lfm2.sizes(c)
    lay = cfg.layout
    params = bench_lfm2.params(m, 18, dev)
    scfg = config.SamplingConfig(greedy=True, min_new_tokens=129,
                                 max_context=cfg.max_context).constrained_to(lay)
    rs = np.random.default_rng(18)
    prompts = [(lay.speech_base + rs.integers(0, lay.codebook_size, int(n))).tolist()
               for n in rs.integers(380, 513, 192)]
    budgets = [int(b) for b in rs.integers(64, 129, 192)]
    eng = Engine(cfg, params, eos_id=lay.speech_gen_end, n_slots=128, sampling=scfg,
                 segment_steps=32, device=dev)
    warm = eng.submit(prompts[0], max_new=40)
    eng.run()
    _build.reset_launches()
    eng.reset_stats()
    rids = [eng.submit(p, max_new=b) for p, b in zip(prompts, budgets)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with TRACER.on() as records:
        res = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    names = [r.name for r in records]
    launches = dict(_build.launches)
    ok = all(len(res[r]) == b and all(lay.speech_base <= t < lay.vocab_size for t in res[r])
             for r, b in zip(rids, budgets))
    out["serving"] = {"slots": 128, "requests": 192, "tokens": sum(budgets), "wall_s": wall,
                      "tok_s": sum(budgets) / wall, "launches": launches,
                      "replays": names.count("decode.replay"),
                      "segments": names.count("batching.decode_steps"),
                      "expert_load_peak": eng.stats.get("expert_load_peak"),
                      "memory_peak_gb": torch.cuda.max_memory_allocated(dev) / 1e9}
    sv = out["serving"]
    print(f"[18] Engine LFM2-8B-A1B bf16, int8 KV, 128 slots: {sv['requests']} requests, "
          f"{sv['tokens']} tokens in {wall:.1f} s, {sv['tok_s']:.1f} tok/s | all served in the "
          f"speech codes: {ok} | {sv['replays']} of {sv['segments']} segments replayed | "
          f"moe_experts launches {launches['moe_experts']} | expert load peak "
          f"{sv['expert_load_peak']:.1f}% | memory peak {sv['memory_peak_gb']:.2f} GB")
    require(ok, "LFM2 serving: a request missed its budget or left the speech codes")
    require(sv["replays"] == sv["segments"] > 0, "LFM2 serving: a segment did not replay")
    require(launches["moe_experts"] > 0 and launches["prefill_attention"] > 0
            and launches["decode_attention_staged"] > 0, "LFM2 serving: a kernel never ran")
    del eng, warm
    gc.collect()
    torch.cuda.empty_cache()
    from benchmark.reference.lfm2 import token_gaps

    gaps = token_gaps(m, params, [(prompts[i], res[rids[i]]) for i in range(4)],
                      {"weights_mode": "bf16", "act": None, "kv": "int8"}, lay.speech_base,
                      lay.vocab_size)
    out["token_gap"] = gaps
    limit = c["limits"]["token_gap"]
    print(f"[18] token gap of 4 served requests against benchmark/reference/lfm2.py: "
          f"{gaps['token_gap']:.4f} over {gaps['tokens']} tokens (limit {limit})")
    require(gaps["token_gap"] <= limit, f"LFM2 serving: token gap {gaps['token_gap']} over the "
            f"configuration's limit {limit}")
    del params
    gc.collect()
    torch.cuda.empty_cache()
    return out


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT))
    import numpy as np

    from neutts_tpu_torch import NeuTTS, config
    from neutts_tpu_torch.models import backbone as bb
    from neutts_tpu_torch.models.checkpoint import tree_leaves, tree_to
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

    if sys.argv[1:2] == ["--lfm2"]:
        lf = report["phases"]["lfm2"] = phase_lfm2(dev)
        rows = lf.pop("kernel_rows")
        for r in rows.values():
            r["launches"] = lf["serving"]["launches"]["moe_experts"]
        report["kernels"] = list(rows.values())
        (out_dir := ROOT / "chiprun_out").mkdir(exist_ok=True)
        (out_dir / "chip_smoke_lfm2.json").write_text(json.dumps(report, indent=1, default=float))
        print(json.dumps({"kernels": report["kernels"]}))
        print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                                 "count": torch.cuda.device_count()}}))
        return 0

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
               source, *, dev_ms, into=results, phase="3"):
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
        print(f"[{phase}] {key}: max_abs_err {err:.3e} (tol {tol:.3e}{note}) | ms {ms:.4f} | device "
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
    def prefill_shape(key, Bx, S, pads_x, into, phase="3"):
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
               "neutts_tpu_torch/csrc/prefill_attention.cu", into=into, dev_ms=dms, phase=phase)

    tile = attn.prefill_tile(G, D, torch.bfloat16)
    print(f"[3] prefill_attention bf16 tile: {tile['query_positions']} query positions x "
          f"{tile['heads']} heads per block, 64-key K/V tiles, {tile['threads']} threads, "
          f"{tile['smem_bytes']} B shared")
    report["prefill_tile"] = tile
    prefill_shape("prefill_attention", B, 512, [0, 3, 100, 255, 511, 64, 17, 200], results)
    prefill_shape("prefill_attention@B64_S512", 64, 512,
                  np.random.default_rng(4).integers(0, 133, 64).tolist(), shapes)
    torch.cuda.empty_cache()

    # W8A8 projections at M = 4096 prompt tokens (B = 8 x a 512 bucket); the
    # fused QKV (#7) also at the admission shape M = 32768 (64 rows x 512).
    # Weights K-major, as backbone.quantize_params stores them.
    M, Dm, Fm, N = 4096, cfg.hidden_size, cfg.intermediate_size, cfg.q_dim + 2 * cfg.kv_dim
    nw = (1.0 + 0.1 * randn(Dm, dtype=torch.float32)).to(torch.bfloat16)
    wqkv = bb.quantize_weight(randn(Dm, N, dtype=torch.float32, scale=Dm**-0.5))
    wqkv["q"] = bb.k_major(wqkv["q"])
    bias = randn(N, dtype=torch.float32, scale=0.05)
    tiles = mlp_ops.w8a8_tiles()
    print(f"[3] w8a8 int8 tensor-core tiles (mma.sync m16n8k32 s8, {tiles['k_bytes']}-byte k "
          f"steps, {tiles['threads']} threads): fused_qkv {tiles['qkv_cols']} columns x "
          f"{tiles['qkv_rows']} rows, {tiles['qkv_stages']} k steps in flight, below M "
          f"{tiles['qkv_wide_m']}, else {tiles['qkv_wide_rows']} rows, "
          f"{tiles['qkv_wide_stages']} steps; gate/up {tiles['gate_up_rows']} rows x "
          f"{tiles['gate_up_cols']} gate + {tiles['gate_up_cols']} up columns; down "
          f"{tiles['down_rows']} rows x {tiles['down_cols']} columns; the MLP's "
          f"{tiles['mlp_stages']} k steps in flight")
    report["w8a8_tiles"] = tiles

    def qkv_shape(key, Mx, iters):
        """Kernel #7 on bf16 x [Mx, D]; returns x. Library: the product alone,
        one torch._int_mm on the same int8 operands (the K-major weight, the
        layout on which cuBLAS takes its TN tensor-core kernel; quantization
        and epilogue outside the timing)."""
        xx = randn(Mx, Dm, scale=0.5)
        qargs = (xx, nw, wqkv["q"], wqkv["s"], bias)
        got = mlp_ops.fused_qkv(*qargs)
        want = mlp_ops.fused_qkv_plain(*qargs)
        ms = time_ms(lambda i: mlp_ops.fused_qkv(*qargs), iters)
        dms = device_ms(lambda i: mlp_ops.fused_qkv(*qargs), iters)
        plain_ms = time_ms(lambda i: mlp_ops.fused_qkv_plain(*qargs), 3)
        xq8 = mlp_ops.quantize_act(mlp_ops._rms(xx, nw, 1e-6))[0]
        lib_ms = time_ms(lambda i: torch._int_mm(xq8, wqkv["q"]), iters)
        record(key, got, want, 2e-2 * float(want.float().abs().max()), ms, plain_ms, lib_ms,
               Mx * Dm * 2 + Dm * N + 2 * N * 4 + Dm * 2 + Mx * N * 2, 2.0 * Mx * Dm * N,
               PEAK_INT8, "neutts_tpu/ops/mlp.py:234", "neutts_tpu_torch/csrc/w8a8.cu",
               dev_ms=dms)
        results[key]["M"] = Mx
        return xx

    x = qkv_shape("fused_qkv", M, 20)
    qkv_shape("fused_qkv@M32768", 64 * 512, 10)
    torch.cuda.empty_cache()
    wg, wu = (bb.quantize_weight(randn(Dm, Fm, dtype=torch.float32, scale=Dm**-0.5))
              for _ in range(2))
    wd = bb.quantize_weight(randn(Fm, Dm, dtype=torch.float32, scale=Fm**-0.5))
    for w in (wg, wu, wd):
        w["q"] = bb.k_major(w["q"])
    margs = (x, nw, wg["q"], wg["s"], wu["q"], wu["s"], wd["q"], wd["s"])
    got = mlp_ops.fused_mlp(*margs)
    want = mlp_ops.fused_mlp_plain(*margs)
    ms = time_ms(lambda i: mlp_ops.fused_mlp(*margs), 10)
    dms = device_ms(lambda i: mlp_ops.fused_mlp(*margs), 10)
    plain_ms = time_ms(lambda i: mlp_ops.fused_mlp_plain(*margs), 3)
    # library: the three products alone as torch._int_mm on the same operands
    # (the K-major weight views; quantizations and epilogues outside the timing)
    xq8, xs8 = mlp_ops.quantize_act(mlp_ops._rms(x, nw, 1e-6))
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
    del x, wqkv, wg, wu, wd, got, want, xq8, xs8, ffq8

    # every GEMM of the w8a8 library runs on the int8 tensor cores: IMMA in
    # each GEMM entry function (the QKV's two tiles in f32 and bf16, and the
    # MLP's), and no IDP4A in any function of the library
    sass = sass_functions(_build._lib_path("w8a8.cu"))
    dp4a = [f for f, t in sass.items() if any("IDP4A" in ln for ln in t)]
    require(not dp4a, f"IDP4A in the w8a8 library: {dp4a}")
    gemms = {f: t for f, t in sass.items() if "imma_gemm_kernel" in f}
    n_qkv = sum("EpiQKV" in f for f in gemms)
    require(len(gemms) == 7 and n_qkv == 4, f"expected 7 tensor-core GEMM functions in w8a8 "
            f"(4 of the QKV: two tiles, f32 and bf16), got {list(gemms)}")
    for f, t in gemms.items():
        n_imma = sum(" IMMA" in ln for ln in t)
        require(n_imma > 0, f"{f}: no IMMA")
        print(f"[3] sass {f[:60]}: {n_imma} IMMA")
    print(f"[3] sass: no IDP4A in any of the {len(sass)} functions of w8a8")
    report["w8a8_sass_imma"] = {f: sum(" IMMA" in ln for ln in t) for f, t in gemms.items()}
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
    def reconcile_launch(key, int4):
        geo = attn.reconcile_geometry(L, Bs, S, KD, int4)
        print(f"[3] {key} launch: grid {geo['grid']} (rows x groups of "
              f"{geo['layers_per_block']} layers), {geo['value_threads']} value threads with "
              f"{geo['vectors_in_flight']} 16-byte vectors of K and of V each in flight + "
              f"{geo['scale_threads']} scale threads per block")
        report.setdefault("reconcile_geometry", {})[key] = geo

    reconcile_launch("reconcile_segment", False)
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
    reconcile_launch("reconcile_segment4", True)
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

    # bf16 projections and heads give the f32 result of their operands, as
    # JAX's preferred_element_type=f32 does (aten::mm.dtype on the card): Air's
    # head, 64 rows, against the f32 product of the same bf16 values (TF32 is
    # off), and the bf16-rounded product it replaces
    xh, wh = randn(64, cfg.hidden_size), randn(cfg.hidden_size, cfg.padded_vocab, scale=0.02)
    exact = xh.float() @ wh.float()
    err_f32 = float((bb.matmul_f32(xh, wh) - exact).abs().max())
    err_bf16 = float((torch.mm(xh, wh).float() - exact).abs().max())
    scale = float(exact.abs().max())
    print(f"[3] bf16 x bf16 -> f32 (Air head, 64 x {cfg.hidden_size} x {cfg.padded_vocab}): "
          f"max |matmul_f32 - f32 product| {err_f32:.3e} (tol 1e-5 of the largest, "
          f"{scale:.2f}); a bf16-rounded product {err_bf16:.3e}")
    require(err_f32 <= 1e-5 * scale < err_bf16, "bf16 products do not give the f32 result")
    report["bf16_f32_result"] = {"err": err_f32, "err_bf16_rounded": err_bf16, "scale": scale}
    del xh, wh, exact

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
    texts = PHASE4_TEXTS
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

    # --- 10. voice cloning: encode_reference at full width ------------------------------
    from neutts_tpu_torch.audio import io as audio_io
    from neutts_tpu_torch.models import codec as cd

    codec_cfg = config.CODEC.scaled(enc_family="codecenc", codecenc=config.CodecEncConfig(),
                                    semantic=config.SemanticConfig(), sem_encoder="conv")
    tts = NeuTTS.initialize_random(config.AIR, codec_cfg, seed=6, device=dev, sampling=sampling)
    clip2 = ROOT / "samples" / "demo.wav"
    out_dir = ROOT / "chiprun_out"
    out_dir.mkdir(exist_ok=True)
    clip10 = out_dir / "demo_x5.wav"
    wav2 = audio_io.load_for_encoding(clip2, prefer_native=False)
    audio_io.write_wav(clip10, np.tile(wav2, 5), 16_000)
    enc: dict = {}
    for label, clip in (("2s", clip2), ("10s", clip10)):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        runs = []
        for _ in range(3):  # the first call also warms cuDNN and the allocator
            codes10 = tts.encode_reference(clip)
            runs.append(dict(tts.last_stats))
        n = runs[0]["samples"] // 320
        require(codes10.dtype == np.int32 and codes10.shape == (n,),
                f"encode {label}: codes {codes10.dtype} {codes10.shape}, want int32 ({n},)")
        require(bool(((codes10 >= 0) & (codes10 < 65_536)).all()), f"encode {label}: code range")
        warm = runs[1:]
        enc[label] = {
            "samples": runs[0]["samples"], "codes": n,
            "first_call_ms": {k[:-2]: v * 1e3 for k, v in runs[0].items() if k.endswith("_s")},
            "mel_ms": sum(r["mel_s"] for r in warm) * 1e3 / len(warm),
            "device_ms": sum(r["encode_s"] for r in warm) * 1e3 / len(warm),
            "load_ms": sum(r["load_s"] for r in warm) * 1e3 / len(warm),
            "distinct_codes": int(len(np.unique(codes10))),
            "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
        }
        print(f"[10] encode_reference {label} ({runs[0]['samples']} samples): {n} codes "
              f"({enc[label]['distinct_codes']} distinct) | mel {enc[label]['mel_ms']:.1f} ms "
              f"(host) + codec {enc[label]['device_ms']:.1f} ms (card, to the codes on the "
              f"host) + load {enc[label]['load_ms']:.1f} ms | first call "
              f"{enc[label]['first_call_ms']} | peak {enc[label]['peak_mem_gb']:.2f} GB")
    ref_codes500 = codes10
    # the 2 s clip on the card against the CPU (same weights, plain f32 on both)
    from neutts_tpu_torch.audio import mel

    sem2 = torch.as_tensor(mel.semantic_features(np.pad(wav2, (160, 160))))[None]
    p_cpu = tree_to(tts.codec_params, "cpu")
    t0 = time.perf_counter()
    with torch.inference_mode():
        z_cpu = cd.encode_latent(codec_cfg, p_cpu, torch.as_tensor(wav2)[None], sem2)
        z_gpu = cd.encode_latent(codec_cfg, tts.codec_params,
                                 torch.as_tensor(wav2, device=dev)[None], sem2.to(dev)).cpu()
    cpu_s = time.perf_counter() - t0
    del p_cpu
    zdiff = float((z_gpu - z_cpu).abs().max())
    zscale = float(z_cpu.abs().max())
    codes_cpu = cd.digits_to_code(cd.fsq_quantize(cd.fsq_bound(z_cpu, codec_cfg.fsq_levels),
                                                  codec_cfg.fsq_levels), codec_cfg.fsq_levels)
    codes_gpu = tts.encode_reference(clip2)
    flips = np.flatnonzero(codes_cpu[0].numpy() != codes_gpu)
    # distance of each frame's scaled latent (zb * h, rounded to the digit)
    # from the nearest rounding boundary; |d(zb * h)/dz| <= half_l < 2, so a
    # frame flips by rounding only if it lies within 2 * zdiff of one
    h = cd._fsq_consts(codec_cfg.fsq_levels, "cpu")[0]
    zh = cd.fsq_bound(z_cpu, codec_cfg.fsq_levels)[0] * h
    margin = (zh - torch.floor(zh) - 0.5).abs().amin(dim=-1).numpy()
    enc["card_vs_cpu_2s"] = {
        "max_latent_diff": zdiff, "latent_scale": zscale, "frames_differing": int(len(flips)),
        "frames": int(codes_gpu.shape[0]), "flipped_frame_margins": margin[flips].tolist(),
        "smallest_margin": float(margin.min()), "cpu_and_card_s": cpu_s}
    print(f"[10] 2 s clip, card vs CPU: max latent diff {zdiff:.3e} (latent scale {zscale:.2f})"
          f" | {len(flips)} of {codes_gpu.shape[0]} code frames differ (their distance to a "
          f"rounding boundary: {margin[flips].tolist()}; the smallest of any frame "
          f"{float(margin.min()):.2e})")
    # the negative control: the same encode with TF32 allowed in cuBLAS and
    # cuDNN, the fault this limit is there to catch
    zlimit = 1e-4 * max(1.0, zscale)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    with torch.inference_mode():
        z_tf32 = cd.encode_latent(codec_cfg, tts.codec_params,
                                  torch.as_tensor(wav2, device=dev)[None], sem2.to(dev)).cpu()
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    tf32_diff = float((z_tf32 - z_cpu).abs().max())
    enc["card_vs_cpu_2s"].update(limit=zlimit, tf32_max_latent_diff=tf32_diff)
    print(f"[10] limit {zlimit:.3e} (1e-4 of the latent scale); the same encode with TF32 "
          f"allowed: max latent diff {tf32_diff:.3e}")
    require(np.isfinite(zdiff) and zdiff <= zlimit, "the encoder on the card disagrees with the CPU")
    require(tf32_diff > zlimit, "the card-vs-CPU limit does not see TF32 in the encoder")
    require(bool((margin[flips] <= 2 * zdiff).all()),
            "a code frame differs between the card and the CPU away from any rounding boundary")
    report["phases"]["encode_reference"] = enc

    # --- 11. streaming: infer_stream at Air width -----------------------------------------
    text = "Streaming synthesis on the graphics card, one chunk at a time."
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    _build.reset_launches()
    t0 = time.perf_counter()
    chunks = []
    for ch in tts.infer_stream(text, ref_codes500, ref_text):
        require(isinstance(ch, np.ndarray) and ch.dtype == np.float32 and ch.ndim == 1,
                "stream: a chunk is not float32 [n]")
        require(bool(np.isfinite(ch).all()), "stream: non-finite samples")
        chunks.append(ch)
    wall = time.perf_counter() - t0
    counts = dict(_build.launches)
    st = tts.last_stats
    require(len(chunks) >= 2 and st["n_codes"] > 0, f"stream: {len(chunks)} chunks")
    seg_ms = [x * 1e3 for x in st["segment_s"]]
    voc_ms = [x * 1e3 for x in st["chunk_s"]]
    n_first = st["first_audio_segments"]  # 2: the first window needs 25 + 5 new frames
    stream = {
        "bucket": st["bucket"], "n_codes": st["n_codes"], "chunks": len(chunks),
        "samples": int(sum(c.size for c in chunks)), "wall_s": wall,
        "first_audio_ms": st["first_audio_s"] * 1e3, "prompt_ms": st["prompt_s"] * 1e3,
        "prefill_ms": st["prefill_s"] * 1e3, "first_audio_segments": n_first,
        "first_audio_decode_ms": sum(seg_ms[:n_first]), "segments_ms": seg_ms,
        "first_window_vocode_watermark_ms": voc_ms[0],
        "segment_ms_mean": sum(seg_ms[1:]) / max(len(seg_ms) - 1, 1),
        "vocode_watermark_ms_mean": sum(voc_ms[1:]) / max(len(voc_ms) - 1, 1),
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9, "launches": counts,
    }
    stream["chunk_ms"] = stream["segment_ms_mean"] + stream["vocode_watermark_ms_mean"]
    print(f"[11] infer_stream: bucket {st['bucket']}, {st['n_codes']} codes in {len(chunks)} "
          f"chunks, {stream['samples']} samples, wall {wall:.1f} s | first audio "
          f"{stream['first_audio_ms']:.1f} ms = prompt {stream['prompt_ms']:.1f} + prefill "
          f"{stream['prefill_ms']:.1f} + decode of {n_first} segments ({25 * n_first} steps) "
          f"{stream['first_audio_decode_ms']:.1f} (first {seg_ms[0]:.1f}) + first window "
          f"vocoded with its watermark {voc_ms[0]:.1f} | per chunk {stream['chunk_ms']:.1f} ms "
          f"= decode 25 steps {stream['segment_ms_mean']:.1f} + vocode+watermark "
          f"{stream['vocode_watermark_ms_mean']:.1f}, against 500 ms of audio | peak "
          f"{stream['peak_mem_gb']:.1f} GB | launches {counts}")
    for k in ("decode_attention_bf16", "prefill_attention"):
        require(counts[k] > 0, f"the stream never launched {k}")
    report["phases"]["bf16_stream"] = stream
    # the low-latency first chunk: a stream closed after its third chunk
    tts.streaming = dataclasses.replace(tts.streaming,
                                        first_chunk_frames=config.STREAMING_LOW_LATENCY_FIRST)
    gen_stream = tts.infer_stream(text, ref_codes500, ref_text)
    sizes = [next(gen_stream).size for _ in range(3)]
    gen_stream.close()
    st = tts.last_stats
    low = {"first_audio_ms": st["first_audio_s"] * 1e3, "prompt_ms": st["prompt_s"] * 1e3,
           "prefill_ms": st["prefill_s"] * 1e3, "first_audio_segments": st["first_audio_segments"],
           "first_segment_ms": st["segment_s"][0] * 1e3,
           "first_window_vocode_watermark_ms": st["chunk_s"][0] * 1e3, "chunk_samples": sizes}
    require(low["first_audio_segments"] == 1, "the 10-frame first chunk waited for a 2nd segment")
    require(sizes[0] == config.STREAMING_LOW_LATENCY_FIRST * 480, f"first chunk {sizes[0]}")
    print(f"[11] first_chunk_frames {config.STREAMING_LOW_LATENCY_FIRST}: first audio "
          f"{low['first_audio_ms']:.1f} ms = prompt {low['prompt_ms']:.1f} + prefill "
          f"{low['prefill_ms']:.1f} + first segment "
          f"(15 steps) {low['first_segment_ms']:.1f} + first window "
          f"{low['first_window_vocode_watermark_ms']:.1f} | chunks {sizes} samples, closed")
    report["phases"]["bf16_stream_low_latency"] = low
    # kernel #5 at the stream's own prefill shape: batch 1, its bucket, its left pad
    prompt = tts._build_prompt(text, ref_codes500, ref_text)
    Sb = stream["bucket"]
    prefill_shape(f"prefill_attention@B1_S{Sb}", 1, Sb, [Sb - len(prompt)], shapes, phase="11")
    del tts, gen_stream
    gc.collect()
    torch.cuda.empty_cache()

    # --- 12. LM finetune at Air width ------------------------------------------------
    from neutts_tpu_torch.parallel import distributed as dist_lib
    from neutts_tpu_torch.serving import MultiChipEngine
    from neutts_tpu_torch.tools.profile_train import finetune_batch
    from neutts_tpu_torch.train import codec_trainer as ct
    from neutts_tpu_torch.train import trainer as tr

    lm = finetune_batch(layout)  # synthetic records, B 2 x S 2048
    lm_args = [torch.from_numpy(lm[k]).to(dev) for k in ("tokens", "labels", "attn_mask")]
    n_valid = int((lm["labels"][:, 1:] != tr.IGNORE_INDEX).sum())
    tc = tr.TrainConfig(max_steps=40)  # warmup 2 steps: lr 0, 2e-5, then 4e-5
    state0 = tr.init_state(config.AIR, tc, seed=12, device=dev)
    n_params = bb.param_count(state0.params)
    lm_runs = {"params": n_params}
    for remat in (False, True):
        tcr = dataclasses.replace(tc, remat=remat)
        state = state0
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _build.reset_launches()
        steps = []
        for i in range(4):
            t0 = time.perf_counter()
            state, m = tr.train_step(config.AIR, tcr, state, *lm_args)
            loss = float(m["loss"])  # reads the step's result: waits for the card
            torch.cuda.synchronize()
            steps.append({"loss": loss, "grad_norm": float(m["grad_norm"]),
                          "ms": (time.perf_counter() - t0) * 1e3})
            if i == 1 and not remat:
                moved = sum(int((a != b).sum()) for a, b in zip(
                    tree_leaves(state.params), tree_leaves(state0.params)))
        counts = dict(_build.launches)
        require(not any(counts.values()), f"LM training launched a kernel: {counts}")
        steady = sum(s["ms"] for s in steps[1:]) / 3
        run = {"steps": steps, "steady_ms": steady, "tokens_per_s": 2 * 2048 / steady * 1e3,
               "target_tokens_per_s": n_valid / steady * 1e3,
               "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9}
        lm_runs["remat" if remat else "no_remat"] = run
        print(f"[12] Air finetune B 2 x S 2048 ({n_valid} supervised targets), bf16, remat "
              f"{remat}: " + "; ".join(f"step {i + 1} loss {s['loss']:.4f} grad norm "
                                       f"{s['grad_norm']:.3f} {s['ms']:.1f} ms"
                                       for i, s in enumerate(steps))
              + f" | steady {steady:.1f} ms/step, {run['tokens_per_s']:.0f} tokens/s "
              f"({run['target_tokens_per_s']:.0f} supervised/s) | peak "
              f"{run['peak_mem_gb']:.1f} GB")
        require(all(np.isfinite([s["loss"], s["grad_norm"]]).all() for s in steps),
                "LM training: a loss or grad norm is not finite")
        del state, m
    lm_runs["elements_moved_after_step_2"] = moved
    print(f"[12] after step 2 (lr {tr.make_optimizer(tc).learning_rate(1):.1e}) {moved} of "
          f"{n_params} bf16 parameters moved")
    require(moved > 0, "LM training: no parameter moved after step 2")
    # remat recomputes each layer's forward with the same ops in the same
    # order: losses and grad norms agree to 1e-4 / 1e-3 relative (equal in
    # the runs so far). Step 1 is at lr 0, so steps 3 and 4 read remat's
    # gradients through the update, and every step's grad norm reads them
    # directly.
    for a, b in zip(lm_runs["no_remat"]["steps"], lm_runs["remat"]["steps"]):
        require(abs(a["loss"] - b["loss"]) <= 1e-4 * abs(a["loss"]),
                f"remat loss {b['loss']} vs {a['loss']}: beyond 1e-4 relative")
        require(abs(a["grad_norm"] - b["grad_norm"]) <= 1e-3 * abs(a["grad_norm"]),
                f"remat grad norm {b['grad_norm']} vs {a['grad_norm']}: beyond 1e-3 relative")
    del state0
    gc.collect()
    torch.cuda.empty_cache()
    # a kernel with no backward refuses inputs that require grad
    qg = randn(1, 64, H, D).requires_grad_(True)
    kg = randn(1, 64, K, D)
    try:
        attn.prefill_attention(qg, kg, kg, torch.zeros(1, dtype=torch.int32, device=dev))
        refused = False
    except RuntimeError as e:
        refused = "no backward" in str(e)
    require(refused, "prefill attention ran on inputs that require grad")
    # card against CPU: Air width, 2 layers, f32, B 1, S 256 (TF32 is off)
    cfg2 = config.AIR.scaled(n_layers=2, dtype="float32")
    p2 = bb.init_params(cfg2, seed=13, device="cpu")
    tok256 = lm_args[0][:1, :256].cpu()
    small = [tok256, tok256.clone(), torch.ones_like(tok256, dtype=torch.bool)]  # all supervised
    cmp = {}
    for d in ("cpu", dev):
        loss, _, grads = tr.value_and_grad(
            lambda q: (tr.loss_fn(cfg2, q, *[a.to(d) for a in small])[0], None),
            tree_to(p2, d))
        cmp[str(d)] = (float(loss), float(tr.clip_by_global_norm(tree_leaves(grads),
                                                                  1.0)[1]))
    (lc, gc_), (lg, gg) = cmp["cpu"], cmp[str(dev)]
    lm_runs["card_vs_cpu"] = {"loss_cpu": lc, "loss_card": lg, "grad_norm_cpu": gc_,
                              "grad_norm_card": gg}
    print(f"[12] Air width, 2 layers, f32, B 1 x S 256, card vs CPU: loss {lg:.6f} / {lc:.6f}, "
          f"global grad norm {gg:.6f} / {gc_:.6f} (tolerance 1e-4 relative)")
    require(abs(lg - lc) <= 1e-4 * abs(lc) and abs(gg - gc_) <= 1e-4 * abs(gc_),
            "LM training on the card disagrees with the CPU")
    del p2
    report["phases"]["lm_finetune"] = lm_runs

    # --- 13. codec reconstruction at full width ------------------------------------------
    ctc = ct.CodecTrainConfig()
    cstate = ct.init_state(config.CODEC, ctc, seed=13, device=dev)
    freqs = np.random.default_rng(13).uniform(200, 800, (2, 1))
    wav16 = torch.as_tensor(0.5 * np.sin(2 * np.pi * freqs * np.arange(32_000) / 16_000),
                            dtype=torch.float32, device=dev)
    wav24 = torch.as_tensor(0.5 * np.sin(2 * np.pi * freqs * np.arange(48_000) / 24_000),
                            dtype=torch.float32, device=dev)
    cstep = ct.make_train_step(config.CODEC, ctc)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    csteps = []
    for _ in range(3):
        t0 = time.perf_counter()
        cstate, m = cstep(cstate, wav16, wav24)
        loss = float(m["loss"])
        torch.cuda.synchronize()
        csteps.append({"loss": loss, "l1": float(m["l1"]), "stft": float(m["stft"]),
                       "ms": (time.perf_counter() - t0) * 1e3})
    codec_run = {"steps": csteps, "steady_ms": sum(s["ms"] for s in csteps[1:]) / 2,
                 "peak_mem_gb": torch.cuda.max_memory_allocated() / 1e9,
                 "params": bb.param_count(cstate.params)}
    print(f"[13] codec reconstruction, full CODEC width ({codec_run['params'] / 1e6:.1f} M "
          f"params), B 2 x 2 s: " + "; ".join(f"loss {s['loss']:.4f} {s['ms']:.1f} ms"
                                             for s in csteps)
          + f" | steady {codec_run['steady_ms']:.1f} ms/step | peak "
          f"{codec_run['peak_mem_gb']:.2f} GB")
    require(all(np.isfinite(s["loss"]) for s in csteps), "codec training: loss not finite")
    report["phases"]["codec_train"] = codec_run
    del cstate, m
    gc.collect()
    torch.cuda.empty_cache()

    # --- 14. a data-parallel step over NCCL, world size 1 --------------------------------
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist_lib.initialize(f"localhost:{port}", num_processes=1, process_id=0, device=dev)
    mesh = dist_lib.global_mesh(device=dev)
    require(mesh.world_size == 1 and mesh.group is not None, f"mesh {mesh}")
    tc14 = tr.TrainConfig(max_steps=40)
    dp_args = [a[:, :512] for a in lm_args]
    ref = tr.init_state(cfg2, tc14, seed=14, device=dev)
    st = tr.init_state(cfg2, tc14, seed=14, device=dev)
    dp_step = tr.make_sharded_train_step(cfg2, tc14, mesh)
    for _ in range(2):
        ref, m_ref = tr.train_step(cfg2, tc14, ref, *dp_args)
        st, m_dp = dp_step(st, *dp_args)
    dparam = max(float((a - b).abs().max()) for a, b in zip(tree_leaves(st.params),
                                                              tree_leaves(ref.params)))
    dp = {"loss": float(m_dp["loss"]), "loss_train_step": float(m_ref["loss"]),
          "max_param_diff": dparam, "backend": torch.distributed.get_backend()}
    dist_lib.shutdown()
    print(f"[14] data-parallel step over {dp['backend']}, world size 1, Air width 2 layers f32 "
          f"B 2 x S 512, 2 steps: loss {dp['loss']:.6f} vs train_step "
          f"{dp['loss_train_step']:.6f}, largest parameter difference {dparam:.3e}")
    require(abs(dp["loss"] - dp["loss_train_step"]) <= 1e-6 * abs(dp["loss_train_step"])
            and dparam <= 1e-6, "the data-parallel step differs from train_step")
    report["phases"]["dp_step_nccl"] = dp
    del ref, st, m_ref, m_dp
    gc.collect()
    torch.cuda.empty_cache()

    # --- 15. MultiChipEngine over every visible card ----------------------------------
    mc_cfg = config.AIR.scaled(kv_dtype="int8")
    mc_params = bb.quantize_params(bb.init_params(mc_cfg, seed=15, device=dev))
    mc_scfg = config.SamplingConfig(min_new_tokens=129,
                                    max_context=mc_cfg.max_context).constrained_to(layout)
    rs15 = np.random.default_rng(15)
    mc_prompts = [(layout.speech_base + rs15.integers(0, layout.codebook_size, int(n))).tolist()
                  for n in rs15.integers(380, 513, 48)]
    mc_budgets = [int(b) for b in rs15.integers(64, 129, 48)]
    mc_kw = dict(eos_id=layout.speech_gen_end, n_slots=32, sampling=mc_scfg, segment_steps=32)
    mce = MultiChipEngine(mc_cfg, mc_params, seed=15, **mc_kw)
    mc_rids = [mce.submit(p, max_new=b) for p, b in zip(mc_prompts, mc_budgets)]
    # the oracle: replica i (seed 15 + i) against a lone Engine with that seed
    # on its device, fed the requests routed to it in the same order
    lone_out = {}
    for i, rep in enumerate(mce.engines):
        lone = Engine(mc_cfg, mc_params, device=rep.device, seed=15 + i, **mc_kw)
        mine = [(r, lone.submit(mc_prompts[j], max_new=mc_budgets[j]))
                for j, r in enumerate(mc_rids) if mce._route[r][0] == i]
        out_i = lone.run(pipelined=False)
        lone_out.update({r: out_i[local] for r, local in mine})
        del lone
        gc.collect()
    torch.cuda.synchronize()
    _build.reset_launches()
    t0 = time.perf_counter()
    mc_out = mce.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    counts = dict(_build.launches)
    mc = {"replicas": mce.n_replicas, "n_slots": 32, "requests": 48, "tokens": sum(mc_budgets),
          "wall_s": wall, "tok_s": sum(mc_budgets) / wall, "launches": counts}
    same = all(mc_out[r] == lone_out[r] for r in mc_rids)
    print(f"[15] MultiChipEngine, {mce.n_replicas} replica(s), W8A8 + int8 KV, 32 slots: 48 "
          f"requests, {mc['tokens']} tokens in {wall:.1f} s, {mc['tok_s']:.1f} tok/s | each "
          f"replica's tokens equal a lone Engine's with its seed: {same} | launches {counts}")
    require(mce.n_replicas == torch.cuda.device_count(), "a visible card has no replica")
    require(same, "MultiChipEngine tokens differ from the lone Engines'")
    for k in ("decode_attention_staged", "reconcile_segment", "scatter_prefill",
              "prefill_attention", "fused_qkv", "fused_mlp"):
        require(counts[k] > 0, f"MultiChipEngine never launched {k}")
    report["phases"]["multichip_serving"] = mc
    del mce, mc_params
    gc.collect()
    torch.cuda.empty_cache()

    # --- 18. LFM2-8B-A1B: the expert kernel and the Engine -----------------------------
    lf = report["phases"]["lfm2"] = phase_lfm2(dev, device_ms)
    results.update(lf.pop("kernel_rows"))

    # --- 16. load published formats at Air width --------------------------------------
    conv, conv_paths = phase_converters(dev, run_path, texts, refs, ref_text)
    report["converters"] = conv
    report["phases"]["converters"] = {"hf_w8a8": conv_paths[0], "q8_0_w8a8": conv_paths[1],
                                      "q4_0_bf16": conv_paths[2]}

    # --- 17. tensor parallelism, tp 2 over gloo on the one card ------------------------
    tp17 = phase_tensor_parallel(dev)
    report["phases"]["tensor_parallel"] = tp17
    gc.collect()
    torch.cuda.empty_cache()

    # --- 11, continued: one steady stream chunk under torch.profiler ----------------
    # last in the script (a profiling session slows the process's later
    # launches): the stream's model again (the same seed), a 25-step segment
    # read to the host, and an 82-frame window vocoded and watermarked
    tts = NeuTTS.initialize_random(config.AIR, codec_cfg, seed=6, device=dev, sampling=sampling)
    from neutts_tpu_torch.tools.profile_decode import _window

    toks, lens_p = dec.pad_prompts([prompt], pad_id=getattr(tts.tokenizer, "pad_id", 0),
                                   bucket=Sb, device=dev)
    seg_state = dec.prefill_init(tts.backbone_cfg, tts.sampling, tts._eos, tts.backbone_params,
                                 toks, lens_p, tts._generator)[0]
    window = ref_codes500[:82].tolist()

    def one_chunk():
        nonlocal seg_state
        seg_state, seg = dec.decode_segment(tts.backbone_cfg, tts.sampling, tts._eos, 25,
                                            tts.backbone_params, seg_state)
        seg[0].cpu()
        tts._watermark(tts._vocode(window))

    one_chunk()
    prof = _window(one_chunk, "[11] one stream chunk, profiled")
    prof["idle_share_unprofiled"] = 1.0 - prof["device_busy_ms"] / stream["chunk_ms"]
    print(f"[11] stream chunk: device busy {prof['device_busy_ms']:.1f} ms of the unprofiled "
          f"{stream['chunk_ms']:.1f} ms per chunk: idle {100 * prof['idle_share_unprofiled']:.1f}%")
    stream["profiled_chunk"] = prof
    del tts, seg_state
    gc.collect()
    torch.cuda.empty_cache()

    # --- report ------------------------------------------------------------------------
    paths = (w8, d16, s8, s16, w4, s4, stream, mc, lf["serving"], *conv_paths, tp17)
    for key, r in results.items():
        # a shape row (name@shape) counts its kernel's launches at every shape
        r["launches"] = sum(ph["launches"][key.split("@")[0]] for ph in paths)
    kernels = {"kernels": list(results.values())}
    report["kernel_shapes"] = shapes
    report["total_s"] = time.perf_counter() - t_start
    (out_dir / "chip_smoke.json").write_text(json.dumps({**report, **kernels}, indent=1))
    print(json.dumps(report))
    print(f"total {report['total_s']:.1f} s")
    print(gpu_line())
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(tp_rank_main(sys.argv[2:]) if sys.argv[1:2] == ["--tp-rank"] else main())
