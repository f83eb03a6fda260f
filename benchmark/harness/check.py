"""The comparisons that decide `correct`, against the plain reference.

* `token_gap`: for served greedy tokens, the widest gap by which a served
  token's reference logit lies below the reference's best logit at that
  position (over the speech codes the sampling is constrained to; EOS is
  held off by `min_new_tokens` in every mix). The reference runs once over
  each prompt with its served tokens.
* `wave_gap`: the widest difference between the streamed audio and the
  reference's (its own decoder over the served codes, in the stream's
  windows, watermarked and overlap-added), over the reference's peak.

The control of each number is the reference in the next precision below
the configuration's (`control_token_gap`: the token the lower precision puts
first, read against the reference; `wave_gap` with TF32 on). The
benchmark's runs compare the program alone; `readings.py` reads both.
"""

from __future__ import annotations

import math
from contextlib import contextmanager
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from benchmark.reference.audio import stream_chunks
from benchmark.reference.backbone import Reference
from benchmark.reference.codec import decode as ref_decode


@contextmanager
def float32_exact(tf32: bool = False):
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = tf32
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def reference_precision(c: dict) -> dict:
    """The configuration's precisions, as the reference takes them."""
    return {"weights_mode": c["weights"], "act": c.get("activations"),
            "kv": None if c["kv_dtype"] in ("bfloat16", "float32") else c["kv_dtype"]}


def token_gaps(m: dict, weights: dict, seqs: Sequence[Tuple[List[int], List[int]]],
               prec: dict, col_lo: int, col_hi: int,
               control: Optional[dict] = None) -> Dict[str, float]:
    """Widest gap of the served tokens (and, given a control precision, of
    the tokens the control puts first) below the reference's best."""
    ref = Reference(m, weights, **prec)
    ctl = Reference(m, weights, **control) if control else None
    worst, worst_ctl, n = 0.0, 0.0, 0
    with float32_exact():
        for prompt, served in seqs:
            if not served:
                continue
            ids = list(prompt) + list(served[:-1])
            lg = ref.logits(ids, len(prompt), col_lo, col_hi)
            best = lg.max(dim=1).values
            idx = torch.as_tensor(served, device=lg.device, dtype=torch.long) - col_lo
            if bool(((idx < 0) | (idx >= lg.shape[1])).any()):
                return {"token_gap": math.inf, "tokens": n + len(served)}
            ar = torch.arange(len(served), device=lg.device)
            worst = max(worst, float((best - lg[ar, idx]).max()))
            n += len(served)
            if ctl is not None:
                pick = ctl.logits(ids, len(prompt), col_lo, col_hi).argmax(dim=1)
                worst_ctl = max(worst_ctl, float((best - lg[ar, pick]).max()))
            del lg
    out = {"token_gap": worst, "tokens": n}
    if ctl is not None:
        out["control_token_gap"] = worst_ctl
    return out


def wave_gap(codec: dict, dec: dict, streams: Sequence[dict], streaming: dict,
             tf32: bool = False) -> Dict[str, float]:
    """streams: {"ref_codes", "first" (codes), "segments" (codes per
    segment), "ended" (the decode reached EOS), "chunks" (the audio the
    program yielded)}. Returns the widest
    sample difference over the reference's peak, over every chunk."""
    hop = codec["hop_out"]

    def vocode(codes):
        return ref_decode(codec, dec, codes).cpu().numpy()

    diff, peak, n = 0.0, 0.0, 0
    with float32_exact(tf32):
        for s in streams:
            got = s["chunks"]
            want = stream_chunks(s["ref_codes"], s["first"], s["segments"], len(got), vocode,
                                 streaming, hop, s.get("ended", False))
            if len(want) != len(got):
                return {"wave_gap": math.inf, "chunks": n}
            for a, b in zip(got, want):
                if a.shape != b.shape or not np.isfinite(a).all():
                    return {"wave_gap": math.inf, "chunks": n}
                diff = max(diff, float(np.abs(a - b).max()))
                peak = max(peak, float(np.abs(b).max()))
                n += 1
    return {"wave_gap": diff / max(peak, 1e-12), "chunks": n}


def judge(values: Dict[str, float], limits: Dict[str, float]) -> Tuple[bool, Dict[str, dict]]:
    """Each compared number beside its limit; correct when each is within."""
    checks = {k: {"value": values[k], "limit": limits[k]} for k in limits if k in values}
    ok = len(checks) == len(limits) and all(
        math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in checks.values())
    return ok, checks
