"""Token sampling for the decode loop (port of `neutts_tpu.ops.sampling`).

Gumbel-max over the top-k candidates, with EOS suppression before
`min_new_tokens`, pad-vocab masking and the optional speech-range
constraint applied to the [B, k] candidates.

Differences from the JAX package, by design:
  * top-k is the exact `torch.topk` — the reference's `exact_topk=True`
    semantics. The JAX default `lax.approx_max_k` exists only on the TPU.
  * random numbers come from an explicit `torch.Generator`; its stream
    differs from `jax.random`, so the two packages agree token for token
    only under greedy decoding.
"""

from __future__ import annotations

import torch

from neutts_tpu_torch.config import SamplingConfig
from neutts_tpu_torch.models import backbone as bb

_NEG_INF = float("-inf")


def _gumbel(shape, like: torch.Tensor, generator: torch.Generator | None) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(U)), U uniform on [tiny, 1) (as
    jax.random.gumbel draws it)."""
    tiny = torch.finfo(torch.float32).tiny
    u = torch.rand(shape, generator=generator, device=like.device, dtype=torch.float32)
    return -torch.log(-torch.log(u.clamp_min(tiny)))


def _pick(vals, idx, temperature, generator):
    vals = vals / max(temperature, 1e-6)
    choice = torch.argmax(vals + _gumbel(vals.shape, vals, generator), dim=-1)
    return torch.gather(idx, -1, choice[:, None])[:, 0]


def sample_tokens(logits, generator=None, *, temperature: float = 1.0, top_k: int = 50,
                  greedy: bool = False, vocab_size: int | None = None) -> torch.Tensor:
    """One token per row [B] int32; greedy is exact argmax. With `vocab_size`,
    padded-vocab ids are masked among the top-k candidates."""
    padded = vocab_size is not None and logits.shape[-1] > vocab_size
    if greedy:
        if padded:
            logits = logits[:, :vocab_size]
        return torch.argmax(logits, dim=-1).to(torch.int32)
    vals, idx = torch.topk(logits, top_k, dim=-1)
    vals = vals.float()
    if padded:
        vals = torch.where(idx >= vocab_size, _NEG_INF, vals)
    return _pick(vals, idx, temperature, generator).to(torch.int32)


def mask_eos(logits, eos_id: int, step: int, min_new_tokens: int) -> torch.Tensor:
    """Suppress EOS before `min_new_tokens` (HF MinNewTokensLengthLogitsProcessor)."""
    out = logits.clone()
    if step < min_new_tokens:
        out[:, eos_id] = _NEG_INF
    return out


def constrain_to_speech(logits, speech_base: int, codebook_size: int, eos_id: int):
    """Restrict to speech tokens + EOS: every other id becomes -inf."""
    ar = torch.arange(logits.shape[-1], device=logits.device)
    ok = ((ar >= speech_base) & (ar < speech_base + codebook_size)) | (ar == eos_id)
    return torch.where(ok[None, :], logits, _NEG_INF)


def _suppress_vector(suppress_eos, B: int, device) -> torch.Tensor:
    # a Python bool is filled on the device: a host-to-device copy of it
    # would wait for the stream (the serving loop must not)
    if isinstance(suppress_eos, torch.Tensor):
        return suppress_eos.to(device=device, dtype=torch.bool).expand(B)
    return torch.full((B,), bool(suppress_eos), dtype=torch.bool, device=device)


def sample_step(logits, generator, cfg: SamplingConfig, eos_id: int, suppress_eos,
                vocab_size: int | None = None) -> torch.Tensor:
    """Decode-loop sampling over full-vocab logits (padded vocab allowed with
    `vocab_size`). suppress_eos: bool or [B] bool, True while min_new_tokens
    is unmet. Returns [B] int32 vocab ids."""
    B = logits.shape[0]
    padded = vocab_size is not None and logits.shape[-1] > vocab_size
    sup = _suppress_vector(suppress_eos, B, logits.device)
    if cfg.greedy:
        if padded:
            logits = logits[:, :vocab_size]
        logits = logits.float()
        if cfg.speech_range is not None:
            base, top = cfg.speech_range
            logits = constrain_to_speech(logits, base, top - base, eos_id)
        logits = logits.clone()
        logits[:, eos_id] = torch.where(sup, _NEG_INF, logits[:, eos_id])
        return torch.argmax(logits, dim=-1).to(torch.int32)
    vals, idx = torch.topk(logits, cfg.top_k, dim=-1)
    vals = vals.float()
    bad = (idx == eos_id) & sup[:, None]
    if padded:
        bad = bad | (idx >= vocab_size)
    if cfg.speech_range is not None:
        base, top = cfg.speech_range
        in_range = ((idx >= base) & (idx < top)) | ((idx == eos_id) & ~sup[:, None])
        bad = bad | ~in_range
    vals = torch.where(bad, _NEG_INF, vals)
    picked = _pick(vals, idx, cfg.temperature, generator)
    if cfg.speech_range is not None:
        # every candidate masked (possible only far off-distribution): EOS
        picked = torch.where(bad.all(dim=-1), eos_id, picked)
    return picked.to(torch.int32)


def sample_step_speech(logits, generator, cfg: SamplingConfig, eos_id: int, suppress_eos,
                       width: int) -> torch.Tensor:
    """Sampling over speech-head logits [B, W] (backbone.add_speech_head):
    column 0 is EOS, column 1 + c is speech code c, columns >= width are
    lane pad. Returns full-vocab ids (offset by eos_id)."""
    B = logits.shape[0]
    sup = _suppress_vector(suppress_eos, B, logits.device)
    if cfg.greedy:
        lf = logits[:, :width].float().clone()
        lf[:, 0] = torch.where(sup, _NEG_INF, lf[:, 0])
        return (torch.argmax(lf, dim=-1) + eos_id).to(torch.int32)
    vals, idx = torch.topk(logits, cfg.top_k, dim=-1)
    vals = vals.float()
    bad = (idx >= width) | ((idx == 0) & sup[:, None])
    vals = torch.where(bad, _NEG_INF, vals)
    picked = _pick(vals, idx, cfg.temperature, generator)
    picked = torch.where(bad.all(dim=-1), 0, picked)
    return (picked + eos_id).to(torch.int32)


def use_speech_head(cfg_backbone, sampling: SamplingConfig, params) -> bool:
    """The speech-head path applies when sampling is constrained to the full
    speech range and the pre-sliced head is attached."""
    lay = cfg_backbone.layout
    return (
        sampling.speech_range == (lay.speech_base, lay.vocab_size)
        and isinstance(params, dict)
        and "lm_head_speech" in params
    )


def sample_logits(logits, generator, cfg_backbone, sampling: SamplingConfig, eos_id: int,
                  suppress, *, speech: bool) -> torch.Tensor:
    """Sampling dispatch over precomputed logits (speech-head or padded
    full-vocab layout per `speech`)."""
    if speech:
        width = cfg_backbone.vocab_size - cfg_backbone.layout.speech_gen_end
        return sample_step_speech(logits, generator, sampling, eos_id, suppress, width=width)
    return sample_step(logits, generator, sampling, eos_id, suppress,
                       vocab_size=cfg_backbone.vocab_size)


def sample_from_hidden(cfg_backbone, sampling: SamplingConfig, params, x, generator, eos_id: int,
                       suppress) -> torch.Tensor:
    """Head projection + sampling for the serving loops, one definition for
    prefill and decode: the pre-sliced speech head when constrained
    sampling has it attached, else the padded full-vocab head. x [B, D];
    returns [B] int32 vocab ids."""
    speech = use_speech_head(cfg_backbone, sampling, params)
    if speech:
        logits = bb._logits_speech(cfg_backbone, params, x)
    else:
        logits = bb._logits(cfg_backbone, params, x, trim=False)
    return sample_logits(logits, generator, cfg_backbone, sampling, eos_id, suppress,
                         speech=speech)
