"""The check fails what it must. At tiny sizes on the CPU: the control (the
reference in the next precision below the configuration's) reads above each
cell's limit of the token gap, and a run whose timed path is broken
underneath comes out not correct, once for each fault a cell can have. The
card's own readings of the control, at the cells' sizes, come from
`benchmark/readings.py`; the codec's TF32 control needs the card."""

from __future__ import annotations

import time
import warnings

import pytest
import torch

from benchmark import run as runmod
from benchmark.drivers import engine, stream
from benchmark.tests import tiny

CPU = torch.device("cpu")
SEEDS = (11, 3_000_000_019, 4_294_967_311)
SERVE = ("serve-w8a8-backlog", "air-w8a8-int8kv", "serve-backlog")
STREAM = ("stream-bf16", "air-bf16", "stream-closed")


@pytest.fixture(autouse=True)
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        yield


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("which", ["serve", "stream"])
def test_control_fails_the_token_gap(which, seed):
    drv, spec = (engine, SERVE) if which == "serve" else (stream, STREAM)
    c = tiny.cell(*spec)
    rec = drv.run(c, seed, 2.0, False, CPU, time.perf_counter())
    v = drv.compare(rec, seed, CPU, control=c.config["control"])
    limit = c.config["limits"]["token_gap"]
    assert v["token_gap"] <= limit < v["control_token_gap"], v


def _faulty(monkeypatch, fault: str):
    """Breaks the timed path underneath the harness."""
    from neutts_tpu_torch.models import backbone as bb
    from neutts_tpu_torch.models import codec as cd
    from neutts_tpu_torch.ops import attention as attn
    from neutts_tpu_torch.ops import sampling as smp

    if fault == "state unchanged (serving)":  # the segment's K/V never reach the cache
        monkeypatch.setattr(attn, "reconcile_segment", lambda *a, **k: None)
    elif fault == "state unchanged (stream)":  # a decode step leaves the cache as it was
        orig = bb.write_kv

        def write_kv(cache, l, at, kf, vf, **kw):
            if isinstance(at[1], int):
                return None
            return orig(cache, l, at, kf, vf, **kw)

        monkeypatch.setattr(bb, "write_kv", write_kv)
    elif fault == "token altered (serving)":
        orig = smp.sample_from_hidden

        def sample_from_hidden(cfg, sampling, params, x, gen, eos_id, suppress):
            t = orig(cfg, sampling, params, x, gen, eos_id, suppress)
            lay = cfg.layout
            return torch.where(t + 1 < lay.vocab_size, t + 1, lay.speech_base).to(t.dtype)

        monkeypatch.setattr(smp, "sample_from_hidden", sample_from_hidden)
    elif fault == "token altered (stream)":
        orig = smp.sample_logits

        def sample_logits(logits, gen, cfg, sampling, eos_id, suppress, *, speech):
            t = orig(logits, gen, cfg, sampling, eos_id, suppress, speech=speech)
            lay = cfg.layout
            return torch.where(t + 1 < lay.vocab_size, t + 1, lay.speech_base).to(t.dtype)

        monkeypatch.setattr(smp, "sample_logits", sample_logits)
    elif fault == "half the batch left out":  # the second half's rows take the first's
        orig = smp.sample_from_hidden

        def sample_from_hidden(cfg, sampling, params, x, gen, eos_id, suppress):
            B = x.shape[0]
            if B > 1:
                x = torch.cat([x[: B - B // 2], x[: B // 2]])
            return orig(cfg, sampling, params, x, gen, eos_id, suppress)

        monkeypatch.setattr(smp, "sample_from_hidden", sample_from_hidden)
    elif fault == "audio altered":
        orig = cd.decode
        monkeypatch.setattr(cd, "decode", lambda *a, **k: orig(*a, **k) * 1.001)
    else:
        raise ValueError(fault)


@pytest.mark.parametrize("spec,fault", [
    (SERVE, "state unchanged (serving)"),
    (SERVE, "token altered (serving)"),
    (SERVE, "half the batch left out"),
    (STREAM, "state unchanged (stream)"),
    (STREAM, "token altered (stream)"),
    (STREAM, "audio altered"),
])
def test_a_broken_timed_path_is_not_correct(monkeypatch, spec, fault):
    c = tiny.cell(*spec)
    ok = runmod.measure(c, 5, 2.0, False, CPU, time.perf_counter())
    assert ok["correct"] is True
    _faulty(monkeypatch, fault)
    res = runmod.measure(c, 5, 2.0, False, CPU, time.perf_counter())
    assert res["correct"] is False, (fault, res["checks"])


@pytest.mark.cuda
def test_tf32_control_fails_the_wave_gap():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: TF32 exists only on the card")
    dev = torch.device("cuda", 0)
    c = tiny.cell(*STREAM)
    for seed in SEEDS:
        rec = stream.run(c, seed, 2.0, False, dev, time.perf_counter())
        v = stream.compare(rec, seed, dev, control=c.config["control"])
        assert v["wave_gap"] <= c.config["limits"]["wave_gap"] < v["control_wave_gap"], v
