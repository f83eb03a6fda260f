"""The port's example CLIs (neutts_tpu_torch/examples/) and its real-artifact
runner's dry run, on the CPU against the repository's samples/demo.*.

Each example runs with --synthetic --device cpu (a random TINY model with
the full 2048-token window); the outputs are finite 24 kHz audio, codes at
50 Hz, or a saved backbone. basic_example and the runner run as
`python -m` subprocesses, the way a user starts them; the others run
in-process through their main(argv).
"""

import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from neutts_tpu_torch.audio import io as audio_io
from neutts_tpu_torch.examples import (basic_streaming_example, decoder_only_example,
                                       encode_reference, finetune, serve_batch)
from neutts_tpu_torch.models import checkpoint as tckpt

ROOT = Path(__file__).resolve().parent.parent
DEMO = ["--ref_text", "samples/demo.txt", "--synthetic", "--device", "cpu"]


@pytest.fixture(autouse=True)
def _repo_root(monkeypatch):
    monkeypatch.chdir(ROOT)  # the examples' paths are relative to the repository


def _assert_audio(path):
    wav, sr = audio_io.read_wav(path)
    assert sr == 24_000 and wav.size > 0 and np.isfinite(wav).all()
    return wav


def test_basic_example_runs_as_a_module(tmp_path):
    out = tmp_path / "out.wav"
    r = subprocess.run(
        [sys.executable, "-m", "neutts_tpu_torch.examples.basic_example",
         "--input_text", "Bundled sample smoke test.", "--ref_audio", "samples/demo.wav",
         *DEMO, "--output_path", str(out)],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout + r.stderr
    _assert_audio(out)


def test_decoder_only_example(tmp_path):
    out = tmp_path / "out.wav"
    decoder_only_example.main(["--input_text", "Pre-encoded codes smoke test.",
                               "--ref_codes", "samples/demo_codes.npy", *DEMO,
                               "--output_path", str(out)])
    _assert_audio(out)


def test_streaming_example(tmp_path, capsys):
    out = tmp_path / "out.wav"
    basic_streaming_example.main(["--input_text", "Streaming smoke test.",
                                  "--ref_codes", "samples/demo_codes.npy", *DEMO,
                                  "--first_chunk_frames", "10", "--output_path", str(out)])
    assert "first audio after" in capsys.readouterr().out
    _assert_audio(out)


def test_encode_reference_example(tmp_path):
    for name in ("codes.npy", "codes.pt"):
        out = tmp_path / name
        encode_reference.main(["--ref_audio", "samples/demo.wav", "--synthetic",
                               "--device", "cpu", "--output_path", str(out)])
        codes = (np.load(out) if out.suffix == ".npy"
                 else torch.load(out, weights_only=True).numpy())
        assert codes.dtype == np.int32 and codes.shape == (100,)  # 2 s at 50 Hz


def test_serve_batch_example(tmp_path):
    serve_batch.main(["--ref_codes", "samples/demo_codes.npy", *DEMO, "--n_slots", "4",
                      "--out_prefix", str(tmp_path / "served_")])
    outs = sorted(tmp_path.glob("served_*.wav"))
    assert outs and len(outs) <= len(serve_batch.SENTENCES)
    for p in outs:
        _assert_audio(p)


def test_finetune_example(tmp_path):
    cfg = tmp_path / "ft.yaml"
    cfg.write_text(
        "model: tiny\ndataset: synthetic\nmax_seq_len: 256\nbatch_size: 4\n"
        f"max_steps: 3\nlogging_steps: 1\nn_samples: 16\ncheckpoints_dir: {tmp_path}\n")
    finetune.main([str(cfg), "--synthetic", "--device", "cpu"])
    saved = tckpt.load_params(tmp_path / "final" / "backbone.npz", device="cpu")
    assert saved["layers"]["wq"].shape[0] == 2 and torch.isfinite(saved["embed"]).all()


def test_verify_real_artifacts_dry_run(tmp_path):
    """The port's runner chains its converters, the HF forward and greedy
    parity (transformers), the codec decode and the encode machinery on a
    synthetic checkpoint and samples/demo.*."""
    pytest.importorskip("transformers")
    r = subprocess.run(
        [sys.executable, "-m", "neutts_tpu_torch.tools.verify_real_artifacts", "--dry-run",
         "--device", "cpu", "--out", str(tmp_path / "verify")],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "FAIL" not in r.stdout
    for stage_name in ("convert", "hf-forward", "greedy-parity", "waveform", "encode-parity"):
        assert f"[PASS] {stage_name}" in r.stdout, (stage_name, r.stdout[-1500:])
