"""Tiny configurations and mixes for the CPU tests: the cells' own shapes of
data, at sizes a test run holds (the port's TINY backbone and CODEC_TINY)."""

from __future__ import annotations

import copy
import json

from benchmark.harness.manifest import BENCH_DIR, Cell


def _load(rel: str) -> dict:
    return json.loads((BENCH_DIR / rel).read_text())


TINY_SIZES = {"hidden_size": 64, "num_hidden_layers": 2, "num_attention_heads": 4,
              "num_key_value_heads": 2, "head_dim": 16, "intermediate_size": 128,
              "max_context": 512, "text_tokens": 320, "special_tokens": 6, "codebook_size": 64,
              "vocab_size": 390, "compute_dtype": "float32"}
TINY_LIMITS = {"token_gap": 0.005, "wave_gap": 1e-5}
TINY_CODEC = {"vq_dim": 16, "dec_dim": 32, "dec_layers": 2, "dec_heads": 2,
              "dec_intermediate": 64}


def config(name: str) -> dict:
    c = copy.deepcopy(_load(f"configs/{name}.json"))
    c.update(TINY_SIZES)
    c["name"] = name + "-tiny"
    if "codec" in c:
        c["codec"].update(TINY_CODEC)
    # limits for these sizes: on the CPU the program computes in float32 and
    # reads 0 against the reference; the control reads 0.04 and more
    c["limits"] = {k: TINY_LIMITS[k] for k in c["limits"]}
    return c


def traffic(mix: str) -> dict:
    t = copy.deepcopy(_load(f"traffic/{mix}.json"))
    t["name"] = mix + "-tiny"
    if t["driver"] == "engine":
        t.update(n_slots=8, segment_steps=8, prompt_tokens=[20, 60], budget=[10, 30],
                 n_requests=4000, check_requests=4, backlog=8, first_wave_budget=[1, 30],
                 warm_segments=1)
    else:
        t.update(clip_codes=[20, 30], n_streams=20)
    return t


def cell(name: str, config_name: str, mix: str) -> Cell:
    return Cell(name=name, chips=1, config=config(config_name), traffic=traffic(mix),
                end_to_end=[], per_layer=[])
