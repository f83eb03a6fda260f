"""The Qwen2 block (`models/backbone.py`) behind the serving engine's block
interface (`runtime/batching.block`): the same five functions as
`models/lfm2.py` and `models/moonlight.py`, so that the decode core picks a
family once per config and calls it alike."""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from neutts_tpu_torch.config import BackboneConfig
from neutts_tpu_torch.models import backbone as bb


def prepare_params(cfg: BackboneConfig, params: bb.Params) -> bb.Params:
    """The weights as the serving engine runs them: `Engine` has already
    stored the fused kernels' weights K-major (`backbone.prepare_params`)."""
    return params


def layer_params(cfg: BackboneConfig, params: bb.Params) -> List[bb.Params]:
    return [bb.layer_params(params, l) for l in range(cfg.n_layers)]


def state_shapes(cfg: BackboneConfig, n_slots: int) -> Dict[str, Tuple[tuple, torch.dtype]]:
    """No device state beside the KV cache."""
    return {}


def prefill_hidden(cfg: BackboneConfig, params: bb.Params, tokens: torch.Tensor,
                   prompt_lens: torch.Tensor, store, state_store=None) -> torch.Tensor:
    return bb.prefill_hidden(cfg, params, tokens, prompt_lens, store)


def decode_hidden(cfg: BackboneConfig, params: bb.Params, layers: List[bb.Params],
                  token: torch.Tensor, positions: torch.Tensor, attend, state) -> torch.Tensor:
    return bb.decode_hidden(cfg, params, layers, token, positions, attend)
