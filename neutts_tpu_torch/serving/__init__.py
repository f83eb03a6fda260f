"""Continuous-batching serving on one GPU (port of `neutts_tpu.serving`).

`MultiChipEngine` (replicas over several devices) is not ported yet
(ROADMAP Queue 1 item 6).
"""

from neutts_tpu_torch.serving.engine import Engine, Request

__all__ = ["Engine", "Request"]
