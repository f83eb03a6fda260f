"""What one run leaves for the metric readers and for the result line."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, Optional

from benchmark.harness.trace import DeviceTrace, Spans


@dataclass
class Run:
    cell: str
    config: dict
    traffic: dict
    sizes: dict  # the model's sizes (`model.sizes`)
    setup_s: float = 0.0
    window_s: float = 0.0  # the measured window's length on the host clock
    spans: Spans = field(default_factory=Spans)
    trace: Optional[DeviceTrace] = None
    data: Dict[str, object] = field(default_factory=dict)  # what the driver measured
    attempted: int = 0
    failed: int = 0
    memory_peak_bytes: int = 0
