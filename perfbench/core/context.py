"""What one run hands its metric readers."""

from __future__ import annotations

from dataclasses import dataclass, field
from types import ModuleType
from typing import Dict, List, Optional

from perfbench.core import traffic
from perfbench.core.trace import Spans, Trace


@dataclass
class Run:
    cell: Dict
    cfg: Dict
    mix: Dict
    seed: int
    seconds: float
    traced: bool
    device: str
    work: ModuleType  # the configuration's model FLOPs (perfbench/work/<config>.py)
    spans: Spans = field(default_factory=Spans)
    setup_s: float = 0.0
    data: List[dict] = field(default_factory=list)  # the corpus or the serving pool
    # the measured window, on the host clock: start, end, and what it did
    window: Dict = field(default_factory=dict)
    # the traced segment after the window (--trace 1): its trace and the
    # dialogues of each of its steps or requests
    trace: Optional[Trace] = None
    segment: List[List[int]] = field(default_factory=list)
    readings: Dict = field(default_factory=dict)  # the program's outputs that the comparison reads
    extra: Dict = field(default_factory=dict)

    @property
    def model(self) -> Dict:
        return self.cfg["model"]

    def forward_flops(self, index: int) -> int:
        """Model FLOPs of one forward over dialogue ``index`` of ``data``."""
        cache = self.extra.setdefault("flops", {})
        if index not in cache:
            cache[index] = self.work.forward_flops(traffic.speaker_ids(self.data[index]), self.model)
        return cache[index]

    def lengths(self, indices) -> List[int]:
        return [len(self.data[i]["label"]) for i in indices]

