"""Learning-rate schedules.

``PlateauDecay`` is the paper's schedule: multiply the LR by ``factor``
(0.7) whenever development perplexity fails to improve over a fixed
interval (5k / 20k batches for WMT14 / WMT17).  It is host-side state
(driven by the eval loop), matching the paper's implementation.
"""
from __future__ import annotations

import math
from dataclasses import dataclass


@dataclass
class PlateauDecay:
    factor: float = 0.7
    best: float = math.inf
    scale: float = 1.0

    def observe(self, dev_ppl: float) -> float:
        """Call once per eval interval with current dev perplexity; returns
        the lr scale to use until the next observation."""
        if dev_ppl >= self.best:
            self.scale *= self.factor
        else:
            self.best = dev_ppl
        return self.scale


def warmup_cosine(step: int, *, peak: float, warmup: int, total: int, floor: float = 0.0) -> float:
    if step < warmup:
        return peak * step / max(warmup, 1)
    t = (step - warmup) / max(total - warmup, 1)
    return floor + 0.5 * (peak - floor) * (1 + math.cos(math.pi * min(t, 1.0)))
