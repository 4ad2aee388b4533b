"""Token sampling.

Samplers share one signature, ``sampler(logits [B, V], generator=None) ->
tokens [B] int64``, so the engine can swap them.  ``greedy`` ignores the
generator; ``temperature_sample`` draws from the given ``torch.Generator``
(on the logits' device).  ``make_sampler`` resolves a temperature into the
right callable (temperature <= 0 means greedy).
"""
from __future__ import annotations

import functools
from typing import Optional

import torch


def greedy(logits: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
    return torch.argmax(logits, dim=-1)


def temperature_sample(logits: torch.Tensor, generator: Optional[torch.Generator] = None,
                       temperature: float = 1.0) -> torch.Tensor:
    if generator is None:
        raise ValueError("temperature_sample needs a torch.Generator")
    probs = torch.softmax(logits.float() / max(temperature, 1e-4), dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


def make_sampler(temperature: float = 0.0):
    """temperature <= 0 -> greedy; otherwise seeded temperature sampling."""
    if temperature <= 0.0:
        return greedy
    return functools.partial(temperature_sample, temperature=temperature)
