"""Dense feed-forward blocks, gated (SwiGLU-style) and plain (port of
``repro/models/mlp.py``)."""
from __future__ import annotations

import torch

from repro_torch.models.common import Initializer, activation


def init_mlp(ini: Initializer, path: str, d: int, ff: int, gated: bool) -> dict:
    if gated:
        return {
            "wi": ini.normal(path + ".wi", (d, ff)),
            "wg": ini.normal(path + ".wg", (d, ff)),
            "wo": ini.normal(path + ".wo", (ff, d)),
        }
    return {
        "wi": ini.normal(path + ".wi", (d, ff)),
        "bi": ini.zeros(path + ".bi", (ff,)),
        "wo": ini.normal(path + ".wo", (ff, d)),
        "bo": ini.zeros(path + ".bo", (d,)),
    }


def apply_mlp(p: dict, x: torch.Tensor, act_name: str, gated: bool) -> torch.Tensor:
    dt = x.dtype
    act = activation(act_name)
    h = torch.matmul(x, p["wi"].to(dt))
    if gated:
        h = act(h) * torch.matmul(x, p["wg"].to(dt))
    else:
        h = act(h + p["bi"].to(dt))
    y = torch.matmul(h, p["wo"].to(dt))
    if not gated:
        y = y + p["bo"].to(dt)
    return y
