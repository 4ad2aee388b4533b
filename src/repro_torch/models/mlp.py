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


def mlp_specs(gated: bool) -> dict:
    """The logical spec tree of :func:`init_mlp`'s parameters, as
    ``repro/models/mlp.py::init_mlp`` returns it beside them."""
    if gated:
        return {"wi": ("embed", "ff"), "wg": ("embed", "ff"), "wo": ("ff", "embed")}
    return {"wi": ("embed", "ff"), "bi": ("ff",), "wo": ("ff", "embed"), "bo": ("embed",)}


def apply_mlp(p: dict, x: torch.Tensor, act_name: str, gated: bool, reduce=None) -> torch.Tensor:
    """``reduce``: applied to the down projection's output before its bias
    (a tensor-parallel rank's sum of the partial outputs)."""
    dt = x.dtype
    act = activation(act_name)
    h = torch.matmul(x, p["wi"].to(dt))
    if gated:
        h = act(h) * torch.matmul(x, p["wg"].to(dt))
    else:
        h = act(h + p["bi"].to(dt))
    y = torch.matmul(h, p["wo"].to(dt))
    if reduce is not None:
        y = reduce(y)
    if not gated:
        y = y + p["bo"].to(dt)
    return y
