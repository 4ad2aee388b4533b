"""Shared model building blocks of the port.

Parameters are nested dicts (and lists) of tensors with the JAX package's
names and layouts, so ``repro_torch.bridge`` moves a ``repro`` param tree
across leaf for leaf.  Model code is plain functions on tensors.
"""
from __future__ import annotations

import math
import zlib

import torch

# Named compute dtypes. Parameters are held in fp32 (master weights); these
# are the dtypes activations may be computed in.
DTYPES = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
}


def resolve_dtype(name: str) -> torch.dtype:
    """Map a dtype name from a config or plan to the torch dtype."""
    try:
        return DTYPES[name]
    except KeyError:
        raise ValueError(f"unknown compute dtype {name!r}; expected one of {tuple(DTYPES)}") from None


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  ``"cuda"`` (the entry points'
    default) raises when CUDA is missing instead of running on the host:
    only an explicit ``"cpu"`` runs there."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"device={str(device)!r} but CUDA is not available; pass device='cpu' to run on the host")
    return dev


class Initializer:
    """Deterministic per-path initialization with the JAX package's shapes
    and scales (``repro/models/common.py::Initializer``).

    Each path seeds its own ``torch.Generator`` from the run seed and a
    stable CRC-32 of the path, so values do not depend on init order or on
    the process.  The values cannot equal JAX's (a different generator);
    parity tests move JAX's weights over with ``repro_torch.bridge``.
    Values are drawn on the host and then moved, so every device gets the
    same weights from the same seed.
    """

    def __init__(self, seed: int, dtype: torch.dtype = torch.float32, device="cpu"):
        self.seed = int(seed)
        self.dtype = dtype
        self.device = torch.device(device)

    def _gen(self, path: str) -> torch.Generator:
        g = torch.Generator()
        g.manual_seed(((self.seed & 0xFFFFFFFF) << 32) | zlib.crc32(path.encode()))
        return g

    def _place(self, x: torch.Tensor) -> torch.Tensor:
        return x.to(device=self.device, dtype=self.dtype)

    def normal(self, path: str, shape, scale: float | None = None) -> torch.Tensor:
        if scale is None:  # fan-in scaled
            fan_in = shape[-2] if len(shape) >= 2 else shape[-1]
            scale = 1.0 / math.sqrt(max(fan_in, 1))
        return self._place(scale * torch.randn(shape, generator=self._gen(path)))

    def embedding(self, path: str, shape, scale: float = 0.02) -> torch.Tensor:
        return self._place(scale * torch.randn(shape, generator=self._gen(path)))

    def zeros(self, path: str, shape) -> torch.Tensor:
        del path
        return torch.zeros(shape, dtype=self.dtype, device=self.device)


def tree_map(fn, *trees):
    """Apply ``fn`` leaf-wise over trees of tensors built from dicts, lists,
    tuples and NamedTuples (all trees share the first one's structure)."""
    t = trees[0]
    if isinstance(t, torch.Tensor):
        return fn(*trees)
    if isinstance(t, dict):
        return {k: tree_map(fn, *(tr[k] for tr in trees)) for k in t}
    if isinstance(t, tuple) and hasattr(t, "_fields"):
        return type(t)(*(tree_map(fn, *xs) for xs in zip(*trees)))
    if isinstance(t, (list, tuple)):
        return type(t)(tree_map(fn, *xs) for xs in zip(*trees))
    raise TypeError(f"unsupported tree node {type(t).__name__}")


def tree_leaves(tree) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out
