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

    def ones(self, path: str, shape) -> torch.Tensor:
        del path
        return torch.ones(shape, dtype=self.dtype, device=self.device)


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


# ---------------------------------------------------------------------------
# norms / activations (repro/models/common.py)
# ---------------------------------------------------------------------------


def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt(torch.mean(torch.square(x), dim=-1, keepdim=True) + eps)
    return (x * scale.float()).to(dt)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = torch.mean(x, dim=-1, keepdim=True)
    var = torch.mean(torch.square(x - mu), dim=-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * scale.float() + bias.float()).to(dt)


def init_norm(ini: Initializer, path: str, d: int, kind: str) -> dict:
    if kind == "rmsnorm":
        return {"scale": ini.ones(path + ".scale", (d,))}
    return {"scale": ini.ones(path + ".scale", (d,)), "bias": ini.zeros(path + ".bias", (d,))}


def norm_specs(kind: str) -> dict:
    """The logical spec tree of :func:`init_norm`'s parameters (as
    ``repro/models/common.py::init_norm`` returns it beside them)."""
    return {"scale": ("embed",)} if kind == "rmsnorm" else {"scale": ("embed",), "bias": ("embed",)}


def apply_norm(p: dict, x: torch.Tensor, kind: str) -> torch.Tensor:
    if kind == "rmsnorm":
        return rms_norm(x, p["scale"])
    return layer_norm(x, p["scale"], p["bias"])


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return torch.nn.functional.gelu(x, approximate="tanh")  # jax.nn.gelu's default


def activation(name: str):
    return {"silu": torch.nn.functional.silu, "gelu": _gelu, "tanh": torch.tanh, "relu": torch.relu}[name]


# ---------------------------------------------------------------------------
# rotary position embeddings
# ---------------------------------------------------------------------------


def rope_frequencies(head_dim: int, theta: float, partial: float = 1.0, device=None) -> torch.Tensor:
    rot = int(head_dim * partial)
    rot -= rot % 2
    return 1.0 / (theta ** (torch.arange(0, rot, 2, dtype=torch.float32, device=device) / rot))


def rope_tables(positions: torch.Tensor, head_dim: int, theta: float, partial: float = 1.0):
    """(cos, sin) [..., S, rot/2] in fp32 for ``positions`` [..., S]: computed
    once per forward and shared by every layer."""
    inv = rope_frequencies(head_dim, theta, partial, device=positions.device)
    ang = positions[..., :, None].float() * inv
    return torch.cos(ang), torch.sin(ang)


def apply_rope_tables(x: torch.Tensor, tables, head_ndims: int = 1) -> torch.Tensor:
    """Rotate x [..., S, *heads, D] by :func:`rope_tables`' (cos, sin); the
    rotation is computed in fp32 and cast back to x's dtype."""
    cos, sin = (t.reshape(t.shape[:-1] + (1,) * head_ndims + t.shape[-1:]) for t in tables)
    d, rot = x.shape[-1], 2 * cos.shape[-1]
    xr, xp = x[..., :rot], x[..., rot:]
    x1, x2 = xr[..., 0::2], xr[..., 1::2]
    y1 = x1 * cos - x2 * sin
    y2 = x2 * cos + x1 * sin
    yr = torch.stack([y1, y2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([yr, xp], dim=-1) if rot < d else yr


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float, partial: float = 1.0,
               head_ndims: int = 1) -> torch.Tensor:
    """x: [..., S, *heads, D] with ``head_ndims`` head dims; positions
    broadcastable to [..., S]."""
    return apply_rope_tables(x, rope_tables(positions, x.shape[-1], theta, partial), head_ndims)


# ---------------------------------------------------------------------------
# embedding / unembedding
# ---------------------------------------------------------------------------


def init_embedding(ini: Initializer, path: str, vocab: int, d: int) -> dict:
    return {"table": ini.embedding(path, (vocab, d))}


EMBEDDING_SPECS = {"table": ("vocab", "embed")}  # :func:`init_embedding`'s, as the JAX package's


def embed(p: dict, tokens: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The rows of the table, cast to ``dtype`` (the JAX package casts the
    whole table first; the values are the same)."""
    return p["table"][tokens.long()].to(dtype)


def unembed(table_or_head: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x [..., d] @ head [d, vocab] -> logits [..., vocab] in fp32."""
    return torch.matmul(x.float(), table_or_head.float())


# ---------------------------------------------------------------------------
# losses / metrics (repro/models/common.py)
# ---------------------------------------------------------------------------


def softmax_cross_entropy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None,
                          total=None):
    """Token-level cross-entropy in fp32 with an optional mask; returns
    (mean loss, denom).  ``total`` maps this call's token count to the count
    the mean divides by (a sum over the ranks that hold the other rows)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = lse - gold
    if mask is None:
        return nll.mean(), torch.tensor(float(nll.numel()), device=nll.device)
    mask = mask.float()
    count = mask.sum()
    denom = torch.clamp(count if total is None else total(count), min=1.0)
    return (nll * mask).sum() / denom, denom


def token_accuracy(logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor | None = None):
    hit = (torch.argmax(logits, dim=-1) == labels.long()).float()
    if mask is None:
        return hit.mean()
    mask = mask.float()
    return (hit * mask).sum() / torch.clamp(mask.sum(), min=1.0)
