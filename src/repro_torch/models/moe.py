"""Mixture-of-experts with top-k routing (port of the global sorted-dispatch
path of ``repro/models/moe.py``).

``apply_moe``: route each token to its top-k experts, give every (token,
expert) slot a position in its expert's group in stable order, drop the
slots past the group's capacity, gather the kept slots into a dispatch
buffer [E, C, d], run each expert's gated FFN over its rows, and combine
each token's slots with its routing weights.  A dropped slot contributes
zero (the residual stream carries the token unchanged).

The expert FFN runs on ``kernels/moe_gemm`` (``kernel="cuda"``: the CUDA
kernel on the card, its plain version on the host) or as
:func:`expert_ffn`'s einsums (``kernel="torch"``, the JAX model's own
path).  Every step is a fixed-shape tensor op with no host
synchronisation, so a decode step that runs it can be captured in a CUDA
graph.  The expert-parallel path (``apply_moe_ep``) waits for the
multi-device layout (ROADMAP queue 4).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.kernels.moe_gemm.ops import moe_gemm_fused
from repro_torch.models.common import Initializer, activation

KERNELS = ("cuda", "torch")


def init_moe(ini: Initializer, path: str, d: int, m: MoEConfig, gated: bool = True) -> dict:
    f = m.d_ff_expert
    p = {
        "router": ini.normal(path + ".router", (d, m.num_experts), scale=0.02),
        "w1": ini.normal(path + ".w1", (m.num_experts, d, f)),
        "wg": ini.normal(path + ".wg", (m.num_experts, d, f)),
        "w2": ini.normal(path + ".w2", (m.num_experts, f, d)),
    }
    if not gated:
        del p["wg"]
    return p


# ---------------------------------------------------------------------------
# routing
# ---------------------------------------------------------------------------


def route(router_w: torch.Tensor, x: torch.Tensor, m: MoEConfig):
    """x [T, d] -> (top_w [T, k] fp32, top_idx [T, k] int64, stats).

    ``stats = (frac [E], mean_prob [E])``, the two per-token-mean statistics
    of the Switch load-balance loss (:func:`aux_from_stats`)."""
    logits = torch.matmul(x.float(), router_w.float())
    probs = torch.softmax(logits, dim=-1)
    top_w, top_idx = torch.topk(probs, m.top_k, dim=-1, sorted=True)
    top_w = top_w / torch.clamp(top_w.sum(-1, keepdim=True), min=1e-9)
    E = m.num_experts
    # one_hot with num_classes does not read the indices back on the card
    frac = torch.nn.functional.one_hot(top_idx, E).sum(1).float().mean(0) / m.top_k
    return top_w, top_idx, (frac, probs.mean(0))


def aux_from_stats(stats, m: MoEConfig) -> torch.Tensor:
    """Switch-style load-balance loss from (frac, mean_prob)."""
    frac, mean_prob = stats
    return m.num_experts * torch.sum(frac * mean_prob)


# ---------------------------------------------------------------------------
# sort-based capacity dispatch
# ---------------------------------------------------------------------------


def sorted_dispatch(ids: torch.Tensor, num_groups: int, capacity: int):
    """Give each slot (token replica) with group ``ids[i]`` a position in its
    group such that a group receives at most ``capacity`` slots, in stable
    order.  Returns (dest [N] int64 in [0, capacity], keep [N] bool); dest ==
    capacity marks a dropped slot."""
    dest, keep, _ = _dispatch(ids, num_groups, capacity)
    return dest, keep


def _dispatch(ids: torch.Tensor, num_groups: int, capacity: int):
    """:func:`sorted_dispatch`, and rows (int32 [num_groups]): how many kept
    slots each group holds, min(n_g, capacity), which sit at its positions
    0 .. rows[g] - 1.  All on ids' device, with no read back to the host, so
    a decode step that runs it stays capturable in a CUDA graph."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    edges = torch.searchsorted(sorted_ids, torch.arange(num_groups + 1, dtype=ids.dtype, device=ids.device))
    starts = edges[:-1]
    pos_sorted = torch.arange(n, device=ids.device) - starts[sorted_ids]
    keep_sorted = pos_sorted < capacity
    dest_sorted = torch.where(keep_sorted, pos_sorted, capacity)
    # back to the slots' own order (order is a permutation: every slot is written)
    dest = torch.empty_like(dest_sorted).scatter_(0, order, dest_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(0, order, keep_sorted)
    rows = torch.clamp(edges[1:] - starts, max=capacity).to(torch.int32)
    return dest, keep, rows


def gather_to_groups(x_slots: torch.Tensor, ids: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor,
                     num_groups: int, capacity: int) -> torch.Tensor:
    """x_slots [N, d] -> buffer [num_groups, capacity, d], contiguous (empty
    and dropped positions zero).  Kept slots have distinct targets; every
    dropped slot writes zeros to one scratch row past the buffer, so
    duplicate writes there all write the same value."""
    d = x_slots.shape[-1]
    flat = torch.where(keep, ids * capacity + dest, num_groups * capacity)
    buf = torch.zeros((num_groups * capacity + 1, d), dtype=x_slots.dtype, device=x_slots.device)
    buf.index_copy_(0, flat, torch.where(keep[:, None], x_slots, 0))
    return buf[: num_groups * capacity].view(num_groups, capacity, d)


def scatter_from_groups(buf: torch.Tensor, ids: torch.Tensor, dest: torch.Tensor, keep: torch.Tensor) -> torch.Tensor:
    """buffer [G, C, d] -> per-slot values [N, d] (dropped slots zero).  A
    dropped slot reads row 0 and the select zeroes it, so the buffer is
    read in place, with no padded copy.  ``index_select``'s backward adds
    each slot's grad into its row (``index_add_``): a kept slot's row is its
    own, and the dropped slots add zeros to row 0, so the sums are exact in
    any order (advanced indexing's backward sorts the rows first: 40 ms a
    layer of chip_smoke.py's MoE training step on an NVIDIA H100 80GB HBM3
    at 700 W)."""
    G, C, d = buf.shape
    vals = torch.index_select(buf.reshape(G * C, d), 0, torch.where(keep, ids * C + dest, 0))
    return torch.where(keep[:, None], vals, 0)


def expert_ffn(p: dict, buf: torch.Tensor, act_name: str) -> torch.Tensor:
    """buf [E, C, d] -> [E, C, d] through each expert's (gated) FFN, in
    buf's dtype (each product rounded to it, as in the JAX package)."""
    dt = buf.dtype
    act = activation(act_name)
    h = torch.einsum("ecd,edf->ecf", buf, p["w1"].to(dt))
    if "wg" in p:
        h = act(h) * torch.einsum("ecd,edf->ecf", buf, p["wg"].to(dt))
    else:
        h = act(h)
    return torch.einsum("ecf,efd->ecd", h, p["w2"].to(dt))


def _capacity(num_slots: int, num_groups: int, factor: float) -> int:
    c = int(num_slots / num_groups * factor) + 1
    return min(max(c, 1), num_slots)


# ---------------------------------------------------------------------------
# global sorted dispatch
# ---------------------------------------------------------------------------


def apply_moe(p: dict, x: torch.Tensor, m: MoEConfig, act_name: str = "silu",
              kernel: str = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, d] -> (y [T, d], aux_loss).  ``kernel="cuda"`` runs the gated
    expert FFN on ``kernels/moe_gemm``, telling it how many rows of each
    expert's group hold a slot (the plain version and the fp32 kernel keep h
    in fp32, as the Pallas kernel does; the bf16 tensor-core kernels round
    it to bf16 between the products); ``"torch"`` on
    :func:`expert_ffn`, which rounds each product to the compute dtype."""
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if kernel == "cuda" and ("wg" not in p or act_name != "silu"):
        raise ValueError(f"the moe_gemm kernel computes the gated silu FFN; this block is "
                         f"{'gated' if 'wg' in p else 'not gated'} with {act_name!r} (use kernel='torch')")
    T, d = x.shape
    top_w, top_idx, stats = route(p["router"], x, m)
    aux = aux_from_stats(stats, m)
    k = m.top_k
    ids = top_idx.reshape(-1)  # [T*k]; slot i -> token i // k
    C = _capacity(T * k, m.num_experts, m.capacity_factor)
    dest, keep, rows = _dispatch(ids, m.num_experts, C)
    x_slots = x[:, None].expand(T, k, d).reshape(T * k, d)
    buf = gather_to_groups(x_slots, ids, dest, keep, m.num_experts, C)
    if kernel == "cuda":
        dt = buf.dtype
        y_buf = moe_gemm_fused(buf, p["w1"].to(dt), p["wg"].to(dt), p["w2"].to(dt), rows)
    else:
        y_buf = expert_ffn(p, buf, act_name)
    y_slots = scatter_from_groups(y_buf, ids, dest, keep)  # [T*k, d]
    y = torch.einsum("tkd,tk->td", y_slots.reshape(T, k, d), top_w.to(y_slots.dtype))
    return y, aux
