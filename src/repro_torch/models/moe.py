"""Mixture-of-experts with top-k routing (port of ``repro/models/moe.py``).

``apply_moe``, the global sorted dispatch: route each token to its top-k
experts, give every (token, expert) slot a position in its expert's group
in stable order, drop the slots past the group's capacity, gather the kept
slots into a dispatch buffer [E, C, d], run each expert's gated FFN over its
rows, and combine each token's slots with its routing weights.  A dropped
slot contributes zero (the residual stream carries the token unchanged).
On a grid whose ranks hold blocks of the batch (DATA), each rank dispatches
its own rows but keeps the JAX package's global dispatch: the capacity is
counted over the whole batch, a slot's position is its place in the global
stable order (its position among the rank's slots plus the same expert's
slots on the ranks before it: one all-gather of an [E] count), and the
load-balance statistics are means over the grid before their product.

``apply_moe_ep``, the expert-parallel path (``repro/models/moe.py:163-220``
step for step): each rank routes its block of tokens, sends each slot to
the rank that holds its expert (an all-to-all over ``model`` at a capacity
per destination), runs its experts on what it received (a capacity per
local expert) and sends the outputs back (the inverse all-to-all).

The expert FFN runs on ``kernels/moe_gemm`` (``kernel="cuda"``: the CUDA
kernel on the card, its plain version on the host) or as
:func:`expert_ffn`'s einsums (``kernel="torch"``, the JAX model's own
path).  With no grid every step is a fixed-shape tensor op with no host
synchronisation, so a decode step that runs it can be captured in a CUDA
graph.
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.configs.base import MoEConfig
from repro_torch.core import strategy as stg
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


def moe_specs(gated: bool = True) -> dict:
    """The logical spec tree of :func:`init_moe`'s parameters, as
    ``repro/models/moe.py::init_moe`` returns it beside them: the experts on
    ``expert``, the router replicated over ``model``."""
    s = {"router": ("embed", None), "w1": ("expert", "embed", "ff"), "wg": ("expert", "embed", "ff"),
         "w2": ("expert", "ff", "embed")}
    if not gated:
        del s["wg"]
    return s


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


def _dispatch(ids: torch.Tensor, num_groups: int, capacity: int, room=None):
    """:func:`sorted_dispatch`, and rows (int32 [num_groups]): how many kept
    slots each group holds, min(n_g, capacity), which sit at its positions
    0 .. rows[g] - 1.  ``room`` ([num_groups], at most ``capacity``): how
    many slots each group still takes, if fewer than ``capacity``.  All on
    ids' device, with no read back to the host, so a decode step that runs
    it stays capturable in a CUDA graph."""
    n = ids.shape[0]
    order = torch.argsort(ids, stable=True)
    sorted_ids = ids[order]
    edges = torch.searchsorted(sorted_ids, torch.arange(num_groups + 1, dtype=ids.dtype, device=ids.device))
    starts = edges[:-1]
    pos_sorted = torch.arange(n, device=ids.device) - starts[sorted_ids]
    keep_sorted = pos_sorted < (capacity if room is None else room[sorted_ids])
    dest_sorted = torch.where(keep_sorted, pos_sorted, capacity)
    # back to the slots' own order (order is a permutation: every slot is written)
    dest = torch.empty_like(dest_sorted).scatter_(0, order, dest_sorted)
    keep = torch.empty_like(keep_sorted).scatter_(0, order, keep_sorted)
    rows = torch.clamp(edges[1:] - starts, max=capacity)
    if room is not None:
        rows = torch.minimum(rows, room)
    return dest, keep, rows.to(torch.int32)


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


def _check_kernel(p: dict, act_name: str, kernel: str) -> None:
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if kernel == "cuda" and ("wg" not in p or act_name != "silu"):
        raise ValueError(f"the moe_gemm kernel computes the gated silu FFN; this block is "
                         f"{'gated' if 'wg' in p else 'not gated'} with {act_name!r} (use kernel='torch')")


def _experts(p: dict, buf: torch.Tensor, rows: torch.Tensor, act_name: str, kernel: str) -> torch.Tensor:
    """Each expert's gated FFN over its group of ``buf`` [E, C, d], of which
    the first ``rows[e]`` rows hold a slot: on ``kernels/moe_gemm`` (the plain
    version and the fp32 kernel keep h in fp32, as the Pallas kernel does;
    the bf16 tensor-core kernels round it to bf16 between the products), or
    :func:`expert_ffn`, which rounds each product to the compute dtype."""
    if kernel == "cuda":
        dt = buf.dtype
        return moe_gemm_fused(buf, p["w1"].to(dt), p["wg"].to(dt), p["w2"].to(dt), rows)
    return expert_ffn(p, buf, act_name)


def _grid_aux(stats: tuple, m: MoEConfig, grid, loss_axis) -> torch.Tensor:
    """The whole batch's load-balance loss on a grid whose ranks hold equal
    blocks of the tokens: (frac, mean_prob) as means over every rank, taken
    before their product (their grads shared back as ``strategy.grid_mean``
    says)."""
    if grid is None or grid.world == 1:
        return aux_from_stats(stats, m)
    both = stg.grid_mean(torch.stack(stats), grid, "all", loss_axis)
    return aux_from_stats((both[0], both[1]), m)


def _global_dispatch(ids: torch.Tensor, m: MoEConfig, grid):
    """The global sorted dispatch of this rank's slots ``ids`` (its block of
    the batch's, the blocks in rank order): (dest, keep, rows, buffer
    width).  The capacity is the whole batch's; a slot is kept when its
    place in the global stable order of its expert's slots (its place among
    this rank's plus the count on the ranks before it) is below it."""
    E = m.num_experts
    n = ids.shape[0]
    C = _capacity(n * grid.world, E, m.capacity_factor)
    counts = torch.zeros(E, dtype=torch.int64, device=ids.device).scatter_add_(0, ids, torch.ones_like(ids))
    before = grid.all_gather(counts[None], "all")[:grid.index("all")].sum(0)  # the ranks before this one
    width = min(C, n)  # no rank keeps more slots of an expert than this
    dest, keep, rows = _dispatch(ids, E, width, torch.clamp(C - before, min=0, max=width))
    return dest, keep, rows, width


def apply_moe(p: dict, x: torch.Tensor, m: MoEConfig, act_name: str = "silu", kernel: str = "cuda",
              grid=None, loss_axis=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x [T, d] -> (y [T, d], aux_loss) by the global sorted dispatch.
    ``kernel="cuda"`` runs the gated expert FFN on ``kernels/moe_gemm``,
    telling it how many rows of each expert's group hold a slot;
    ``"torch"`` on :func:`expert_ffn`.  With a ``grid`` of more than one
    rank, ``x`` is this rank's block of the batch's tokens (the blocks in
    rank order, each the same size) and the dispatch is the whole batch's
    (see the module docstring); ``loss_axis`` is the grid axis over which
    the ranks' losses are terms of the step's (``strategy.grid_mean``)."""
    _check_kernel(p, act_name, kernel)
    T, d = x.shape
    E, k = m.num_experts, m.top_k
    top_w, top_idx, stats = route(p["router"], x, m)
    aux = _grid_aux(stats, m, grid, loss_axis)
    ids = top_idx.reshape(-1)  # [T*k]; slot i -> token i // k
    if grid is None or grid.world == 1:
        C = _capacity(T * k, E, m.capacity_factor)
        dest, keep, rows = _dispatch(ids, E, C)
    else:
        dest, keep, rows, C = _global_dispatch(ids, m, grid)
    x_slots = x[:, None].expand(T, k, d).reshape(T * k, d)
    buf = gather_to_groups(x_slots, ids, dest, keep, E, C)
    y_buf = _experts(p, buf, rows, act_name, kernel)
    y_slots = scatter_from_groups(y_buf, ids, dest, keep)  # [T*k, d]
    y = torch.einsum("tkd,tk->td", y_slots.reshape(T, k, d), top_w.to(y_slots.dtype))
    return y, aux


# ---------------------------------------------------------------------------
# expert parallel
# ---------------------------------------------------------------------------


def apply_moe_ep(p_local: dict, x_loc: torch.Tensor, m: MoEConfig, act_name: str, grid, axis: str = "model",
                 loss_axis=None, kernel: str = "cuda") -> Tuple[torch.Tensor, torch.Tensor]:
    """This rank's share of the expert-parallel MoE (the per-shard body of
    ``repro/models/moe.py::apply_moe_ep``): ``x_loc`` [T_loc, d] is its block
    of the tokens (the blocks in rank order over the whole grid, each the
    same size); ``p_local`` holds its block of the experts ([E/M, d, f],
    block ``index(axis)`` of ``axis``) and the whole router.  Returns (y_loc
    [T_loc, d], aux), aux the whole batch's: the statistics are means over
    the grid before their product.

    Route locally; dispatch the slots by destination rank at ``Cs =
    _capacity(T_loc * k, M, cf)`` a rank; the all-to-all over ``axis``
    (each slot's local expert id beside it, 0 for an empty position); on the
    expert side dispatch what arrived by local expert at ``Ce = _capacity(M
    * Cs, E_loc, cf)`` an expert, the empty positions into an overflow group;
    the experts' FFN with the count of each one's rows; the inverse
    all-to-all; combine."""
    _check_kernel(p_local, act_name, kernel)
    M = grid.size(axis)
    E_loc = p_local["w1"].shape[0]
    T_loc, d = x_loc.shape
    k = m.top_k
    top_w, top_idx, stats = route(p_local["router"], x_loc, m)
    aux = _grid_aux(stats, m, grid, loss_axis)
    ids = top_idx.reshape(-1)  # global expert id per slot [T_loc*k]
    dev = ids // E_loc  # destination rank per slot

    # send side: group the slots by destination rank
    Cs = _capacity(T_loc * k, M, m.capacity_factor)
    dest, keep = sorted_dispatch(dev, M, Cs)
    x_slots = x_loc[:, None].expand(T_loc, k, d).reshape(T_loc * k, d)
    send_x = gather_to_groups(x_slots, dev, dest, keep, M, Cs)  # [M, Cs, d]
    send_e = gather_to_groups((ids % E_loc + 1)[:, None], dev, dest, keep, M, Cs)  # local expert id + 1; 0: empty
    recv_x = stg.all_to_all(send_x, grid, axis)
    recv_e = grid.all_to_all(send_e, axis)

    # expert side: group what arrived by local expert
    flat_x = recv_x.reshape(M * Cs, d)
    flat_e = recv_e.reshape(M * Cs)
    valid = flat_e > 0
    eloc = torch.where(valid, flat_e - 1, E_loc)  # empty positions -> the overflow group
    Ce = _capacity(M * Cs, E_loc, m.capacity_factor)
    dest2, keep2, rows = _dispatch(eloc, E_loc + 1, Ce)
    keep2 = keep2 & valid
    buf = gather_to_groups(flat_x, eloc, dest2, keep2, E_loc + 1, Ce)[:E_loc]
    y_buf = _experts(p_local, buf, rows[:E_loc], act_name, kernel)
    y_flat = scatter_from_groups(y_buf, eloc, dest2, keep2)  # [M*Cs, d]; the overflow group's reads are zeroed

    # return trip
    back = stg.all_to_all(y_flat.reshape(M, Cs, d), grid, axis)
    y_slots = scatter_from_groups(back, dev, dest, keep)  # [T_loc*k, d]
    y = torch.einsum("tkd,tk->td", y_slots.reshape(T_loc, k, d), top_w.to(y_slots.dtype))
    return y, aux
