"""Rank functions for ``tests/test_torch_lm_grid.py``: the dense and MoE LMs
trained on a grid of gloo ranks.

They run in fresh processes started by ``repro_torch.launch.mesh.spawn_grid``,
so they live at module level in an importable file that imports no JAX.
Each takes the process grid first and returns plain numpy data (rank 0's
results; the other ranks return what a test reads of them).
"""
from __future__ import annotations

import contextlib
import dataclasses
import io

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.core import strategy as stg
from repro_torch.core.plan import ExecutionPlan
from repro_torch.launch.mesh import ProcessGrid
from repro_torch.models import moe
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adam
from repro_torch.train import Trainer
from repro_torch.train.trainer import batch_to_device, make_grad_fn

# the smoke models with GQA at G = 4 (8 q heads on 2 kv heads: kv sharded at 2 ranks, whole at 4), fp32
GQA = dict(num_heads=8, num_kv_heads=2, head_dim=32, dtype="float32")
# a dense model at d = 1024, the FSDP floor: HYBRID_OPT shards its big dims over `data`
WIDE = dict(d_model=1024, emb_size=1024, num_heads=8, num_kv_heads=2, head_dim=128, d_ff=1024, vocab_size=1024,
            dtype="float32")
AMPLE, TIGHT = 64.0, 1.0  # the MoE's capacity factors: no slot dropped, and slots dropped


def replacements(config: str) -> dict:
    """The ``dataclasses.replace`` changes of test config ``config`` to its
    arch's smoke config (the same on the JAX side); the MoE's capacity
    factor under ``"moe"`` (a MoEConfig field)."""
    return {"dense": dict(GQA), "wide": dict(WIDE), "moe-ample": dict(GQA, moe=AMPLE),
            "moe-tight": dict(GQA, moe=TIGHT)}[config]


def arch_of(config: str) -> str:
    return "qwen3-moe-30b-a3b" if config.startswith("moe") else "qwen3-1.7b"


def replaced(cfg, changes: dict):
    """``cfg`` with ``changes`` (``replacements``) made; works on either
    package's config."""
    changes = dict(changes)
    if "moe" in changes:
        changes["moe"] = dataclasses.replace(cfg.moe, capacity_factor=changes["moe"])
    return dataclasses.replace(cfg, **changes)


def port_config(config: str):
    return replaced(get_config(arch_of(config), smoke=True), replacements(config))


def to_tensors(tree):
    if isinstance(tree, dict):
        return {k: to_tensors(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_tensors(v) for v in tree]
    return torch.from_numpy(np.array(tree))


# ---------------------------------------------------------------------------
# planted faults (each must make a layout miss the meshless step)
# ---------------------------------------------------------------------------


def _own_dispatch(ids, m, grid):
    """DATA's fault: this rank's own capacity and positions."""
    C = moe._capacity(ids.shape[0], m.num_experts, m.capacity_factor)
    dest, keep, rows = moe._dispatch(ids, m.num_experts, C)
    return dest, keep, rows, C


def _product_then_mean(stats, m, grid, loss_axis):
    """The load-balance statistics multiplied on each rank, the products averaged."""
    if grid is None or grid.world == 1:
        return moe.aux_from_stats(stats, m)
    return stg.grid_mean(moe.aux_from_stats(stats, m), grid, "all", loss_axis)


def _unsummed(x, grid, axis):
    """One row-parallel partial not summed over ``model``."""
    return x


FAULTS = {"own_capacity": (moe, "_global_dispatch", _own_dispatch),
          "product_before_mean": (moe, "_grid_aux", _product_then_mean),
          "partial_not_summed": (stg, "sum_from_model", _unsummed)}


@contextlib.contextmanager
def planted(name):
    if name is None:
        yield
        return
    module, attr, fn = FAULTS[name]
    old = getattr(module, attr)
    setattr(module, attr, fn)
    try:
        yield
    finally:
        setattr(module, attr, old)


# ---------------------------------------------------------------------------
# rank functions
# ---------------------------------------------------------------------------


def _grid(grids: dict, grid, shape: tuple):
    if shape not in grids:
        grids[shape] = ProcessGrid(*shape, device="cpu", timeout_s=grid.timeout.total_seconds())
    return grids[shape]


def _calls(grid):
    """A grid that counts its all-to-alls (the MoE's exchanges)."""
    from torch_hybrid_workers import CountingGrid

    return CountingGrid(grid)


def layout_cases(grid, grids: dict, cases: dict, models: dict, batches: dict) -> dict:
    """For each case ({"config", "grid": (D, M), "fault": name or None, plan
    keywords...}) of this world's size: one fp32 step of ``make_grad_fn`` on
    this rank's blocks of ``models[config]`` (a numpy tree) and rows of
    ``batches[config]``; rank 0 returns the loss, aux, denom, every grad
    leaf gathered whole and the step's all-to-alls."""
    out = {}
    for name, case in cases.items():
        case = dict(case)
        config, shape, fault = case.pop("config"), tuple(case.pop("grid")), case.pop("fault", None)
        if shape[0] * shape[1] != grid.world:
            continue
        g = _calls(_grid(grids, grid, shape))
        cfg = port_config(config)
        plan = ExecutionPlan(mesh=g, **case)
        params = plan.shard_params(to_tensors(models[config]), cfg)
        with planted(fault):
            loss, extras, grads = make_grad_fn(cfg, plan)(params, batch_to_device(batches[config], "cpu"))
        calls = [c for c in g.calls if c[0] == "all_to_all"]
        whole = plan.gather_params(grads, cfg)
        if grid.rank == 0:
            out[name] = {"loss": float(loss), "aux": float(extras["aux"]), "denom": float(extras["denom"]),
                         "grads": [x.numpy() for x in tree_leaves(whole)], "all_to_all": calls,
                         "tensor_parallel": plan.for_config(cfg).tensor_parallel}
    return out


def all_to_all_check(grid, grids: dict, axis: str = "model") -> dict:
    """``ProcessGrid.all_to_all`` of each rank's [M * 2, 3] blocks and the
    backward of ``strategy.all_to_all``: rank r's block j holds r * 100 + j."""
    M, r = grid.size(axis), grid.index(axis)
    x = (r * 100 + torch.arange(M, dtype=torch.float32)).repeat_interleave(2)[:, None].expand(2 * M, 3).contiguous()
    y = grid.all_to_all(x, axis)
    live = x.clone().requires_grad_()
    w = torch.arange(2 * M * 3, dtype=torch.float32).reshape(2 * M, 3) + 1000 * r
    (g,) = torch.autograd.grad((stg.all_to_all(live, grid, axis) * w).sum(), live)
    return {"y": y.numpy(), "grad": g.numpy(), "w_back": grid.all_to_all(w, axis).numpy(), "rank": r}


def moe_ep_case(grid, grids: dict, shape: tuple, m, x_np, p_np, cot_np, aux_weight: float) -> dict:
    """``models/moe.py::apply_moe_ep`` on this rank's block of the tokens
    ``x_np`` [T, d] (blocks over the whole grid, data-major) and of the
    experts (over ``model``), fp32, ``kernel="cuda"`` (the plain version on
    the host); the loss sum(y * cot) + aux_weight * aux, each rank's term
    with aux counted once.  Returns the rank's output block, aux, which of
    its slots were kept end to end, and (rank 0) the grads of x, the router
    and the experts, gathered whole."""
    grid = _grid(grids, grid, shape)
    N, M = grid.world, grid.size("model")
    T = x_np.shape[0] // N
    lo = grid.index("all") * T
    E_loc = p_np["w1"].shape[0] // M
    mine = slice(grid.index("model") * E_loc, (grid.index("model") + 1) * E_loc)
    x = torch.from_numpy(x_np[lo:lo + T].copy()).requires_grad_()
    p = {k: torch.from_numpy((v if k == "router" else v[mine]).copy()).requires_grad_() for k, v in p_np.items()}
    kept = {}
    dispatch = moe._dispatch

    def spy(ids, num_groups, capacity, room=None):  # the send side's keep (first call), the expert side's (second)
        res = dispatch(ids, num_groups, capacity, room)
        kept.setdefault("send" if "send" not in kept else "expert", (ids, res))
        return res

    moe._dispatch = spy
    try:
        y, aux = moe.apply_moe_ep(p, x, m, "silu", grid, "model", loss_axis="all", kernel="cuda")
    finally:
        moe._dispatch = dispatch
    loss = (y * torch.from_numpy(cot_np[lo:lo + T].copy())).sum() + aux_weight * aux / N
    grads = torch.autograd.grad(loss, [x] + [p[k] for k in ("router", "w1", "wg", "w2")])
    gx, grouter, *gexp = [g.contiguous() for g in grads]
    grid.all_reduce(grouter, "all").wait()
    for g in gexp:
        grid.all_reduce(g, "data").wait()
    gx = grid.all_gather(gx, "all")
    gexp = [grid.all_gather(g, "model") for g in gexp]
    # the slots this rank kept end to end: kept on the send side, and kept by the expert side it reached
    dev, (dest, keep, _) = kept["send"]
    eloc, (_, keep2, _) = kept["expert"]
    Cs = moe._capacity(T * m.top_k, M, m.capacity_factor)
    back = keep2 & (eloc < E_loc)  # at each received position: kept by its expert
    back = grid.all_to_all(back.reshape(M, Cs).to(torch.int64), "model").reshape(M * Cs)  # back to the senders
    final = keep & (back[dev * Cs + torch.clamp(dest, max=Cs - 1)] > 0)
    out = {"y": y.detach().numpy(), "aux": float(aux.detach()), "kept": final.numpy(), "send_kept": keep.numpy()}
    if grid.rank == 0:
        out["grads"] = [g.numpy() for g in [gx, grouter, *gexp]]
    return out


def trainer_run(grid, grids: dict, config: str, shape: tuple, strategy: str, params_np, batches: list) -> dict:
    """Three fp32 Adam steps through ``Trainer`` on a grid of ``shape``; rank 0
    returns the losses and grad norms."""
    cfg = port_config(config)
    plan = ExecutionPlan(strategy=strategy, mesh=_grid(grids, grid, shape))
    trainer = Trainer(cfg, adam(lr=1e-3), iter(batches), plan=plan, params=to_tensors(params_np), device="cpu")
    trainer.run(len(batches), log_every=1, log=lambda line: None)
    if grid.rank != 0:
        return {}
    return {"loss": [h["loss"] for h in trainer.history], "grad_norm": [h["grad_norm"] for h in trainer.history]}


def launch_lines(grid, grids: dict, argv: list) -> list:
    """``repro_torch.launch.train.main(argv)`` on this rank (its grid built on
    the spawned ranks' process group): what it printed."""
    from repro_torch.launch import train

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        train.main(argv)
    return buf.getvalue().splitlines()


def run_all(grid, jobs: list) -> dict:
    """Every job of one spawn, in order: (key, function name, arguments);
    each function takes the spawned grid and the grids of other shapes built
    on its process group (shared by the jobs) first."""
    grids = {grid.shape: grid}
    return {key: globals()[fn](grid, grids, *args) for key, fn, args in jobs}
