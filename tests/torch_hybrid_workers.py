"""Rank functions for the port's multi-rank tests (``tests/test_torch_hybrid.py``,
``tests/test_torch_layouts.py``, ``tests/test_torch_input_feeding.py``).

They run in fresh processes started by ``repro_torch.launch.mesh.spawn_grid``,
so they live at module level in an importable file that imports no JAX.
Each takes the process grid first and returns plain numpy data.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import bridge
from repro_torch.configs import get_config
from repro_torch.core.plan import ExecutionPlan
from repro_torch.launch.mesh import ProcessGrid
from repro_torch.models.common import tree_leaves
from repro_torch.optim import adam
from repro_torch.train.trainer import batch_to_device, init_train_state, make_grad_fn, make_train_step


def small_config(dropout: float = 0.0):
    """The smoke model at four layers (so it splits over four stages), fp32."""
    return dataclasses.replace(get_config("seq2seq-rnn", smoke=True), num_layers=4, dtype="float32", dropout=dropout)


WIDE = dict(num_layers=2, d_model=1024, emb_size=1024, vocab_size=2048)  # h at the FSDP floor


def wide_config(dropout: float = 0.0):
    """Two layers a side at h = emb = 1024 (the FSDP floor: the smoke widths
    shard nothing over ``data``), vocab 2048, fp32."""
    return dataclasses.replace(get_config("seq2seq-rnn", smoke=True), **WIDE, dtype="float32", dropout=dropout)


def _with_input_feeding(make):
    def config(dropout: float = 0.0):
        return dataclasses.replace(make(dropout), input_feeding=True)

    return config


# "-if": the same models with input feeding (the first decoder layer takes [emb; Hc])
CONFIGS = {"small": small_config, "wide": wide_config,
           "small-if": _with_input_feeding(small_config), "wide-if": _with_input_feeding(wide_config)}


def _stored(plan, tree) -> dict:
    """{dotted path: shape} of a tree this rank stores."""
    from repro_torch.core.plan import _paths

    return {".".join(map(str, path)): tuple(t.shape) for path, t in _paths(tree)}


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(seed)
    return g


class CountingGrid:
    """A process grid that records every all-gather, reduce-scatter and
    all-to-all made through it, as (op, axis, dim, shape of the block sent;
    an all-to-all's dim is 0); everything else is the grid's own."""

    def __init__(self, grid):
        self._grid = grid
        self.calls = []

    def __getattr__(self, name):
        return getattr(self._grid, name)

    def all_gather(self, t, axis, dim=0):
        self.calls.append(("all_gather", axis, dim, tuple(t.shape)))
        return self._grid.all_gather(t, axis, dim)

    def reduce_scatter(self, t, axis, dim=0):
        self.calls.append(("reduce_scatter", axis, dim, tuple(t.shape)))
        return self._grid.reduce_scatter(t, axis, dim)

    def all_to_all(self, t, axis):
        self.calls.append(("all_to_all", axis, 0, tuple(t.shape)))
        return self._grid.all_to_all(t, axis)


def run_cases(grid, cases: dict, params_np: dict, batch_np: dict, seed: int, config: str = "small") -> dict:
    """For each case ({"grid": (D, M), "dropout": p, "step": bool, plan
    keywords...}) on a grid of this world's size: the step's loss, token
    count and every grad leaf (gathered whole), and with "step" the grad
    norm and params after one Adam step; returned by rank 0.  With "step"
    every rank also returns the shapes of the params and Adam moments it
    stores.  The model is ``CONFIGS[config]``.  Each plan runs on a
    :class:`CountingGrid`: rank 0 also returns the step's all-gathers and
    reduce-scatters (``"calls"``, taken before the grads are gathered whole)
    and whether the plan ran tensor-parallel.  Grids of other shapes over
    the same ranks are built on the spawned one's process group."""
    grids = {grid.shape: grid}
    out = {}
    for name, case in cases.items():
        case = dict(case)
        shape = tuple(case.pop("grid"))
        if shape[0] * shape[1] != grid.world:
            continue
        if shape not in grids:
            grids[shape] = ProcessGrid(*shape, device="cpu", timeout_s=grid.timeout.total_seconds())
        g = CountingGrid(grids[shape])
        cfg = CONFIGS[config](case.pop("dropout", 0.0))
        with_step = case.pop("step", False)
        batch = batch_to_device(batch_np, "cpu")
        plan = ExecutionPlan(mesh=g, **case)
        params = plan.shard_params(bridge.params_from_jax(params_np, device="cpu"), cfg)  # this rank's blocks
        loss, extras, grads = make_grad_fn(cfg, plan)(params, batch, _generator(seed))
        res = {"loss": float(loss), "denom": float(extras["denom"]), "calls": list(g.calls),
               "tensor_parallel": plan.for_config(cfg).tensor_parallel}
        res["grads"] = [x.numpy() for x in tree_leaves(plan.gather_params(grads, cfg))]
        if with_step:
            opt = adam(lr=1e-2)
            step = make_train_step(cfg, opt, plan=plan, clip_norm=0.05)
            state, metrics = step(init_train_state(params, opt, plan=plan, cfg=cfg), batch, 1.0, _generator(seed))
            res["grad_norm"] = float(metrics["grad_norm"])
            res["params"] = [p.numpy() for p in tree_leaves(plan.gather_params(state.params, cfg))]
            res["stored"] = {"params": _stored(plan, state.params), "m": _stored(plan, state.opt_state.m),
                             "v": _stored(plan, state.opt_state.v)}
        out[name] = res if grid.rank == 0 else {k: v for k, v in res.items() if k == "stored"}
    return out


def fail_on_rank(grid, rank: int):
    """Raise on one rank while the others wait on a collective with it."""
    if grid.rank == rank:
        raise RuntimeError(f"rank {rank} fails on purpose")
    grid.all_reduce(torch.ones(())).wait()


def train_and_save(grid, ckpt_dir: str, params_np: dict, steps: int) -> None:
    """A few HYBRID pipelined steps on the smoke model, then every rank
    gathers the stages' layers and rank 0 writes the whole tree."""
    from repro_torch.checkpoint import save_checkpoint
    from repro_torch.data import MTBatchIterator, SyntheticMTTask
    from repro_torch.train import Trainer

    cfg = small_config()
    plan = ExecutionPlan(strategy="hybrid", mesh=grid, use_pipeline=True, micro_batches=2)
    it = MTBatchIterator(SyntheticMTTask(vocab_size=cfg.vocab_size, min_len=4, max_len=5), 8, seed=1, buckets=(6,))
    trainer = Trainer(cfg, adam(lr=1e-2), it, plan=plan, params=bridge.params_from_jax(params_np, device="cpu"),
                      device="cpu")
    trainer.run(steps, log=lambda line: None)
    whole = trainer.params()
    if grid.rank == 0:
        save_checkpoint(ckpt_dir, steps, whole)


def run_case_groups(grid, groups: list) -> dict:
    """``run_cases`` for each (cases, params_np, batch_np, seed, config) of
    ``groups`` in one spawn; the merged results."""
    out = {}
    for cases, params_np, batch_np, seed, config in groups:
        out.update(run_cases(grid, cases, params_np, batch_np, seed, config))
    return out


def launch_train(grid, argv: list) -> list:
    """``repro_torch.launch.train.main(argv)`` on this rank (its grid built
    on the spawned ranks' process group); rank 0 returns the trained
    parameters gathered whole, as numpy."""
    from repro_torch.launch import train

    trainer = train.main(argv)
    whole = trainer.params()
    return [p.numpy() for p in tree_leaves(whole)] if grid.rank == 0 else None
