"""Rank functions for the port's multi-rank tests (``tests/test_torch_hybrid.py``).

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


def _generator(seed: int) -> torch.Generator:
    g = torch.Generator()
    g.manual_seed(seed)
    return g


def run_cases(grid, cases: dict, params_np: dict, batch_np: dict, seed: int) -> dict:
    """For each case ({"grid": (D, M), "dropout": p, "step": bool, plan
    keywords...}) on a grid of this world's size: the step's loss, token
    count and every grad leaf (each from its owner), and with "step" the
    grad norm and params after one Adam step; returned by rank 0.  Grids of
    other shapes over the same ranks are built on the spawned one's
    process group."""
    grids = {grid.shape: grid}
    out = {}
    for name, case in cases.items():
        case = dict(case)
        shape = tuple(case.pop("grid"))
        if shape[0] * shape[1] != grid.world:
            continue
        if shape not in grids:
            grids[shape] = ProcessGrid(*shape, device="cpu", timeout_s=grid.timeout.total_seconds())
        g = grids[shape]
        cfg = small_config(case.pop("dropout", 0.0))
        with_step = case.pop("step", False)
        params = bridge.params_from_jax(params_np, device="cpu")
        batch = batch_to_device(batch_np, "cpu")
        plan = ExecutionPlan(mesh=g, **case)
        loss, extras, grads = make_grad_fn(cfg, plan)(params, batch, _generator(seed))
        res = {"loss": float(loss), "denom": float(extras["denom"]),
               "grads": [x.numpy() for x in tree_leaves(plan.gather_params(grads))]}
        if with_step:
            opt = adam(lr=1e-2)
            step = make_train_step(cfg, opt, plan=plan, clip_norm=0.05)
            state, metrics = step(init_train_state(params, opt, plan=plan, cfg=cfg), batch, 1.0, _generator(seed))
            res["grad_norm"] = float(metrics["grad_norm"])
            res["params"] = [p.numpy() for p in tree_leaves(plan.gather_params(state.params))]
        out[name] = res
    return out if grid.rank == 0 else None


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
