#!/usr/bin/env python3
"""Read ``chip_smoke.py``'s planted input-feeding faults on the CPU.  Run
from the repository root:

    PYTHONPATH=src python3 tools/input_feeding_faults.py

Two gloo processes on the CPU run the input-feeding step of MODEL at 1 x 2
(the smoke model at four layers, dropout 0.3, ``chip_smoke.py``'s batch of
64 and dropout seed) in fp32 and in bf16: sound, then with each of
``chip_smoke.IF_FAULTS`` planted in the rank's ``Sharding``.  Each step's
loss and grads (gathered whole) are held against the meshless step in the
same precision.  For each it prints the loss |diff| and the largest
per-leaf ||diff|| / ||meshless||: what phase 8c (b) reads on the card at
full width, at a width a CPU runs in seconds.  The kernels' plain versions
stand in for the kernels (CPU tensors), so the bf16 readings lack the
card's route difference per step; they show whether a fault moves the
grads more than the sound step's rounding does.
"""
from __future__ import annotations

import dataclasses
import os
import sys
import tempfile

import torch

sys.path.insert(0, os.getcwd())

import chip_smoke as cs  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.plan import ExecutionPlan  # noqa: E402
from repro_torch.launch.mesh import spawn_grid  # noqa: E402
from repro_torch.models import seq2seq as s2s  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.train.trainer import make_grad_fn  # noqa: E402

DTYPES = ("float32", "bfloat16")


def config():
    cfg = get_config("seq2seq-rnn", smoke=True)
    return dataclasses.replace(cfg, input_feeding=True, num_layers=4, dtype="float32", dropout=0.3)


def step(cfg, plan, params, batch):
    loss, _, grads = make_grad_fn(cfg, plan)(params, batch, cs._hybrid_generator("cpu"))
    return float(loss), grads


def rank(grid, ref_path: str) -> dict:
    cfg = config()
    ref = torch.load(ref_path, weights_only=False)
    whole = s2s.init_seq2seq(0, cfg, device="cpu")
    batch = cs._hybrid_batch(cfg, "cpu")
    out = {}
    for name, patch, _ in (("sound", {}, False),) + cs.IF_FAULTS:
        for dt in DTYPES:
            plan = ExecutionPlan(mesh=grid, strategy="model", compute_dtype=dt)
            with cs._planted(patch):
                loss, grads = step(cfg, plan, plan.shard_params(whole, cfg), batch)
            full = plan.gather_params(grads, cfg)
            rel, leaf = cs._grad_rel_errors(full, ref[dt]["grads"])
            out[(name, dt)] = (abs(loss - ref[dt]["loss"]), rel, leaf)
    return out


def main():
    cfg = config()
    params = s2s.init_seq2seq(0, cfg, device="cpu")
    batch = cs._hybrid_batch(cfg, "cpu")
    ref = {}
    for dt in DTYPES:
        loss, grads = step(cfg, ExecutionPlan(compute_dtype=dt), params, batch)
        ref[dt] = {"loss": loss, "grads": list(tree_leaves(grads))}
    with tempfile.TemporaryDirectory(prefix="input-feeding-faults-") as tmp:
        path = os.path.join(tmp, "ref.pt")
        torch.save(ref, path)
        res = spawn_grid(rank, 1, 2, args=(path,), device="cpu", backend="gloo", timeout_s=600)[0]
    for (name, dt), (dloss, rel, leaf) in res.items():
        print(f"MODEL 1x2 {name:32s} {dt:9s} loss |diff| {dloss:.3e}  largest ||diff|| / ||meshless|| "
              f"{rel:.3e} (leaf {leaf})")


if __name__ == "__main__":
    main()
