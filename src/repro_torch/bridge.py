"""Move ``repro`` (JAX) parameters into the port, through numpy alone.

* :func:`params_from_jax` takes a nested dict/list of numpy arrays, as
  ``jax.device_get(params)`` gives it, and returns the same tree of torch
  tensors with names and layouts kept (``encoder[0]["wx"]`` stays
  ``[in, 4, H]``).
* :func:`load_jax_checkpoint` reads a checkpoint that
  ``repro/checkpoint/ckpt.py::save_checkpoint`` wrote (``step_<n>/`` with
  ``shard_*.npz`` and ``manifest.json``; keys such as ``encoder/0/wx``) and
  rebuilds the tree, lists where a level's keys are all indices.
"""
from __future__ import annotations

import json
import os

import numpy as np
import torch

from repro_torch.models.common import resolve_device


def _to_tensor(leaf, device: torch.device) -> torch.Tensor:
    # own copy: the arrays jax.device_get returns are read-only
    return torch.from_numpy(np.array(leaf, copy=True)).to(device)


def params_from_jax(tree, *, device="cuda"):
    """Nested dict/list/tuple of arrays -> the same structure of tensors."""
    dev = resolve_device(device)

    def conv(node):
        if isinstance(node, dict):
            return {k: conv(v) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return [conv(v) for v in node]
        return _to_tensor(node, dev)

    return conv(tree)


def _nest(flat: dict):
    """{"encoder/0/wx": a, ...} -> {"encoder": [{"wx": a}, ...], ...}."""
    root: dict = {}
    for key, leaf in flat.items():
        *parents, last = key.split("/")
        node = root
        for p in parents:
            node = node.setdefault(p, {})
        node[last] = leaf

    def listify(node):
        if not isinstance(node, dict):
            return node
        out = {k: listify(v) for k, v in node.items()}
        if out and all(k.isdigit() for k in out):
            idx = sorted(out, key=int)
            if [int(i) for i in idx] != list(range(len(idx))):
                raise ValueError(f"checkpoint list indices are not 0..n-1: {idx}")
            return [out[i] for i in idx]
        return out

    return listify(root)


def load_jax_checkpoint(ckpt_dir: str, step: int, *, device="cuda"):
    """Read ``<ckpt_dir>/step_<step>/`` into the port's parameter tree."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for shard in manifest["shards"]:
        with np.load(os.path.join(path, shard["file"])) as data:
            for npz_key, tree_key in shard["keys"].items():
                flat[tree_key] = data[npz_key]
    return params_from_jax(_nest(flat), device=device)
