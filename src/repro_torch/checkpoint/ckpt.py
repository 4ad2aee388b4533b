"""Checkpoints in the JAX package's format, with numpy alone (the port of
``repro/checkpoint/ckpt.py``).

A tree of tensors (nested dicts and lists, as the port's parameters are) is
flattened to ``/``-joined key paths (``encoder/0/wx``) in JAX's order (dict
keys sorted); the leaves are grouped into ~512 MB ``.npz`` shards under
``<dir>/step_<n>/`` with a ``manifest.json`` of each shard's keys, written
into ``step_<n>.tmp/`` and renamed into place, so a reader never sees half a
step.  ``repro.checkpoint.restore_checkpoint`` and
``repro_torch.bridge.load_jax_checkpoint`` read what :func:`save_checkpoint`
writes, and :func:`restore_checkpoint` reads what the JAX writer writes.

On a process grid the ranks own different leaves: gather them first
(``ExecutionPlan.gather_params``, every rank) and write from rank 0.
"""
from __future__ import annotations

import json
import os
import shutil
from typing import Any, Optional

import numpy as np
import torch

SHARD_BYTES = 512 * 1024 * 1024


def _flatten(tree, prefix: str = "") -> dict:
    """{"a/0/b": leaf}, dict keys sorted as ``jax.tree_util`` orders them."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}{k}/"))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
        return out
    return {prefix[:-1]: tree}


def _to_numpy(leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


def save_checkpoint(ckpt_dir: str, step: int, tree: Any) -> str:
    """Writes <dir>/step_<n>/ with shard_*.npz + manifest.json; returns its path."""
    out = os.path.join(ckpt_dir, f"step_{step:08d}")
    tmp = out + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    shards, cur, cur_bytes = [], {}, 0
    for key, leaf in _flatten(tree).items():
        arr = _to_numpy(leaf)
        cur[key] = arr
        cur_bytes += arr.nbytes
        if cur_bytes >= SHARD_BYTES:
            shards.append(cur)
            cur, cur_bytes = {}, 0
    if cur:
        shards.append(cur)
    manifest = {"step": step, "shards": [], "treedef": None}
    for i, shard in enumerate(shards):
        name = f"shard_{i:04d}.npz"
        keymap = {f"a{j}": k for j, k in enumerate(shard)}  # npz keys cannot hold '/'
        np.savez(os.path.join(tmp, name), **{f"a{j}": shard[k] for j, k in enumerate(shard)})
        manifest["shards"].append({"file": name, "keys": keymap})
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(out):
        shutil.rmtree(out)
    os.rename(tmp, out)
    return out


def latest_step(ckpt_dir: str) -> Optional[int]:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(d.split("_")[1]) for d in os.listdir(ckpt_dir) if d.startswith("step_") and not d.endswith(".tmp")]
    return max(steps) if steps else None


def restore_checkpoint(ckpt_dir: str, step: int, like: Any) -> Any:
    """Restore into the structure of ``like`` (a tree of tensors): each leaf
    in ``like``'s dtype and on its device."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    flat = {}
    for shard in manifest["shards"]:
        with np.load(os.path.join(path, shard["file"])) as data:
            for npz_key, tree_key in shard["keys"].items():
                flat[tree_key] = data[npz_key]
    missing = set(_flatten(like)) - set(flat)
    if missing:
        raise KeyError(f"checkpoint missing keys: {sorted(missing)[:5]} ...")

    def fill(node, prefix):
        if isinstance(node, dict):
            return {k: fill(v, f"{prefix}{k}/") for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            return type(node)(fill(v, f"{prefix}{i}/") for i, v in enumerate(node))
        return torch.from_numpy(np.array(flat[prefix[:-1]])).to(dtype=node.dtype, device=node.device)

    return fill(like, "")
