"""The port's checkpoint writer and reader (``repro_torch/checkpoint``)
against the JAX package's (``repro/checkpoint/ckpt.py``): the same
``step_<n>/`` npz shards and ``manifest.json``, read across in both
directions, from the launcher, and from a grid whose stages own different
layers (rank 0 writes the whole tree)."""
from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import latest_step as jax_latest_step  # noqa: E402
from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import latest_step, restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.plan import ExecutionPlan  # noqa: E402
from repro_torch.data import MTBatchIterator, SyntheticMTTask  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import spawn_grid  # noqa: E402
from repro_torch.models import seq2seq as s2s  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from torch_hybrid_workers import small_config, train_and_save  # noqa: E402

pytestmark = pytest.mark.torch_port


def _jax_tree(num_layers=2, seed=0):
    jcfg = dataclasses.replace(jax_get_config("seq2seq-rnn", smoke=True), num_layers=num_layers)
    jparams, _ = js2s.init_seq2seq(jax.random.key(seed), jcfg)
    return jparams


def _equal(tree, jtree):
    leaves = tree_leaves(tree)
    jleaves = tree_leaves(bridge.params_from_jax(jax.device_get(jtree), device="cpu"))  # the port's leaf order
    assert len(leaves) == len(jleaves)
    for a, b in zip(leaves, jleaves):
        assert a.dtype == b.dtype and torch.equal(a.cpu(), b), (a.shape, b.shape)


def test_port_writer_is_read_by_the_jax_reader_and_the_bridge(tmp_path):
    jparams = _jax_tree(seed=1)
    params = bridge.params_from_jax(jax.device_get(jparams), device="cpu")
    path = save_checkpoint(str(tmp_path), 7, params)
    assert os.path.basename(path) == "step_00000007" and not os.path.exists(path + ".tmp")
    assert latest_step(str(tmp_path)) == jax_latest_step(str(tmp_path)) == 7
    _equal(params, jax_restore(str(tmp_path), 7, _jax_tree(seed=2)))  # restored into another tree's structure
    _equal(bridge.load_jax_checkpoint(str(tmp_path), 7, device="cpu"), jparams)


def test_jax_writer_is_read_by_the_port_reader(tmp_path):
    jparams = _jax_tree(seed=3)
    jax_save(str(tmp_path), 5, jparams)
    like = bridge.params_from_jax(jax.device_get(_jax_tree(seed=4)), device="cpu")
    _equal(restore_checkpoint(str(tmp_path), 5, like), jparams)


def test_same_files_as_the_jax_writer(tmp_path):
    """Manifest, shard names and npz keys are the JAX writer's."""
    jparams = _jax_tree(seed=5)
    jax_save(str(tmp_path / "jax"), 3, jparams)
    save_checkpoint(str(tmp_path / "port"), 3, bridge.params_from_jax(jax.device_get(jparams), device="cpu"))
    manifests = [json.loads((tmp_path / side / "step_00000003" / "manifest.json").read_text()) for side in ("jax", "port")]
    assert manifests[0] == manifests[1]
    for shard in manifests[0]["shards"]:
        with np.load(tmp_path / "jax" / "step_00000003" / shard["file"]) as a, \
                np.load(tmp_path / "port" / "step_00000003" / shard["file"]) as b:
            assert sorted(a.files) == sorted(b.files)
            for k in a.files:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


def test_restore_refuses_a_tree_with_missing_keys(tmp_path):
    params = bridge.params_from_jax(jax.device_get(_jax_tree()), device="cpu")
    save_checkpoint(str(tmp_path), 1, {"head": params["head"]})
    with pytest.raises(KeyError, match="missing keys"):
        restore_checkpoint(str(tmp_path), 1, params)


def test_launcher_ckpt_dir_writes_the_trained_params(tmp_path, capsys):
    trainer = launch_train.main(["--arch", "seq2seq-rnn", "--smoke", "--device", "cpu", "--steps", "2", "--batch", "4",
                                 "--strategy", "hybrid", "--pipeline", "--micro-batches", "2",
                                 "--ckpt-dir", str(tmp_path)])
    out = capsys.readouterr().out
    assert "pipeline=True" in out and "grid=1x1" in out
    assert f"checkpoint: {tmp_path / 'step_00000002'}" in out
    like = s2s.init_seq2seq(9, get_config("seq2seq-rnn", smoke=True), device="cpu")
    restored = restore_checkpoint(str(tmp_path), 2, like)
    for a, b in zip(tree_leaves(restored), tree_leaves(trainer.state.params)):
        assert torch.equal(a, b)


def test_rank0_writes_every_stages_layers(tmp_path):
    """On a 1 x 2 grid each stage updates only its own layers; the gathered
    checkpoint equals two meshless steps on the same batches."""
    cfg = small_config()
    jparams = jax.tree.map(np.asarray, jax.device_get(_jax_tree(num_layers=4)))
    spawn_grid(train_and_save, 1, 2, args=(str(tmp_path), jparams, 2), timeout_s=120)
    params = bridge.params_from_jax(jparams, device="cpu")
    it = MTBatchIterator(SyntheticMTTask(vocab_size=cfg.vocab_size, min_len=4, max_len=5), 8, seed=1, buckets=(6,))
    trainer = Trainer(cfg, adam(lr=1e-2), it, plan=ExecutionPlan(), params=params, device="cpu")
    trainer.run(2, log=lambda line: None)
    restored = restore_checkpoint(str(tmp_path), 2, params)
    for a, b in zip(tree_leaves(restored), tree_leaves(trainer.state.params)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-4, rtol=0)
