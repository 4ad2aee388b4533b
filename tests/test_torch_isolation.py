"""Boundaries of the port: ``repro_torch`` and ``chip_smoke.py`` import
nothing of JAX or of the JAX package; entry points run on the card unless
asked for the CPU; the luong wrapper's CPU path is the plain version; the
weight bridge moves every leaf of a JAX param tree and reads the JAX
package's checkpoints.
"""
from __future__ import annotations

import dataclasses
import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.checkpoint import save_checkpoint  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels.luong_attn import ops  # noqa: E402
from repro_torch.kernels.luong_attn.ref import luong_attention_ref  # noqa: E402
from repro_torch.models import seq2seq as s2s  # noqa: E402

pytestmark = pytest.mark.torch_port

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))

_BLOCKED_IMPORTS = textwrap.dedent(
    """
    import importlib, pkgutil, sys

    class Refuse:
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in ("jax", "jaxlib", "repro"):
                raise ImportError(f"refused import of {name}")
            return None

    sys.meta_path.insert(0, Refuse())
    import repro_torch
    names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
    for n in names:
        importlib.import_module(n)
    import chip_smoke
    leaked = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not leaked, leaked
    print(len(names))
    """
)


def test_port_imports_no_jax_and_no_repro():
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.join(ROOT, "src"), ROOT]))
    res = subprocess.run([sys.executable, "-c", _BLOCKED_IMPORTS], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 15  # every module of the package was imported


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    cfg = get_config("seq2seq-rnn", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        s2s.init_seq2seq(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        s2s.init_seq2seq_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        bridge.params_from_jax({"w": np.zeros(2, np.float32)})
    from repro_torch.launch import serve as launch_serve

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--smoke"])


def test_luong_wrapper_cpu_path_is_plain_version():
    rng = np.random.default_rng(0)
    B, N, M, h = 2, 3, 5, 8
    H, S = torch.randn(B, N, h), torch.randn(B, M, h)
    mask = torch.from_numpy(rng.random((B, M)) > 0.3)
    wa, wc = torch.randn(h, h), torch.randn(2 * h, h)
    before = ops.luong_attention_fused.launches
    got = ops.luong_attention_fused(H, S, mask, wa, wc)
    assert ops.luong_attention_fused.launches == before
    assert torch.equal(got, luong_attention_ref(H, S, mask, wa, wc[:h], wc[h:]))


def _jax_tree():
    cfg = dataclasses.replace(jax_get_config("seq2seq-rnn", smoke=True), input_feeding=True)
    params, _ = js2s.init_seq2seq(jax.random.key(0), cfg)
    return jax.device_get(params)


def _assert_same_tree(tree, port):
    if isinstance(tree, dict):
        assert isinstance(port, dict) and set(port) == set(tree)
        for k in tree:
            _assert_same_tree(tree[k], port[k])
    elif isinstance(tree, (list, tuple)):
        assert isinstance(port, list) and len(port) == len(tree)
        for a, b in zip(tree, port):
            _assert_same_tree(a, b)
    else:
        arr = np.asarray(tree)
        assert isinstance(port, torch.Tensor) and tuple(port.shape) == arr.shape
        assert np.array_equal(port.numpy(), arr)


def test_bridge_round_trips_every_leaf():
    tree = _jax_tree()
    port = bridge.params_from_jax(tree, device="cpu")
    _assert_same_tree(tree, port)
    assert tuple(port["encoder"][0]["wx"].shape) == tree["encoder"][0]["wx"].shape  # [in, 4, H] kept
    back = jax.tree_util.tree_map(lambda t: t.numpy(), port, is_leaf=lambda x: isinstance(x, torch.Tensor))
    _assert_same_tree(back, port)


def test_bridge_reads_jax_checkpoint(tmp_path):
    tree = _jax_tree()
    save_checkpoint(str(tmp_path), 7, tree)
    port = bridge.load_jax_checkpoint(str(tmp_path), 7, device="cpu")
    _assert_same_tree(tree, port)
