"""Boundaries of the port: ``repro_torch`` and ``chip_smoke.py`` import
nothing of JAX or of the JAX package; entry points run on the card unless
asked for the CPU; the luong, flash_attn and moe_gemm wrappers' CPU paths
are their plain versions, and a CUDA tensor never reaches a plain version;
the weight bridge moves every leaf of a JAX param tree (the seq2seq, the
dense LM and the MoE LM trees) and reads the JAX package's checkpoints.
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
from repro.models import transformer as jtfm  # noqa: E402
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
    assert int(res.stdout.split()[-1]) >= 43  # every module of the package was imported, the MoE slice's too


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
    from repro_torch.launch import train as launch_train
    from repro_torch.optim import adam
    from repro_torch.train import Trainer

    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--smoke"])
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        Trainer(cfg, adam(), iter(()))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_train.main(["--smoke", "--steps", "1"])


def test_luong_wrapper_cpu_path_is_plain_version():
    rng = np.random.default_rng(0)
    B, N, M, h = 2, 3, 5, 8
    H, S = torch.randn(B, N, h), torch.randn(B, M, h)
    mask = torch.from_numpy(rng.random((B, M)) > 0.3)
    wa, wc = torch.randn(h, h), torch.randn(2 * h, h)
    before = ops.luong_attention_fused.launches, dict(ops.luong_attention_fused.launches_by_route)
    got = ops.luong_attention_fused(H, S, mask, wa, wc)
    assert (ops.luong_attention_fused.launches, ops.luong_attention_fused.launches_by_route) == before
    assert torch.equal(got, luong_attention_ref(H, S, mask, wa, wc[:h], wc[h:]))


def test_luong_wrapper_sends_cuda_tensors_to_a_kernel(monkeypatch):
    """A CUDA tensor goes to the kernels' launch with the route asked for and
    never to the plain version; any device but CPU and CUDA raises."""
    g = torch.Generator().manual_seed(0)
    B, N, M, h = 2, 3, 5, 64
    S, wa, wc = torch.randn(B, M, h, generator=g), torch.randn(h, h, generator=g), torch.randn(2 * h, h, generator=g)
    mask = torch.ones(B, M, dtype=torch.bool)

    class OnTheCard:  # all the Function's forward reads before it dispatches
        device = torch.device("cuda", 0)

    class Ctx:
        def save_for_backward(self, *tensors):
            self.saved = tensors

    def refuse(*args):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(ops, "_plain", refuse)
    monkeypatch.setattr(ops, "_launch", lambda *args: ("launched", args[-1]))
    for route in (None, "decode", "wgmma", "fma"):
        assert ops._LuongHead.forward(Ctx(), OnTheCard(), S, mask, wa, wc, route) == ("launched", route)
    with pytest.raises(ValueError, match="runs on CUDA"):
        ops.luong_attention_fused(torch.randn(B, N, h).to("meta"), S, mask, wa, wc)


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


def test_lm_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import ServeEngine

    cfg = get_config("qwen3-1.7b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfm.init_lm(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfm.init_cache(cfg, 1, 8)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, tfm.init_lm(0, cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--arch", "qwen3-1.7b", "--smoke", "--engine", "static"])


@pytest.mark.parametrize("layout", ["kernel", "grouped", "flat"])
def test_flash_wrapper_cpu_path_is_plain_version(layout):
    from repro_torch.kernels.flash_attn import ops as flash_ops
    from repro_torch.kernels.flash_attn.ref import flash_attention_plain

    g = torch.Generator().manual_seed(0)
    B, S, KV, G, D = 2, 40, 2, 2, 16
    k, v = torch.randn(B * KV, S, D, generator=g), torch.randn(B * KV, S, D, generator=g)
    q = torch.randn(B * KV * G, S, D, generator=g)
    before = flash_ops.flash_attention_fused.launches
    want = flash_attention_plain(q, k, v, causal=True, window=8, group=G)
    if layout == "kernel":
        got = flash_ops.flash_attention_fused(q, k, v, causal=True, window=8, group=G)
    else:  # the same numbers in the model's layouts
        qm = q.reshape(B, KV, G, S, D).permute(0, 3, 1, 2, 4)
        if layout == "flat":
            qm = qm.reshape(B, S, KV * G, 1, D)
        km, vm = (t.reshape(B, KV, S, D).permute(0, 2, 1, 3) for t in (k, v))
        got = flash_ops.flash_attention(qm, km, vm, causal=True, window=8)
        got = got.reshape(B, S, KV, G, D).permute(0, 2, 3, 1, 4).reshape(B * KV * G, S, D)
    assert flash_ops.flash_attention_fused.launches == before
    assert torch.equal(got, want)


def test_bridge_round_trips_lm_tree():
    """Every leaf of the JAX LM tree: the stacked [G, ...] blocks, the flat
    layout's 5-D wq/wo, the qk-norm scales and the tied embedding table."""
    jcfg = dataclasses.replace(jax_get_config("qwen3-1.7b", smoke=True), num_kv_heads=2)
    tree = jax.device_get(jtfm.init_lm(jax.random.key(0), jcfg)[0])
    port = bridge.params_from_jax(tree, device="cpu")
    _assert_same_tree(tree, port)
    attn = port["blocks"][0]["attn"]
    assert tuple(attn["wq"].shape) == (2, 256, 4, 1, 64) and tuple(attn["wo"].shape) == (2, 4, 1, 64, 256)
    assert tuple(attn["q_norm"].shape) == (2, 64) and "lm_head" not in port
    back = jax.tree_util.tree_map(lambda t: t.numpy(), port, is_leaf=lambda x: isinstance(x, torch.Tensor))
    _assert_same_tree(back, port)


def test_moe_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("checks the behaviour on a host without CUDA")
    from repro_torch.launch import serve as launch_serve
    from repro_torch.models import transformer as tfm
    from repro_torch.serve import ServeEngine

    cfg = get_config("qwen3-moe-30b-a3b", smoke=True)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tfm.init_lm(0, cfg)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        ServeEngine(cfg, tfm.init_lm(0, cfg, device="cpu"))
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        launch_serve.main(["--arch", "qwen3-moe-30b-a3b", "--smoke", "--engine", "static"])


def test_moe_gemm_wrapper_cpu_path_is_plain_version(monkeypatch):
    """CPU tensors take the plain version without a launch; a CUDA tensor
    goes to the kernel's launch and never to the plain version; any other
    device raises."""
    from repro_torch.kernels.moe_gemm import ops as moe_ops
    from repro_torch.kernels.moe_gemm.ref import moe_gemm_plain

    g = torch.Generator().manual_seed(0)
    E, C, d, F = 3, 10, 24, 36
    x, w1, wg, w2 = (torch.randn(s, generator=g) for s in ((E, C, d), (E, d, F), (E, d, F), (E, F, d)))
    before = moe_ops.moe_gemm_fused.launches
    assert torch.equal(moe_ops.moe_gemm_fused(x, w1, wg, w2), moe_gemm_plain(x, w1, wg, w2))
    assert moe_ops.moe_gemm_fused.launches == before

    class OnTheCard:  # all the wrapper reads before it dispatches
        device = torch.device("cuda", 0)

    def refuse(*args):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(moe_ops, "moe_gemm_plain", refuse)
    monkeypatch.setattr(moe_ops, "_launch", lambda *args: "launched")
    assert moe_ops.moe_gemm_fused(OnTheCard(), w1, wg, w2) == "launched"
    with pytest.raises(ValueError, match="runs on CUDA"):
        moe_ops.moe_gemm_fused(x.to("meta"), w1, wg, w2)


def test_bridge_round_trips_moe_tree():
    """Every leaf of the JAX MoE LM tree: the [G, E, d, F] / [G, E, F, d]
    expert stacks, the [G, d, E] router, the flat attention layout and the
    untied head."""
    jcfg = jax_get_config("qwen3-moe-30b-a3b", smoke=True)
    tree = jax.device_get(jtfm.init_lm(jax.random.key(0), jcfg)[0])
    port = bridge.params_from_jax(tree, device="cpu")
    _assert_same_tree(tree, port)
    moe = port["blocks"][0]["moe"]
    assert tuple(moe["w1"].shape) == tuple(moe["wg"].shape) == (2, 4, 256, 128)
    assert tuple(moe["w2"].shape) == (2, 4, 128, 256) and tuple(moe["router"].shape) == (2, 256, 4)
    assert "lm_head" in port and "mlp" not in port["blocks"][0]
    back = jax.tree_util.tree_map(lambda t: t.numpy(), port, is_leaf=lambda x: isinstance(x, torch.Tensor))
    _assert_same_tree(back, port)
