"""The port's LM training slice (``models/transformer.py::forward_train`` and
``chunked_ce``, the differentiable ``flash_attn`` and ``moe_gemm`` wrappers,
``Trainer``, ``perplexity``, the LM data pipeline and launcher) against the
JAX package on the CPU, at the smoke size of ``qwen3-1.7b`` (dense) and
``qwen3-moe-30b-a3b`` (MoE, the load-balance term in the loss).

Weights are made by the JAX package and bridged.  At fp32 the loss and
every grad leaf match ``jax.value_and_grad(forward_train)`` at atol 1e-4 /
rtol 1e-3 (``tests/test_torch_train.py``'s ``FP32_TOL``), on both kernel
paths (``RunCtx.kernel`` "cuda": the wrappers' ``autograd.Function``s, whose
forward and recompute backward are the plain versions on the host; "torch":
``chunked_attention`` and ``expert_ffn``) with remat on and off.  At bf16
the loss is held within 0.03 (``tests/test_torch_train.py``'s bf16 bound),
and the dense model's grad leaves within 0.1 of each leaf's max magnitude;
the MoE model's bf16 grads are not held leaf by leaf: bf16 rounding flips
some of the router's top-k picks, and JAX's own bf16 grads differ from its
fp32 grads by up to a third of a leaf's max.  The JAX reference trains on
its plain paths: its ``flash_attn`` and ``moe_gemm`` wrappers have no VJP.
The JAX initializer folds Python's salted ``hash`` of each parameter path
into its key, so the weights differ from one process to the next.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.checkpoint import restore_checkpoint as jax_restore  # noqa: E402
from repro.checkpoint import save_checkpoint as jax_save  # noqa: E402
from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import strategy as jst  # noqa: E402
from repro.core.plan import ExecutionPlan as JaxPlan  # noqa: E402
from repro.data import LMBatchIterator as JaxLMBatchIterator  # noqa: E402
from repro.data import SyntheticLMTask as JaxSyntheticLMTask  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.train import Trainer as JaxTrainer  # noqa: E402
from repro.train import perplexity as jax_perplexity  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.checkpoint import restore_checkpoint, save_checkpoint  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.plan import ExecutionPlan, LeafRole, _placed_leaves  # noqa: E402
from repro_torch.data import LMBatchIterator, SyntheticLMTask  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as moe_ops  # noqa: E402
from repro_torch.launch import mesh as launch_mesh  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.train import Trainer, perplexity  # noqa: E402
from repro_torch.train.trainer import batch_to_device, make_loss_fn  # noqa: E402

pytestmark = pytest.mark.torch_port


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """The smoke shapes are too small for torch's intra-op threads, which
    cost more than they give when pytest workers already fill the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

ARCHS = ("qwen3-1.7b", "qwen3-moe-30b-a3b")
FP32_TOL = dict(atol=1e-4, rtol=1e-3)
BF16_LOSS_TOL = 0.03
BF16_GRAD_REL = 0.1
B, S = 2, 48
CHUNKS = dict(q_chunk=16, kv_chunk=16)  # several q and kv chunks on the "torch" path at S=48


@functools.lru_cache(maxsize=None)
def _model(arch: str, dtype: str = "float32"):
    """(jax cfg, jax params, port cfg, port params): one weight set, bridged."""
    jcfg = dataclasses.replace(jax_get_config(arch, smoke=True), dtype=dtype)
    cfg = dataclasses.replace(get_config(arch, smoke=True), dtype=dtype)
    jparams, _ = jtfm.init_lm(jax.random.key(0), jcfg)
    return jcfg, jparams, cfg, bridge.params_from_jax(jax.device_get(jparams), device="cpu")


def _batch(cfg, seed: int = 0, batch: int = B, seq: int = S) -> dict:
    it = LMBatchIterator(SyntheticLMTask(cfg.vocab_size, branching=16), batch, seq, seed=seed)
    b = next(it)
    b["mask"][0, -5:] = False  # a ragged row: the mean divides by the unmasked count
    return b


def _flat_jax(tree) -> list:
    """Leaves of a JAX tree in the port's traversal order (dict insertion)."""
    out = []

    def walk(node):
        if isinstance(node, dict):
            for k in node:
                walk(node[k])
        elif isinstance(node, (list, tuple)):
            for v in node:
                walk(v)
        else:
            out.append(np.asarray(node, np.float32))

    walk(tree)
    return out


@functools.lru_cache(maxsize=None)
def _jax_value_and_grad(arch: str, dtype: str = "float32"):
    jcfg, jparams, cfg, _ = _model(arch, dtype)
    b = _batch(cfg)
    ctx = jtfm.RunCtx(mode="train", **CHUNKS)

    def f(p):
        return jtfm.forward_train(p, jcfg, jnp.asarray(b["tokens"]), jnp.asarray(b["labels"]),
                                  jnp.asarray(b["mask"]), ctx=ctx)

    (loss, extras), grads = jax.jit(jax.value_and_grad(f, has_aux=True))(jparams)
    return float(loss), {k: float(v) for k, v in extras.items()}, _flat_jax(grads)


def _port_value_and_grad(params, cfg, batch: dict, ctx):
    live = tree_map(lambda t: t.detach().requires_grad_(), params)
    t = batch_to_device(batch, "cpu")
    loss, extras = tfm.forward_train(live, cfg, t["tokens"], t["labels"], t["mask"], ctx=ctx)
    grads = torch.autograd.grad(loss, tree_leaves(live))
    return float(loss), {k: float(v) for k, v in extras.items()}, [g.numpy() for g in grads]


# ---------------------------------------------------------------------------
# forward_train: loss, ce, aux and every grad leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("remat", [True, False], ids=["remat", "no_remat"])
@pytest.mark.parametrize("kernel", ["cuda", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_forward_train_matches_jax(arch, kernel, remat):
    _, _, cfg, params = _model(arch)
    jloss, jextras, jgrads = _jax_value_and_grad(arch)
    ctx = tfm.RunCtx(mode="train", kernel=kernel, remat=remat, **CHUNKS)
    loss, extras, grads = _port_value_and_grad(params, cfg, _batch(cfg), ctx)
    assert abs(loss - jloss) < FP32_TOL["atol"], (loss, jloss)
    assert abs(extras["ce"] - jextras["ce"]) < FP32_TOL["atol"]
    assert abs(extras["aux"] - jextras["aux"]) < FP32_TOL["atol"]
    assert extras["denom"] == jextras["denom"] == B * S - 5
    if cfg.moe is not None:  # the load-balance term is in the loss
        assert extras["aux"] > 1.0
        assert abs(loss - extras["ce"] - cfg.moe.router_aux_weight * extras["aux"] / cfg.num_layers) < 1e-6
    else:
        assert extras["aux"] == 0.0 and loss == extras["ce"]
    assert len(grads) == len(jgrads)
    for i, (g, jg) in enumerate(zip(grads, jgrads)):
        np.testing.assert_allclose(g, jg, **FP32_TOL, err_msg=f"{arch} {kernel} remat={remat} leaf {i}")


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_loss_matches_jax(arch, kernel):
    _, _, cfg, params = _model(arch, "bfloat16")
    jloss, _, jgrads = _jax_value_and_grad(arch, "bfloat16")
    loss, _, grads = _port_value_and_grad(params, cfg, _batch(cfg), tfm.RunCtx(mode="train", kernel=kernel, **CHUNKS))
    assert abs(loss - jloss) < BF16_LOSS_TOL, (loss, jloss)
    assert all(g.dtype == np.float32 for g in grads)  # fp32 masters get fp32 grads
    if cfg.moe is None:
        for i, (g, jg) in enumerate(zip(grads, jgrads)):
            rel = float(np.abs(g - jg).max()) / (float(np.abs(jg).max()) + 1e-6)
            assert rel < BF16_GRAD_REL, (arch, kernel, i, rel)


def _indexed_layers(blocks, G):
    """The per-layer take by indexing each stacked leaf (``a[g]``)."""
    return [[tree_map(lambda a: a[g], blk) for blk in blocks] for g in range(G)]


@pytest.mark.parametrize("arch", ARCHS)
def test_layer_unbind_gives_the_indexed_grads_and_serving_logits(arch, monkeypatch):
    """``layer_weights`` (one unbind per stacked leaf) against indexing
    ``a[g]`` per layer: the same grads bit for bit in training, the same
    prefill and decode logits in serving."""
    _, _, cfg, params = _model(arch)
    batch = _batch(cfg)
    ctx = tfm.RunCtx(mode="train", **CHUNKS)
    toks = torch.from_numpy(batch["tokens"])

    def run():
        _, _, grads = _port_value_and_grad(params, cfg, batch, ctx)
        logits, cache = tfm.forward_prefill(params, cfg, toks[:, :40], ctx=tfm.RunCtx(mode="prefill", window=64))
        from repro_torch.serve.engine import pad_cache

        step, _ = tfm.forward_decode(params, cfg, toks[:, 40], pad_cache(cfg, cache, 48),
                                     ctx=tfm.RunCtx(mode="decode", window=64))
        return grads, logits, step

    grads, logits, step = run()
    monkeypatch.setattr(tfm, "layer_weights", _indexed_layers)
    igrads, ilogits, istep = run()
    assert all(np.array_equal(a, b) for a, b in zip(grads, igrads))
    assert torch.equal(logits, ilogits) and torch.equal(step, istep)


# ---------------------------------------------------------------------------
# chunked CE and the two differentiable kernel wrappers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("S_", [12, 16, 40, 48], ids=["below", "equal", "ragged_chunks", "multiple"])
def test_chunked_ce_matches_jax(S_):
    """chunk 16: S below and equal to it (one unembed), 40 (not a multiple:
    4 chunks of 10) and 48 (3 chunks of 16); loss, denom and the grads of x
    and the head."""
    rng = np.random.default_rng(S_)
    d, V = 32, 64
    x = rng.normal(size=(2, S_, d)).astype(np.float32)
    w = (rng.normal(size=(d, V)) / np.sqrt(d)).astype(np.float32)
    labels = rng.integers(0, V, size=(2, S_)).astype(np.int32)
    mask = rng.random((2, S_)) > 0.2
    jfun = lambda a, b: jtfm.chunked_ce(a, b, jnp.asarray(labels), jnp.asarray(mask), chunk=16)  # noqa: E731
    jl, jd = jax.jit(jfun)(x, w)
    jg = jax.jit(jax.grad(lambda a, b: jfun(a, b)[0], argnums=(0, 1)))(x, w)
    tx, tw = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    loss, denom = tfm.chunked_ce(tx, tw, torch.from_numpy(labels), torch.from_numpy(mask), chunk=16)
    gx, gw = torch.autograd.grad(loss, (tx, tw))
    assert abs(float(loss) - float(jl)) < 1e-5
    assert float(denom) == float(jd) == float(mask.sum())
    np.testing.assert_allclose(gx.numpy(), np.asarray(jg[0]), atol=1e-6, rtol=1e-4)
    np.testing.assert_allclose(gw.numpy(), np.asarray(jg[1]), atol=1e-6, rtol=1e-4)


def _reaches(out: torch.Tensor, node: str) -> bool:
    """Whether ``out``'s autograd graph holds a node named ``node``."""
    seen, todo = set(), [out.grad_fn]
    while todo:
        fn = todo.pop()
        if fn is None or fn in seen:
            continue
        seen.add(fn)
        if type(fn).__name__ == node:
            return True
        todo.extend(f for f, _ in fn.next_functions)
    return False


# (name, B, S, KV, G, D, window, flat): G=2 and 4 grouped, a window, a flat
# q layout (H query heads on KV kv heads), and S=300 (two of the plain
# version's 256-row blocks)
FLASH_CASES = [
    ("grouped", 2, 48, 2, 2, 16, None, False),
    ("window", 2, 48, 1, 4, 16, 20, False),
    ("flat", 2, 48, 2, 2, 16, None, True),
    ("two_blocks", 1, 300, 2, 2, 8, 100, False),
]


@pytest.mark.parametrize("case", FLASH_CASES, ids=[c[0] for c in FLASH_CASES])
def test_flash_attention_grads_match_jax_chunked_attention(case):
    """dq, dk, dv through ``flash_attention`` (the ``autograd.Function``: the
    plain version forward and its recompute backward on the host) against
    ``jax.grad`` of the JAX model's ``chunked_attention``."""
    _, B_, S_, KV, G, D, window, flat = case
    rng = np.random.default_rng(S_ + G)
    qshape = (B_, S_, KV * G, 1, D) if flat else (B_, S_, KV, G, D)
    q = rng.normal(size=qshape).astype(np.float32)
    k, v = (rng.normal(size=(B_, S_, KV, D)).astype(np.float32) for _ in range(2))
    w = rng.normal(size=qshape).astype(np.float32)
    qc = S_ // 3 if S_ % 3 == 0 else S_

    def jloss(q_, k_, v_):
        o = jattn.chunked_attention(q_, k_, v_, causal=True, window=window, q_chunk=qc, kv_chunk=qc)
        return jnp.sum(o * w)

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2)))(q, k, v)
    tq, tk, tv = (torch.from_numpy(a).requires_grad_() for a in (q, k, v))
    before = flash_ops.flash_attention_fused.launches
    out = flash_ops.flash_attention(tq, tk, tv, causal=True, window=window)
    assert _reaches(out, "_FlashAttentionBackward")
    grads = torch.autograd.grad((out * torch.from_numpy(w)).sum(), (tq, tk, tv))
    assert flash_ops.flash_attention_fused.launches == before  # the host runs no kernel
    for name, g, jg in zip("qkv", grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5, rtol=1e-4, err_msg=f"d{name}")


@pytest.mark.parametrize("rows_kind", [None, "mixed"])
def test_moe_gemm_grads_match_jax_expert_ffn(rows_kind):
    """dx, dw1, dwg, dw2 through ``moe_gemm_fused`` (its ``autograd.Function``)
    against ``jax.grad`` of the JAX model's ``expert_ffn`` on the buffer whose
    rows past ``rows[e]`` are zero; with rows, NaN planted there in x must
    get a grad of exactly zero, and the output there is zero."""
    rng = np.random.default_rng(3)
    E, C, d, F = 4, 6, 16, 24
    x = rng.normal(size=(E, C, d)).astype(np.float32)
    w1, wg = (rng.normal(size=(E, d, F)).astype(np.float32) / 4 for _ in range(2))
    w2 = rng.normal(size=(E, F, d)).astype(np.float32) / 5
    cot = rng.normal(size=(E, C, d)).astype(np.float32)
    rows = None if rows_kind is None else np.array([0, 6, 3, 1], np.int32)
    live = np.ones((E, C, 1), bool) if rows is None else (np.arange(C)[None, :] < rows[:, None])[..., None]

    def jloss(x_, w1_, wg_, w2_):
        out = jmoe.expert_ffn({"w1": w1_, "wg": wg_, "w2": w2_}, jnp.where(live, x_, 0.0), "silu")
        return jnp.sum(jnp.where(live, out, 0.0) * cot)

    jgrads = jax.jit(jax.grad(jloss, argnums=(0, 1, 2, 3)))(x, w1, wg, w2)
    xt = np.where(live, x, np.nan).astype(np.float32)
    ins = [torch.from_numpy(a).requires_grad_() for a in (xt, w1, wg, w2)]
    out = moe_ops.moe_gemm_fused(*ins, None if rows is None else torch.from_numpy(rows))
    assert _reaches(out, "_MoeGemmBackward")
    grads = torch.autograd.grad((out * torch.from_numpy(cot)).sum(), ins)
    dead = ~np.broadcast_to(live, (E, C, d))
    assert not out.detach().numpy()[dead].any()
    assert np.isfinite(grads[0].numpy()).all() and not grads[0].numpy()[dead].any()
    for name, g, jg in zip(("x", "w1", "wg", "w2"), grads, jgrads):
        np.testing.assert_allclose(g.numpy(), np.asarray(jg), atol=1e-5, rtol=1e-4, err_msg=f"d{name}")


# ---------------------------------------------------------------------------
# Trainer, perplexity, data, launcher, checkpoints
# ---------------------------------------------------------------------------


def test_lm_batch_iterator_yields_jax_arrays():
    task, jtask = SyntheticLMTask(300, branching=16, seed=2), JaxSyntheticLMTask(300, branching=16, seed=2)
    assert task.entropy_floor == jtask.entropy_floor
    it, jit_ = LMBatchIterator(task, 3, 20, seed=5), JaxLMBatchIterator(jtask, 3, 20, seed=5)
    for _ in range(3):
        b, jb = next(it), next(jit_)
        assert b.keys() == jb.keys() == {"tokens", "labels", "mask"}
        for k in b:
            assert b[k].dtype == jb[k].dtype and np.array_equal(b[k], jb[k]), k
        assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


@pytest.mark.parametrize("micro_batches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_trainer_loss_trajectory_matches_jax(arch, micro_batches):
    """Three steps of Adam (1e-3, clip 5.0) at fp32 on the same batches: the
    port's Trainer (kernel path) against JAX's Trainer on a meshless plan."""
    jcfg, jparams, cfg, params = _model(arch)
    steps = 3

    def it(lib):
        return lib[1](lib[0](cfg.vocab_size, branching=16), 4, 32, seed=7)

    jtrainer = JaxTrainer(jcfg, jopt.adam(lr=1e-3), it((JaxSyntheticLMTask, JaxLMBatchIterator)),
                          plan=JaxPlan(strategy=jst.Strategy.SINGLE, micro_batches=micro_batches), params=jparams,
                          seed=0)
    jtrainer.run(steps, log_every=1, log=lambda s: None)
    trainer = Trainer(cfg, adam(lr=1e-3), it((SyntheticLMTask, LMBatchIterator)),
                      plan=ExecutionPlan(micro_batches=micro_batches), params=params, seed=0, device="cpu")
    trainer.run(steps, log_every=1, log=lambda s: None)
    losses = [h["loss"] for h in trainer.history]
    np.testing.assert_allclose(losses, [h["loss"] for h in jtrainer.history], atol=1e-4, rtol=0)
    assert int(trainer.state.opt_state.step) == steps
    # the trainer trained a copy: the params passed in are as they were
    tree_map(lambda a, b: np.testing.assert_array_equal(a.numpy(), b.numpy()), params,
             bridge.params_from_jax(jax.device_get(jparams), device="cpu"))


@pytest.mark.parametrize("optimizer", ["adam", "sgd", "sgd_momentum"])
def test_donated_step_equals_the_functional_step(optimizer, monkeypatch):
    """``make_train_step(donate=True)`` (the Trainer's: each leaf updated in
    place, a slice at a time) gives the functional step's params, moments
    and metrics bit for bit over two steps; the slices are cut small here
    so every leaf spans several."""
    from repro_torch.optim import sgd
    from repro_torch.train import trainer as trainer_mod

    monkeypatch.setattr(trainer_mod, "UPDATE_CHUNK", 1000)
    _, _, cfg, params = _model("qwen3-moe-30b-a3b")
    make = {"adam": lambda: adam(lr=1e-2), "sgd": lambda: sgd(lr=0.1),
            "sgd_momentum": lambda: sgd(lr=0.1, momentum=0.9)}[optimizer]
    batches = [batch_to_device(_batch(cfg, seed=i), "cpu") for i in range(2)]
    out = []
    for donate in (False, True):
        state = trainer_mod.init_train_state(tree_map(torch.clone, params), make())
        step = trainer_mod.make_train_step(cfg, make(), clip_norm=0.5, donate=donate)
        metrics = []
        for b in batches:
            state, m = step(state, b, 1.0, None)
            metrics.append((float(m["loss"]), float(m["grad_norm"]), float(m["moe_aux"])))
        out.append((metrics, tree_leaves((state.params, state.opt_state))))
    assert out[0][0] == out[1][0]
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("arch", ARCHS)
def test_perplexity_matches_jax(arch):
    """Without remat, the CE alone: the MoE load-balance term left out."""
    jcfg, jparams, cfg, params = _model(arch)
    ppl = perplexity(params, cfg, LMBatchIterator(SyntheticLMTask(cfg.vocab_size, branching=16), 2, 32, seed=9),
                     max_batches=2)
    jppl = jax_perplexity(jparams, jcfg, JaxLMBatchIterator(JaxSyntheticLMTask(cfg.vocab_size, branching=16), 2, 32,
                                                            seed=9), max_batches=2)
    assert np.isfinite(ppl) and abs(ppl - jppl) < 1e-3 * jppl, (ppl, jppl)


@pytest.mark.parametrize("arch", ARCHS)
def test_launcher_trains_the_lm_on_cpu(arch, capsys):
    launch_train.main(["--arch", arch, "--smoke", "--device", "cpu", "--steps", "8", "--batch", "8", "--seq", "32",
                       "--lr", "3e-3", "--compute-dtype", "float32"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"arch={arch}-smoke params=") and "mesh=none" in lines[0]
    losses = [float(line.split()[3]) for line in lines[1:] if line.startswith("step")]
    assert len(losses) == 4 and losses[-1] < losses[0], losses


@pytest.mark.parametrize("arch", ARCHS)
def test_lm_checkpoint_round_trip(arch, tmp_path):
    """The port's writer read by the JAX reader and its own, and the JAX
    writer read by the port's reader and the bridge."""
    _, jparams, _, params = _model(arch)
    save_checkpoint(str(tmp_path / "port"), 3, params)
    got = jax_restore(str(tmp_path / "port"), 3, jparams)
    assert jax.tree.structure(got) == jax.tree.structure(jparams)
    assert all(np.array_equal(a, b) for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jparams)))
    like = tree_map(torch.zeros_like, params)
    back = restore_checkpoint(str(tmp_path / "port"), 3, like)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(back), tree_leaves(params)))
    jax_save(str(tmp_path / "jax"), 5, jparams)
    for tree in (restore_checkpoint(str(tmp_path / "jax"), 5, like),
                 bridge.load_jax_checkpoint(str(tmp_path / "jax"), 5, device="cpu")):
        assert [tuple(t.shape) for t in tree_leaves(tree)] == [tuple(t.shape) for t in tree_leaves(params)]
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(tree), tree_leaves(params)))


def test_lm_plan_without_a_grid_places_nothing():
    """Every leaf whole, its grad summed over no axis, kept as it is."""
    _, _, cfg, params = _model("qwen3-moe-30b-a3b")
    plan = ExecutionPlan()
    assert all(r == LeafRole(None, None) for r in plan.leaf_roles(params, cfg))
    placed = _placed_leaves(params, plan.placement(cfg))
    assert [len(p) for p in placed] == [t.dim() for t in tree_leaves(params)]
    assert not any(any(p) for p in placed)
    assert all(a is b for a, b in zip(tree_leaves(plan.shard_params(params, cfg)), tree_leaves(params)))


def _refusal(case: str):
    _, _, cfg, _ = _model("qwen3-1.7b")
    if case == "grid_plan":
        return ExecutionPlan(strategy="data", mesh=launch_mesh.make_production_mesh()).placement(cfg)
    if case == "grid_loss_fn":
        return make_loss_fn(cfg, ExecutionPlan(strategy="hybrid", mesh=launch_mesh.make_production_mesh(multi_pod=True)))
    if case == "non_attention_block":
        return tfm.block_pattern(dataclasses.replace(cfg, attn_every=2))
    if case == "learned_pos_emb":
        return tfm.init_lm(0, dataclasses.replace(cfg, learned_pos_emb=True), device="cpu")
    raise AssertionError(case)


# the grid cases keep the ids they have always had (an LM on a test grid trains now; the production mesh refuses)
@pytest.mark.parametrize("case,item", [pytest.param("grid_plan", "4\\(f\\)", id="grid_plan-4\\(d\\)"),
                                       pytest.param("grid_loss_fn", "4\\(f\\)", id="grid_loss_fn-4\\(d\\)"),
                                       ("non_attention_block", "6\\(c\\)"), ("learned_pos_emb", "6\\(d\\)")])
def test_unported_lm_paths_raise_naming_their_roadmap_item(case, item):
    """An LM trains on the test grids (``tests/test_torch_lm_grid.py``); the
    TPU pod meshes, the non-attention blocks and learned position embeddings
    still raise, each naming its ROADMAP item."""
    with pytest.raises(NotImplementedError, match=f"ROADMAP queue 1 item {item}"):
        _refusal(case)


@pytest.mark.parametrize("flags", [["--mesh", "test"], ["--pipeline"]], ids=["mesh", "pipeline"])
def test_launcher_refuses_an_lm_on_a_grid(flags, capsys):
    """What the launcher still refuses or warns of for an LM: ``--mesh pod``
    (the TPU mesh, ROADMAP queue 1 item 4(f)) and a test grid too small for
    the 48-layer MoE's training state (the per-rank reckoning names the
    smallest that fits); ``--pipeline`` warns and runs the step unpipelined
    (the JAX LM loss has no backbone to pipeline)."""
    if flags[0] == "--mesh":
        with pytest.raises(NotImplementedError, match=r"ROADMAP queue 1 item 4\(f\)"):
            launch_train.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--mesh", "pod"])
        with pytest.raises(SystemExit, match=r"= 489 GB, 244\.4 GB on a rank of the 1x2 grid under --strategy model.*"
                                             r"--grid 1x8"):
            launch_train.main(["--arch", "qwen3-moe-30b-a3b", "--device", "cpu", "--strategy", "model", *flags,
                               "--grid", "1x2"])
    else:
        launch_train.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu", "--strategy", "hybrid", *flags,
                           "--steps", "2", "--batch", "4", "--seq", "16", "--compute-dtype", "float32"])
        lines = capsys.readouterr().out.splitlines()
        assert lines[0].startswith("warning: --pipeline with --arch qwen3-1.7b") and "unpipelined" in lines[0]
        assert "pipeline=True" in lines[1] and len([ln for ln in lines if ln.startswith("step")]) == 2
    # the full MoE model's training state exceeds one card: exit before any allocation
    with pytest.raises(SystemExit, match=r"30,532,122,624 parameters x 16 B .* = 489 GB.*--num-layers"):
        launch_train.main(["--arch", "qwen3-moe-30b-a3b", "--device", "cpu"])
