"""The port's hybrid data-model parallel training step (``core/pipeline.py``,
``core/strategy.py``, the plan's grid fields, ``train/trainer.py`` on a
process grid) on gloo ranks on the CPU.

The references:

* the JAX package's meshless step (``make_grad_fn`` on a SINGLE plan), which
  the pipelined step equals by construction (the pipeline only reorders
  work); the JAX package's meshed steps fail on jax 0.9.0 (ROADMAP queue
  3), so no meshed JAX step is a reference;
* JAX's ``pipeline_lstm`` forward on a (1, 1) mesh, for the wavefront
  forward alone;
* the port's own meshless step, at dropout 0.3 (dropout cannot match
  ``jax.random.bernoulli``).

Weights come from the JAX initializer (the smoke model at four layers, so it
splits over four stages), bridged; batches of 8 with sequences of 6 from
``MTBatchIterator``.  Tolerances: fp32 loss within 1e-4 and every grad leaf
at atol 1e-4 / rtol 1e-3 (``tests/test_plan.py``'s); against the port's
meshless step the same.  Overlap and buckets on or off must be bitwise
equal.  The ranks run in two spawns (worlds of 2 and 4 processes), each
running every case of its world size, with a time limit.
"""
from __future__ import annotations

import dataclasses
import functools
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import strategy as jst  # noqa: E402
from repro.core.pipeline import pipeline_lstm as jax_pipeline_lstm  # noqa: E402
from repro.core.pipeline import stack_pipeline_params  # noqa: E402
from repro.core.plan import ExecutionPlan as JaxPlan  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro.train.trainer import make_grad_fn as jax_make_grad_fn  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core.pipeline import pipeline_lstm  # noqa: E402
from repro_torch.core.plan import ExecutionPlan  # noqa: E402
from repro_torch.data import MTBatchIterator, SyntheticMTTask  # noqa: E402
from repro_torch.kernels.lstm_cell import ops as lstm_ops  # noqa: E402
from repro_torch.kernels.luong_attn import ops as luong_ops  # noqa: E402
from repro_torch.launch.mesh import make_grid, spawn_grid  # noqa: E402
from repro_torch.models import lstm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.train.trainer import batch_to_device, init_train_state, make_grad_fn, make_train_step  # noqa: E402
from torch_hybrid_workers import fail_on_rank, run_cases, small_config  # noqa: E402

pytestmark = pytest.mark.torch_port

FP32_TOL = dict(atol=1e-4, rtol=1e-3)
SEED = 3  # the dropout generator's seed, on every rank and in the meshless reference
SPAWN_LIMIT_S = 240  # per spawn of every case of one world size

H, P, D = "hybrid", dict(use_pipeline=True), "data"
CASES = {
    # world 2
    "hybrid-1x2-gpipe-k1": dict(grid=(1, 2), strategy=H, micro_batches=1, schedule="gpipe", **P),
    "hybrid-1x2-gpipe-k2": dict(grid=(1, 2), strategy=H, micro_batches=2, schedule="gpipe", step=True, **P),
    "hybrid-1x2-1f1b-k1": dict(grid=(1, 2), strategy=H, micro_batches=1, schedule="1f1b", **P),
    "hybrid-1x2-1f1b-k2": dict(grid=(1, 2), strategy=H, micro_batches=2, schedule="1f1b", **P),
    "hybrid-1x2-zerobubble-k1": dict(grid=(1, 2), strategy=H, micro_batches=1, schedule="zerobubble", **P),
    "hybrid-1x2-zerobubble-k2": dict(grid=(1, 2), strategy=H, micro_batches=2, schedule="zerobubble", **P),
    "hybrid-1x2-1f1b-k2-torch": dict(grid=(1, 2), strategy=H, micro_batches=2, schedule="1f1b",
                                     stage_kernel="torch", **P),
    "model-1x2-gpipe-k2": dict(grid=(1, 2), strategy="model", micro_batches=2, schedule="gpipe", **P),
    "data-2x1-k1": dict(grid=(2, 1), strategy=D, micro_batches=1),
    "data-2x1-k2": dict(grid=(2, 1), strategy=D, micro_batches=2),
    "data-2x1-k2-overlap": dict(grid=(2, 1), strategy=D, micro_batches=2, overlap=True, step=True),
    "data-2x1-k2-buckets": dict(grid=(2, 1), strategy=D, micro_batches=2, overlap=True, bucket_bytes=200_000),
    "hybrid-2x1-k2": dict(grid=(2, 1), strategy=H, micro_batches=2),
    "hybrid-2x1-k2-overlap": dict(grid=(2, 1), strategy=H, micro_batches=2, overlap=True),
    "hybrid-1x2-gpipe-k2-dropout": dict(grid=(1, 2), strategy=H, micro_batches=2, schedule="gpipe", dropout=0.3, **P),
    "data-2x1-k1-dropout": dict(grid=(2, 1), strategy=D, micro_batches=1, dropout=0.3),
    # world 4
    "hybrid-1x4-gpipe-k1": dict(grid=(1, 4), strategy=H, micro_batches=1, schedule="gpipe", **P),
    "hybrid-1x4-gpipe-k2": dict(grid=(1, 4), strategy=H, micro_batches=2, schedule="gpipe", **P),
    "hybrid-1x4-1f1b-k1": dict(grid=(1, 4), strategy=H, micro_batches=1, schedule="1f1b", **P),
    "hybrid-1x4-1f1b-k2": dict(grid=(1, 4), strategy=H, micro_batches=2, schedule="1f1b", step=True, **P),
    "hybrid-1x4-zerobubble-k1": dict(grid=(1, 4), strategy=H, micro_batches=1, schedule="zerobubble", **P),
    "hybrid-1x4-zerobubble-k2": dict(grid=(1, 4), strategy=H, micro_batches=2, schedule="zerobubble", **P),
    "hybrid-2x2-gpipe-k1": dict(grid=(2, 2), strategy=H, micro_batches=1, schedule="gpipe", **P),
    "hybrid-2x2-gpipe-k2": dict(grid=(2, 2), strategy=H, micro_batches=2, schedule="gpipe", **P),
    "hybrid-2x2-1f1b-k1": dict(grid=(2, 2), strategy=H, micro_batches=1, schedule="1f1b", **P),
    "hybrid-2x2-1f1b-k2": dict(grid=(2, 2), strategy=H, micro_batches=2, schedule="1f1b", step=True, **P),
    "hybrid-2x2-zerobubble-k1": dict(grid=(2, 2), strategy=H, micro_batches=1, schedule="zerobubble", **P),
    "hybrid-2x2-zerobubble-k2": dict(grid=(2, 2), strategy=H, micro_batches=2, schedule="zerobubble", **P),
    "model-1x4-1f1b-k2": dict(grid=(1, 4), strategy="model", micro_batches=2, schedule="1f1b", **P),
    "model-2x2-gpipe-k2": dict(grid=(2, 2), strategy="model", micro_batches=2, schedule="gpipe", step=True, **P),
    "data-2x2-k2": dict(grid=(2, 2), strategy=D, micro_batches=2),
    "data-2x2-k2-overlap": dict(grid=(2, 2), strategy=D, micro_batches=2, overlap=True),
    "data-2x2-k2-buckets": dict(grid=(2, 2), strategy=D, micro_batches=2, overlap=True, bucket_bytes=200_000),
    "hybrid-2x2-1f1b-k2-dropout": dict(grid=(2, 2), strategy=H, micro_batches=2, schedule="1f1b", dropout=0.3, **P),
    "data-4x1-k1-dropout": dict(grid=(4, 1), strategy=D, micro_batches=1, dropout=0.3),
}
BITWISE = [
    ("data-2x1-k2", "data-2x1-k2-overlap", "data-2x1-k2-buckets"),
    ("hybrid-2x1-k2", "hybrid-2x1-k2-overlap"),
    ("data-2x2-k2", "data-2x2-k2-overlap", "data-2x2-k2-buckets"),
]


def _accum(case: dict) -> int:
    """The meshless step a case equals: a pipelined plan runs its microbatches
    in one wavefront (one mean), an unpipelined one accumulates them."""
    return 1 if case.get("use_pipeline") else case["micro_batches"]


@functools.lru_cache(maxsize=None)
def _model():
    """(jax cfg, jax params, numpy params, numpy batch)."""
    cfg = small_config()
    jcfg = dataclasses.replace(jax_get_config("seq2seq-rnn", smoke=True), num_layers=4, dtype="float32", dropout=0.0)
    jparams, _ = js2s.init_seq2seq(jax.random.key(0), jcfg)
    params_np = jax.tree.map(np.asarray, jax.device_get(jparams))
    task = SyntheticMTTask(vocab_size=cfg.vocab_size, min_len=4, max_len=5)
    batch = next(MTBatchIterator(task, batch_size=8, seed=0, buckets=(6,)))
    return jcfg, jparams, params_np, batch


def _generator():
    g = torch.Generator()
    g.manual_seed(SEED)
    return g


@functools.lru_cache(maxsize=None)
def _jax_meshless(k: int):
    jcfg, jparams, _, batch = _model()
    plan = JaxPlan(strategy=jst.Strategy.SINGLE, micro_batches=k)
    loss, extras, grads = jax.jit(jax_make_grad_fn(jcfg, plan))(
        jparams, {n: jnp.asarray(v) for n, v in batch.items()}, jax.random.key(5))
    leaves = [np.asarray(g, np.float32) for g in tree_leaves(bridge.params_from_jax(jax.device_get(grads), device="cpu"))]
    return float(loss), float(extras["denom"]), leaves


@functools.lru_cache(maxsize=None)
def _port_meshless(k: int, dropout: float, with_step: bool = False):
    _, _, params_np, batch = _model()
    cfg = small_config(dropout)
    params = bridge.params_from_jax(params_np, device="cpu")
    b = batch_to_device(batch, "cpu")
    plan = ExecutionPlan(micro_batches=k)
    loss, _, grads = make_grad_fn(cfg, plan)(params, b, _generator())
    out = {"loss": float(loss), "grads": [g.numpy() for g in tree_leaves(grads)]}
    if with_step:
        opt = adam(lr=1e-2)
        state, metrics = make_train_step(cfg, opt, plan=plan, clip_norm=0.05)(
            init_train_state(params, opt, plan=plan, cfg=cfg), b, 1.0, _generator())
        out["grad_norm"] = float(metrics["grad_norm"])
        out["params"] = [p.numpy() for p in tree_leaves(state.params)]
    return out


@pytest.fixture(scope="module")
def results():
    """Every case, run on gloo ranks: one spawn of 2 processes, one of 4."""
    _, _, params_np, batch = _model()
    out = {}
    for world, shape in ((2, (1, 2)), (4, (1, 4))):
        t0 = time.monotonic()
        (res, *_) = spawn_grid(run_cases, *shape, args=(CASES, params_np, batch, SEED), timeout_s=SPAWN_LIMIT_S)
        assert time.monotonic() - t0 < SPAWN_LIMIT_S
        out.update(res)
    assert set(out) == set(CASES)
    return out


def _close(got: list, want: list, what: str, tol=FP32_TOL):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.float32, (what, i, g.dtype)
        np.testing.assert_allclose(g, w, **tol, err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if not c.get("dropout")])
def test_step_matches_jax_meshless(results, name):
    """Loss, token count and every grad leaf of the multi-rank step against
    the JAX package's meshless step, at fp32 and dropout 0."""
    got = results[name]
    loss, denom, grads = _jax_meshless(_accum(CASES[name]))
    assert abs(got["loss"] - loss) < 1e-4, (got["loss"], loss)
    assert got["denom"] == denom == float(_model()[3]["tgt_mask"].sum())
    _close(got["grads"], grads, name)


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c.get("dropout")])
def test_step_matches_port_meshless_with_dropout(results, name):
    """At dropout 0.3 the ranks draw each layer's mask for the whole batch in
    the meshless generator order and keep their rows: the step equals the
    port's meshless step with the same generator seed."""
    got = results[name]
    want = _port_meshless(_accum(CASES[name]), CASES[name]["dropout"])
    no_dropout = _port_meshless(_accum(CASES[name]), 0.0)
    # the masks matter: without them some grad leaf misses the tolerance
    assert not all(np.allclose(a, b, **FP32_TOL) for a, b in zip(want["grads"], no_dropout["grads"]))
    assert abs(got["loss"] - want["loss"]) < 1e-4, (got["loss"], want["loss"])
    _close(got["grads"], want["grads"], name)


@pytest.mark.parametrize("names", BITWISE, ids=["-vs-".join(n) for n in BITWISE])
def test_overlap_and_buckets_are_bitwise_equal(results, names):
    """The delayed and bucketed all-reduces move only when each one runs."""
    first = results[names[0]]
    for name in names[1:]:
        assert results[name]["loss"] == first["loss"], name
        for i, (a, b) in enumerate(zip(results[name]["grads"], first["grads"])):
            assert np.array_equal(a, b), (name, i)


@pytest.mark.parametrize("name", [n for n, c in CASES.items() if c.get("step")])
def test_adam_step_matches_meshless(results, name):
    """One step of Adam (lr 1e-2, clip 0.05, so the clip binds): the grid's
    global norm and every parameter, each from its owner, against the port's
    meshless step.  Adam's first step moves a weight by lr * g / (|g| + eps):
    a grad that differs by the fp32 tolerance moves it by at most
    lr * atol / eps's fraction of lr, so the params are held to lr * 1e-2."""
    got = results[name]
    want = _port_meshless(_accum(CASES[name]), 0.0, with_step=True)
    assert abs(got["grad_norm"] - want["grad_norm"]) < 1e-4 * want["grad_norm"]
    assert want["grad_norm"] > 0.05  # the clip binds
    _close(got["params"], want["params"], f"{name} params", tol=dict(atol=1e-4, rtol=0))


def test_a_failed_rank_fails_the_run():
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match="(?s)rank 1 of a 1 x 2 grid failed first.*rank 1 fails on purpose"):
        spawn_grid(fail_on_rank, 1, 2, args=(1,), timeout_s=60)
    assert time.monotonic() - t0 < 60


# ---------------------------------------------------------------------------
# in process, on the trivial (1, 1) grid
# ---------------------------------------------------------------------------


@pytest.fixture
def grid11():
    with make_grid(1, 1, device="cpu") as grid:
        yield grid


@pytest.mark.parametrize("schedule", ["gpipe", "1f1b"])
def test_wavefront_forward_matches_jax_pipeline_lstm(grid11, schedule):
    """The port's wavefront forward (k=2) on the (1, 1) grid against JAX's
    ``pipeline_lstm`` on a (1, 1) mesh, over the encoder's layers at fp32."""
    jcfg, jparams, params_np, _ = _model()
    x = np.random.default_rng(1).normal(size=(4, 5, jcfg.emb_size)).astype(np.float32)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    stacked, _ = stack_pipeline_params(jparams["encoder"], 1)
    want = jax_pipeline_lstm(mesh, stacked, jnp.asarray(x), in_dim=jcfg.emb_size, micro_batches=2, schedule=schedule)
    layers = bridge.params_from_jax(params_np["encoder"], device="cpu")
    got = pipeline_lstm(grid11, layers, torch.from_numpy(x), micro_batches=2, schedule=schedule)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


def test_pipelined_step_on_the_trivial_grid_equals_the_meshless_step(grid11):
    """One stage: the wavefront is the meshless loop in another order; no
    collective is called and the CPU tensors run no kernel."""
    _, _, params_np, batch = _model()
    cfg = small_config()
    params = bridge.params_from_jax(params_np, device="cpu")
    b = batch_to_device(batch, "cpu")
    before = (lstm_ops.lstm_cell_fused.launches, luong_ops.luong_attention_fused.launches)
    want = make_grad_fn(cfg, ExecutionPlan())(params, b)
    for schedule in ("gpipe", "1f1b", "zerobubble", "interleaved"):
        plan = ExecutionPlan(strategy="hybrid", mesh=grid11, use_pipeline=True, micro_batches=1, schedule=schedule)
        got = make_grad_fn(cfg, plan)(params, b)
        assert float(got[0]) == float(want[0])
        for a, w in zip(tree_leaves(got[2]), tree_leaves(want[2])):
            assert torch.equal(a, w), schedule  # one microbatch: the same sums in the same order
    assert (lstm_ops.lstm_cell_fused.launches, luong_ops.luong_attention_fused.launches) == before


@pytest.mark.parametrize("stage_kernel", lstm.STAGE_KERNELS)
def test_wavefront_weight_grads_are_fp32_sums_over_timesteps(grid11, stage_kernel):
    """bf16 over 32 timesteps, two microbatches: the wavefront's weight grads
    (summed over the ticks in fp32 by its backward) against JAX's scan that
    sums the steps' bf16-rounded terms in fp32, at 2^-8 of the largest JAX
    grad (``test_torch_lstm_cell.py``'s check of the meshless layer loop, on
    its inputs and reference)."""
    from test_torch_lstm_cell import _jax_meshless_bf16_loss, _one_layer, jax_fused

    B, S, In, Hd = 4, 32, 8, 16
    layer, xs, w_out = _one_layer(7, B, S, In, Hd)
    bf16 = jnp.bfloat16

    def jloss(p, x):
        if stage_kernel == "torch":
            return _jax_meshless_bf16_loss(p, x.astype(jnp.float32), w_out)

        def step(carry, x_t):
            h, c = jax_fused(x_t, *carry, p["wx"].astype(bf16), p["wh"].astype(bf16), p["b"].astype(bf16),
                             interpret=True)
            return (h, c), h.astype(bf16)

        z = jnp.zeros((B, Hd), jnp.float32)
        _, hs = jax.lax.scan(step, (z, z), jnp.swapaxes(x, 0, 1))
        return jnp.sum(jnp.swapaxes(hs, 0, 1).astype(jnp.float32) * w_out)

    jg = jax.grad(jloss)({k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(xs, bf16))
    masters = {k: torch.from_numpy(v).requires_grad_() for k, v in layer.items()}
    hs = pipeline_lstm(grid11, [masters], torch.from_numpy(xs).to(torch.bfloat16), micro_batches=2,
                       stage_kernel=stage_kernel)
    grads = torch.autograd.grad((hs.float() * torch.from_numpy(w_out)).sum(), [masters[k] for k in ("wx", "wh", "b")])
    for name, g in zip(("wx", "wh", "b"), grads):
        want = np.asarray(jg[name], np.float32)
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), want, atol=2.0**-8 * np.abs(want).max(), rtol=0, err_msg=name)
