"""The paper's input-feeding step (HybridNMTIF) on the port's grids: the
decoder runs step-major, every layer of step t on this rank's column shards
(each cell followed by one all-gather of h over ``model``), then eq. 1-4 of
step t on this rank's row block of its data shard and one all-gather of Hc
over ``model``; eq. 1-5 then run once over all steps through each layout's
phase-2 path.  On gloo ranks on the CPU.

The references:

* the JAX package's meshless input-feeding step (``make_grad_fn`` on a SINGLE
  plan, fp32, dropout 0), which every layout equals by construction (JAX's
  meshed steps fail on jax 0.9.0, ROADMAP queue 3);
* the port's own meshless step, at dropout 0.3 (the encoder's masks cannot
  match ``jax.random.bernoulli``) and for one Adam step;
* the JAX placement rule, ``repro.core.strategy.resolve_specs``, for the
  placement of a pipelined plan under input feeding.

Two models with ``input_feeding=True``: the smoke model at four layers and
``tests/test_torch_layouts.py``'s wide config (h = emb = 1024, vocab 2048),
on which HYBRID_OPT shards decoder layer 0's [2048, 4, 1024] ``wx`` over
``data``.  Weights come from the JAX initializer, bridged; batches of 8 with
sequences of 6 from ``MTBatchIterator``.  Tolerances: fp32 loss within 1e-4
and every grad leaf, gathered whole, at atol 1e-4 / rtol 1e-3
(``tests/test_torch_hybrid.py``'s).  The ranks run in two spawns (worlds of 2
and 4 processes), each running every case of its world size under a time
limit of 150 s; both spawns together, with the JAX models' set-up, took
44-92 s on one process (the whole file 57-126 s, on a shared machine).
"""
from __future__ import annotations

import collections
import dataclasses
import functools
import time
from types import SimpleNamespace

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import strategy as jst  # noqa: E402
from repro.core.plan import ExecutionPlan as JaxPlan  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro.train.trainer import make_grad_fn as jax_make_grad_fn  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.core import strategy as stg  # noqa: E402
from repro_torch.core.plan import ExecutionPlan  # noqa: E402
from repro_torch.data import MTBatchIterator, SyntheticMTTask  # noqa: E402
from repro_torch.kernels.lstm_cell import ops as lstm_ops  # noqa: E402
from repro_torch.launch.mesh import make_grid, spawn_grid  # noqa: E402
from repro_torch.models import seq2seq as s2s  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.train.trainer import batch_to_device, init_train_state, make_grad_fn, make_train_step  # noqa: E402
from torch_hybrid_workers import CONFIGS, WIDE, run_case_groups  # noqa: E402

pytestmark = pytest.mark.torch_port

FP32_TOL = dict(atol=1e-4, rtol=1e-3)
SEED = 3  # the dropout generator's seed, on every rank and in the meshless reference
SPAWN_LIMIT_S = 150  # per spawn of every case of one world size

SMALL = {
    "model-1x2": dict(grid=(1, 2), strategy="model"),
    "model-1x2-torch": dict(grid=(1, 2), strategy="model", stage_kernel="torch"),
    "hybrid-1x2": dict(grid=(1, 2), strategy="hybrid", step=True),
    "hybrid-2x2": dict(grid=(2, 2), strategy="hybrid"),
    "hybrid-1x4": dict(grid=(1, 4), strategy="hybrid", step=True),
    "hybrid-pipelined-1x2-k2": dict(grid=(1, 2), strategy="hybrid", use_pipeline=True, micro_batches=2),
    "hybrid-1x2-k2": dict(grid=(1, 2), strategy="hybrid", micro_batches=2),
    "hybrid-1x2-dropout": dict(grid=(1, 2), strategy="hybrid", dropout=0.3),
    "model-2x2-dropout": dict(grid=(2, 2), strategy="model", dropout=0.3),
}
WIDE_CASES = {
    "opt-wide-1x2": dict(grid=(1, 2), strategy="hybrid_opt"),
    "opt-wide-2x1": dict(grid=(2, 1), strategy="hybrid_opt", step=True),
    "opt-wide-2x2": dict(grid=(2, 2), strategy="hybrid_opt"),
}
CASES = {**{n: ("small-if", c) for n, c in SMALL.items()}, **{n: ("wide-if", c) for n, c in WIDE_CASES.items()}}


def _accum(case: dict) -> int:
    """The meshless step a case equals: a pipelined plan runs one forward
    and backward (one mean), an unpipelined one accumulates its microbatches."""
    return 1 if case.get("use_pipeline") else case.get("micro_batches", 1)


def _jax_cfg(config: str):
    base = dataclasses.replace(jax_get_config("seq2seq-rnn", smoke=True), dtype="float32", dropout=0.0,
                               input_feeding=True)
    return dataclasses.replace(base, num_layers=4) if config == "small-if" else dataclasses.replace(base, **WIDE)


@functools.lru_cache(maxsize=None)
def _model(config: str):
    """(jax cfg, jax params, numpy params, numpy batch)."""
    jcfg = _jax_cfg(config)
    jparams, _ = js2s.init_seq2seq(jax.random.key(0), jcfg)
    params_np = jax.tree.map(np.asarray, jax.device_get(jparams))
    task = SyntheticMTTask(vocab_size=jcfg.vocab_size, min_len=4, max_len=5)
    batch = next(MTBatchIterator(task, batch_size=8, seed=0, buckets=(6,)))
    return jcfg, jparams, params_np, batch


def _generator():
    g = torch.Generator()
    g.manual_seed(SEED)
    return g


@functools.lru_cache(maxsize=None)
def _jax_meshless(config: str, k: int):
    jcfg, jparams, _, batch = _model(config)
    plan = JaxPlan(strategy=jst.Strategy.SINGLE, micro_batches=k)
    loss, extras, grads = jax.jit(jax_make_grad_fn(jcfg, plan))(
        jparams, {n: jnp.asarray(v) for n, v in batch.items()}, jax.random.key(5))
    leaves = [np.asarray(g, np.float32) for g in tree_leaves(bridge.params_from_jax(jax.device_get(grads), device="cpu"))]
    return float(loss), float(extras["denom"]), leaves


@functools.lru_cache(maxsize=None)
def _port_meshless(config: str, k: int, dropout: float, with_step: bool = False):
    _, _, params_np, batch = _model(config)
    cfg = CONFIGS[config](dropout)
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
    """Every case, run on gloo ranks: one spawn of 2 processes, one of 4;
    rank 0's results."""
    out = {}
    for world, shape in ((2, (1, 2)), (4, (1, 4))):
        groups = []
        for config, cases in (("small-if", SMALL), ("wide-if", WIDE_CASES)):
            mine = {n: c for n, c in cases.items() if c["grid"][0] * c["grid"][1] == world}
            if mine:
                _, _, params_np, batch = _model(config)
                groups.append((mine, params_np, batch, SEED, config))
        t0 = time.monotonic()
        ranks = spawn_grid(run_case_groups, *shape, args=(groups,), timeout_s=SPAWN_LIMIT_S)
        assert time.monotonic() - t0 < SPAWN_LIMIT_S
        out.update(ranks[0])
    assert set(out) == set(CASES)
    return out


def _close(got: list, want: list, what: str, tol=FP32_TOL):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.float32, (what, i, g.dtype)
        np.testing.assert_allclose(g, w, **tol, err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("name", [n for n, (_, c) in CASES.items() if not c.get("dropout")])
def test_input_feeding_step_matches_jax_meshless(results, name):
    """Loss, token count and every grad leaf (gathered whole from the ranks'
    blocks) against the JAX package's meshless input-feeding step, at fp32
    and dropout 0; every case runs tensor-parallel, the pipelined plan too."""
    config, case = CASES[name]
    got = results[name]
    loss, denom, grads = _jax_meshless(config, _accum(case))
    assert got["tensor_parallel"]
    assert abs(got["loss"] - loss) < 1e-4, (got["loss"], loss)
    assert got["denom"] == denom == float(_model(config)[3]["tgt_mask"].sum())
    _close(got["grads"], grads, name)


@pytest.mark.parametrize("name", [n for n, (_, c) in CASES.items() if c.get("dropout")])
def test_input_feeding_step_matches_port_meshless_with_dropout(results, name):
    """At dropout 0.3 (the encoder's, as in JAX) every rank draws the
    meshless masks of its data shard's rows: the step equals the port's
    meshless input-feeding step."""
    config, case = CASES[name]
    got = results[name]
    want = _port_meshless(config, _accum(case), case["dropout"])
    no_dropout = _port_meshless(config, _accum(case), 0.0)
    assert not all(np.allclose(a, b, **FP32_TOL) for a, b in zip(want["grads"], no_dropout["grads"]))
    assert abs(got["loss"] - want["loss"]) < 1e-4, (got["loss"], want["loss"])
    _close(got["grads"], want["grads"], name)


@pytest.mark.parametrize("name", [n for n, (_, c) in CASES.items() if c.get("step")])
def test_input_feeding_adam_step_matches_meshless(results, name):
    """One Adam step (lr 1e-2, clip 0.05, so the clip binds) on each rank's
    blocks: the grid's global norm and every parameter, gathered whole,
    against the port's meshless step (bound lr * 1e-2)."""
    config, case = CASES[name]
    got = results[name]
    want = _port_meshless(config, _accum(case), 0.0, with_step=True)
    assert abs(got["grad_norm"] - want["grad_norm"]) < 1e-4 * want["grad_norm"]
    assert want["grad_norm"] > 0.05
    _close(got["params"], want["params"], f"{name} params", tol=dict(atol=1e-4, rtol=0))


@pytest.mark.parametrize("name", [n for n, (_, c) in CASES.items() if _accum(c) == 1 and c["grid"][1] > 1])
def test_input_feeding_collectives_per_step(results, name):
    """A forward makes, on the ``model`` axis, one all-gather of h per cell
    (layers x (M + N): the encoder layer-major, the decoder L per step) and
    one all-gather of Hc [B_d / M, h] per step but the last (whose Hc feeds
    no step, so its eq. 1-4 do not run); the backward one reduce-scatter of
    each."""
    config, case = CASES[name]
    cfg = CONFIGS[config]()
    batch = _model(config)[3]
    D, M = case["grid"]
    L, Ms, N = cfg.num_layers, batch["src"].shape[1], batch["tgt_in"].shape[1]
    rows = batch["src"].shape[0] // D // M
    calls = collections.Counter(
        (op, dim, shape) for op, axis, dim, shape in results[name]["calls"] if axis == "model")
    for op in ("all_gather", "reduce_scatter"):
        h_shape = (rows * M, cfg.d_model // M) if op == "all_gather" else (rows * M, cfg.d_model)
        hc_shape = (rows, cfg.d_model) if op == "all_gather" else (rows * M, cfg.d_model)
        assert calls[(op, 1, h_shape)] == L * (Ms + N), (op, calls)
        assert calls[(op, 0, hc_shape)] == N - 1, (op, calls)


# ---------------------------------------------------------------------------
# in process
# ---------------------------------------------------------------------------


class _Grid:
    """The shape of a grid without its processes: all that a plan's
    placement reads."""

    axis_names = ("data", "model")

    def __init__(self, data: int, model: int):
        self.data, self.model = data, model
        self.world = data * model

    def size(self, axis: str) -> int:
        return {"data": self.data, "model": self.model, "all": self.world}[axis]


def _jax_placement(jcfg, strategy: str, D: int, M: int) -> dict:
    """{dotted path: placement} by the JAX rule on a duck-typed mesh."""
    shapes = jax.eval_shape(lambda key: js2s.init_seq2seq(key, jcfg)[0], jax.random.key(0))
    _, specs = js2s.init_seq2seq(jax.random.key(0), _jax_cfg("small-if"))  # the specs do not depend on the widths
    mesh = SimpleNamespace(axis_names=("data", "model"), devices=np.empty((D, M)))
    placed = {key: jst.resolve_specs(specs[key], shapes[key], mesh, jst.Strategy(strategy),
                                     is_head=key in jst.HEAD_KEYS) for key in specs}
    flat = jax.tree_util.tree_flatten_with_path(placed, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(p) for path, p in flat}


def _dotted(tree, prefix: str = "") -> dict:
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[1:]: tree}
    return {k: v for key, sub in items for k, v in _dotted(sub, f"{prefix}.{key}").items()}


@pytest.mark.parametrize("strategy", ["model", "hybrid"])
@pytest.mark.parametrize("grid", [(1, 2), (2, 4)], ids=lambda g: f"{g[0]}x{g[1]}")
def test_pipelined_plan_under_input_feeding_is_tensor_parallel(strategy, grid):
    """A pipelined MODEL/HYBRID plan on a model axis above 1 has no backbone
    to pipeline under input feeding (the JAX trainer drops it): its
    placement is the JAX rule's by strategy alone, every leaf's role is a
    tensor-parallel one, its loss axis is the tensor-parallel layout's, and
    it still runs its microbatches in one forward and backward."""
    cfg = CONFIGS["small-if"]()
    plan = ExecutionPlan(strategy=strategy, mesh=_Grid(*grid), use_pipeline=True, micro_batches=2)
    assert plan.pipelined and not plan.tensor_parallel
    twin = plan.for_config(cfg)
    assert twin.tensor_parallel and not twin.pipelined and twin.accum_steps == plan.accum_steps == 1
    assert _dotted(plan.placement(cfg)) == _jax_placement(_jax_cfg("small-if"), strategy, *grid)
    assert plan.for_config(dataclasses.replace(cfg, input_feeding=False)) is plan
    params = s2s.init_seq2seq(0, cfg, device="cpu")
    roles = plan.leaf_roles(params, cfg)
    assert all(r.owner is None for r in roles) and any(r.shard for r in roles)
    unpipelined = ExecutionPlan(strategy=strategy, mesh=_Grid(*grid))
    assert twin.loss_axis() == unpipelined.loss_axis()
    assert roles == unpipelined.leaf_roles(params, cfg)


@pytest.mark.parametrize("stage_kernel", ["cuda", "torch"])
def test_meshless_input_feeding_step_runs_every_cell_on_the_stage_kernel(monkeypatch, stage_kernel):
    """With ``stage_kernel="cuda"`` every encoder and decoder cell of the
    meshless input-feeding step goes through the ``lstm_cell`` wrapper, once
    per cell (layers x (M + N)), each step's weights cast once; ``"torch"``
    keeps the plain cells.  Both equal the JAX step at fp32."""
    calls, casts = [], []
    fused, cast = lstm_ops.lstm_cell_fused, lstm_ops.cast_weights
    monkeypatch.setattr(lstm_ops, "lstm_cell_fused", lambda *a, **k: calls.append(a[0].shape) or fused(*a, **k))
    monkeypatch.setattr(lstm_ops, "cast_weights", lambda *a: casts.append(a[0].shape) or cast(*a))
    cfg = CONFIGS["small-if"]()
    _, _, params_np, batch = _model("small-if")
    loss, _, grads = make_grad_fn(cfg, ExecutionPlan(stage_kernel=stage_kernel))(
        bridge.params_from_jax(params_np, device="cpu"), batch_to_device(batch, "cpu"))
    L, M, N = cfg.num_layers, batch["src"].shape[1], batch["tgt_in"].shape[1]
    if stage_kernel == "cuda":
        assert len(calls) == L * (M + N)
        assert calls.count((8, cfg.emb_size + cfg.d_model)) == N  # decoder layer 0: [emb; Hc]
        assert len(casts) == 2 * L  # each encoder layer call, and each decoder layer once per step call
    else:
        assert not calls and not casts
    want_loss, _, want = _jax_meshless("small-if", 1)
    assert abs(float(loss) - want_loss) < 1e-4
    _close([g.numpy() for g in tree_leaves(grads)], want, f"meshless {stage_kernel}")


def test_hybrid_opt_input_feeding_on_the_trivial_grid_matches_jax_meshless():
    """HYBRID_OPT on the 1 x 1 grid at h = 1024 under input feeding: the
    tensor-parallel input-feeding step's code paths (the encoder's backbone,
    the step-major shard cells, the per-step row block and its gather, the
    vocab-parallel head), every placement trivial."""
    _, _, params_np, batch = _model("wide-if")
    cfg = CONFIGS["wide-if"]()
    with make_grid(1, 1, device="cpu") as grid:
        plan = ExecutionPlan(strategy="hybrid_opt", mesh=grid)
        assert plan.tensor_parallel and plan.sharding(cfg) is not None
        params = plan.shard_params(bridge.params_from_jax(params_np, device="cpu"), cfg)
        loss, _, grads = make_grad_fn(cfg, plan)(params, batch_to_device(batch, "cpu"))
        got = [g.numpy() for g in tree_leaves(plan.gather_params(grads, cfg))]
    want_loss, _, want = _jax_meshless("wide-if", 1)
    assert abs(float(loss) - want_loss) < 1e-4
    _close(got, want, "hybrid_opt 1x1 input feeding")


def test_step_rows_need_whole_blocks():
    """The per-step row block refuses a data shard that does not split into
    equal blocks over ``model``."""
    sharding = stg.Sharding(SimpleNamespace(size=lambda a: 4, index=lambda a: 1), {})
    assert sharding.step_rows(torch.arange(8)).tolist() == [2, 3]
    with pytest.raises(ValueError, match="do not split into 4 blocks"):
        sharding.step_rows(torch.arange(6))
