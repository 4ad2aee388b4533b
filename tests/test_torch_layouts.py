"""The port's tensor-parallel and interleaved training layouts on gloo ranks
on the CPU: the interleaved ring executor (``virtual_stages > 1``), the
tensor-parallel backbone under MODEL and HYBRID without the pipeline, and
HYBRID_OPT (the vocab-sharded head, FSDP over ``data``).

The references:

* the JAX package's meshless step (``make_grad_fn`` on a SINGLE plan), which
  every layout equals by construction (a layout only places and orders
  work); the JAX package's meshed steps fail on jax 0.9.0 (ROADMAP queue
  3), so no meshed JAX step is a reference;
* JAX's ``pipeline_lstm(..., schedule="interleaved", virtual_stages=v)``
  forward on a (1, 1) mesh, for the ring's forward alone;
* the JAX placement rule, ``repro.core.strategy.resolve_specs`` on a
  duck-typed mesh, for every leaf's placement;
* the port's own meshless step, at dropout 0.3 (dropout cannot match
  ``jax.random.bernoulli``), and for one Adam step.

Two models: the smoke model at four layers (``small_config``; no dim reaches
the FSDP floor of 1024, so HYBRID_OPT shards nothing over ``data`` there)
and ``wide_config`` (two layers a side at h = emb = 1024, vocab 2048), on
which HYBRID_OPT shards the big weights over ``data``.  Weights come from
the JAX initializer, bridged; batches of 8 with sequences of 6 from
``MTBatchIterator``.  Tolerances: fp32 loss within 1e-4 and every grad leaf
at atol 1e-4 / rtol 1e-3 (``tests/test_torch_hybrid.py``'s).  The ranks run
in two spawns (worlds of 2 and 4 processes), each running every case of its
world size, with a time limit.
"""
from __future__ import annotations

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
from repro.core.pipeline import pipeline_lstm as jax_pipeline_lstm  # noqa: E402
from repro.core.pipeline import stack_pipeline_params  # noqa: E402
from repro.core.plan import ExecutionPlan as JaxPlan  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro.train.trainer import make_grad_fn as jax_make_grad_fn  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import strategy as stg  # noqa: E402
from repro_torch.core.pipeline import layer_stage, pipeline_lstm  # noqa: E402
from repro_torch.core.plan import ExecutionPlan  # noqa: E402
from repro_torch.data import MTBatchIterator, SyntheticMTTask  # noqa: E402
from repro_torch.launch.mesh import make_grid, spawn_grid  # noqa: E402
from repro_torch.models import seq2seq as s2s  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.train.trainer import batch_to_device, init_train_state, make_grad_fn, make_train_step  # noqa: E402
from torch_hybrid_workers import CONFIGS, WIDE, run_case_groups  # noqa: E402

pytestmark = pytest.mark.torch_port

FP32_TOL = dict(atol=1e-4, rtol=1e-3)
SEED = 3  # the dropout generator's seed, on every rank and in the meshless reference
SPAWN_LIMIT_S = 300  # per spawn of every case of one world size

RING = dict(use_pipeline=True, schedule="interleaved", virtual_stages=2)
SMALL = {
    # (a) the interleaved ring, v = 2 chunks per stage
    "ring-hybrid-1x2-k1": dict(grid=(1, 2), strategy="hybrid", micro_batches=1, **RING),
    "ring-hybrid-1x2-k2": dict(grid=(1, 2), strategy="hybrid", micro_batches=2, step=True, **RING),
    "ring-model-1x2-k1": dict(grid=(1, 2), strategy="model", micro_batches=1, **RING),
    "ring-model-1x2-k2": dict(grid=(1, 2), strategy="model", micro_batches=2, **RING),
    "ring-hybrid-1x2-k2-torch": dict(grid=(1, 2), strategy="hybrid", micro_batches=2, stage_kernel="torch", **RING),
    "ring-hybrid-1x2-k2-dropout": dict(grid=(1, 2), strategy="hybrid", micro_batches=2, dropout=0.3, **RING),
    "ring-hybrid-2x2-k2": dict(grid=(2, 2), strategy="hybrid", micro_batches=2, step=True, **RING),
    # (b) the tensor-parallel backbone, on both stage kernels
    **{f"tp-{st}-{d}x{m}-{sk}": dict(grid=(d, m), strategy=st, micro_batches=1, stage_kernel=sk)
       for st in ("model", "hybrid") for d, m in ((1, 2), (2, 2), (1, 4)) for sk in ("cuda", "torch")},
    "tp-hybrid-1x2-dropout": dict(grid=(1, 2), strategy="hybrid", micro_batches=1, dropout=0.3),
    "tp-model-2x2-dropout": dict(grid=(2, 2), strategy="model", micro_batches=1, dropout=0.3),
    "tp-model-1x2-k2-step": dict(grid=(1, 2), strategy="model", micro_batches=2, step=True),
    "tp-hybrid-2x2-k2-overlap": dict(grid=(2, 2), strategy="hybrid", micro_batches=2, overlap=True, step=True),
    "tp-model-2x2-k2-buckets": dict(grid=(2, 2), strategy="model", micro_batches=2, overlap=True,
                                    bucket_bytes=200_000),
    # (c) HYBRID_OPT at the smoke widths: the vocab-parallel head, no FSDP
    "opt-small-1x2": dict(grid=(1, 2), strategy="hybrid_opt", micro_batches=1),
    "opt-small-1x4": dict(grid=(1, 4), strategy="hybrid_opt", micro_batches=1),
}
WIDE_CASES = {
    # (c) HYBRID_OPT at h = 1024: FSDP over data (2 x 1), vocab-parallel (1 x 2), both (2 x 2)
    "opt-wide-2x1": dict(grid=(2, 1), strategy="hybrid_opt", micro_batches=1, step=True),
    "opt-wide-1x2": dict(grid=(1, 2), strategy="hybrid_opt", micro_batches=1, step=True),
    "opt-wide-2x2": dict(grid=(2, 2), strategy="hybrid_opt", micro_batches=1, step=True),
    "opt-wide-2x2-k2-dropout": dict(grid=(2, 2), strategy="hybrid_opt", micro_batches=2, dropout=0.3),
    "tp-hybrid-wide-2x2": dict(grid=(2, 2), strategy="hybrid", micro_batches=1, step=True),
}
CASES = {**{n: ("small", c) for n, c in SMALL.items()}, **{n: ("wide", c) for n, c in WIDE_CASES.items()}}


def _accum(case: dict) -> int:
    """The meshless step a case equals: a pipelined plan runs its microbatches
    in one wavefront (one mean), an unpipelined one accumulates them."""
    return 1 if case.get("use_pipeline") else case["micro_batches"]


def _jax_cfg(config: str):
    base = dataclasses.replace(jax_get_config("seq2seq-rnn", smoke=True), dtype="float32", dropout=0.0)
    return dataclasses.replace(base, num_layers=4) if config == "small" else dataclasses.replace(base, **WIDE)


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
    each rank's results (rank 0's hold the losses and grads)."""
    out = {}
    for world, shape in ((2, (1, 2)), (4, (1, 4))):
        groups = []
        for config, cases in (("small", SMALL), ("wide", WIDE_CASES)):
            mine = {n: c for n, c in cases.items() if c["grid"][0] * c["grid"][1] == world}
            if mine:
                _, _, params_np, batch = _model(config)
                groups.append((mine, params_np, batch, SEED, config))
        t0 = time.monotonic()
        ranks = spawn_grid(run_case_groups, *shape, args=(groups,), timeout_s=SPAWN_LIMIT_S)
        assert time.monotonic() - t0 < SPAWN_LIMIT_S
        for name in ranks[0]:
            out[name] = dict(ranks[0][name], ranks=ranks)
    assert set(out) == set(CASES)
    return out


def _close(got: list, want: list, what: str, tol=FP32_TOL):
    assert len(got) == len(want)
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == np.float32, (what, i, g.dtype)
        np.testing.assert_allclose(g, w, **tol, err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("name", [n for n, (_, c) in CASES.items() if not c.get("dropout")])
def test_layout_step_matches_jax_meshless(results, name):
    """Loss, token count and every grad leaf (gathered whole from the ranks'
    blocks) against the JAX package's meshless step, at fp32 and dropout 0."""
    config, case = CASES[name]
    got = results[name]
    loss, denom, grads = _jax_meshless(config, _accum(case))
    assert abs(got["loss"] - loss) < 1e-4, (got["loss"], loss)
    assert got["denom"] == denom == float(_model(config)[3]["tgt_mask"].sum())
    _close(got["grads"], grads, name)


@pytest.mark.parametrize("name", [n for n, (_, c) in CASES.items() if c.get("dropout")])
def test_layout_step_matches_port_meshless_with_dropout(results, name):
    """At dropout 0.3 every rank draws each layer's mask for its data shard's
    rows in the meshless generator order (every ``model`` rank the same
    masks): the step equals the port's meshless step."""
    config, case = CASES[name]
    got = results[name]
    want = _port_meshless(config, _accum(case), case["dropout"])
    no_dropout = _port_meshless(config, _accum(case), 0.0)
    assert not all(np.allclose(a, b, **FP32_TOL) for a, b in zip(want["grads"], no_dropout["grads"]))
    assert abs(got["loss"] - want["loss"]) < 1e-4, (got["loss"], want["loss"])
    _close(got["grads"], want["grads"], name)


@pytest.mark.parametrize("name", [n for n, (_, c) in CASES.items() if c.get("step")])
def test_layout_adam_step_matches_meshless(results, name):
    """One Adam step (lr 1e-2, clip 0.05, so the clip binds) on each rank's
    blocks and moments: the grid's global norm (each element counted once)
    and every parameter, gathered whole, against the port's meshless step
    (``test_torch_hybrid.py``'s bound: lr * 1e-2)."""
    config, case = CASES[name]
    got = results[name]
    want = _port_meshless(config, _accum(case), 0.0, with_step=True)
    assert abs(got["grad_norm"] - want["grad_norm"]) < 1e-4 * want["grad_norm"]
    assert want["grad_norm"] > 0.05
    _close(got["params"], want["params"], f"{name} params", tol=dict(atol=1e-4, rtol=0))


class _Grid:
    """The shape of a grid without its processes: all that a plan's
    validators and the placement read."""

    axis_names = ("data", "model")

    def __init__(self, data: int, model: int):
        self.data, self.model = data, model
        self.world = data * model

    def size(self, axis: str) -> int:
        return {"data": self.data, "model": self.model, "all": self.data * self.model}[axis]


def _jax_placement(config: str, strategy: str, D: int, M: int) -> dict:
    """{dotted path: placement tuple} by the JAX rule on a duck-typed mesh."""
    jcfg = _jax_cfg(config) if config != "full" else jax_get_config("seq2seq-rnn")
    shapes = jax.eval_shape(lambda key: js2s.init_seq2seq(key, jcfg)[0], jax.random.key(0))
    tiny = dataclasses.replace(jax_get_config("seq2seq-rnn", smoke=True), num_layers=jcfg.num_layers,
                               input_feeding=jcfg.input_feeding)
    _, specs = js2s.init_seq2seq(jax.random.key(0), tiny)  # the logical specs do not depend on the widths
    mesh = SimpleNamespace(axis_names=("data", "model"), devices=np.empty((D, M)))
    placed = {key: jst.resolve_specs(specs[key], shapes[key], mesh, jst.Strategy(strategy),
                                     is_head=key in jst.HEAD_KEYS) for key in specs}
    flat = jax.tree_util.tree_flatten_with_path(placed, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))[0]
    return {".".join(str(getattr(k, "key", getattr(k, "idx", k))) for k in path): tuple(p) for path, p in flat}


def _dotted(tree, prefix: str = "") -> dict:
    """{dotted path: leaf} of a tree of shapes or placements (tuples are leaves)."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list):
        items = enumerate(tree)
    else:
        return {prefix[1:]: tree}
    return {k: v for key, sub in items for k, v in _dotted(sub, f"{prefix}.{key}").items()}


def _port_config(config: str):
    return get_config("seq2seq-rnn") if config == "full" else CONFIGS[config]()


GRIDS = ((1, 2), (2, 1), (2, 2), (1, 4))


@pytest.mark.parametrize("config", ["full", "wide"])
@pytest.mark.parametrize("strategy", ["model", "hybrid", "hybrid_opt"])
@pytest.mark.parametrize("grid", GRIDS, ids=lambda g: f"{g[0]}x{g[1]}")
def test_placement_matches_jax_resolve_specs(config, strategy, grid):
    """The port's placement rule on the seq2seq spec tree equals JAX's, leaf
    by leaf, at the full-width config and the h = 1024 test config; where
    the plan is tensor-parallel its placement is that rule's."""
    cfg = _port_config(config)
    want = _jax_placement(config, strategy, *grid)
    shape = _Grid(*grid)
    placed = stg.param_placement(s2s.param_specs(cfg.num_layers), s2s.param_shapes(cfg), shape, strategy)
    got = _dotted(placed)
    assert got == want
    plan = ExecutionPlan(strategy=strategy, mesh=shape)
    if plan.tensor_parallel:
        assert plan.placement(cfg) == placed
    if config == "full" and strategy == "hybrid_opt" and grid == (2, 2):  # the table of the JAX rule at full width
        assert got["encoder.1.wx"] == ("data", None, "model") and got["encoder.0.wx"] == (None, None, "model")
        assert got["head.w_alpha"] == (None, "data") and got["head.w_c"] == ("model", "data")
        assert got["head.f_c"] == ("data", "model") and got["src_emb.table"] == ("model", None)


@pytest.mark.parametrize("name", [n for n, (_, c) in CASES.items() if c.get("step")])
def test_ranks_store_only_their_blocks(results, name):
    """After the step, each rank's params and both Adam moments have the
    whole leaf's shape divided along the JAX placement (so FSDP and the
    tensor-parallel shards are stored as blocks, not sliced from a whole
    copy), and the blocks' elements add up to the whole tree's on every
    axis that shards them."""
    config, case = CASES[name]
    D, M = case["grid"]
    cfg = _port_config(config)
    whole = _dotted(s2s.param_shapes(cfg))
    plan = ExecutionPlan(strategy=case["strategy"], mesh=_Grid(D, M),
                         **{k: v for k, v in case.items() if k in ("use_pipeline", "schedule", "virtual_stages")})
    placed = _jax_placement(config, case["strategy"], D, M) if plan.tensor_parallel else \
        {k: (None,) * len(s) for k, s in whole.items()}
    sizes = {"data": D, "model": M, None: 1}
    sharded = 0
    for r, rank in enumerate(results[name]["ranks"]):
        stored = rank[name]["stored"]
        for path, shape in whole.items():
            want = tuple(n // sizes[a] for n, a in zip(shape, placed[path]))
            for tree in ("params", "m", "v"):
                assert stored[tree][path] == want, (r, tree, path, stored[tree][path], want)
            sharded += want != shape
    if plan.tensor_parallel and D * M > 1:
        assert sharded > 0
    if config == "wide" and case["strategy"] == "hybrid_opt" and D > 1:  # FSDP stores a 1/D block of the big weights
        assert placed["decoder.1.wh"][0] == "data" and placed["head.f_c"][0] == "data"


# ---------------------------------------------------------------------------
# in process, on the trivial (1, 1) grid
# ---------------------------------------------------------------------------


@pytest.fixture
def grid11():
    with make_grid(1, 1, device="cpu") as grid:
        yield grid


@pytest.mark.parametrize("v", [2, 4])
def test_ring_forward_matches_jax_interleaved_pipeline_lstm(grid11, v):
    """The port's ring forward (k=2) on the (1, 1) grid against JAX's
    ``pipeline_lstm(..., schedule="interleaved", virtual_stages=v)`` on a
    (1, 1) mesh, over the encoder's four layers at fp32."""
    jcfg, jparams, params_np, _ = _model("small")
    x = np.random.default_rng(1).normal(size=(4, 5, jcfg.emb_size)).astype(np.float32)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    stacked, _ = stack_pipeline_params(jparams["encoder"], 1)
    want = jax_pipeline_lstm(mesh, stacked, jnp.asarray(x), in_dim=jcfg.emb_size, micro_batches=2,
                             schedule="interleaved", virtual_stages=v)
    layers = bridge.params_from_jax(params_np["encoder"], device="cpu")
    got = pipeline_lstm(grid11, layers, torch.from_numpy(x), micro_batches=2, schedule="interleaved", virtual_stages=v)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("v", [2, 4])
@pytest.mark.parametrize("k", [1, 2])
def test_ring_step_on_the_trivial_grid_matches_jax_meshless(grid11, v, k):
    """HYBRID on the ring at v chunks of the one stage (each layer a chunk at
    v=4): loss and every grad leaf against JAX's meshless step."""
    _, _, params_np, batch = _model("small")
    plan = ExecutionPlan(strategy="hybrid", mesh=grid11, use_pipeline=True, micro_batches=k, schedule="interleaved",
                         virtual_stages=v)
    loss, extras, grads = make_grad_fn(CONFIGS["small"](), plan)(bridge.params_from_jax(params_np, device="cpu"),
                                                                 batch_to_device(batch, "cpu"))
    want_loss, denom, want = _jax_meshless("small", 1)
    assert abs(float(loss) - want_loss) < 1e-4 and float(extras["denom"]) == denom
    _close([g.numpy() for g in tree_leaves(grads)], want, f"ring v={v} k={k}")


def test_hybrid_opt_on_the_trivial_grid_matches_jax_meshless(grid11):
    """HYBRID_OPT on the 1 x 1 grid (every placement trivial, the sharded
    code paths taken) at h = 1024."""
    _, _, params_np, batch = _model("wide")
    plan, cfg = ExecutionPlan(strategy="hybrid_opt", mesh=grid11), CONFIGS["wide"]()
    params = plan.shard_params(bridge.params_from_jax(params_np, device="cpu"), cfg)
    assert plan.tensor_parallel and plan.sharding(cfg) is not None
    loss, _, grads = make_grad_fn(cfg, plan)(params, batch_to_device(batch, "cpu"))
    want_loss, _, want = _jax_meshless("wide", 1)
    assert abs(float(loss) - want_loss) < 1e-4
    _close([g.numpy() for g in tree_leaves(plan.gather_params(grads, cfg))], want, "hybrid_opt 1x1")


def test_plan_takes_every_layout():
    """The layouts that used to raise build plans; the JAX validators stay."""
    shape = _Grid(2, 2)
    for kw in (dict(strategy="hybrid", use_pipeline=True, schedule="interleaved", virtual_stages=2),
               dict(strategy="model"), dict(strategy="hybrid"), dict(strategy="hybrid_opt"),
               dict(strategy="hybrid_opt", use_pipeline=True)):
        plan = ExecutionPlan(mesh=shape, **kw)
        assert plan.tensor_parallel == (not plan.pipelined)
    assert not ExecutionPlan(strategy="hybrid_opt", mesh=shape, use_pipeline=True).pipelined  # as in JAX: a no-op
    with pytest.raises(ValueError, match="requires schedule='interleaved'"):
        ExecutionPlan(strategy="hybrid", mesh=shape, use_pipeline=True, virtual_stages=2)
    with pytest.raises(ValueError, match="accumulated microbatches"):  # 6-row microbatches over 4 ranks
        ExecutionPlan(strategy="hybrid", mesh=shape, micro_batches=2).validate_batch(12)
    ExecutionPlan(strategy="hybrid", mesh=shape, use_pipeline=True, micro_batches=2).validate_batch(12)
    with pytest.raises(ValueError, match="cannot split into 4 virtual chunks"):
        layer_stage(0, 4, 2, 4)  # 2 layers a stage, 4 chunks


def test_tensor_parallel_backbone_output_is_contiguous(grid11):
    """The backbone's [B, S, H] output is laid out as the meshless stack's,
    which the Luong head's kernel requires of its inputs on the card."""
    from repro_torch.core.pipeline import tensor_parallel_backbone

    _, _, params_np, _ = _model("small")
    layers = bridge.params_from_jax(params_np["encoder"], device="cpu")
    x = torch.from_numpy(np.random.default_rng(2).normal(size=(4, 5, 256)).astype(np.float32))
    got = tensor_parallel_backbone(grid11)(layers, x, None)
    assert got.is_contiguous() and got.shape == (4, 5, 256)
    want = s2s.lstm.run_stacked_lstm(layers, x, stage_kernel="cuda")[0]
    assert torch.equal(got, want)
