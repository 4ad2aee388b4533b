"""The port's own copies of the JAX package's JAX-free planning code
(``repro_torch/core/schedule.py``, ``core/hybrid.py``) and the plan's
multi-device fields (``core/plan.py``) against ``repro.core``.

Schedules: every kind, S in {1, 3, 5}, NS in {1, 2, 4}, k in {1, 2, 4} and
chunks 1-2 where legal: the work tables, ``summary()``, the liveness
accounting and the executor contract (``bwd_group_size``/``bwd_group_starts``)
equal exactly.  Cost models: equal on ``seq2seq-rnn`` and its smoke config.
Plan: ``grad_buckets`` equals the JAX plan's on the bridged tree, and every
validator raises where JAX's does (the layouts the port does not have raise
``NotImplementedError`` instead, by name).
"""
from __future__ import annotations

import dataclasses
import itertools
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import hybrid as jhybrid  # noqa: E402
from repro.core import schedule as jschedule  # noqa: E402
from repro.core import strategy as jst  # noqa: E402
from repro.core.plan import ExecutionPlan as JaxPlan  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import hybrid, schedule  # noqa: E402
from repro_torch.core import strategy as stg  # noqa: E402
from repro_torch.core.plan import ExecutionPlan  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402

pytestmark = pytest.mark.torch_port

KINDS = ("gpipe", "1f1b", "zerobubble", "interleaved")


@pytest.mark.parametrize("NS", [1, 2, 4])
@pytest.mark.parametrize("kind", KINDS)
def test_schedule_tables_equal_jax(kind, NS):
    assert schedule.SCHEDULES == jschedule.SCHEDULES
    for S, k, chunks in itertools.product((1, 3, 5), (1, 2, 4), (1, 2) if kind == "interleaved" else (1,)):
        ours = schedule.PipelineSchedule(seq_len=S, num_stages=NS, micro_batches=k, kind=kind, chunks=chunks)
        ref = jschedule.PipelineSchedule(seq_len=S, num_stages=NS, micro_batches=k, kind=kind, chunks=chunks)
        what = (kind, S, NS, k, chunks)
        assert [tuple(u) for u in ours.table()] == [tuple(u) for u in ref.table()], what
        assert ours.summary() == ref.summary(), what
        assert ours.bwd_group_size == ref.bwd_group_size, what
        assert ours.bwd_group_starts == ref.bwd_group_starts, what
        assert ours.forward_ticks == ref.forward_ticks == k * S + ours.virtual_stages - 1, what
        assert ours.time_stretch() == ref.time_stretch(), what
        for s in range(ours.virtual_stages):
            assert ours.peak_live_microbatches(s) == ref.peak_live_microbatches(s), what
            assert ours.peak_stash_steps(s) == ref.peak_stash_steps(s), what
        w, jw = ours.wavefront, ref.wavefront
        assert (w.ticks, w.naive_ticks, w.fill_drain_ticks, w.bubble_fraction) == (
            jw.ticks, jw.naive_ticks, jw.fill_drain_ticks, jw.bubble_fraction), what


def test_schedule_rejects_what_jax_rejects():
    for kw in (dict(seq_len=0, num_stages=1), dict(seq_len=2, num_stages=1, kind="pipedream"),
               dict(seq_len=2, num_stages=1, chunks=2), dict(seq_len=2, num_stages=1, chunks=0)):
        with pytest.raises(ValueError):
            jschedule.PipelineSchedule(**kw)
        with pytest.raises(ValueError):
            schedule.PipelineSchedule(**kw)


# ---------------------------------------------------------------------------
# cost models
# ---------------------------------------------------------------------------

CONFIGS = [("seq2seq-rnn", False), ("seq2seq-rnn", True)]


def _fields(obj) -> tuple:
    """A dataclass's field values and properties' values (the two packages'
    classes are distinct types)."""
    props = [n for n in dir(type(obj)) if isinstance(getattr(type(obj), n), property)]
    return dataclasses.astuple(obj) + tuple(getattr(obj, n) for n in props)


def _cfgs(arch, smoke):
    return get_config(arch, smoke=smoke), jax_get_config(arch, smoke=smoke)


@pytest.mark.parametrize("arch,smoke", CONFIGS, ids=["full", "smoke"])
def test_cost_models_equal_jax(arch, smoke):
    cfg, jcfg = _cfgs(arch, smoke)
    assert hybrid.seq2seq_param_split(cfg) == jhybrid.seq2seq_param_split(jcfg)
    shape = dict(batch=64, src_len=32, tgt_len=32)
    for strategy, devices, k, overlap, dt in itertools.product(
            ("data", "model", "hybrid", "hybrid_opt"), (1, 4, 8), (1, 2), (False, True), (None, "bfloat16")):
        kw = dict(strategy=strategy, devices=devices, micro_batches=k, overlap=overlap, compute_dtype=dt, **shape)
        assert _fields(hybrid.strategy_comm_cost(cfg, **kw)) == _fields(jhybrid.strategy_comm_cost(jcfg, **kw)), kw
        for pipelined, buckets in itertools.product((False, True), (0, 3)):
            ckw = dict(kw, pipelined=pipelined, bucket_count=buckets)
            assert _fields(hybrid.comm_contract(cfg, **ckw)) == _fields(jhybrid.comm_contract(jcfg, **ckw)), ckw
        if strategy != "hybrid_opt":
            for sched, inf in itertools.product(("gpipe", "1f1b", "zerobubble"), (False, True)):
                skw = dict(kw, flops_per_sec=989e12, link_bytes_per_sec=450e9, input_feeding=inf, schedule=sched)
                assert hybrid.scaling_factor_model(cfg, **skw) == jhybrid.scaling_factor_model(jcfg, **skw), skw
    for sched, NS, k, dt in itertools.product(("gpipe", "1f1b", "zerobubble"), (1, 2, 4), (1, 2, 4),
                                              (None, "float32")):
        kw = dict(schedule=sched, num_stages=NS, micro_batches=k, compute_dtype=dt, **shape)
        assert hybrid.pipeline_activation_model(cfg, **kw) == jhybrid.pipeline_activation_model(jcfg, **kw), kw
    assert _fields(hybrid.serve_comm_contract(devices=4)) == _fields(jhybrid.serve_comm_contract(devices=4))


# ---------------------------------------------------------------------------
# the plan
# ---------------------------------------------------------------------------


class _Grid:
    """The shape of a process grid, without processes: all a plan's
    validators read."""

    axis_names = ("data", "model")

    def __init__(self, data, model):
        self.shape = (data, model)
        self.world = data * model

    def size(self, axis):
        return {"data": self.shape[0], "model": self.shape[1], "all": self.world}[axis]


@pytest.mark.parametrize("bucket_bytes", [1, 100_000, 1_000_000, 10**12])
def test_grad_buckets_equal_jax(bucket_bytes):
    """Leaf order, bytes and names of every bucket, the port's positions
    pointing at the leaves of those names."""
    jcfg = dataclasses.replace(jax_get_config("seq2seq-rnn", smoke=True), num_layers=4)
    jparams, _ = js2s.init_seq2seq(jax.random.key(0), jcfg)
    params = bridge.params_from_jax(jax.device_get(jparams), device="cpu")
    want = JaxPlan(strategy=jst.Strategy.SINGLE, overlap=True, bucket_bytes=bucket_bytes).grad_buckets(jparams)
    got = ExecutionPlan(overlap=True, bucket_bytes=bucket_bytes).grad_buckets(params)
    assert [(b["index"], b["bytes"], b["names"]) for b in got] == [(b["index"], b["bytes"], b["names"]) for b in want]
    leaves = tree_leaves(params)
    jleaves = jax.tree.leaves(jparams)
    for b, jb in zip(got, want):
        for pos, jpos in zip(b["leaves"], jb["leaves"]):
            assert np.array_equal(leaves[pos].numpy(), np.asarray(jleaves[jpos]))
    assert sorted(i for b in got for i in b["leaves"]) == list(range(len(leaves)))


def _jax_mesh():
    return jax.make_mesh((1, 1), ("data", "model"))


VALIDATOR_CASES = [
    dict(micro_batches=0),
    dict(stage_kernel="triton"),
    dict(schedule="pipedream"),
    dict(virtual_stages=0),
    dict(virtual_stages=2),
    dict(compute_dtype="float64"),
    dict(loss_scale_init=0.0),
    dict(loss_scale_growth=0),
    dict(bucket_bytes=0, overlap=True),
    dict(bucket_bytes=1024),
    dict(overlap=True, use_pipeline=True, mesh=True, strategy="hybrid"),
    dict(overlap=True, use_pipeline=True, mesh=True, strategy="model"),
    dict(strategy="nope"),
]


@pytest.mark.parametrize("kw", VALIDATOR_CASES, ids=[",".join(f"{k}={v}" for k, v in c.items()) for c in VALIDATOR_CASES])
def test_validators_raise_where_jax_does(kw):
    jkw, pkw = dict(kw), dict(kw)
    if kw.get("mesh"):
        jkw["mesh"], pkw["mesh"] = _jax_mesh(), _Grid(1, 1)
    jkw.setdefault("strategy", "single")
    with pytest.raises(ValueError):
        JaxPlan(**jkw)
    with pytest.raises(ValueError):
        ExecutionPlan(**pkw)


def test_layouts_not_ported_raise_by_name():
    """Plans JAX accepts and the port cannot run yet."""
    cases = [
        (dict(schedule="interleaved", virtual_stages=2), "interleaved ring executor"),
        (dict(strategy="hybrid", mesh=(1, 2)), "tensor-parallel backbone"),
        (dict(strategy="model", mesh=(2, 4)), "tensor-parallel backbone"),
        (dict(strategy="hybrid_opt", mesh=(2, 1)), "hybrid_opt"),
    ]
    for kw, name in cases:
        jkw, pkw = dict(kw), dict(kw)
        if "mesh" in kw:
            jkw["mesh"], pkw["mesh"] = _jax_mesh(), _Grid(*kw["mesh"])
        JaxPlan(**{"strategy": "single", **jkw})
        with pytest.raises(NotImplementedError, match=f"{name}.*ROADMAP queue 1 item 4"):
            ExecutionPlan(**pkw)
    # the same grids with the pipeline, and a model axis of 1 without it, are ported
    ExecutionPlan(strategy="hybrid", mesh=_Grid(1, 2), use_pipeline=True)
    ExecutionPlan(strategy="model", mesh=_Grid(2, 4), use_pipeline=True, micro_batches=4)
    ExecutionPlan(strategy="hybrid", mesh=_Grid(2, 1), micro_batches=2, overlap=True)


@pytest.mark.parametrize("strategy,grid,pipeline", [
    ("single", None, False), ("data", (2, 4), False), ("hybrid", (2, 4), True), ("model", (2, 4), True),
    ("hybrid", (1, 1), True), ("hybrid", (4, 1), False)])
def test_derived_structure_equals_jax(strategy, grid, pipeline):
    """pipelined, num_stages, accum_steps, batch_shard_size and the schedule
    a plan prescribes (the JAX side on a stand-in for a mesh of the grid's
    shape: these read only its axis names and device array's shape)."""
    jmesh = None if grid is None else types.SimpleNamespace(axis_names=("data", "model"), devices=np.empty(grid))
    pgrid = None if grid is None else _Grid(*grid)
    for k, sched in itertools.product((1, 2), ("gpipe", "1f1b")):
        jp = JaxPlan(strategy=strategy, mesh=jmesh, use_pipeline=pipeline, micro_batches=k, schedule=sched)
        pp = ExecutionPlan(strategy=strategy, mesh=pgrid, use_pipeline=pipeline, micro_batches=k, schedule=sched)
        assert (pp.pipelined, pp.accum_steps) == (jp.pipelined, jp.accum_steps)
        assert pp.batch_shard_size() == jp.batch_shard_size()
        assert stg.model_shard_size(pp.strategy, pgrid) == jst.model_shard_size(jp.strategy, jmesh)
        assert pp.num_stages == jp.num_stages
        assert pp.pipeline_schedule(5).summary() == jschedule.PipelineSchedule(
            seq_len=5, num_stages=pp.num_stages, micro_batches=k if pp.pipelined else 1, kind=sched).summary()
        for B in (8, 12, 16):
            try:
                jp.validate_batch(B)
                jok = True
            except ValueError:
                jok = False
            try:
                pp.validate_batch(B)
                pok = True
            except ValueError:
                pok = False
            # the port also needs the hybrid head's rows to split over every rank
            assert pok == (jok and (strategy != "hybrid" or grid is None or B % (grid[0] * grid[1]) == 0)), B
