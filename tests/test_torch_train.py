"""The port's training slice (``repro_torch.train``, ``optim``, ``data``,
the seq2seq training forwards) against the JAX package's meshless
reference, on the CPU at the smoke size.

Weights are bridged from ``init_seq2seq(jax.random.key(0), smoke cfg)`` and
both sides see the same ``MTBatchIterator`` batches.  The reference step is
``make_grad_fn(cfg, ExecutionPlan(SINGLE, stage_kernel="pallas_interpret"))``
(plain LSTM scan, the Luong head's Pallas kernel in interpret mode with its
custom-vjp backward).  Tolerances: at fp32 the loss within 1e-4 and every
grad leaf at atol 1e-4 / rtol 1e-3 (``tests/test_plan.py``'s); at bf16 the
loss within 0.03 and each leaf's max error under 0.1 of its max magnitude
(``tests/test_mixed_precision.py``'s relative bound).  Dropout cannot match
``jax.random.bernoulli`` bit for bit, so parity runs at dropout 0 and
dropout is checked on its own.
"""
from __future__ import annotations

import dataclasses
import functools
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core import strategy as jst  # noqa: E402
from repro.core.plan import ExecutionPlan as JaxPlan  # noqa: E402
from repro.data import MTBatchIterator as JaxMTBatchIterator  # noqa: E402
from repro.data import SyntheticMTTask as JaxSyntheticMTTask  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro.optim import optimizers as jopt  # noqa: E402
from repro.train import Trainer as JaxTrainer  # noqa: E402
from repro.train import perplexity as jax_perplexity  # noqa: E402
from repro.train.trainer import make_grad_fn as jax_make_grad_fn  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.plan import ExecutionPlan  # noqa: E402
from repro_torch.data import MTBatchIterator, SyntheticMTTask  # noqa: E402
from repro_torch.kernels.lstm_cell import ops as lstm_ops  # noqa: E402
from repro_torch.kernels.luong_attn import ops as luong_ops  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.models import lstm  # noqa: E402
from repro_torch.models.common import tree_leaves, tree_map  # noqa: E402
from repro_torch.optim import optimizers as opt  # noqa: E402
from repro_torch.train import Trainer, perplexity  # noqa: E402
from repro_torch.train.trainer import batch_to_device, init_train_state, make_grad_fn, make_train_step  # noqa: E402

pytestmark = pytest.mark.torch_port

STAGE_KERNELS = ("cuda", "torch")
FP32_TOL = dict(atol=1e-4, rtol=1e-3)


@functools.lru_cache(maxsize=None)
def _model(dtype="float32", input_feeding=False, dropout=0.0):
    """(jax cfg, jax params, port cfg, port params): one weight set, bridged."""
    kw = dict(dropout=dropout, dtype=dtype, input_feeding=input_feeding)
    jcfg = dataclasses.replace(jax_get_config("seq2seq-rnn", smoke=True), **kw)
    cfg = dataclasses.replace(get_config("seq2seq-rnn", smoke=True), **kw)
    jparams, _ = js2s.init_seq2seq(jax.random.key(0), jcfg)
    params = bridge.params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _batches(cfg, n, B=4, seed=0, max_len=10):
    task = SyntheticMTTask(vocab_size=cfg.vocab_size, min_len=4, max_len=max_len)
    it = MTBatchIterator(task, batch_size=B, seed=seed)
    return [next(it) for _ in range(n)]


def _jax_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _flat_jax(tree):
    """Leaves of a JAX param tree in the port's traversal order (dict
    insertion order, as the port's tree_leaves walks it)."""
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


def _assert_grads(grads, jgrads, dt, what):
    leaves, jleaves = tree_leaves(grads), _flat_jax(jgrads)
    assert len(leaves) == len(jleaves)
    for i, (g, jg) in enumerate(zip(leaves, jleaves)):
        assert g.dtype == torch.float32, f"{what} leaf {i} is {g.dtype}"
        g = g.numpy()
        if dt == "float32":
            np.testing.assert_allclose(g, jg, **FP32_TOL, err_msg=f"{what} leaf {i}")
        else:
            rel = float(np.abs(g - jg).max()) / (float(np.abs(jg).max()) + 1e-6)
            assert rel < 0.1, (what, i, rel)


def _jax_step(jcfg, jparams, batch, micro_batches=1):
    plan = JaxPlan(strategy=jst.Strategy.SINGLE, stage_kernel="pallas_interpret", micro_batches=micro_batches)
    loss, _, grads = jax.jit(jax_make_grad_fn(jcfg, plan))(jparams, _jax_batch(batch), jax.random.key(5))
    return float(loss), grads


# ---------------------------------------------------------------------------
# one step: loss and every grad leaf
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("input_feeding", [False, True], ids=["no_input_feeding", "input_feeding"])
@pytest.mark.parametrize("dt", ["float32", "bfloat16"])
def test_grad_fn_matches_jax(dt, input_feeding):
    jcfg, jparams, cfg, params = _model(dt, input_feeding)
    batch = _batches(cfg, 1)[0]
    jloss, jgrads = _jax_step(jcfg, jparams, batch)
    tol = 1e-4 if dt == "float32" else 0.03
    for sk in STAGE_KERNELS:
        loss, extras, grads = make_grad_fn(cfg, ExecutionPlan(stage_kernel=sk))(params, batch_to_device(batch, "cpu"))
        assert abs(float(loss) - jloss) < tol, (sk, float(loss), jloss)
        assert float(extras["denom"]) == float(batch["tgt_mask"].sum())
        _assert_grads(grads, jgrads, dt, f"{dt} {sk} input_feeding={input_feeding}")


def test_cuda_stage_kernel_routes_through_both_wrappers():
    """On CPU tensors the wrappers run their plain versions (no launch)
    and their Functions' backwards; the loss equals the plain path's."""
    _, _, cfg, params = _model()
    batch = batch_to_device(_batches(cfg, 1)[0], "cpu")
    before = (lstm_ops.lstm_cell_fused.launches, luong_ops.luong_attention_fused.launches)
    loss_k, _, _ = make_grad_fn(cfg, ExecutionPlan(stage_kernel="cuda"))(params, batch)
    loss_p, _, _ = make_grad_fn(cfg, ExecutionPlan(stage_kernel="torch"))(params, batch)
    assert (lstm_ops.lstm_cell_fused.launches, luong_ops.luong_attention_fused.launches) == before
    assert abs(float(loss_k) - float(loss_p)) < 1e-5


def test_micro_batch_accumulation():
    """micro_batches=2 equals 1 at fp32 on a batch whose halves carry equal
    token counts (the accumulated grads are a mean of per-microbatch
    means), and equals JAX's micro_batches=2 on a ragged batch."""
    jcfg, jparams, cfg, params = _model()
    half = _batches(cfg, 1, B=2)[0]
    even = {k: np.concatenate([v, v]) for k, v in half.items()}
    t = batch_to_device(even, "cpu")
    l1, _, g1 = make_grad_fn(cfg, ExecutionPlan(stage_kernel="cuda"))(params, t)
    l2, _, g2 = make_grad_fn(cfg, ExecutionPlan(stage_kernel="cuda", micro_batches=2))(params, t)
    assert abs(float(l1) - float(l2)) < 1e-6
    for a, b in zip(tree_leaves(g1), tree_leaves(g2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-6, rtol=1e-5)

    ragged = _batches(cfg, 1, seed=7)[0]
    jloss, jgrads = _jax_step(jcfg, jparams, ragged, micro_batches=2)
    loss, extras, grads = make_grad_fn(cfg, ExecutionPlan(micro_batches=2))(params, batch_to_device(ragged, "cpu"))
    assert abs(float(loss) - jloss) < 1e-4
    assert float(extras["denom"]) == float(ragged["tgt_mask"].sum())
    _assert_grads(grads, jgrads, "float32", "micro_batches=2")


# ---------------------------------------------------------------------------
# the Trainer over several steps
# ---------------------------------------------------------------------------


def test_batch_iterator_copy_yields_jax_arrays():
    task, jtask = SyntheticMTTask(vocab_size=512), JaxSyntheticMTTask(vocab_size=512)
    it, jit_ = MTBatchIterator(task, batch_size=5, seed=3), JaxMTBatchIterator(jtask, batch_size=5, seed=3)
    for _ in range(4):
        b, jb = next(it), next(jit_)
        assert b.keys() == jb.keys()
        for k in b:
            assert b[k].dtype == jb[k].dtype and np.array_equal(b[k], jb[k]), k


def test_trainer_loss_trajectory_matches_jax():
    """Five steps of Adam (clip 5.0) at fp32 on the same batches: the port's
    Trainer on the kernel path against JAX's Trainer on a meshless plan."""
    jcfg, jparams, cfg, params = _model()
    steps = 5

    def task():
        return SyntheticMTTask(vocab_size=cfg.vocab_size, min_len=4, max_len=10)

    jtrainer = JaxTrainer(jcfg, jopt.adam(lr=3e-3), JaxMTBatchIterator(task(), 4, seed=11),
                          plan=JaxPlan(strategy=jst.Strategy.SINGLE), params=jparams, seed=0)
    jtrainer.run(steps, log_every=1, log=lambda s: None)
    trainer = Trainer(cfg, opt.adam(lr=3e-3), MTBatchIterator(task(), 4, seed=11),
                      plan=ExecutionPlan(stage_kernel="cuda"), params=params, seed=0, device="cpu")
    trainer.run(steps, log_every=1, log=lambda s: None)
    losses = [h["loss"] for h in trainer.history]
    jlosses = [h["loss"] for h in jtrainer.history]
    assert len(losses) == steps
    np.testing.assert_allclose(losses, jlosses, atol=1e-4, rtol=0)
    assert losses[-1] < losses[0]
    assert int(trainer.state.opt_state.step) == steps


# ---------------------------------------------------------------------------
# optimizers
# ---------------------------------------------------------------------------


def _trees(seed=0):
    """(port params, port grads, JAX params, JAX grads): one small fp32 tree each."""
    rng = np.random.default_rng(seed)
    shapes = {"a": (3, 4), "b": [(5,), (2, 2, 3)]}

    def draw(scale):
        return {"a": np.float32(rng.normal(size=shapes["a"]) * scale),
                "b": [np.float32(rng.normal(size=s) * scale) for s in shapes["b"]]}

    p, g = draw(1.0), draw(3.0)
    as_torch = lambda t: {"a": torch.from_numpy(t["a"]), "b": [torch.from_numpy(x) for x in t["b"]]}  # noqa: E731
    return as_torch(p), as_torch(g), jax.tree.map(jnp.asarray, p), jax.tree.map(jnp.asarray, g)


def _same_tree(t, j, tol=dict(atol=1e-7, rtol=1e-6)):
    for a, b in zip(tree_leaves(t), _flat_jax(j)):
        np.testing.assert_allclose(a.numpy(), b, **tol)


@pytest.mark.parametrize(
    "name,make,jmake",
    [
        ("adam", lambda: opt.adam(lr=1e-2), lambda: jopt.adam(lr=1e-2)),
        ("adam_wd", lambda: opt.adam(lr=1e-2, weight_decay=0.1), lambda: jopt.adam(lr=1e-2, weight_decay=0.1)),
        ("sgd", lambda: opt.sgd(lr=0.5), lambda: jopt.sgd(lr=0.5)),
        ("sgd_momentum", lambda: opt.sgd(lr=0.5, momentum=0.9), lambda: jopt.sgd(lr=0.5, momentum=0.9)),
    ],
)
def test_optimizer_matches_jax(name, make, jmake):
    tp, tg, jp, jg = _trees()
    o, jo = make(), jmake()
    st, jst_ = o.init(tp), jo.init(jp)
    for step in range(3):
        u, st = o.update(tg, st, tp, lr_scale=0.7)
        ju, jst_ = jo.update(jg, jst_, jp, lr_scale=0.7)
        _same_tree(u, ju)
        tp, jp = opt.apply_updates(tp, u), jopt.apply_updates(jp, ju)
        _same_tree(tp, jp)
        tg = tree_map(lambda x: x * 0.5, tg)
        jg = jax.tree.map(lambda x: x * 0.5, jg)
    assert int(st.step) == int(jst_.step) == 3
    _same_tree(st.m, jst_.m)


@pytest.mark.parametrize("max_norm", [0.5, 100.0])
def test_clip_and_global_norm_match_jax(max_norm):
    _, tg, _, jg = _trees(1)
    assert abs(float(opt.global_norm(tg)) - float(jopt.global_norm(jg))) < 1e-5
    clipped, norm = opt.clip_by_global_norm(tg, max_norm)
    jclipped, jnorm = jopt.clip_by_global_norm(jg, max_norm)
    assert abs(float(norm) - float(jnorm)) < 1e-5
    _same_tree(clipped, jclipped)
    if max_norm < float(norm):
        assert abs(float(opt.global_norm(clipped)) - max_norm) < 1e-5


# ---------------------------------------------------------------------------
# fp16 dynamic loss scaling (the meshless cases of tests/test_mixed_precision.py)
# ---------------------------------------------------------------------------


def _fp16_step(loss_scale_init, loss_scale_growth=2000):
    _, _, cfg, params = _model()
    plan = ExecutionPlan(compute_dtype="float16", loss_scale_init=loss_scale_init,
                         loss_scale_growth=loss_scale_growth)
    step = make_train_step(cfg, opt.adam(), plan=plan)
    state = init_train_state(params, opt.adam(), plan=plan, cfg=cfg)
    return step, state, batch_to_device(_batches(cfg, 1)[0], "cpu")


def test_fp16_overflow_step_is_a_bitwise_no_op_that_halves_the_scale():
    step, state, batch = _fp16_step(2.0**126)
    assert float(state.scaling.scale) == 2.0**126 and int(state.scaling.good_steps) == 0
    state2, m = step(state, batch, 1.0, None)
    assert m["overflow"] == 1.0
    assert float(m["loss_scale"]) == 2.0**125
    assert int(state2.scaling.good_steps) == 0
    for a, b in zip(tree_leaves(state.params), tree_leaves(state2.params)):
        assert torch.equal(a, b)
    for a, b in zip(tree_leaves(state.opt_state), tree_leaves(state2.opt_state)):
        assert torch.equal(a, b)
    assert math.isfinite(float(m["loss"]))  # the reported loss is unscaled


def test_fp16_clean_streak_doubles_the_scale():
    step, state, batch = _fp16_step(2.0**10, loss_scale_growth=2)
    p0 = tree_leaves(state.params)
    state, m = step(state, batch, 1.0, None)
    assert m["overflow"] == 0.0 and float(m["loss_scale"]) == 2.0**10 and int(state.scaling.good_steps) == 1
    assert any(not torch.equal(a, b) for a, b in zip(p0, tree_leaves(state.params)))
    assert all(p.dtype == torch.float32 for p in tree_leaves(state.params))  # fp32 masters stay fp32
    state, m = step(state, batch, 1.0, None)
    assert float(m["loss_scale"]) == 2.0**11 and int(state.scaling.good_steps) == 0


def test_non_fp16_plans_carry_no_loss_scale():
    _, _, cfg, params = _model()
    for dt in ("float32", "bfloat16"):
        assert init_train_state(params, opt.adam(), plan=ExecutionPlan(compute_dtype=dt), cfg=cfg).scaling is None


# ---------------------------------------------------------------------------
# dropout
# ---------------------------------------------------------------------------


def test_dropout_keep_rate_and_scale():
    p = 0.3
    h = torch.full((64, 50, 16), 2.0)
    g = torch.Generator()
    g.manual_seed(0)
    out = lstm.dropout(h, p, g)
    kept = out != 0
    n = h.numel()
    rate = float(kept.float().mean())
    assert abs(rate - (1 - p)) < 5 * math.sqrt(p * (1 - p) / n)  # five binomial standard deviations
    assert torch.allclose(out[kept], torch.full((), 2.0 / (1 - p)))


@pytest.mark.parametrize("stage_kernel", STAGE_KERNELS)
def test_dropout_in_the_step_follows_the_generator(stage_kernel):
    _, _, cfg, params = _model(dropout=0.3)
    batch = batch_to_device(_batches(cfg, 1)[0], "cpu")
    fn = make_grad_fn(cfg, ExecutionPlan(stage_kernel=stage_kernel))

    def loss(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return float(fn(params, batch, g)[0])

    assert loss(1) == loss(1)
    assert loss(1) != loss(2)
    assert loss(1) != float(fn(params, batch, None)[0])  # no generator: no dropout


# ---------------------------------------------------------------------------
# evaluation, launcher
# ---------------------------------------------------------------------------


def test_perplexity_matches_jax():
    jcfg, jparams, cfg, params = _model()
    batches = _batches(cfg, 3, seed=5)
    want = jax_perplexity(jparams, jcfg, iter(batches), max_batches=3)
    for sk in STAGE_KERNELS:
        got = perplexity(params, cfg, iter(batches), max_batches=3, stage_kernel=sk)
        assert abs(got - want) / want < 1e-5, (sk, got, want)


def test_perplexity_matches_jax_input_feeding():
    """The same with input feeding: the decoder step-major, eq. 1-4 inside
    its recurrence, on both stage kernels."""
    jcfg, jparams, cfg, params = _model(input_feeding=True)
    batches = _batches(cfg, 3, seed=5)
    want = jax_perplexity(jparams, jcfg, iter(batches), max_batches=3)
    for sk in STAGE_KERNELS:
        got = perplexity(params, cfg, iter(batches), max_batches=3, stage_kernel=sk)
        assert abs(got - want) / want < 1e-5, (sk, got, want)


def test_plan_rejects_unported_fields():
    """The JAX plan's multi-device fields are ported (``tests/test_torch_hybrid.py``
    and ``tests/test_torch_layouts.py`` drive them), ``virtual_stages`` with
    the interleaved schedule included; bad values raise."""
    for kw in (dict(strategy="hybrid"), dict(use_pipeline=True), dict(overlap=True), dict(schedule="1f1b"),
               dict(overlap=True, bucket_bytes=1024), dict(mesh=None), dict(strategy="hybrid_opt"),
               dict(schedule="interleaved", virtual_stages=2)):
        ExecutionPlan(**kw)
    with pytest.raises(ValueError, match="not a valid Strategy"):
        ExecutionPlan(strategy="pipeline")
    with pytest.raises(ValueError, match="stage_kernel"):
        ExecutionPlan(stage_kernel="pallas")
    with pytest.raises(ValueError, match="micro_batches"):
        ExecutionPlan(micro_batches=3).validate_batch(8)


def test_launcher_prints_config_and_step_lines(capsys):
    launch_train.main(["--arch", "seq2seq-rnn", "--smoke", "--device", "cpu", "--steps", "4", "--batch", "4"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=seq2seq-rnn-smoke params=") and "stage_kernel=cuda" in lines[0]
    steps = [ln for ln in lines if ln.startswith("step")]
    assert [int(ln.split()[1]) for ln in steps] == [1, 2, 3, 4]
    assert all("loss" in ln and "tok/s" in ln for ln in steps)
    for flags in (["--mesh", "pod"], ["--mesh", "multipod"]):
        with pytest.raises(NotImplementedError, match="production mesh .* not ported"):
            launch_train.main(["--smoke", "--device", "cpu", *flags])
    launch_train.main(["--smoke", "--device", "cpu", "--steps", "1", "--batch", "4", "--strategy", "hybrid",
                       "--pipeline", "--schedule", "interleaved", "--virtual-stages", "2"])
    assert "pipeline=True" in capsys.readouterr().out  # the ring, two layer chunks of the one stage


def test_launcher_input_feeding_prints_config_and_falling_step_lines(capsys):
    """``--input-feeding`` trains the baseline / HybridNMTIF model: the config
    line says so and the loss falls over the logged steps."""
    launch_train.main(["--arch", "seq2seq-rnn", "--smoke", "--device", "cpu", "--input-feeding", "--steps", "4",
                       "--batch", "8", "--lr", "3e-3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith("arch=seq2seq-rnn-smoke params=") and "input_feeding=True" in lines[0]
    losses = [float(ln.split()[3]) for ln in lines if ln.startswith("step")]
    assert len(losses) == 4 and all(b < a for a, b in zip(losses, losses[1:])), losses
