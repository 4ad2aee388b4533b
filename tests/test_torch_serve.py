"""The port's ``ContinuousEngine`` against the JAX package's on the serve
harness's ``seq2seq-encdec_memory`` case: fp32 smoke model (weights bridged
from the harness's), ``max_slots=2``, ``max_len=32``, ``prefill_chunk=4``,
the harness's prompts twice over so slots recycle.  Tokens must be equal
for ``torch``<->``jnp`` and ``cuda``<->``pallas_interpret``.  Also: early
EOS, the poison canary, per-request errors, ``max_new=0``, admission, the
plan's checks and the launcher's summary line on the CPU.

The JAX engine passes host numpy arrays to ``jnp.asarray`` and mutates them
right after dispatch (the recycle masks, the current tokens).  On this
jax's CPU backend ``jnp.asarray`` can alias the numpy buffer, so under load
the asynchronous computation may read the mutated values and the engine's
outputs vary from run to run.  ``jax_engine_copies_host_arrays`` makes the
reference copy those arrays for the duration of a test; nothing of the JAX
package changes.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import types  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import serve_harness as sh  # noqa: E402

import repro.serve.engine as jax_engine  # noqa: E402

from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.plan import ServePlan  # noqa: E402
from repro_torch.serve import ContinuousEngine, RequestError, make_sampler  # noqa: E402

pytestmark = pytest.mark.torch_port

CASE = sh.REGISTRY["seq2seq-encdec_memory"]
PAIRS = [("torch", "jnp"), ("cuda", "pallas_interpret")]


@functools.lru_cache(maxsize=None)
def _port_model():
    jcfg, jparams = sh.build(CASE.arch)
    cfg = dataclasses.replace(get_config(CASE.arch, smoke=True), dropout=jcfg.dropout, dtype=jcfg.dtype)
    return cfg, bridge.params_from_jax(jax.device_get(jparams), device="cpu")


def _engine(stage_kernel="torch", **kw):
    cfg, params = _port_model()
    plan_kw = dict(max_slots=2, max_len=32, prefill_chunk=4, stage_kernel=stage_kernel)
    plan_kw.update(kw.pop("plan", {}))
    engine_kw = dict(CASE.engine_kwargs)
    engine_kw.update(kw)
    return ContinuousEngine(cfg, params, ServePlan(**plan_kw), **engine_kw)


def _prompts(seed=0):
    return sh.prompts_for(CASE, seed=seed) * 2  # 6 requests on 2 slots: recycling


def _lists(outs):
    return [o.tolist() for o in outs]


@pytest.fixture
def jax_engine_copies_host_arrays(monkeypatch):
    def asarray(x, *args, **kwargs):
        return jnp.asarray(np.array(x, copy=True) if isinstance(x, np.ndarray) else x, *args, **kwargs)

    proxy = types.SimpleNamespace(**{k: getattr(jnp, k) for k in dir(jnp) if not k.startswith("__")})
    proxy.asarray = asarray
    monkeypatch.setattr(jax_engine, "jnp", proxy)


@pytest.mark.usefixtures("jax_engine_copies_host_arrays")
@pytest.mark.parametrize("pair", PAIRS, ids=lambda p: f"{p[0]}-{p[1]}")
def test_engine_tokens_equal_jax(pair):
    ours, theirs = pair
    prompts = _prompts()
    want = sh.make_engine(CASE, stage_kernel=theirs).run(prompts, 6)
    eng = _engine(ours)
    got = eng.run(prompts, 6)
    assert _lists(got) == _lists(want)
    assert eng.decode_ticks > 0 and eng.prefill_steps > 0


@pytest.mark.usefixtures("jax_engine_copies_host_arrays")
def test_early_eos_matches_jax_and_truncates():
    prompts = _prompts()
    free = _engine().run(prompts, 8)
    eos = int(free[0][2])  # an EOS the model actually emits
    got = _engine(eos=eos).run(prompts, 8)
    want = sh.make_engine(CASE, engine_kwargs={"eos": eos}).run(prompts, 8)
    assert _lists(got) == _lists(want)
    for g, ref in zip(got, free):
        ref = ref.tolist()
        assert g.tolist() == (ref[: ref.index(eos) + 1] if eos in ref else ref)


@pytest.mark.parametrize("stage_kernel", ["torch", "cuda"])
def test_poisoned_recycling_equals_plain(stage_kernel):
    """Retired slots are filled with NaN / 2**30 / True before reuse: a
    reset that missed any leaf would change the outputs or trip the
    live-state finiteness check."""
    prompts = _prompts(seed=1)
    plain = _engine(stage_kernel).run(prompts, 5)
    eng = _engine(stage_kernel, poison_on_recycle=True, check_live_finite=True)
    assert _lists(eng.run(prompts, 5)) == _lists(plain)
    assert eng.finite_checks == eng.decode_ticks > 0


def test_bad_requests_fail_alone():
    good = _prompts()[:2]
    prompts = [good[0], np.zeros((0,), np.int32), np.full(33, 5, np.int32), good[1]]
    outs = _engine().run(prompts, 4)
    assert isinstance(outs[1], RequestError) and "non-empty" in outs[1].reason
    assert isinstance(outs[2], RequestError) and "exceeds memory capacity" in outs[2].reason
    alone = _engine().run(good, 4)
    assert [outs[0].tolist(), outs[3].tolist()] == _lists(alone)


def test_max_new_zero_and_per_request_budgets():
    prompts = _prompts()[:3]
    eng = _engine()
    outs = eng.run(prompts, [0, 3, 1])
    assert [len(o) for o in outs] == [0, 3, 1]
    assert _lists(outs)[1:] == [o[:n] for o, n in zip(_lists(_engine().run(prompts[1:], 3)), (3, 1))]
    assert eng.run(prompts[:1], 0)[0].shape == (0,) and eng.prefill_steps == 0


def test_static_admission():
    prompts = _prompts()[:3]
    cont = _engine(plan=dict(max_slots=3)).run(prompts, 4)
    stat = _engine(plan=dict(max_slots=3, admission="static")).run(prompts, 4)
    assert _lists(stat) == _lists(cont)
    with pytest.raises(ValueError, match="static admission"):
        _engine(plan=dict(admission="static")).run(prompts, 4)


def test_temperature_sampling_is_seeded():
    prompts = _prompts()[:2]

    def run(seed):
        g = torch.Generator()
        g.manual_seed(seed)
        return _lists(_engine().run(prompts, 6, sampler=make_sampler(0.8), generator=g))

    assert run(3) == run(3)


def test_plan_checks():
    cfg, _ = _port_model()
    plan = ServePlan.for_config(cfg, max_len=30, prefill_chunk=8)
    assert plan.prefill_chunk == 6 and plan.cache_policy == "encdec_memory" and plan.stage_kernel == "cuda"
    for bad in (dict(page_size=8), dict(draft_arch="xlstm-350m"), dict(mesh=None), dict(window=4)):
        with pytest.raises(NotImplementedError, match="not ported"):
            ServePlan.for_config(cfg, **bad)
    with pytest.raises(ValueError, match="not ported"):
        ServePlan(cache_policy="full_kv")
    with pytest.raises(ValueError, match="must divide"):
        ServePlan(max_len=30, prefill_chunk=8)
    with pytest.raises(ValueError, match="stage_kernel"):
        ServePlan(stage_kernel="pallas")


def test_launcher_summary_line_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve

    outs = launch_serve.main(["--arch", "seq2seq-rnn", "--smoke", "--device", "cpu", "--batch", "3",
                              "--prompt-len", "6", "--steps", "3", "--prefill-chunk", "4", "--max-slots", "2"])
    line = capsys.readouterr().out.splitlines()[0]
    tok = sum(len(o) for o in outs)
    assert line.startswith(f"[seq2seq-rnn-smoke | encdec_memory | continuous] 3 requests, {tok} tokens in ")
    assert line.endswith(" tok/s)")
    with pytest.raises(SystemExit, match="not ported yet"):
        launch_serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu"])
