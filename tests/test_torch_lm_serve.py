"""The port's dense LM serving path (``repro_torch.models.transformer`` and
``repro_torch.serve.engine.ServeEngine``) against the JAX package on the CPU.

The model is ``reduced(qwen3-1.7b)`` with 2 kv heads (GQA 4/2 in the flat
layout: the smoke config alone has 4/4 heads and would never test the kv
broadcast), fp32, its weights made by the JAX package and bridged.  Prompts
fall on both sides of its window of 64.  ``forward_prefill`` logits and
caches must match JAX's within 1e-4 on both prefill attention paths
(``RunCtx.kernel`` ``cuda``: the flash wrapper, here its plain version;
``torch``: the chunked attention), ``forward_decode`` too, and
``ServeEngine.generate`` must give JAX's greedy tokens exactly.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.core.plan import ServePlan as JaxServePlan  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import transformer as jtfm  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.engine import pad_cache as jax_pad_cache  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.plan import ServePlan  # noqa: E402
from repro_torch.models import common  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve.engine import ContinuousEngine, ServeEngine, pad_cache  # noqa: E402

pytestmark = pytest.mark.torch_port

TOL = dict(atol=1e-4, rtol=1e-4)
WINDOW = 64  # reduced()'s window


@functools.lru_cache(maxsize=None)
def _model():
    jcfg = dataclasses.replace(jax_get_config("qwen3-1.7b", smoke=True), num_kv_heads=2, dtype="float32")
    cfg = dataclasses.replace(get_config("qwen3-1.7b", smoke=True), num_kv_heads=2, dtype="float32")
    jparams, _ = jtfm.init_lm(jax.random.key(0), jcfg)
    return jcfg, jparams, cfg, bridge.params_from_jax(jax.device_get(jparams), device="cpu")


def _tokens(B: int, S: int, seed: int) -> np.ndarray:
    return np.random.default_rng(seed).integers(3, 512, size=(B, S)).astype(np.int32)


def _cache_arrays(cache) -> list:
    return [np.asarray(a) for a in jax.tree.leaves(cache.entries)]


def _port_cache_arrays(cache) -> list:
    return [t.numpy() for kv in cache.entries for t in kv]


@functools.lru_cache(maxsize=None)
def _jax_prefill(S: int, window):
    jcfg, jparams, _, _ = _model()
    ctx = jtfm.RunCtx(mode="prefill", window=window, q_chunk=128, remat=False)
    fn = jax.jit(lambda p, t: jtfm.forward_prefill(p, jcfg, t, ctx=ctx)[:2])
    logits, cache = fn(jparams, jnp.asarray(_tokens(2, S, S)))
    return np.asarray(logits), cache


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
@pytest.mark.parametrize("window", [None, WINDOW])
@pytest.mark.parametrize("S", [40, 100, 200])
def test_forward_prefill_matches_jax(S, window, kernel):
    """Logits at the last position and every layer's cache (rolled to the
    window's slot order when S exceeds it)."""
    _, _, cfg, params = _model()
    want_logits, want_cache = _jax_prefill(S, window)
    ctx = tfm.RunCtx(mode="prefill", window=window, q_chunk=128, kernel=kernel)
    logits, cache = tfm.forward_prefill(params, cfg, torch.from_numpy(_tokens(2, S, S)), ctx=ctx)
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    assert cache.length == int(want_cache.length) == S
    got, want = _port_cache_arrays(cache), _cache_arrays(want_cache)
    assert [g.shape for g in got] == [w.shape for w in want]
    assert got[0].shape[2] == (min(S, window) if window else S)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("window", [None, WINDOW])
def test_forward_decode_matches_jax(window, chunk):
    """Two decode calls after a 100-token prefill padded to 128 slots (or kept
    at the window's 64: a rolling buffer); a chunk of 4 on the rolling buffer
    takes ``decode_attention_concat``."""
    jcfg, jparams, cfg, params = _model()
    S = 100
    toks = _tokens(2, S, 5)
    new = _tokens(2, 2 * chunk, 6)
    jctx = jtfm.RunCtx(mode="decode", window=window, remat=False)
    _, jc, _ = jtfm.forward_prefill(jparams, jcfg, jnp.asarray(toks),
                                    ctx=jtfm.RunCtx(mode="prefill", window=window, remat=False))
    jc = jax_pad_cache(jcfg, jc, 128)
    _, c = tfm.forward_prefill(params, cfg, torch.from_numpy(toks), ctx=tfm.RunCtx(mode="prefill", window=window))
    c = pad_cache(cfg, c, 128)
    ctx = tfm.RunCtx(mode="decode", window=window)
    for i in range(2):
        step = new[:, i * chunk : (i + 1) * chunk]
        jl, jc = jtfm.forward_decode(jparams, jcfg, jnp.asarray(step if chunk > 1 else step[:, 0]), jc, ctx=jctx)
        tl, c = tfm.forward_decode(params, cfg, torch.from_numpy(step if chunk > 1 else step[:, 0]), c, ctx=ctx)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), **TOL)
        assert c.length == int(jc.length)
    for g, w in zip(_port_cache_arrays(c), _cache_arrays(jc)):
        np.testing.assert_allclose(g, w, **TOL)


# (prompt length, new tokens, plan overrides): both sides of the window, a
# short prompt whose generation crosses it, and an unwindowed full_kv cache
SERVE_CASES = [
    (40, 12, dict(max_len=WINDOW)),
    (50, 24, dict(max_len=WINDOW)),
    (100, 8, dict(max_len=WINDOW)),
    (100, 8, dict(cache_policy="full_kv", max_len=128)),
]


@functools.lru_cache(maxsize=None)
def _jax_generate(i: int):
    jcfg, jparams, _, _ = _model()
    S, steps, over = SERVE_CASES[i]
    plan = JaxServePlan.for_config(jcfg, **over)
    out = JaxServeEngine(jcfg, jparams, plan=plan).generate(jnp.asarray(_tokens(2, S, 10 + i)), steps)
    return np.asarray(out), plan


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
@pytest.mark.parametrize("i", range(len(SERVE_CASES)),
                         ids=lambda i: f"S{SERVE_CASES[i][0]}-steps{SERVE_CASES[i][1]}-"
                                       f"{SERVE_CASES[i][2].get('cache_policy', 'window')}")
def test_serve_engine_tokens_match_jax(i, kernel):
    _, _, cfg, params = _model()
    S, steps, over = SERVE_CASES[i]
    want, jplan = _jax_generate(i)
    plan = ServePlan.for_config(cfg, stage_kernel=kernel, **over)
    assert (plan.cache_policy, plan.window, plan.max_len, plan.prefill_chunk) == \
        (jplan.cache_policy, jplan.window, jplan.max_len, jplan.prefill_chunk)
    engine = ServeEngine(cfg, params, plan=plan, device="cpu")
    got = engine.generate(_tokens(2, S, 10 + i), steps)
    assert got.dtype == torch.int64 and tuple(got.shape) == (2, steps)
    assert got.tolist() == want.tolist()
    assert engine.prefill_s > 0 and engine.decode_s >= 0


@pytest.mark.parametrize("overrides", [
    dict(), dict(max_len=64, prefill_chunk=48), dict(cache_policy="full_kv", max_len=96, prefill_chunk=40),
    dict(window=16, max_len=64), dict(admission="static", max_slots=3),
])
def test_plan_for_dense_config_matches_jax(overrides):
    jcfg, _, cfg, _ = _model()
    got = ServePlan.for_config(cfg, **overrides)
    want = JaxServePlan.for_config(jcfg, **overrides)
    for field in ("cache_policy", "window", "max_len", "prefill_chunk", "max_slots", "admission"):
        assert getattr(got, field) == getattr(want, field), field


def test_plan_rejects_what_jax_rejects():
    _, _, cfg, _ = _model()
    with pytest.raises(ValueError, match="positive window"):
        ServePlan(cache_policy="window")
    with pytest.raises(ValueError, match="cannot exceed window"):
        ServePlan(cache_policy="window", window=8, max_len=32, prefill_chunk=16)
    with pytest.raises(ValueError, match="only meaningful"):
        ServePlan(cache_policy="full_kv", window=8)
    with pytest.raises(ValueError, match="encdec_memory serves the seq2seq family"):
        ServePlan(cache_policy="encdec_memory").validate_for(cfg)
    with pytest.raises(ValueError, match="requires cache_policy='encdec_memory'"):
        ServePlan(cache_policy="full_kv").validate_for(get_config("seq2seq-rnn", smoke=True))
    with pytest.raises(NotImplementedError, match="not ported"):
        ServePlan.for_config(cfg, page_size=16)


def test_engines_reject_the_wrong_family():
    _, _, cfg, params = _model()
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 5"):
        ContinuousEngine(cfg, params, ServePlan.for_config(cfg))
    with pytest.raises(ValueError, match="dense LM family"):
        ServeEngine(get_config("seq2seq-rnn", smoke=True), {}, device="cpu")


def test_full_kv_overflow_raises():
    _, _, cfg, params = _model()
    engine = ServeEngine(cfg, params, plan=ServePlan.for_config(cfg, cache_policy="full_kv", max_len=64),
                         device="cpu")
    with pytest.raises(ValueError, match="exceed the cache capacity"):
        engine.generate(_tokens(1, 60, 0), 8)


def test_init_lm_matches_jax_tree():
    """Same names, stacked [G, ...] shapes and scales as the JAX package's
    ``init_lm``; the parameter count is the config's plus the qk-norm scales
    (which ``param_count`` leaves out, as the JAX package's does)."""
    jcfg, jparams, cfg, _ = _model()
    params = tfm.init_lm(0, cfg, device="cpu")
    jflat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    flat = {jax.tree_util.keystr(k): v.numpy() for k, v in jax.tree_util.tree_flatten_with_path(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]}
    assert sorted(flat) == sorted(jflat)
    for name, a in flat.items():
        assert a.shape == jflat[name].shape, name
        assert a.std() == pytest.approx(jflat[name].std(), rel=0.2, abs=1e-6), name
    n = sum(a.size for a in flat.values())
    assert n == cfg.param_count() + cfg.num_layers * 2 * cfg.head_dim
    assert cfg.param_count() == jcfg.param_count()
    full = get_config("qwen3-1.7b")
    assert full.param_count() == jax_get_config("qwen3-1.7b").param_count() == 1_720_567_808


def test_launcher_static_engine_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve

    out = launch_serve.main(["--arch", "qwen3-1.7b", "--smoke", "--engine", "static", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "80", "--steps", "5"])
    line = capsys.readouterr().out.splitlines()[0]
    assert tuple(out.shape) == (2, 5)
    assert line.startswith("[qwen3-1.7b-smoke | window | static] generated (2, 5) in ")
    with pytest.raises(SystemExit, match="ROADMAP.md queue 1 item 5"):
        launch_serve.main(["--arch", "qwen3-1.7b", "--smoke", "--device", "cpu"])
    with pytest.raises(SystemExit, match="continuous engine"):
        launch_serve.main(["--arch", "seq2seq-rnn", "--smoke", "--engine", "static", "--device", "cpu"])


@pytest.mark.parametrize("theta,partial,head_ndims", [(1e6, 1.0, 2), (1e4, 0.5, 1), (1e4, 0.25, 2)])
def test_rope_matches_jax(theta, partial, head_ndims):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7) + (3, 2)[:head_ndims] + (16,)).astype(np.float32)
    pos = np.arange(5, 12)[None]
    got = common.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta, partial, head_ndims=head_ndims)
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta, partial, head_ndims=head_ndims)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm", "silu", "gelu", "tanh", "relu"])
def test_norms_and_activations_match_jax(kind):
    rng = np.random.default_rng(4)
    x = rng.normal(size=(3, 5, 24)).astype(np.float32)
    if kind in ("rmsnorm", "layernorm"):
        p = {"scale": rng.normal(size=24).astype(np.float32), "bias": rng.normal(size=24).astype(np.float32)}
        got = common.apply_norm({k: torch.from_numpy(a) for k, a in p.items()}, torch.from_numpy(x), kind)
        want = jcommon.apply_norm({k: jnp.asarray(a) for k, a in p.items()}, jnp.asarray(x), kind)
    else:
        got = common.activation(kind)(torch.from_numpy(x))
        want = jcommon.activation(kind)(jnp.asarray(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=1e-5)
