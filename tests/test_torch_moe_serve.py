"""The port's MoE LM serving path (``models/transformer.py`` with the
``models/moe.py`` blocks, ``ServeEngine``) against the JAX package on the
CPU.

The model is ``reduced(qwen3-moe-30b-a3b)`` with 2 kv heads (GQA 4/2 in the
flat layout), 8 experts, top-2, fp32, its weights made by the JAX package
and bridged.  At capacity factor 1.25 slots are dropped in the prefill and
collide in decode, as in the full model.  Prompts fall on both sides of its
window of 64.  ``forward_prefill`` logits and caches must match JAX's
within 1e-4 on both kernel paths (``cuda``: the flash and moe_gemm
wrappers, here their plain versions; ``torch``: the chunked attention and
``expert_ffn``), ``forward_decode`` too, and ``ServeEngine.generate`` must
give JAX's greedy tokens exactly.  The tree, the parameter counts (full and
8-layer cut), the plan and the launcher are held against JAX's as well.
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
from repro.models import transformer as jtfm  # noqa: E402
from repro.serve.engine import ServeEngine as JaxServeEngine  # noqa: E402
from repro.serve.engine import pad_cache as jax_pad_cache  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.plan import ServePlan  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as moe_ops  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.serve.engine import ContinuousEngine, ServeEngine, pad_cache  # noqa: E402

pytestmark = pytest.mark.torch_port

ARCH = "qwen3-moe-30b-a3b"
TOL = dict(atol=1e-4, rtol=1e-4)
WINDOW = 64  # reduced()'s window


def _small(cfg):
    return dataclasses.replace(cfg, num_kv_heads=2, dtype="float32",
                               moe=dataclasses.replace(cfg.moe, num_experts=8, top_k=2))


@functools.lru_cache(maxsize=None)
def _model():
    jcfg = _small(jax_get_config(ARCH, smoke=True))
    cfg = _small(get_config(ARCH, smoke=True))
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
@pytest.mark.parametrize("S", [40, 100])
def test_forward_prefill_matches_jax(S, window, kernel):
    """Logits at the last position and every layer's cache; both kernels of
    the path (attention and expert FFN) follow ``kernel``."""
    _, _, cfg, params = _model()
    want_logits, want_cache = _jax_prefill(S, window)
    ctx = tfm.RunCtx(mode="prefill", window=window, q_chunk=128, kernel=kernel)
    before = moe_ops.moe_gemm_fused.launches
    logits, cache = tfm.forward_prefill(params, cfg, torch.from_numpy(_tokens(2, S, S)), ctx=ctx)
    assert moe_ops.moe_gemm_fused.launches == before  # the host runs the plain version
    np.testing.assert_allclose(logits.numpy(), want_logits, **TOL)
    assert cache.length == int(want_cache.length) == S
    got, want = _port_cache_arrays(cache), _cache_arrays(want_cache)
    assert [g.shape for g in got] == [w.shape for w in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, **TOL)


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
@pytest.mark.parametrize("chunk", [1, 4])
@pytest.mark.parametrize("window", [None, WINDOW])
def test_forward_decode_matches_jax(window, chunk, kernel):
    """Two decode calls after a 100-token prefill padded to 128 slots (or
    kept at the window's 64: a rolling buffer).  A decode step of 2 tokens
    has 4 slots on 8 experts (capacity 1), so slots collide and drop."""
    jcfg, jparams, cfg, params = _model()
    S = 100
    toks = _tokens(2, S, 5)
    new = _tokens(2, 2 * chunk, 6)
    jctx = jtfm.RunCtx(mode="decode", window=window, remat=False)
    _, jc, _ = jtfm.forward_prefill(jparams, jcfg, jnp.asarray(toks),
                                    ctx=jtfm.RunCtx(mode="prefill", window=window, remat=False))
    jc = jax_pad_cache(jcfg, jc, 128)
    pctx = tfm.RunCtx(mode="prefill", window=window, kernel=kernel)
    _, c = tfm.forward_prefill(params, cfg, torch.from_numpy(toks), ctx=pctx)
    c = pad_cache(cfg, c, 128)
    ctx = tfm.RunCtx(mode="decode", window=window, kernel=kernel)
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


def test_init_lm_matches_jax_tree():
    """Same names, stacked [G, ...] shapes ([G, E, d, F] expert stacks and the
    [G, d, E] router) and scales as the JAX package's ``init_lm``."""
    jcfg, jparams, cfg, _ = _model()
    params = tfm.init_lm(0, cfg, device="cpu")
    jflat = {jax.tree_util.keystr(k): np.asarray(v) for k, v in jax.tree_util.tree_flatten_with_path(jparams)[0]}
    flat = {jax.tree_util.keystr(k): v.numpy() for k, v in jax.tree_util.tree_flatten_with_path(
        params, is_leaf=lambda x: isinstance(x, torch.Tensor))[0]}
    assert sorted(flat) == sorted(jflat)
    for name, a in flat.items():
        assert a.shape == jflat[name].shape, name
        assert a.std() == pytest.approx(jflat[name].std(), rel=0.2, abs=1e-6), name
    moe = params["blocks"][0]["moe"]
    assert tuple(moe["w1"].shape) == (2, 8, 256, 128) and tuple(moe["router"].shape) == (2, 256, 8)
    assert "mlp" not in params["blocks"][0] and "lm_head" in params
    n = sum(a.size for a in flat.values())
    assert n == cfg.param_count() + cfg.num_layers * 2 * cfg.head_dim


def test_param_count_matches_jax():
    """The full config and the 8-layer cut that ``chip_smoke.py`` serves."""
    cfg, jcfg = get_config(ARCH), jax_get_config(ARCH)
    assert cfg.param_count() == jcfg.param_count() == 30_532_110_336
    cut, jcut = dataclasses.replace(cfg, num_layers=8), dataclasses.replace(jcfg, num_layers=8)
    assert cut.param_count() == jcut.param_count() == 5_607_294_976
    assert cfg.layer_group == jcfg.layer_group == 1
    sm, jsm = get_config(ARCH, smoke=True), jax_get_config(ARCH, smoke=True)
    assert (sm.moe.num_experts, sm.moe.top_k, sm.moe.d_ff_expert) == (jsm.moe.num_experts, jsm.moe.top_k,
                                                                      jsm.moe.d_ff_expert) == (4, 2, 128)
    assert sm.param_count() == jsm.param_count()


def test_cast_params_casts_experts_and_keeps_router_fp32():
    _, _, cfg, params = _model()
    cast = tfm.cast_params(params, dataclasses.replace(cfg, dtype="bfloat16"))
    blk = cast["blocks"][0]["moe"]
    assert all(blk[k].dtype == torch.bfloat16 for k in ("w1", "wg", "w2"))
    assert blk["router"].dtype == torch.float32 and cast["lm_head"]["w"].dtype == torch.float32


@pytest.mark.parametrize("overrides", [dict(), dict(max_len=64, prefill_chunk=48), dict(admission="static", max_slots=3)])
def test_plan_for_moe_config_matches_jax(overrides):
    jcfg, _, cfg, _ = _model()
    got = ServePlan.for_config(cfg, **overrides)
    want = JaxServePlan.for_config(jcfg, **overrides)
    for field in ("cache_policy", "window", "max_len", "prefill_chunk", "max_slots", "admission"):
        assert getattr(got, field) == getattr(want, field), field


def test_continuous_engine_still_rejects_the_moe_family():
    _, _, cfg, params = _model()
    with pytest.raises(NotImplementedError, match="ROADMAP.md queue 1 item 5"):
        ContinuousEngine(cfg, params, ServePlan.for_config(cfg))


def test_launcher_moe_on_cpu(capsys):
    from repro_torch.launch import serve as launch_serve

    out = launch_serve.main(["--arch", ARCH, "--smoke", "--engine", "static", "--device", "cpu",
                             "--batch", "2", "--prompt-len", "80", "--steps", "5"])
    line = capsys.readouterr().out.splitlines()[0]
    assert tuple(out.shape) == (2, 5)
    assert line.startswith(f"[{ARCH}-smoke | window | static] generated (2, 5) in ")
    # the full model's fp32 masters (122 GB) and bf16 copy (60 GB) exceed one card: exit before any allocation
    with pytest.raises(SystemExit, match=r"30,532,122,624 parameters x 4 B = 122 GB and the bfloat16 copy cast for "
                                         r"each generate 29,896,998,912 x 2 B = 60 GB: 182 GB.*ROADMAP.md queue 4"):
        launch_serve.main(["--arch", ARCH, "--engine", "static", "--device", "cpu"])
