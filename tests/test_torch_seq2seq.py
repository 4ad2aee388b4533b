"""The port's seq2seq serving path (``repro_torch.models``) against the JAX
package's, on weights bridged from ``init_seq2seq(jax.random.key(0), smoke
cfg)``: LSTM cell and stack at ``TOL_TIGHT``, the attention-softmax head at
``TOL_ATTN``, ``encode_extend`` / ``decode_step`` for both input-feeding
variants, and ``greedy_decode`` (equal tokens at fp32, logits within 5e-2 at
bf16).  Inputs are made with numpy from a seed and handed to both sides.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from kernel_harness import TOL_ATTN, TOL_TIGHT  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.models import lstm as jlstm  # noqa: E402
from repro.models import seq2seq as js2s  # noqa: E402
from repro_torch import bridge  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.models import lstm  # noqa: E402
from repro_torch.models import seq2seq as s2s  # noqa: E402

pytestmark = pytest.mark.torch_port

DTYPES = ("float32", "bfloat16")
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}


@functools.lru_cache(maxsize=None)
def _model(dtype="float32", input_feeding=False):
    """(jax cfg, jax params, port cfg, port params): one weight set, bridged."""
    kw = dict(dropout=0.0, dtype=dtype, input_feeding=input_feeding)
    jcfg = dataclasses.replace(jax_get_config("seq2seq-rnn", smoke=True), **kw)
    cfg = dataclasses.replace(get_config("seq2seq-rnn", smoke=True), **kw)
    jparams, _ = js2s.init_seq2seq(jax.random.key(0), jcfg)
    params = bridge.params_from_jax(jax.device_get(jparams), device="cpu")
    return jcfg, jparams, cfg, params


def _close(got, want, tol, what):
    got = got.float().numpy() if isinstance(got, torch.Tensor) else np.asarray(got, np.float32)
    np.testing.assert_allclose(got, np.asarray(want, np.float32), **tol, err_msg=what)


def _close_cache(c, jc, tol, what):
    _close(c.memory, jc.memory, tol, what + " memory")
    assert c.src_mask.numpy().tolist() == np.asarray(jc.src_mask).tolist(), what + " src_mask"
    for name in ("enc_states", "dec_states"):
        for li, (st, jst) in enumerate(zip(getattr(c, name), getattr(jc, name))):
            _close(st.h, jst.h, tol, f"{what} {name}[{li}].h")
            _close(st.c, jst.c, tol, f"{what} {name}[{li}].c")
    _close(c.hc, jc.hc, tol, what + " hc")
    assert (c.length.numpy() == int(jc.length)).all(), what + " length"


def _floats(rng, shape, dt):
    x = rng.normal(size=shape).astype(np.float32)
    return jnp.asarray(x, jnp.dtype(dt)), torch.from_numpy(x).to(TORCH_DT[dt])


@pytest.mark.parametrize("smoke", [True, False])
def test_config_matches_jax(smoke):
    jcfg, cfg = jax_get_config("seq2seq-rnn", smoke=smoke), get_config("seq2seq-rnn", smoke=smoke)
    for f in dataclasses.fields(cfg):
        assert getattr(cfg, f.name) == getattr(jcfg, f.name), f.name
    assert cfg.param_count() == jcfg.param_count()


@pytest.mark.parametrize("dt", DTYPES)
def test_lstm_cell_matches_jax(dt):
    _, jparams, cfg, params = _model(dt)
    rng = np.random.default_rng(1)
    B, e, h = 3, cfg.emb_size, cfg.d_model
    jx, x = _floats(rng, (B, e), dt)
    jh, hh = _floats(rng, (B, h), "float32")
    jc, cc = _floats(rng, (B, h), "float32")
    jst, jout = jlstm.lstm_cell(jparams["encoder"][0], jx, jlstm.LSTMCellState(jh, jc))
    st, out = lstm.lstm_cell(params["encoder"][0], x, lstm.LSTMCellState(hh, cc))
    assert st.h.dtype == st.c.dtype == torch.float32 and out.dtype == TORCH_DT[dt]
    tol = TOL_TIGHT[dt]
    _close(st.h, jst.h, tol, "h")
    _close(st.c, jst.c, tol, "c")
    _close(out, jout, tol, "out")


@pytest.mark.parametrize("dt", DTYPES)
def test_run_stacked_lstm_matches_jax(dt):
    _, jparams, cfg, params = _model(dt)
    rng = np.random.default_rng(2)
    jxs, xs = _floats(rng, (2, 7, cfg.emb_size), dt)
    jhs, jstates = jlstm.run_stacked_lstm(jparams["encoder"], jxs)
    hs, states = lstm.run_stacked_lstm(params["encoder"], xs)
    tol = TOL_TIGHT[dt]
    _close(hs, jhs, tol, "hs")
    for li, (st, jst) in enumerate(zip(states, jstates)):
        _close(st.h, jst.h, tol, f"layer {li} h")
        _close(st.c, jst.c, tol, f"layer {li} c")


@pytest.mark.parametrize("pair", [("torch", "jnp"), ("cuda", "pallas_interpret")], ids=lambda p: f"{p[0]}-{p[1]}")
@pytest.mark.parametrize("dt", DTYPES)
def test_attention_softmax_head_matches_jax(dt, pair):
    _, jparams, cfg, params = _model(dt)
    rng = np.random.default_rng(3)
    B, N, M, h = 2, 5, 9, cfg.d_model
    jS, S = _floats(rng, (B, M, h), dt)
    jH, H = _floats(rng, (B, N, h), dt)
    mask = rng.random((B, M)) > 0.3
    mask[:, 0] = True
    hc, logits = s2s.attention_softmax_head(params["head"], S, H, torch.from_numpy(mask), stage_kernel=pair[0])
    jhc, jlogits = js2s.attention_softmax_head(jparams["head"], jS, jH, jnp.asarray(mask), stage_kernel=pair[1])
    _close(hc, jhc, TOL_ATTN[dt], "Hc")
    _close(logits, jlogits, TOL_ATTN[dt], "logits")


@pytest.mark.parametrize("input_feeding", [False, True], ids=["no_input_feeding", "input_feeding"])
def test_encode_extend_and_decode_step_match_jax(input_feeding):
    """Two encode chunks (the second with padding), then three decode steps
    from the same cache, on both sides, fp32."""
    jcfg, jparams, cfg, params = _model("float32", input_feeding)
    rng = np.random.default_rng(4)
    B, cap = 2, 12
    src = rng.integers(3, cfg.vocab_size, size=(B, 9))
    pad = np.ones((B, 4), bool)
    pad[1, 2:] = False
    jc = js2s.init_seq2seq_cache(jcfg, B, cap)
    c = s2s.init_seq2seq_cache(cfg, B, cap, device="cpu")
    for sl, m in ((slice(0, 5), None), (slice(5, 9), pad)):
        jc = js2s.encode_extend(jparams, jcfg, jnp.asarray(src[:, sl]), jc,
                                chunk_mask=None if m is None else jnp.asarray(m))
        c = s2s.encode_extend(params, cfg, torch.from_numpy(src[:, sl]), c,
                              chunk_mask=None if m is None else torch.from_numpy(m))
    _close_cache(c, jc, TOL_TIGHT["float32"], "after encode")
    tok = np.array([1, 1])
    for step in range(3):
        jlogits, jc = js2s.decode_step(jparams, jcfg, jnp.asarray(tok), jc)
        logits, c = s2s.decode_step(params, cfg, torch.from_numpy(tok), c)
        _close(logits, jlogits, TOL_ATTN["float32"], f"decode {step} logits")
        _close_cache(c, jc, TOL_ATTN["float32"], f"decode {step}")
        tok = np.array(jnp.argmax(jlogits, -1))  # writable copy for torch.from_numpy


def _src(cfg, seed=5):
    rng = np.random.default_rng(seed)
    src = rng.integers(3, cfg.vocab_size, size=(3, 8))
    mask = np.ones((3, 8), bool)
    mask[1, 6:] = False
    mask[2, 3:] = False
    return src, mask


@pytest.mark.parametrize("stage_kernel", ["torch", "cuda"])
def test_greedy_decode_tokens_equal_jax_fp32(stage_kernel):
    jcfg, jparams, cfg, params = _model("float32")
    src, mask = _src(cfg)
    want = js2s.greedy_decode(jparams, jcfg, jnp.asarray(src), jnp.asarray(mask), 10, bos=1, eos=2)
    got = s2s.greedy_decode(params, cfg, torch.from_numpy(src), torch.from_numpy(mask), 10, bos=1, eos=2,
                            stage_kernel=stage_kernel)
    assert got.dtype == torch.int64 and got.shape == (3, 10)
    assert got.numpy().tolist() == np.asarray(want).tolist()


def test_decode_logits_bf16_within_5e2():
    """bf16 rounds at other places in the two frameworks: hold the greedy
    path's decode logits (fed JAX's tokens) within 5e-2."""
    jcfg, jparams, cfg, params = _model("bfloat16")
    src, mask = _src(cfg)
    jc = js2s.encode_extend(jparams, jcfg, jnp.asarray(src), js2s.init_seq2seq_cache(jcfg, 3, 8),
                            chunk_mask=jnp.asarray(mask))
    c = s2s.encode_extend(params, cfg, torch.from_numpy(src), s2s.init_seq2seq_cache(cfg, 3, 8, device="cpu"),
                          chunk_mask=torch.from_numpy(mask))
    tok = np.ones(3, np.int64)
    for step in range(6):
        jlogits, jc = js2s.decode_step(jparams, jcfg, jnp.asarray(tok), jc)
        logits, c = s2s.decode_step(params, cfg, torch.from_numpy(tok), c)
        _close(logits, jlogits, dict(atol=5e-2, rtol=5e-2), f"bf16 decode {step}")
        tok = np.array(jnp.argmax(jlogits, -1), dtype=np.int64)
