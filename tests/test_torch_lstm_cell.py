"""The port's fused LSTM cell (``repro_torch.kernels.lstm_cell``) and its
stacked use against the JAX package's, on the CPU.

* ``lstm_cell_fused`` (its plain version on CPU tensors, inside the same
  ``torch.autograd.Function`` whose backward is the analytic adjoint)
  against JAX's ``lstm_cell_fused(..., interpret=True)``, forward and the
  grads of all six inputs, on every ``lstm_cell`` shape of
  ``tests/kernel_harness.py``, fp32 and bf16.  Forward at ``TOL_TIGHT``;
  fp32 grads at atol 1e-5 / rtol 1e-4 (``tests/test_kernels.py``'s);
  bf16 grads at ``TOL_TIGHT``'s bf16 entry.
* ``run_stacked_lstm(stage_kernel="cuda")`` against a JAX loop that feeds
  the Pallas cell as ``repro/core/pipeline.py:97-110`` does (x in the
  compute dtype, h/c fp32, fp32 weights, h cast before the next layer):
  outputs and grads.

The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from kernel_harness import REGISTRY, TOL_TIGHT  # noqa: E402

from repro.kernels.lstm_cell.ops import lstm_cell_fused as jax_fused  # noqa: E402
from repro_torch.kernels.lstm_cell import ops  # noqa: E402
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref  # noqa: E402
from repro_torch.models import lstm  # noqa: E402

pytestmark = pytest.mark.torch_port

DTYPES = ("float32", "bfloat16")
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
SHAPES = REGISTRY["lstm_cell"].shapes + REGISTRY["lstm_cell"].ragged_shapes
NAMES = ("x", "h", "c", "wx", "wh", "b")
GRAD_TOL = {"float32": dict(atol=1e-5, rtol=1e-4), "bfloat16": TOL_TIGHT["bfloat16"]}


def _sid(s):
    return "-".join(f"{k}{v}" for k, v in s.items())


def _cell_inputs(s, seed=0):
    """fp32 numpy x, h, c, wx, wh, b at the harness's scales."""
    rng = np.random.default_rng(seed)
    B, In, H = s["B"], s["In"], s["H"]
    f = lambda shape, scale=1.0: (rng.normal(size=shape) * scale).astype(np.float32)  # noqa: E731
    return [f((B, In)), f((B, H)), f((B, H)), f((In, 4, H), 0.1), f((H, 4, H), 0.1), f((4, H), 0.1)]


def _loss_weights(s, seed=1):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(s["B"], s["H"])).astype(np.float32) for _ in range(2)]


def _close(got, want, tol, what):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol, err_msg=what)


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", SHAPES, ids=_sid)
def test_lstm_cell_fused_cpu_matches_jax(shape, dt):
    arrs = _cell_inputs(shape)
    wh_, wc_ = _loss_weights(shape)
    targs = [torch.from_numpy(a).to(TORCH_DT[dt]).requires_grad_() for a in arrs]
    jargs = [jnp.asarray(a, jnp.dtype(dt)) for a in arrs]
    cell = lambda *a: jax_fused(*a, block_b=shape["bb"], block_h=shape["bh"], interpret=True)  # noqa: E731

    before = ops.lstm_cell_fused.launches
    h_new, c_new = ops.lstm_cell_fused(*targs)
    assert ops.lstm_cell_fused.launches == before  # CPU tensors take the plain version
    jh, jc = cell(*jargs)
    assert h_new.dtype == c_new.dtype == TORCH_DT[dt]
    _close(h_new.detach(), jh, TOL_TIGHT[dt], f"h' {shape} {dt}")
    _close(c_new.detach(), jc, TOL_TIGHT[dt], f"c' {shape} {dt}")

    # a loss that weighs h' and c' differently, so both cotangents are exercised
    loss = (h_new.float() * torch.from_numpy(wh_)).sum() + (c_new.float() * torch.from_numpy(wc_)).sum()
    grads = torch.autograd.grad(loss, targs)

    def jloss(*a):
        h, c = cell(*a)
        return jnp.sum(h.astype(jnp.float32) * wh_) + jnp.sum(c.astype(jnp.float32) * wc_)

    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(*jargs)
    for name, g, jg, a in zip(NAMES, grads, jgrads, targs):
        assert g.dtype == a.dtype and g.shape == a.shape
        _close(g, jg, GRAD_TOL[dt], f"d{name} {shape} {dt}")


def test_backward_is_the_adjoint_of_the_plain_version():
    """Autograd through the fused cell's Function equals autograd through
    its plain version, at fp32 on a ragged shape."""
    s = dict(B=7, In=13, H=24)
    arrs = _cell_inputs(s, seed=3)
    wh_, wc_ = (torch.from_numpy(w) for w in _loss_weights(s))
    grads = []
    for fn in (ops.lstm_cell_fused, lstm_cell_ref):
        ins = [torch.from_numpy(a).requires_grad_() for a in arrs]
        h, c = fn(*ins)
        grads.append(torch.autograd.grad((h * wh_).sum() + (c * wc_).sum(), ins))
    for name, g, r in zip(NAMES, *grads):
        _close(g, r.numpy(), dict(atol=1e-5, rtol=1e-5), f"d{name}")


def test_model_feed_dtypes():
    """The model's mixed feed (x bf16; h, c and weights fp32): fp32 outputs,
    and grads in each input's dtype."""
    arrs = _cell_inputs(dict(B=4, In=8, H=16))
    dts = (torch.bfloat16,) + (torch.float32,) * 5
    ins = [torch.from_numpy(a).to(dt).requires_grad_() for a, dt in zip(arrs, dts)]
    h, c = ops.lstm_cell_fused(*ins)
    assert h.dtype == c.dtype == torch.float32
    want = lstm_cell_ref(*[t.detach() for t in ins])
    assert torch.equal(h.detach(), want[0]) and torch.equal(c.detach(), want[1])
    for g, a in zip(torch.autograd.grad(h.sum() + c.sum(), ins), ins):
        assert g.dtype == a.dtype and g.shape == a.shape


def test_wrapper_rejects_bad_inputs():
    arrs = [torch.from_numpy(a) for a in _cell_inputs(dict(B=2, In=3, H=4))]
    with pytest.raises(ValueError, match="wx is"):
        ops.lstm_cell_fused(arrs[0], arrs[1], arrs[2], arrs[3][:, :2], arrs[4], arrs[5])
    with pytest.raises(ValueError, match="not on"):
        ops.lstm_cell_fused(*[a.to("meta") for a in arrs])


def _jax_stacked_pallas(jparams, xs, dt):
    """The JAX pipeline's stage-cell feed, layer-major on one stage."""
    B, S, _ = xs.shape
    h_in = xs
    for p in jparams:
        H = p["wh"].shape[0]
        h, c = jnp.zeros((B, H), jnp.float32), jnp.zeros((B, H), jnp.float32)
        outs = []
        for t in range(S):
            h, c = jax_fused(h_in[:, t], h, c, p["wx"], p["wh"], p["b"], interpret=True)
            outs.append(h.astype(dt))
        h_in = jnp.stack(outs, axis=1)
    return h_in


@pytest.mark.parametrize("dt", DTYPES)
def test_stacked_lstm_cuda_path_matches_jax_pipeline_feed(dt):
    rng = np.random.default_rng(4)
    B, S, In, H, L = 3, 5, 8, 16, 2
    layers = [
        {"wx": (rng.normal(size=(In if li == 0 else H, 4, H)) * 0.3).astype(np.float32),
         "wh": (rng.normal(size=(H, 4, H)) * 0.3).astype(np.float32),
         "b": (rng.normal(size=(4, H)) * 0.1).astype(np.float32)}
        for li in range(L)
    ]
    xs = rng.normal(size=(B, S, In)).astype(np.float32)
    w_out = rng.normal(size=(B, S, H)).astype(np.float32)
    jdt = jnp.dtype(dt)

    tparams = [{k: torch.from_numpy(v).requires_grad_() for k, v in p.items()} for p in layers]
    txs = torch.from_numpy(xs).to(TORCH_DT[dt]).requires_grad_()
    before = ops.lstm_cell_fused.launches
    hs, states = lstm.run_stacked_lstm(tparams, txs, stage_kernel="cuda")
    assert ops.lstm_cell_fused.launches == before
    assert hs.dtype == TORCH_DT[dt] and states[-1].h.dtype == torch.float32
    leaves = [txs] + [p[k] for p in tparams for k in ("wx", "wh", "b")]
    grads = torch.autograd.grad((hs.float() * torch.from_numpy(w_out)).sum(), leaves)

    jlayers = [{k: jnp.asarray(v) for k, v in p.items()} for p in layers]
    jxs = jnp.asarray(xs, jdt)
    jhs = _jax_stacked_pallas(jlayers, jxs, jdt)
    _close(hs.detach(), jhs, TOL_TIGHT[dt], f"hs {dt}")
    jloss = lambda x, ps: jnp.sum(_jax_stacked_pallas(ps, x, jdt).astype(jnp.float32) * w_out)  # noqa: E731
    jgx, jgp = jax.grad(jloss, argnums=(0, 1))(jxs, jlayers)
    jleaves = [jgx] + [p[k] for p in jgp for k in ("wx", "wh", "b")]
    for i, (g, jg) in enumerate(zip(grads, jleaves)):
        _close(g, jg, GRAD_TOL[dt], f"grad leaf {i} {dt}")
