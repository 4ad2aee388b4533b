"""The port's fused LSTM cell (``repro_torch.kernels.lstm_cell``) and its
stacked use against the JAX package's, on the CPU.

* ``lstm_cell_fused`` (its plain version on CPU tensors, inside the same
  ``torch.autograd.Function`` whose backward is the analytic adjoint)
  against JAX's ``lstm_cell_fused(..., interpret=True)``, forward and the
  grads of all six inputs, on every ``lstm_cell`` shape of
  ``tests/kernel_harness.py``, fp32 and bf16.  Forward at ``TOL_TIGHT``;
  fp32 grads at atol 1e-5 / rtol 1e-4 (``tests/test_kernels.py``'s);
  bf16 grads at ``TOL_TIGHT``'s bf16 entry.
* ``lstm_cell_fused`` on the model's feed (x and weights bf16, h and c fp32)
  against JAX's on the same values: forward at ``TOL_TIGHT["float32"]``, each
  grad at the tolerance of its dtype (fp32 for h and c, bf16 for x and the
  weights, whose grads both sides round to bf16).
* ``run_stacked_lstm(stage_kernel="cuda")`` against a JAX loop that feeds
  the Pallas cell the compute dtype's values (x and the weights cast to it,
  h/c fp32, h cast before the next layer; at fp32 this is the pipeline's
  stage-cell feed, ``repro/core/pipeline.py:97-110``): outputs and grads; and,
  on both stage paths, at bf16 over 32 timesteps, that the fp32 masters'
  grads are fp32 sums over the timesteps, as JAX's are, and not bf16 sums;
* the ``"torch"`` stage path's forward, bit for bit the plain loop over the
  once-cast copy.
* The tensor-core kernel's packed weight layout and ``cast_weights``.

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


MODEL_FEED_DTS = ("bfloat16", "float32", "float32", "bfloat16", "bfloat16", "bfloat16")  # x, h, c, wx, wh, b


def _by_dtype(t):
    return GRAD_TOL["bfloat16" if t.dtype == torch.bfloat16 else "float32"]


@pytest.mark.parametrize("shape", SHAPES, ids=_sid)
def test_lstm_cell_fused_model_feed_matches_jax(shape):
    """x and the weights bf16, h and c fp32: the plain version against the
    Pallas kernel in interpret mode, both fp32 math on the same values.  The
    forward at fp32's tolerance; dh and dc (fp32) at fp32's grad tolerance;
    dx and the weight grads at bf16's, since both sides round them to their
    inputs' dtype."""
    arrs = _cell_inputs(shape)
    wh_, wc_ = _loss_weights(shape)
    targs = [torch.from_numpy(a).to(TORCH_DT[d]).requires_grad_() for a, d in zip(arrs, MODEL_FEED_DTS)]
    jargs = [jnp.asarray(a, jnp.dtype(d)) for a, d in zip(arrs, MODEL_FEED_DTS)]
    cell = lambda *a: jax_fused(*a, block_b=shape["bb"], block_h=shape["bh"], interpret=True)  # noqa: E731

    h_new, c_new = ops.lstm_cell_fused(*targs)
    jh, jc = cell(*jargs)
    assert h_new.dtype == c_new.dtype == torch.float32
    _close(h_new.detach(), jh, TOL_TIGHT["float32"], f"h' {shape}")
    _close(c_new.detach(), jc, TOL_TIGHT["float32"], f"c' {shape}")

    loss = (h_new * torch.from_numpy(wh_)).sum() + (c_new * torch.from_numpy(wc_)).sum()
    grads = torch.autograd.grad(loss, targs)

    def jloss(*a):
        h, c = cell(*a)
        return jnp.sum(h * wh_) + jnp.sum(c * wc_)

    jgrads = jax.grad(jloss, argnums=tuple(range(6)))(*jargs)
    for name, g, jg, a in zip(NAMES, grads, jgrads, targs):
        assert g.dtype == a.dtype and g.shape == a.shape
        _close(g, jg, _by_dtype(g), f"d{name} {shape}")


def _jax_stacked_pallas(jparams, xs, dt):
    """The JAX package's cell feed, layer-major on one stage: x and the
    weights in the compute dtype (cast inside each step), h and c fp32."""
    B, S, _ = xs.shape
    h_in = xs
    for p in jparams:
        H = p["wh"].shape[0]
        h, c = jnp.zeros((B, H), jnp.float32), jnp.zeros((B, H), jnp.float32)
        outs = []
        for t in range(S):
            h, c = jax_fused(h_in[:, t], h, c, p["wx"].astype(dt), p["wh"].astype(dt), p["b"].astype(dt),
                             interpret=True)
            outs.append(h.astype(dt))
        h_in = jnp.stack(outs, axis=1)
    return h_in


@pytest.mark.parametrize("dt", DTYPES)
def test_stacked_lstm_cuda_path_matches_jax_compute_dtype_feed(dt):
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


def _one_layer(seed, B, S, In, H):
    rng = np.random.default_rng(seed)
    layer = {"wx": (rng.normal(size=(In, 4, H)) * In**-0.5).astype(np.float32),
             "wh": (rng.normal(size=(H, 4, H)) * H**-0.5).astype(np.float32),
             "b": (rng.normal(size=(4, H)) * 0.1).astype(np.float32)}
    return layer, rng.normal(size=(B, S, In)).astype(np.float32), rng.normal(size=(B, S, H)).astype(np.float32)


def _bf16_round(a):
    return jax.lax.reduce_precision(a, exponent_bits=8, mantissa_bits=7)


@jax.custom_vjp
def _bf16(a):
    """A bf16 value held in fp32: rounded on the way in, and its cotangent
    rounded on the way back, as a bf16 tensor's grad is in PyTorch."""
    return _bf16_round(a)


_bf16.defvjp(lambda a: (_bf16_round(a), None), lambda _, ct: (_bf16_round(ct),))


def _jax_meshless_bf16_loss(p, x, w_out):
    """``repro/models/lstm.py::lstm_cell``'s arithmetic (the masters cast to
    bf16 inside each step, the gate products and their sum in bf16, the
    nonlinearities and the carries fp32) scanned over x's timesteps, with
    every bf16 rounding written out where a bf16 framework makes it, both
    ways: each product and sum, and each cotangent that reaches a bf16 value
    (so each step's weight-grad term is rounded to bf16, then summed over the
    steps in fp32, as the scan sums it).  XLA on the CPU keeps some of these
    sums in fp32, so the package's own cell differs from PyTorch's plain cell
    by one bf16 step in the forward already."""
    B, S, _ = x.shape
    H = p["wh"].shape[0]
    wx, wh, b = p["wx"].reshape(p["wx"].shape[0], -1), p["wh"].reshape(H, -1), p["b"].reshape(-1)
    h = c = jnp.zeros((B, H), jnp.float32)
    loss = 0.0
    for t in range(S):
        g = _bf16(_bf16(_bf16(_bf16(x[:, t]) @ _bf16(wx)) + _bf16(_bf16(h) @ _bf16(wh))) + _bf16(b)).reshape(B, 4, H)
        c = jax.nn.sigmoid(g[:, 1]) * c + jax.nn.sigmoid(g[:, 0]) * jnp.tanh(g[:, 2])
        h = jax.nn.sigmoid(g[:, 3]) * jnp.tanh(c)
        loss = loss + jnp.sum(_bf16(h) * w_out[:, t])
    return loss


@pytest.mark.parametrize("stage_kernel", lstm.STAGE_KERNELS)
def test_stacked_lstm_weight_grads_are_fp32_sums_over_timesteps(stage_kernel):
    """bf16 over 32 timesteps: the fp32 masters' grads from
    ``run_stacked_lstm`` on either stage path (the masters cast once per
    layer call) against JAX's from a scan that casts the masters to bf16
    inside each step and sums the steps' terms in fp32: over the Pallas cell
    for ``"cuda"``, over the meshless cell (``repro/models/lstm.py``, whose
    gate products sum in bf16 as the plain cell's do) for ``"torch"``.

    Tolerance, per leaf: 2^-8 of the largest JAX grad.  JAX's backward rounds
    each step's term to bf16 (a relative error of at most 2^-9); the port
    keeps them in fp32, and the two differ by those roundings, dominated by
    the largest terms.  The bf16-summed alternative (the bf16 copy as the
    cell's input, so autograd sums the 32 terms into it in bf16, rounding the
    running sum at every step) must miss the same tolerance: the fused cell
    on the copies for ``"cuda"``, the plain cell on :func:`lstm.cast_cell`'s
    copy for ``"torch"``."""
    B, S, In, H = 3, 32, 8, 16
    layer, xs, w_out = _one_layer(7, B, S, In, H)
    bf16 = jnp.bfloat16

    def jloss(p, x):
        if stage_kernel == "torch":
            return _jax_meshless_bf16_loss(p, x.astype(jnp.float32), w_out)

        def step(carry, x_t):
            h, c = jax_fused(x_t, *carry, p["wx"].astype(bf16), p["wh"].astype(bf16), p["b"].astype(bf16),
                             interpret=True)
            return (h, c), h.astype(bf16)

        z = jnp.zeros((B, H), jnp.float32)
        _, hs = jax.lax.scan(step, (z, z), jnp.swapaxes(x, 0, 1))
        return jnp.sum(jnp.swapaxes(hs, 0, 1).astype(jnp.float32) * w_out)

    jg = jax.grad(jloss)({k: jnp.asarray(v) for k, v in layer.items()}, jnp.asarray(xs, bf16))
    tx = torch.from_numpy(xs).to(torch.bfloat16)
    w = torch.from_numpy(w_out)

    masters = {k: torch.from_numpy(v).requires_grad_() for k, v in layer.items()}
    hs, _ = lstm.run_stacked_lstm([masters], tx, stage_kernel=stage_kernel)
    fp32_sums = torch.autograd.grad((hs.float() * w).sum(), [masters[k] for k in ("wx", "wh", "b")])

    masters2 = {k: torch.from_numpy(v).requires_grad_() for k, v in layer.items()}
    outs = []
    if stage_kernel == "cuda":
        copies = {k: v.to(torch.bfloat16) for k, v in masters2.items()}
        h, c = torch.zeros(B, H), torch.zeros(B, H)
        for t in range(S):
            h, c = ops.lstm_cell_fused(tx[:, t].contiguous(), h, c, copies["wx"], copies["wh"], copies["b"])
            outs.append(h.to(torch.bfloat16))
    else:
        pc = lstm.cast_cell(masters2, torch.bfloat16)  # with grad: autograd sums into the copy in bf16
        state = lstm.init_lstm_state(B, H)
        for t in range(S):
            state, h = lstm.cell_step(pc, tx[:, t], state)
            outs.append(h)
    assert torch.equal(torch.stack(outs, 1), hs)  # the same forward
    bf16_sums = torch.autograd.grad((torch.stack(outs, 1).float() * w).sum(), [masters2[k] for k in ("wx", "wh", "b")])

    for name, g, g16 in zip(("wx", "wh", "b"), fp32_sums, bf16_sums):
        want = np.asarray(jg[name], np.float32)
        tol = dict(atol=2.0**-8 * np.abs(want).max(), rtol=0)
        assert g.dtype == g16.dtype == torch.float32
        _close(g, want, tol, f"d{name}: fp32 sums")
        with pytest.raises(AssertionError):
            _close(g16, want, tol, f"d{name}: bf16 sums")


@pytest.mark.parametrize("dt", DTYPES)
def test_torch_stage_path_forward_is_the_plain_loop(dt):
    """The ``"torch"`` stage path's forward is bit for bit the loop of
    :func:`lstm.cell_step` over :func:`lstm.cast_cell`'s copy, as it was before
    its weight grads went to the masters; its x and h grads too, and at fp32
    its weight grads."""
    B, S, In, H = 3, 9, 8, 16
    layer, xs, w_out = _one_layer(11, B, S, In, H)
    tdt = TORCH_DT[dt]
    w = torch.from_numpy(w_out)
    masters = {k: torch.from_numpy(v).requires_grad_() for k, v in layer.items()}
    tx = torch.from_numpy(xs).to(tdt).requires_grad_()
    hs, fin = lstm.run_lstm_layer(masters, tx, stage_kernel="torch")
    grads = torch.autograd.grad((hs.float() * w).sum(), [tx] + [masters[k] for k in ("wx", "wh", "b")])

    masters2 = {k: torch.from_numpy(v).requires_grad_() for k, v in layer.items()}
    tx2 = torch.from_numpy(xs).to(tdt).requires_grad_()
    pc = lstm.cast_cell(masters2, tdt)
    state, outs = lstm.init_lstm_state(B, H), []
    for t in range(S):
        state, h = lstm.cell_step(pc, tx2[:, t], state)
        outs.append(h)
    want = torch.stack(outs, 1)
    assert hs.dtype == tdt and torch.equal(hs, want)
    assert torch.equal(fin.h, state.h) and torch.equal(fin.c, state.c)
    want_grads = torch.autograd.grad((want.float() * w).sum(), [tx2] + [masters2[k] for k in ("wx", "wh", "b")])
    assert torch.equal(grads[0], want_grads[0])  # the input's grad: the same products, the same sum
    if dt == "float32":  # every sum already fp32: the weight grads are the same numbers
        for g, wg in zip(grads[1:], want_grads[1:]):
            torch.testing.assert_close(g, wg, atol=1e-6, rtol=1e-6)


def test_pack_weights_layout():
    """The tensor-core kernel's packed copy, element by element: tile t, chunk
    q, row n = (granule, gate, unit), depth k stored at 16-byte group
    (k // 8) ^ (n % 8); zero past In, H and the last unit."""
    In, H = 24, 40  # ragged in every direction: 3 tiles (the last half empty), one chunk of x, one of h
    rng = np.random.default_rng(0)
    wx = torch.from_numpy(rng.normal(size=(In, 4, H)).astype(np.float32))
    wh = torch.from_numpy(rng.normal(size=(H, 4, H)).astype(np.float32))
    packed = ops.pack_weights(wx, wh)
    assert packed.dtype == torch.bfloat16 and tuple(packed.shape) == (3, 2, 64, 64)
    want = torch.zeros(3, 2, 64, 64)
    for t in range(3):
        for n in range(64):
            unit = 16 * t + 8 * (n // 32) + n % 8
            if unit >= H:
                continue
            gate = n // 8 % 4
            for k in range(64):
                col = ((k // 8) ^ (n % 8)) * 8 + k % 8
                if k < In:
                    want[t, 0, n, col] = wx[k, gate, unit]
                if k < H:
                    want[t, 1, n, col] = wh[k, gate, unit]
    assert torch.equal(packed.float(), want.bfloat16().float())


def test_cast_weights():
    """At fp32 the masters themselves (no copy); at bf16 fp32 copies of the
    rounded values, and no packed copy off the card."""
    layer, _, _ = _one_layer(1, 2, 1, 8, 16)
    wx, wh, b = (torch.from_numpy(layer[k]) for k in ("wx", "wh", "b"))
    w32 = ops.cast_weights(wx, wh, b, torch.float32)
    assert w32.packed is None
    for got, master in zip(w32[:3], (wx, wh, b)):
        assert got.data_ptr() == master.data_ptr() and got.dtype == torch.float32 and not got.requires_grad
    w16 = ops.cast_weights(wx, wh, b, torch.bfloat16)
    assert w16.packed is None
    for got, master in zip(w16[:3], (wx, wh, b)):
        assert got.dtype == torch.float32 and torch.equal(got, master.bfloat16().float())


# ---------------------------------------------------------------------------
# the column shard: the TPU kernel's own column tile, as the tensor-parallel
# backbone runs it
# ---------------------------------------------------------------------------

SHARD_SHAPE = dict(B=8, In=24, H=32)


def _shard(arrs, r, n):
    """Shard r of n of the cell's inputs: h whole, c and the weights' units
    [r*Hs, (r+1)*Hs)."""
    x, h, c, wx, wh, b = arrs
    Hs = h.shape[1] // n
    cols = slice(r * Hs, (r + 1) * Hs)
    return [x, h, c[:, cols], wx[..., cols], wh[..., cols], b[:, cols]]


@pytest.mark.parametrize("parts", [2, 4])
def test_column_shard_matches_jax_column_tiles(parts):
    """The plain column-shard cell and its adjoint at Hs = H/2 and H/4 against
    JAX's Pallas cell in interpret mode run in column tiles of Hs
    (``block_h=Hs``): each shard's h', c' and its weights' grads are the
    tiles' columns, and the shards' dx and dh summed are the whole cell's."""
    s = SHARD_SHAPE
    arrs = _cell_inputs(s, seed=5)
    wh_, wc_ = _loss_weights(s, seed=6)
    Hs = s["H"] // parts

    def jloss(*a):
        h, c = jax_fused(*a, block_h=Hs, interpret=True)
        return jnp.sum(h * wh_) + jnp.sum(c * wc_), (h, c)

    (_, (jh, jc)), jgrads = jax.value_and_grad(jloss, argnums=tuple(range(6)), has_aux=True)(
        *[jnp.asarray(a) for a in arrs])
    dx = dh = 0.0
    for r in range(parts):
        cols = slice(r * Hs, (r + 1) * Hs)
        ins = [torch.from_numpy(np.ascontiguousarray(a)).requires_grad_() for a in _shard(arrs, r, parts)]
        h, c = ops.lstm_cell_fused(*ins)
        assert h.shape == c.shape == (s["B"], Hs)
        _close(h.detach(), np.asarray(jh)[:, cols], TOL_TIGHT["float32"], f"h' shard {r}")
        _close(c.detach(), np.asarray(jc)[:, cols], TOL_TIGHT["float32"], f"c' shard {r}")
        g = torch.autograd.grad((h * torch.from_numpy(wh_[:, cols])).sum() + (c * torch.from_numpy(wc_[:, cols])).sum(),
                                ins)
        for name, got, want in zip(NAMES[2:], g[2:], jgrads[2:]):
            _close(got, np.asarray(want)[..., cols], GRAD_TOL["float32"], f"d{name} shard {r}")
        dx, dh = dx + g[0], dh + g[1]
    _close(dx, jgrads[0], GRAD_TOL["float32"], "dx summed over the shards")
    _close(dh, jgrads[1], GRAD_TOL["float32"], "dh summed over the shards")


def test_column_shard_adjoint_shapes_and_partial_dh():
    """``lstm_cell_adjoint`` on a shard: dh is [B, H_in] and the shards' dh
    sum to the whole cell's adjoint dh; dwx and dwh are the shard's columns."""
    s = SHARD_SHAPE
    arrs = [torch.from_numpy(a) for a in _cell_inputs(s, seed=7)]
    dh_new, dc_new = (torch.from_numpy(w) for w in _loss_weights(s, seed=8))
    whole = ops.lstm_cell_adjoint(*arrs, dh_new, dc_new)
    Hs = s["H"] // 2
    dh = 0.0
    for r in range(2):
        cols = slice(r * Hs, (r + 1) * Hs)
        x, h, c, wx, wh, b = _shard(arrs, r, 2)
        dx_, dh_, dc_, dwx, dwh, db = ops.lstm_cell_adjoint(x, h, c, wx, wh, b, dh_new[:, cols], dc_new[:, cols])
        assert dh_.shape == (s["B"], s["H"]) and dwh.shape == (s["H"], 4, Hs)
        for got, want in ((dc_, whole[2][:, cols]), (dwx, whole[3][..., cols]), (dwh, whole[4][..., cols]),
                          (db, whole[5][:, cols])):
            torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)
        dh = dh + dh_
    torch.testing.assert_close(dh, whole[1], atol=1e-5, rtol=1e-5)


def test_pack_weights_of_a_column_shard_are_the_whole_cells_tiles():
    """The packed copy of a column shard is the whole cell's packed tiles of
    its units, so the kernel walks the same depth on the same weights."""
    In, H = 40, 64
    rng = np.random.default_rng(2)
    wx = torch.from_numpy(rng.normal(size=(In, 4, H)).astype(np.float32))
    wh = torch.from_numpy(rng.normal(size=(H, 4, H)).astype(np.float32))
    whole = ops.pack_weights(wx, wh)
    for parts in (2, 4):
        Hs, T = H // parts, H // parts // 16
        for r in range(parts):
            cols = slice(r * Hs, (r + 1) * Hs)
            shard = ops.pack_weights(wx[..., cols].contiguous(), wh[..., cols].contiguous())
            assert torch.equal(shard, whole[r * T:(r + 1) * T]), (parts, r)


def test_wrapper_rejects_a_mismatched_shard():
    x, h, c, wx, wh, b = [torch.from_numpy(a) for a in _cell_inputs(SHARD_SHAPE)]
    with pytest.raises(ValueError, match="wh is"):
        ops.lstm_cell_fused(x, h, c[:, :16], wx[..., :16], wh[:16, :, :16], b[:, :16])
    with pytest.raises(ValueError, match="b is"):
        ops.lstm_cell_fused(x, h, c[:, :16], wx[..., :16], wh[..., :16], b)
