"""The port's fused Luong head (``repro_torch.kernels.luong_attn``) against
the JAX package's, on every ``luong_attn`` and ``luong_head`` shape of
``tests/kernel_harness.py``, fp32 and bf16, at ``TOL_ATTN``.

On the CPU the port's wrapper runs its plain version; it is held against
JAX's ``luong_attention_ref`` and against the Pallas kernel in interpret
mode.  The same inputs, made with numpy from a seed, go to both sides.
The CUDA kernel itself is held against the plain version on the card by
``tests/test_torch_cuda.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from kernel_harness import REGISTRY, TOL_ATTN  # noqa: E402

from repro.kernels.luong_attn.ops import luong_attention_fused as jax_fused  # noqa: E402
from repro.kernels.luong_attn.ref import luong_attention_ref as jax_ref  # noqa: E402
from repro.models.seq2seq import attention_softmax_head as jax_head  # noqa: E402
from repro_torch.kernels.luong_attn import ops  # noqa: E402
from repro_torch.models.seq2seq import attention_softmax_head  # noqa: E402

pytestmark = pytest.mark.torch_port

DTYPES = ("float32", "bfloat16")
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LUONG_SHAPES = REGISTRY["luong_attn"].shapes + REGISTRY["luong_attn"].ragged_shapes
HEAD_SHAPES = REGISTRY["luong_head"].shapes + REGISTRY["luong_head"].ragged_shapes
ALL_MASKED = dict(B=3, N=2, M=5, h=16)  # row 1 has no real source position


def _sid(s):
    return "-".join(f"{k}{v}" for k, v in s.items())


def _inputs(s, seed=0, masked_row=None):
    """fp32 numpy inputs for one shape (the harness's scales and mask)."""
    rng = np.random.default_rng(seed)
    B, N, M, h = s["B"], s["N"], s["M"], s["h"]
    f32 = lambda shape, scale=1.0: (rng.normal(size=shape) * scale).astype(np.float32)
    x = dict(H=f32((B, N, h)), S=f32((B, M, h)), wa=f32((h, h), 0.1), wc=f32((2 * h, h), 0.1))
    mask = rng.random((B, M)) > 0.2
    mask[:, 0] = True
    if masked_row is not None:
        mask[masked_row] = False
    x["mask"] = mask
    if "V" in s:
        x["fc"] = f32((h, s["V"]), 0.1)
    return x


def _jax(x, dt):
    return {k: (jnp.asarray(v) if k == "mask" else jnp.asarray(v, jnp.dtype(dt))) for k, v in x.items()}


def _torch(x, dt):
    return {k: (torch.from_numpy(v) if k == "mask" else torch.from_numpy(v).to(TORCH_DT[dt])) for k, v in x.items()}


def _close(got, want, dt, what):
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), **TOL_ATTN[dt], err_msg=f"{what} {dt}"
    )


@pytest.mark.parametrize("reference", ["ref", "pallas_interpret"])
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", LUONG_SHAPES, ids=_sid)
def test_luong_fused_cpu_matches_jax(shape, dt, reference):
    x = _inputs(shape)
    j, t = _jax(x, dt), _torch(x, dt)
    h = shape["h"]
    before = ops.luong_attention_fused.launches
    got = ops.luong_attention_fused(t["H"], t["S"], t["mask"], t["wa"], t["wc"])
    assert ops.luong_attention_fused.launches == before  # CPU tensors take the plain version
    assert got.dtype == TORCH_DT[dt] and got.shape == t["H"].shape
    if reference == "ref":
        want = jax_ref(j["H"], j["S"], j["mask"], j["wa"], j["wc"][:h], j["wc"][h:])
    else:
        want = jax_fused(j["H"], j["S"], j["mask"], j["wa"], j["wc"], block_n=shape["bn"], interpret=True)
    _close(got, want, dt, f"luong_attn {shape} vs {reference}")


@pytest.mark.parametrize("pair", [("torch", "jnp"), ("cuda", "pallas_interpret")], ids=lambda p: f"{p[0]}-{p[1]}")
@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", HEAD_SHAPES, ids=_sid)
def test_luong_head_cpu_matches_jax(shape, dt, pair):
    x = _inputs(shape)
    j, t = _jax(x, dt), _torch(x, dt)
    ours, theirs = pair
    head_t = {"w_alpha": t["wa"], "w_c": t["wc"], "f_c": t["fc"]}
    head_j = {"w_alpha": j["wa"], "w_c": j["wc"], "f_c": j["fc"]}
    hc, logits = attention_softmax_head(head_t, t["S"], t["H"], t["mask"], stage_kernel=ours)
    hc_j, logits_j = jax_head(head_j, j["S"], j["H"], j["mask"], stage_kernel=theirs)
    assert logits.dtype == torch.float32
    _close(hc, hc_j, dt, f"head Hc {shape} {pair}")
    _close(logits, logits_j, dt, f"head logits {shape} {pair}")


@pytest.mark.parametrize("dt", DTYPES)
def test_all_masked_row_is_uniform_not_nan(dt):
    """A free decode lane has an all-False mask: -1e30 scores give a
    uniform alpha (C = mean of S), never NaN, as in the JAX reference."""
    x = _inputs(ALL_MASKED, masked_row=1)
    j, t = _jax(x, dt), _torch(x, dt)
    h = ALL_MASKED["h"]
    got = ops.luong_attention_fused(t["H"], t["S"], t["mask"], t["wa"], t["wc"])
    assert torch.isfinite(got.float()).all()
    _close(got, jax_ref(j["H"], j["S"], j["mask"], j["wa"], j["wc"][:h], j["wc"][h:]), dt, "all-masked row")
    Hf, Sf, wc = (t[k].float() for k in ("H", "S", "wc"))
    uniform = torch.tanh(Hf[1] @ wc[:h] + Sf[1].mean(0, keepdim=True) @ wc[h:])
    _close(got[1], uniform.numpy(), dt, "uniform alpha")


LUONG_GRAD_NAMES = ("H", "S", "w_alpha", "w_c")


@pytest.mark.parametrize("dt", DTYPES)
@pytest.mark.parametrize("shape", LUONG_SHAPES, ids=_sid)
def test_luong_fused_grads_match_jax_custom_vjp(shape, dt):
    """The recompute backward of the port's Function (CPU: plain forward,
    autograd of the plain version) against ``jax.grad`` through JAX's
    ``luong_attention_fused(interpret=True)`` and its custom-vjp, for H, S,
    w_alpha and w_c; the mask gets no gradient.  Tolerance: TOL_ATTN, with
    its absolute part scaled by the leaf's largest magnitude: each grad is
    a sum over B*N*M products and reaches ~80 at these shapes, where fp32
    reassociation alone moves it by a few 1e-6 of that magnitude."""
    x = _inputs(shape)
    rng = np.random.default_rng(9)
    ct = rng.normal(size=(shape["B"], shape["N"], shape["h"])).astype(np.float32)
    j, t = _jax(x, dt), _torch(x, dt)
    ins = [t[k].requires_grad_() for k in ("H", "S", "wa", "wc")]
    out = ops.luong_attention_fused(ins[0], ins[1], t["mask"], ins[2], ins[3])
    grads = torch.autograd.grad((out.float() * torch.from_numpy(ct)).sum(), ins)

    def jloss(H, S, wa, wc):
        o = jax_fused(H, S, j["mask"], wa, wc, block_n=shape["bn"], interpret=True)
        return jnp.sum(o.astype(jnp.float32) * ct)

    jgrads = jax.grad(jloss, argnums=(0, 1, 2, 3))(j["H"], j["S"], j["wa"], j["wc"])
    for name, g, jg, a in zip(LUONG_GRAD_NAMES, grads, jgrads, ins):
        assert g.dtype == a.dtype and g.shape == a.shape
        want = np.asarray(jg, np.float32)
        tol = dict(TOL_ATTN[dt], atol=TOL_ATTN[dt]["atol"] * max(1.0, float(np.abs(want).max())))
        np.testing.assert_allclose(g.float().numpy(), want, **tol, err_msg=f"d{name} {shape} {dt}")


def test_luong_fused_grads_flow_only_where_asked():
    """Inputs that do not require grad get none; a mask never does."""
    x = _torch(_inputs(REGISTRY["luong_attn"].shapes[0]), "float32")
    H = x["H"].requires_grad_()
    out = ops.luong_attention_fused(H, x["S"], x["mask"], x["wa"], x["wc"])
    assert out.requires_grad
    (gH,) = torch.autograd.grad(out.sum(), [H])
    assert gH.shape == H.shape and torch.isfinite(gH).all()
    assert x["S"].grad is None and not x["mask"].requires_grad


# ---------------------------------------------------------------------------
# The kernel routes: which inputs each takes, and the "wgmma" route's
# roundings written out in plain PyTorch (the CUDA kernels themselves are
# held against the plain version on the card by tests/test_torch_cuda.py).
# ---------------------------------------------------------------------------

BF16, F32 = torch.bfloat16, torch.float32
# (dtype, h, R = B*N, the pick): the boundaries of each route
ROUTE_PICKS = [
    (BF16, 1024, 1, "decode"), (BF16, 1024, 4, "decode"), (BF16, 1024, ops.DECODE_MAX_ROWS, "decode"),
    (BF16, 1024, ops.DECODE_MAX_ROWS + 1, "wgmma"), (BF16, 1024, 2048, "wgmma"), (BF16, 64, 4, "decode"),
    (BF16, 64, 33, "wgmma"), (BF16, 128, 64, "wgmma"), (BF16, 1088, 4, "wgmma"), (BF16, 2048, 2048, "wgmma"),
    (BF16, 2112, 4, "fma"), (BF16, 2112, 2048, "fma"), (BF16, 48, 4, "fma"), (BF16, 1000, 2048, "fma"),
    (BF16, 16, 2, "fma"), (F32, 1024, 4, "fma"), (F32, 1024, 2048, "fma"), (F32, 64, 32, "fma"),
    (torch.float16, 1024, 4, "fma"),
]
# (route, dtype, h, R, fits)
ROUTE_FITS = [
    ("decode", BF16, 1024, ops.DECODE_MAX_ROWS, True), ("decode", BF16, 1024, ops.DECODE_MAX_ROWS + 1, False),
    ("decode", BF16, ops.DECODE_MAX_H, 1, True), ("decode", BF16, ops.DECODE_MAX_H + 64, 1, False),
    ("decode", BF16, 96, 4, False), ("decode", F32, 1024, 4, False), ("wgmma", BF16, ops.WGMMA_MAX_H, 1, True),
    ("wgmma", BF16, ops.WGMMA_MAX_H + 64, 2048, False), ("wgmma", BF16, 64, 1, True), ("wgmma", BF16, 32, 2048, False),
    ("wgmma", F32, 1024, 2048, False), ("fma", F32, 16, 1, True), ("fma", BF16, 1024, 2048, True),
    ("fma", BF16, 48, 30, True),
]


@pytest.mark.parametrize("dtype,h,R,want", ROUTE_PICKS, ids=lambda v: str(v).replace("torch.", ""))
def test_pick_route(dtype, h, R, want):
    assert ops.pick_route(dtype, h, R) == want
    assert ops.route_fits(want, dtype, h, R)


@pytest.mark.parametrize("route,dtype,h,R,fits", ROUTE_FITS, ids=lambda v: str(v).replace("torch.", ""))
def test_route_fits(route, dtype, h, R, fits):
    assert ops.route_fits(route, dtype, h, R) is fits


@pytest.mark.parametrize("route", ["decode", "wgmma", "bogus"])
def test_named_route_that_does_not_fit_raises_on_cpu(route):
    """fp32 inputs fit only "fma": naming another route raises, as on the card."""
    t = _torch(_inputs(dict(B=2, N=1, M=3, h=64)), "float32")
    with pytest.raises(ValueError, match="route"):
        ops.luong_attention_fused(t["H"], t["S"], t["mask"], t["wa"], t["wc"], route=route)


@pytest.mark.parametrize("dt", DTYPES)
def test_cpu_path_counts_no_route_launch(dt):
    """The plain version runs on CPU tensors, with a fitting route named or not, and no count moves."""
    t = _torch(_inputs(dict(B=2, N=3, M=5, h=64)), dt)
    before = (ops.luong_attention_fused.launches, dict(ops.luong_attention_fused.launches_by_route))
    routes = [None, "fma"] + (["decode", "wgmma"] if dt == "bfloat16" else [])
    outs = [ops.luong_attention_fused(t["H"], t["S"], t["mask"], t["wa"], t["wc"], route=r) for r in routes]
    assert (ops.luong_attention_fused.launches, ops.luong_attention_fused.launches_by_route) == before
    for o in outs[1:]:
        assert torch.equal(o, outs[0])


def _model_scale_inputs(s, seed=0):
    """fp32 numpy inputs at chip_smoke.py's model scales: tanh-bounded states,
    W_c at its fan-in scale and W_a at an eighth of it, so the scores'
    standard deviation is about 1.6.  At h=1024 the harness's scales (and
    W_a's full fan-in scale) make the softmax all but one-hot, and no source
    position but the largest one moves the output."""
    rng = np.random.default_rng(seed)
    B, N, M, h = s["B"], s["N"], s["M"], s["h"]
    f32 = lambda shape, scale=1.0: (rng.normal(size=shape) * scale).astype(np.float32)  # noqa: E731
    x = dict(H=np.tanh(f32((B, N, h))), S=np.tanh(f32((B, M, h))), wa=f32((h, h), h**-0.5 / 8),
             wc=f32((2 * h, h), (2 * h) ** -0.5))
    mask = rng.random((B, M)) > 0.2
    mask[:, 0] = True
    x["mask"] = mask
    return x


def _wgmma_route_emulation(H, S, mask, wa, wc):
    """The "wgmma" route's arithmetic on bf16 inputs, in plain PyTorch: Q = H W_a
    kept in fp32 (exact bf16 products, fp32 sums), fp32 scores, softmax and
    C = alpha S, C as two bf16 terms C_hi + C_lo, then tanh of the fp32 sum of
    [H | C_hi | C_lo] [W_ch; W_cc; W_cc], rounded to bf16 once."""
    h = H.shape[-1]
    Hf, Sf, waf, wcf = (t.float() for t in (H, S, wa, wc))
    scores = (Hf @ waf) @ Sf.transpose(1, 2)
    scores = torch.where(mask[:, None, :] != 0, scores, torch.full((), -1e30))
    C = torch.softmax(scores, dim=-1) @ Sf
    c_hi = C.to(BF16).float()
    c_lo = (C - c_hi).to(BF16).float()
    return torch.tanh(Hf @ wcf[:h] + c_hi @ wcf[h:] + c_lo @ wcf[h:]).to(BF16)


def _drop_last_position(mask):
    """Each row's last unmasked source position masked too (the control)."""
    m = mask.copy()
    for row in m:
        real = np.flatnonzero(row)
        if real.size:
            row[real[-1]] = False
    return m


def _errors(got, want):
    """(relative L2, max abs) of ``got`` against the fp32 ``want``."""
    d = got.astype(np.float32) - want
    return float(np.linalg.norm(d) / np.linalg.norm(want)), float(np.abs(d).max())


# (shape, model scales, control): the control at every shape but M=1, where dropping the one position
# leaves the same (uniform) softmax
EMULATION_CASES = [(s, ms, c) for s, ms in [(s, False) for s in LUONG_SHAPES] + [(dict(B=2, N=3, M=20, h=1024), True)]
                   for c in (False, True) if not (c and s["M"] == 1)]


@pytest.mark.parametrize("shape,model_scales,control", EMULATION_CASES,
                         ids=lambda v: _sid(v) if isinstance(v, dict) else {True: "control", False: ""}.get(v, ""))
def test_wgmma_route_roundings_within_bound_of_jax(shape, model_scales, control):
    """The "wgmma" route's roundings against JAX's ``luong_attention_ref`` on
    the same bf16 inputs, computed in fp32 (H handed over as fp32, which makes
    the output fp32): within twice the error of JAX's own output rounded to
    bf16, by relative L2 and by max abs, as chip_smoke.py holds the kernel on
    the card.  The control, each row's last unmasked position dropped, must
    miss that bound."""
    x = _model_scale_inputs(shape) if model_scales else _inputs(shape)
    t = _torch(x, "bfloat16")
    j = _jax(x, "bfloat16")
    h = shape["h"]
    want = np.asarray(jax_ref(j["H"].astype(jnp.float32), j["S"], j["mask"], j["wa"], j["wc"][:h], j["wc"][h:]))
    assert want.dtype == np.float32
    own = np.asarray(jnp.asarray(want).astype(jnp.bfloat16).astype(jnp.float32))
    own_rel, own_err = _errors(own, want)
    mask = torch.from_numpy(_drop_last_position(x["mask"]) if control else x["mask"])
    got = _wgmma_route_emulation(t["H"], t["S"], mask, t["wa"], t["wc"])
    rel, err = _errors(got.float().numpy(), want)
    within = rel <= 2 * own_rel and err <= 2 * own_err
    assert within is not control, (f"relative L2 {rel:.3e} (bound {2 * own_rel:.3e}), max abs {err:.3e} "
                                   f"(bound {2 * own_err:.3e})")
