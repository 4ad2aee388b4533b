"""The port's grouped expert FFN (``repro_torch.kernels.moe_gemm``) and MoE
block (``repro_torch.models.moe``) against the JAX package on the CPU,
where the wrapper runs its plain version.

* the five ``moe_gemm`` shapes of ``tests/kernel_harness.py`` (standard and
  ragged) x {fp32, bf16}: the wrapper against JAX's Pallas kernel in
  interpret mode (at the harness's blocks) and against ``moe_gemm_ref``;
  fp32 within 1e-5, bf16 within ``TOL_TIGHT``;
* the same with ``rows`` (how many leading rows of each expert hold a
  slot: 0, C and values between), NaN or 1e4 planted past ``rows[e]``:
  JAX's kernel on the buffer with those rows zeroed, and exact zeros there;
  the routes the wrapper picks, and its refusals;
* each function of ``models/moe.py`` against its JAX counterpart at fp32,
  8 experts, top-2, capacity factors 1.25, 0.5 (drops) and 16 (none):
  ``route`` (weights within 1e-6, indices equal), ``sorted_dispatch`` (dest
  and keep equal), gather and scatter, ``expert_ffn``, and ``apply_moe`` on
  both ``kernel`` values (y within 1e-5, aux within 1e-6); the ``rows``
  that ``apply_moe`` hands the kernel against a count of the kept slots of
  JAX's ``sorted_dispatch``.

Inputs come from a numpy seed; bf16 inputs are rounded once and handed to
both frameworks.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from kernel_harness import TOL_TIGHT  # noqa: E402

from repro.configs.base import MoEConfig as JaxMoEConfig  # noqa: E402
from repro.kernels.moe_gemm.ops import moe_gemm_fused as jax_moe_gemm_fused  # noqa: E402
from repro.kernels.moe_gemm.ref import moe_gemm_ref  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch.configs.base import MoEConfig  # noqa: E402
from repro_torch.kernels.moe_gemm import ops  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import moe_gemm_plain  # noqa: E402
from repro_torch.models import moe  # noqa: E402

pytestmark = pytest.mark.torch_port

# tests/kernel_harness.py's moe_gemm shapes (standard + ragged), copied
HARNESS_SHAPES = [
    dict(E=4, C=16, d=32, F=64, bc=8, bf=32),
    dict(E=2, C=8, d=64, F=96, bc=8, bf=48),
    dict(E=8, C=32, d=16, F=16, bc=16, bf=16),
    dict(E=1, C=1, d=16, F=16, bc=16, bf=16),
    dict(E=3, C=10, d=24, F=36, bc=4, bf=16),
]
DTYPES = {"float32": (torch.float32, jnp.float32), "bfloat16": (torch.bfloat16, jnp.bfloat16)}
TOL_FP32 = dict(atol=1e-5, rtol=1e-5)


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


def _gemm_inputs(s: dict, dt: str, seed: int = 0):
    """The harness's scales (x N(0,1), weights 0.1 N(0,1)); returns (torch, jax)."""
    rng = np.random.default_rng(seed)
    E, C, d, F = s["E"], s["C"], s["d"], s["F"]
    tdt, jdt = DTYPES[dt]
    ts, js = [], []
    for shape, scale in (((E, C, d), 1.0), ((E, d, F), 0.1), ((E, d, F), 0.1), ((E, F, d), 0.1)):
        t = torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).to(tdt)
        ts.append(t)
        js.append(jnp.asarray(t.float().numpy()).astype(jdt))
    return ts, js


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("s", HARNESS_SHAPES, ids=lambda s: f"E{s['E']}-C{s['C']}-d{s['d']}-F{s['F']}")
def test_plain_moe_gemm_matches_jax_kernel(s, dt):
    (x, w1, wg, w2), jargs = _gemm_inputs(s, dt)
    before = ops.moe_gemm_fused.launches
    got = ops.moe_gemm_fused(x, w1, wg, w2)
    assert ops.moe_gemm_fused.launches == before  # the CPU path is the plain version: no launch
    assert torch.equal(got, moe_gemm_plain(x, w1, wg, w2))
    assert got.dtype == x.dtype and got.shape == x.shape
    tol = TOL_FP32 if dt == "float32" else TOL_TIGHT["bfloat16"]
    pallas = jax_moe_gemm_fused(*jargs, block_c=s["bc"], block_f=s["bf"], interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)
    np.testing.assert_allclose(_np(got), _np(moe_gemm_ref(*jargs)), **tol)


# (rows pattern, what is planted past rows[e]): rows of 0, C and values between across the experts
ROWS_CASES = [("mixed", "nan"), ("mixed", "large"), ("one", "nan"), ("none", "large"), ("full", "none")]


def _rows(kind: str, E: int, C: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    if kind == "mixed":  # 0, C and random values between (a single expert holds C)
        r = rng.integers(0, C + 1, size=E)
        r[: min(E, 2)] = [0, C][: min(E, 2)]
        return r.astype(np.int32)
    return np.full(E, {"one": min(1, C), "none": 0, "full": C}[kind], dtype=np.int32)


@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("case", ROWS_CASES, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("s", HARNESS_SHAPES, ids=lambda s: f"E{s['E']}-C{s['C']}-d{s['d']}-F{s['F']}")
def test_plain_moe_gemm_rows_matches_jax_kernel(s, case, dt):
    """With ``rows``, the rows past rows[e] are no slot: whatever the buffer
    holds there (NaN, 1e4), the wrapper gives JAX's kernel's output on the
    buffer with those rows zeroed, and exact zeros in them."""
    kind, garbage = case
    (x, w1, wg, w2), _ = _gemm_inputs(s, dt)
    E, C = s["E"], s["C"]
    rows = _rows(kind, E, C)
    dead = np.arange(C)[None, :] >= rows[:, None]
    if garbage != "none":
        x[torch.from_numpy(dead)] = float("nan") if garbage == "nan" else 1e4
    zeroed = x.float().numpy().copy()
    zeroed[dead] = 0.0
    tdt, jdt = DTYPES[dt]
    before = ops.moe_gemm_fused.launches
    got = ops.moe_gemm_fused(x, w1, wg, w2, torch.from_numpy(rows))
    assert ops.moe_gemm_fused.launches == before
    assert got.dtype == x.dtype and got.shape == x.shape
    assert torch.count_nonzero(got[torch.from_numpy(dead)]) == 0 and not torch.isnan(got).any()
    tol = TOL_FP32 if dt == "float32" else TOL_TIGHT["bfloat16"]
    jargs = [jnp.asarray(zeroed).astype(jdt)] + [jnp.asarray(t.float().numpy()).astype(jdt) for t in (w1, wg, w2)]
    pallas = jax_moe_gemm_fused(*jargs, block_c=s["bc"], block_f=s["bf"], interpret=True)
    np.testing.assert_allclose(_np(got), _np(pallas), **tol)


@pytest.mark.parametrize("dtype, E, C, d, F, want", [
    (torch.bfloat16, 128, 641, 2048, 768, "wgmma"),  # the MoE prefill's call
    (torch.bfloat16, 128, 1, 2048, 768, "decode"),  # the decode step's
    (torch.bfloat16, 8, 16, 256, 192, "decode"),
    (torch.bfloat16, 8, 17, 256, 192, "wgmma"),
    (torch.bfloat16, 2, 70, 40, 72, "mma"),  # not multiples of 64
    (torch.bfloat16, 3, 10, 24, 36, "fma"),  # F not a multiple of 8
    (torch.float32, 128, 641, 2048, 768, "fma"),
    (torch.bfloat16, 512, 641, 2048, 768, "mma"),  # more experts than the wgmma kernels' prefix sums hold
])
def test_pick_route(dtype, E, C, d, F, want):
    assert ops.pick_route(dtype, E, C, d, F) == want
    assert ops.route_fits(want, dtype, E, C, d, F) and ops.route_fits("fma", dtype, E, C, d, F)


def test_route_and_rows_are_checked_on_the_host():
    """A named route that does not fit, and rows of the wrong type or shape,
    raise on CPU tensors as on the card; a route that fits runs the plain
    version."""
    (x, w1, wg, w2), _ = _gemm_inputs(HARNESS_SHAPES[0], "float32")
    with pytest.raises(ValueError, match="do not take"):
        ops.moe_gemm_fused(x, w1, wg, w2, route="wgmma")
    with pytest.raises(ValueError, match="route must be one of"):
        ops.moe_gemm_fused(x, w1, wg, w2, route="tiled")
    with pytest.raises(ValueError, match="rows must be int32"):
        ops.moe_gemm_fused(x, w1, wg, w2, torch.zeros(x.shape[0], dtype=torch.int64))
    with pytest.raises(ValueError, match="rows must be int32"):
        ops.moe_gemm_fused(x, w1, wg, w2, torch.zeros(x.shape[0] + 1, dtype=torch.int32))
    assert torch.equal(ops.moe_gemm_fused(x, w1, wg, w2, route="fma"), moe_gemm_plain(x, w1, wg, w2))


def test_zero_rows_give_zero_rows():
    """Empty capacity slots are zero rows of the dispatch buffer; they come
    back exactly zero."""
    (x, w1, wg, w2), _ = _gemm_inputs(HARNESS_SHAPES[4], "float32")
    x[:, 3:7] = 0
    got = ops.moe_gemm_fused(x, w1, wg, w2)
    assert torch.count_nonzero(got[:, 3:7]) == 0


# ---------------------------------------------------------------------------
# models/moe.py
# ---------------------------------------------------------------------------

T, D, F_EXP, E, K = 24, 16, 32, 8, 2
CAPACITY_FACTORS = [1.25, 0.5, 16.0]


def _cfgs(cf: float):
    kw = dict(num_experts=E, top_k=K, d_ff_expert=F_EXP, capacity_factor=cf)
    return MoEConfig(**kw), JaxMoEConfig(**kw)


def _block(seed: int = 0):
    """x [T, d] and the block's weights at the initializer's scales."""
    rng = np.random.default_rng(seed)
    f = lambda shape, scale: (rng.normal(size=shape) * scale).astype(np.float32)  # noqa: E731
    x = f((T, D), 1.0)
    p = {"router": f((D, E), 0.02 * 10), "w1": f((E, D, F_EXP), D**-0.5), "wg": f((E, D, F_EXP), D**-0.5),
         "w2": f((E, F_EXP, D), F_EXP**-0.5)}  # a router 10x the init scale spreads the tokens over the experts
    return x, p


def _torch_tree(p):
    return {k: torch.from_numpy(v) for k, v in p.items()}


def _jax_tree(p):
    return {k: jnp.asarray(v) for k, v in p.items()}


def test_route_matches_jax():
    x, p = _block()
    m, jm = _cfgs(1.25)
    w, idx, (frac, mp) = moe.route(torch.from_numpy(p["router"]), torch.from_numpy(x), m)
    jw, jidx, (jfrac, jmp) = jmoe.route(jnp.asarray(p["router"]), jnp.asarray(x), jm)
    assert idx.tolist() == np.asarray(jidx).tolist()
    np.testing.assert_allclose(w.numpy(), np.asarray(jw), atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(frac.numpy(), np.asarray(jfrac), atol=1e-6)
    np.testing.assert_allclose(mp.numpy(), np.asarray(jmp), atol=1e-6)
    aux = moe.aux_from_stats((frac, mp), m)
    np.testing.assert_allclose(aux.item(), float(jmoe.aux_from_stats((jfrac, jmp), jm)), atol=1e-6)


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_sorted_dispatch_gather_scatter_match_jax(cf):
    x, p = _block(1)
    m, jm = _cfgs(cf)
    _, idx, _ = jmoe.route(jnp.asarray(p["router"]), jnp.asarray(x), jm)
    ids = np.array(idx).reshape(-1)  # a writable copy
    C = moe._capacity(T * K, E, cf)
    assert C == jmoe._capacity(T * K, E, cf)
    dest, keep = moe.sorted_dispatch(torch.from_numpy(ids).long(), E, C)
    jdest, jkeep = jmoe.sorted_dispatch(jnp.asarray(ids), E, C)
    assert dest.tolist() == np.asarray(jdest).tolist() and keep.tolist() == np.asarray(jkeep).tolist()
    assert bool(keep.all()) == (cf == 16.0)  # drops at 0.5 (and here at 1.25), none at 16
    slots = np.repeat(x, K, axis=0)
    buf = moe.gather_to_groups(torch.from_numpy(slots), torch.from_numpy(ids).long(), dest, keep, E, C)
    jbuf = jmoe.gather_to_groups(jnp.asarray(slots), jnp.asarray(ids), jdest, jkeep, E, C)
    assert buf.is_contiguous()
    np.testing.assert_array_equal(buf.numpy(), np.asarray(jbuf))
    back = moe.scatter_from_groups(buf, torch.from_numpy(ids).long(), dest, keep)
    jback = jmoe.scatter_from_groups(jbuf, jnp.asarray(ids), jdest, jkeep)
    np.testing.assert_array_equal(back.numpy(), np.asarray(jback))


def test_expert_ffn_matches_jax():
    rng = np.random.default_rng(2)
    _, p = _block(2)
    buf = rng.normal(size=(E, 5, D)).astype(np.float32)
    got = moe.expert_ffn(_torch_tree(p), torch.from_numpy(buf), "silu")
    want = jmoe.expert_ffn(_jax_tree(p), jnp.asarray(buf), "silu")
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL_FP32)
    plain = {k: v for k, v in p.items() if k != "wg"}  # the ungated expert
    got = moe.expert_ffn(_torch_tree(plain), torch.from_numpy(buf), "gelu")
    np.testing.assert_allclose(got.numpy(), np.asarray(jmoe.expert_ffn(_jax_tree(plain), jnp.asarray(buf), "gelu")),
                               **TOL_FP32)


@pytest.mark.parametrize("kernel", ["cuda", "torch"])
@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_apply_moe_matches_jax(cf, kernel):
    x, p = _block(3)
    m, jm = _cfgs(cf)
    y, aux = moe.apply_moe(_torch_tree(p), torch.from_numpy(x), m, "silu", kernel=kernel)
    jy, jaux = jmoe.apply_moe(_jax_tree(p), jnp.asarray(x), jm, "silu")
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **TOL_FP32)
    np.testing.assert_allclose(aux.item(), float(jaux), atol=1e-6)


@pytest.mark.parametrize("cf", CAPACITY_FACTORS)
def test_apply_moe_rows_match_jax_dispatch(cf, monkeypatch):
    """The rows that apply_moe computes on the device and hands the kernel
    are, per expert, the count of the slots JAX's sorted_dispatch keeps
    (min(n_e, C)); the buffer holds the slots in those rows and zeros past
    them."""
    x, p = _block(4)
    m, jm = _cfgs(cf)
    seen = []

    def record(buf, w1, wg, w2, rows=None):
        seen.append((buf.clone(), rows.clone()))
        return ops.moe_gemm_fused(buf, w1, wg, w2, rows)

    monkeypatch.setattr(moe, "moe_gemm_fused", record)
    moe.apply_moe(_torch_tree(p), torch.from_numpy(x), m, "silu", kernel="cuda")
    _, idx, _ = jmoe.route(jnp.asarray(p["router"]), jnp.asarray(x), jm)
    ids = np.array(idx).reshape(-1)
    C = jmoe._capacity(T * K, E, cf)
    _, jkeep = jmoe.sorted_dispatch(jnp.asarray(ids), E, C)
    want = np.bincount(ids[np.asarray(jkeep)], minlength=E)
    assert len(seen) == 1
    buf, rows = seen[0]
    assert rows.dtype == torch.int32 and rows.tolist() == want.tolist()
    assert (rows.numpy() < np.bincount(ids, minlength=E)).any() == (cf != 16.0)  # slots dropped below cf=16
    live = np.arange(C)[None, :] < want[:, None]
    assert torch.count_nonzero(buf[torch.from_numpy(~live)]) == 0
    assert bool((buf[torch.from_numpy(live)] != 0).any(-1).all())


def test_apply_moe_rejects_what_the_kernel_does_not_compute():
    x, p = _block()
    m, _ = _cfgs(1.25)
    with pytest.raises(ValueError, match="gated silu"):
        moe.apply_moe(_torch_tree(p), torch.from_numpy(x), m, "gelu", kernel="cuda")
    with pytest.raises(ValueError, match="kernel must be one of"):
        moe.apply_moe(_torch_tree(p), torch.from_numpy(x), m, kernel="pallas")
    plain = {k: v for k, v in p.items() if k != "wg"}
    y, _ = moe.apply_moe(_torch_tree(plain), torch.from_numpy(x), m, "silu", kernel="torch")
    assert y.shape == (T, D)
