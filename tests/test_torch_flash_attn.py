"""The port's flash attention (``repro_torch.kernels.flash_attn``) against the
JAX package on the CPU, where the wrapper runs its plain version.

* the six ``flash_attn`` shapes of ``tests/kernel_harness.py`` x {fp32, bf16}:
  the model-layout wrapper against ``dense_attention`` (the harness's
  oracle), the kernel-layout wrapper against ``flash_attention_ref``, and
  the plain version against ``chunked_attention`` at the harness's blocks,
  all within ``TOL_ATTN``;
* the flat q layout of ``attn_flat`` configs ([B,S,H,1,D] with H != KV)
  against ``attend``, which broadcasts kv per group (``_match_kv``);
* ``attend`` at the serving prefill's ``q_chunk=128`` with S not a multiple
  of 128, on both of the port's attention paths;
* ragged kernel-layout shapes (S != T) against the dense oracle;
* the wrapper's choice of kernel (route) for every (dtype, head dim) pair,
  and its refusal of a named route that does not take the inputs.

Inputs come from a numpy seed; the JAX Pallas kernel does not run on this
jax, so the JAX side is its dense reference and the chunked attention.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from kernel_harness import TOL_ATTN  # noqa: E402

from repro.kernels.flash_attn.ref import flash_attention_ref  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro_torch.kernels.flash_attn import ops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import flash_attention_dense, flash_attention_plain  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402

pytestmark = pytest.mark.torch_port

# tests/kernel_harness.py's flash_attn shapes (standard + ragged), copied
HARNESS_SHAPES = [
    dict(B=2, S=128, KV=2, G=2, D=32, causal=True, bq=32, bkv=32),
    dict(B=1, S=256, KV=1, G=4, D=64, causal=True, window=64, bq=32, bkv=32),
    dict(B=2, S=64, KV=4, G=1, D=16, causal=False, bq=32, bkv=32),
    dict(B=1, S=128, KV=2, G=1, D=128, causal=True, window=32, bq=32, bkv=32),
    dict(B=1, S=96, KV=1, G=2, D=32, causal=True, bq=64, bkv=64),
    dict(B=1, S=32, KV=1, G=1, D=8, causal=True, window=1, bq=32, bkv=32),
]
DTYPES = {"float32": (np.float32, torch.float32, jnp.float32), "bfloat16": (None, torch.bfloat16, jnp.bfloat16)}
CASES = [(i, dt) for i in range(len(HARNESS_SHAPES)) for dt in DTYPES]


def _ids(case):
    i, dt = case
    s = HARNESS_SHAPES[i]
    return f"S{s['S']}-KV{s['KV']}-G{s['G']}-D{s['D']}-{'causal' if s['causal'] else 'full'}-w{s.get('window')}-{dt}"


def _inputs(shapes, dt: str, seed: int = 0):
    """numpy fp32 draws, rounded to bf16 first for the bf16 cases so both
    frameworks see the same values; returns (torch tensors, jax arrays)."""
    rng = np.random.default_rng(seed)
    _, tdt, jdt = DTYPES[dt]
    ts, js = [], []
    for shape in shapes:
        t = torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(tdt)
        ts.append(t)
        js.append(jnp.asarray(t.float().numpy()).astype(jdt))
    return ts, js


def _np(x):
    return np.asarray(x.float().numpy() if isinstance(x, torch.Tensor) else jnp.asarray(x, jnp.float32))


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_model_layout_wrapper_matches_dense_oracle(case):
    i, dt = case
    s = HARNESS_SHAPES[i]
    B, S, KV, G, D = s["B"], s["S"], s["KV"], s["G"], s["D"]
    (q, k, v), (jq, jk, jv) = _inputs([(B, S, KV, G, D), (B, S, KV, D), (B, S, KV, D)], dt)
    before = ops.flash_attention_fused.launches
    got = ops.flash_attention(q, k, v, causal=s["causal"], window=s.get("window"))
    assert ops.flash_attention_fused.launches == before  # the CPU path launches nothing
    assert got.dtype == q.dtype and got.shape == q.shape
    want = jattn.dense_attention(jq, jk, jv, causal=s["causal"], window=s.get("window"))
    np.testing.assert_allclose(_np(got), _np(want), **TOL_ATTN[dt])


@pytest.mark.parametrize("case", CASES, ids=_ids)
def test_kernel_layout_wrapper_matches_flash_attention_ref(case):
    i, dt = case
    s = HARNESS_SHAPES[i]
    B, S, KV, G, D = s["B"], s["S"], s["KV"], s["G"], s["D"]
    (q, k, v), (jq, jk, jv) = _inputs([(B * KV * G, S, D), (B * KV, S, D), (B * KV, S, D)], dt, seed=1)
    got = ops.flash_attention_fused(q, k, v, causal=s["causal"], window=s.get("window"), group=G)
    want = flash_attention_ref(jq, jk, jv, causal=s["causal"], window=s.get("window"), group=G)
    assert got.dtype == q.dtype
    np.testing.assert_allclose(_np(got), _np(want), **TOL_ATTN[dt])


@pytest.mark.parametrize("i", range(len(HARNESS_SHAPES)), ids=lambda i: _ids((i, "float32")))
def test_plain_version_matches_chunked_attention(i):
    """The plain version at the harness's blocks against the JAX package's
    chunked attention at the same chunks (the same online softmax), fp32."""
    dt = "float32"
    s = HARNESS_SHAPES[i]
    B, S, KV, G, D = s["B"], s["S"], s["KV"], s["G"], s["D"]
    (q, k, v), (jq, jk, jv) = _inputs([(B, S, KV, G, D), (B, S, KV, D), (B, S, KV, D)], dt, seed=2)
    qf = q.permute(0, 2, 3, 1, 4).reshape(B * KV * G, S, D)
    kf, vf = (t.permute(0, 2, 1, 3).reshape(B * KV, S, D) for t in (k, v))
    bq, bkv = tattn.pick_chunk(S, s["bq"]), tattn.pick_chunk(S, s["bkv"])  # blocks fitted to divisors of S
    got = flash_attention_plain(qf, kf, vf, causal=s["causal"], window=s.get("window"), group=G,
                                block_q=bq, block_kv=bkv)
    got = got.reshape(B, KV, G, S, D).permute(0, 3, 1, 2, 4)
    chunked = jax.jit(functools.partial(jattn.chunked_attention, causal=s["causal"], window=s.get("window"),
                                        q_chunk=bq, kv_chunk=bkv))  # one compile instead of one per chunk
    want = chunked(jq, jk, jv)
    np.testing.assert_allclose(_np(got), _np(want), **TOL_ATTN[dt])


FLAT_CASES = [
    dict(B=2, S=64, H=4, KV=2, D=16, window=None),
    dict(B=1, S=96, H=4, KV=2, D=32, window=24),
    dict(B=2, S=48, H=6, KV=2, D=8, window=None),
    dict(B=1, S=80, H=8, KV=1, D=16, window=16),
]


@functools.lru_cache(maxsize=None)
def _flat_case(i: int):
    """Inputs and the JAX ``attend`` output of FLAT_CASES[i] (computed once
    for both of the port's paths)."""
    s = FLAT_CASES[i]
    B, S, H, KV, D = s["B"], s["S"], s["H"], s["KV"], s["D"]
    (q, k, v), (jq, jk, jv) = _inputs([(B, S, H, 1, D), (B, S, KV, D), (B, S, KV, D)], "float32", seed=3)
    attend = jax.jit(functools.partial(jattn.attend, causal=True, window=s["window"], q_chunk=32, kv_chunk=32))
    return (q, k, v), _np(attend(jq, jk, jv))


@pytest.mark.parametrize("i", range(len(FLAT_CASES)),
                         ids=lambda i: "H{H}-KV{KV}-S{S}-w{window}".format(**FLAT_CASES[i]))
@pytest.mark.parametrize("kernel", ["cuda", "torch"])
def test_flat_layout_gqa_matches_attend(i, kernel):
    """q [B,S,H,1,D] with H != KV: head h reads kv head h // (H / KV), as the
    JAX package's ``attend`` broadcasts it."""
    (q, k, v), want = _flat_case(i)
    got = tattn.attend(q, k, v, causal=True, window=FLAT_CASES[i]["window"], q_chunk=32, kv_chunk=32, kernel=kernel)
    assert got.shape == q.shape
    np.testing.assert_allclose(_np(got), want, **TOL_ATTN["float32"])


@functools.lru_cache(maxsize=None)
def _prefill_case(S: int):
    B, KV, G, D = 1, 2, 2, 16
    (q, k, v), (jq, jk, jv) = _inputs([(B, S, KV, G, D), (B, S, KV, D), (B, S, KV, D)], "float32", seed=S)
    attend = jax.jit(functools.partial(jattn.attend, causal=True, window=64, q_chunk=128))
    return (q, k, v), _np(attend(jq, jk, jv))


@pytest.mark.parametrize("S", [192, 200, 320])
@pytest.mark.parametrize("kernel", ["cuda", "torch"])
def test_attend_at_prefill_q_chunk(S, kernel):
    """The serving prefill's q_chunk=128 with S not a multiple of 128
    (``pick_chunk`` fits 96, 100 and 80), GQA 4/2, a window of 64."""
    (q, k, v), want = _prefill_case(S)
    got = tattn.attend(q, k, v, causal=True, window=64, q_chunk=128, kernel=kernel)
    np.testing.assert_allclose(_np(got), want, **TOL_ATTN["float32"])


@pytest.mark.parametrize("S,T,causal,window", [(50, 70, False, None), (70, 50, True, None), (33, 65, True, 8),
                                               (1, 1, True, None)])
def test_ragged_kernel_layout_matches_dense(S, T, causal, window):
    """S != T and tails that divide no block: plain version and dense oracle
    (positions start at 0 for q and k, as in the TPU kernel)."""
    (q, k, v), (jq, jk, jv) = _inputs([(4, S, 16), (2, T, 16), (2, T, 16)], "float32", seed=7)
    got = flash_attention_plain(q, k, v, causal=causal, window=window, group=2, block_q=32, block_kv=32)
    want = flash_attention_dense(q, k, v, causal=causal, window=window, group=2)
    np.testing.assert_allclose(got.numpy(), want.numpy(), **TOL_ATTN["float32"])
    np.testing.assert_allclose(got.numpy(), _np(flash_attention_ref(jq, jk, jv, causal=causal, window=window,
                                                                    group=2)), **TOL_ATTN["float32"])


def test_row_that_sees_no_key_gets_zeros():
    """S > T + window leaves the last rows with no key: zeros (the dense
    oracle would give them the mean of v)."""
    (q, k, v), _ = _inputs([(2, 40, 8), (2, 10, 8), (2, 10, 8)], "float32", seed=8)
    got = flash_attention_plain(q, k, v, causal=True, window=4, group=1)
    assert torch.equal(got[:, 13:], torch.zeros_like(got[:, 13:]))
    assert torch.isfinite(got).all() and got[:, :13].abs().sum() > 0


def test_wrapper_rejects_bad_inputs():
    q, k = torch.zeros(2, 8, 3, 2, 16), torch.zeros(2, 8, 3, 16)
    with pytest.raises(ValueError, match="window"):
        ops.flash_attention(q, k, k, window=0)
    with pytest.raises(ValueError, match="flat"):
        ops.flash_attention(torch.zeros(2, 8, 4, 2, 16), torch.zeros(2, 8, 3, 16), torch.zeros(2, 8, 3, 16))
    with pytest.raises(ValueError, match="expected q"):
        ops.flash_attention(q[0], k, k)
    with pytest.raises(ValueError, match="CUDA .kernel. or CPU"):
        ops.flash_attention_fused(torch.zeros(2, 4, 8, device="meta"), torch.zeros(2, 4, 8, device="meta"),
                                  torch.zeros(2, 4, 8, device="meta"))


@pytest.mark.parametrize("B,flat", [(1, False), (1, True), (2, True)])
def test_adapter_hands_the_kernel_contiguous_inputs(monkeypatch, B, flat):
    """The model-layout adapter passes the kernel layout contiguous (at B == 1
    the permuted reshape is a strided view, which the kernel's wrapper
    refuses): run the CUDA path's input checks on the CPU tensors."""
    calls = []

    def checked(q, k, v, *, causal, window, group):
        ops._check_cuda_inputs(q, k, v, group)
        calls.append(group)
        return flash_attention_plain(q, k, v, causal=causal, window=window, group=group)

    monkeypatch.setattr(ops, "flash_attention_fused", checked)
    (q, k, v), _ = _inputs([(B, 24, 2, 2, 16), (B, 24, 2, 16), (B, 24, 2, 16)], "float32", seed=11)
    if flat:
        q = q.reshape(B, 24, 4, 1, 16)
    out = ops.flash_attention(q, k, v, causal=True, window=None)
    assert calls == [2] and out.shape == q.shape


ROUTE_DIMS = [8, 16, 40, 48, 64, 80, 96, 112, 128]


@pytest.mark.parametrize("D", ROUTE_DIMS)
@pytest.mark.parametrize("dname", ["float32", "bfloat16"])
def test_wrapper_route_choice_and_refusal(dname, D):
    """bf16 at D = 64 or 128 picks the wgmma kernel, bf16 at other multiples
    of 16 the mma.sync kernel, the rest the FMA kernel.  A named route that
    takes the inputs runs (on the CPU: the plain version, no launch); one
    that does not raises, on the CPU as on the card, before any launch."""
    dtype = DTYPES[dname][1]
    bf16 = dtype == torch.bfloat16
    want = "wgmma" if bf16 and D in (64, 128) else "mma" if bf16 and D % 16 == 0 else "fma"
    assert ops.pick_route(dtype, D) == want
    fits = {"wgmma": bf16 and D in (64, 128), "mma": bf16 and D % 16 == 0, "fma": True}
    assert {r: ops.route_fits(r, dtype, D) for r in ops.ROUTES} == fits
    (q, k, v), _ = _inputs([(2, 8, D), (1, 8, D), (1, 8, D)], "float32", seed=12)
    q, k, v = q.to(dtype), k.to(dtype), v.to(dtype)
    plain = flash_attention_plain(q, k, v, causal=True, window=None, group=2)
    before = (ops.flash_attention_fused.launches, dict(ops.flash_attention_fused.launches_by_route))
    for route, ok in fits.items():
        if ok:
            assert torch.equal(ops.flash_attention_fused(q, k, v, group=2, route=route), plain)
        else:
            with pytest.raises(ValueError, match=f"'{route}' kernel does not take"):
                ops.flash_attention_fused(q, k, v, group=2, route=route)
    with pytest.raises(ValueError, match="route must be one of"):
        ops.flash_attention_fused(q, k, v, group=2, route="tma")
    assert (ops.flash_attention_fused.launches, ops.flash_attention_fused.launches_by_route) == before
