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


def test_wrapper_is_inference_only():
    x = _torch(_inputs(REGISTRY["luong_attn"].shapes[0]), "float32")
    with pytest.raises(NotImplementedError, match="inference-only"):
        ops.luong_attention_fused(x["H"].requires_grad_(), x["S"], x["mask"], x["wa"], x["wc"])

