"""The port's CUDA kernels against their plain PyTorch versions, on the card.

These tests need an NVIDIA GPU with ``nvcc`` (marker ``cuda``) and skip
elsewhere; they import nothing of JAX, so they run where only the port is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels.lstm_cell import ops as lstm_ops  # noqa: E402
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref  # noqa: E402
from repro_torch.kernels.luong_attn import ops  # noqa: E402
from repro_torch.kernels.luong_attn.ref import luong_attention_ref  # noqa: E402

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]

TOL_ATTN = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}  # kernel_harness's
TOL_TIGHT = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=5e-2, rtol=5e-2)}  # kernel_harness's
TORCH_DT = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# kernel_harness.py's luong_attn shapes, the serving decode shape, and an all-masked row (row 1)
CASES = [
    (dict(B=2, N=16, M=12, h=64), None),
    (dict(B=4, N=32, M=8, h=32), None),
    (dict(B=1, N=64, M=33, h=128), None),
    (dict(B=3, N=10, M=7, h=48), None),
    (dict(B=2, N=1, M=1, h=16), None),
    (dict(B=4, N=1, M=64, h=1024), None),
    (dict(B=3, N=2, M=5, h=16), 1),
]


# kernel_harness.py's lstm_cell shapes (block sizes dropped) and the model's two full-width shapes
LSTM_SHAPES = [
    dict(B=8, In=16, H=32), dict(B=4, In=64, H=64), dict(B=16, In=24, H=128),
    dict(B=1, In=8, H=16), dict(B=6, In=24, H=40), dict(B=7, In=13, H=24),
    dict(B=64, In=512, H=1024), dict(B=64, In=1024, H=1024),
    dict(B=130, In=40, H=72),  # three row tiles of 64, the last ragged
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False


def _lstm_inputs(s, dts, seed=0):
    """x, h, c, wx, wh, b on the card in the dtypes ``dts``: the harness's
    scales for its shapes, the model's (tanh-bounded states, fan-in
    weights) at H=1024."""
    rng = np.random.default_rng(seed)
    B, In, H = s["B"], s["In"], s["H"]
    model = H >= 1024
    f = lambda shape, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.normal(size=shape) * scale).astype(np.float32)).cuda()
    x, h, c = f((B, In)), f((B, H)), f((B, H))
    if model:
        x, h = torch.tanh(x), torch.tanh(h)
        wx, wh, b = f((In, 4, H), In**-0.5), f((H, 4, H), H**-0.5), f((4, H), 0.1)
    else:
        wx, wh, b = f((In, 4, H), 0.1), f((H, 4, H), 0.1), f((4, H), 0.1)
    return tuple(t.to(dt) for t, dt in zip((x, h, c, wx, wh, b), dts))


@pytest.mark.parametrize("feed", ["float32", "bfloat16", "model"])
def test_lstm_kernel_matches_plain(cuda, feed):
    """All six inputs in one dtype at TOL_TIGHT, and the model's feed (x bf16,
    h/c and weights fp32) at fp32's: both sides take the same bf16 x into
    fp32 products, and the outputs are fp32."""
    dts = (torch.bfloat16,) + (torch.float32,) * 5 if feed == "model" else (TORCH_DT[feed],) * 6
    tol = TOL_TIGHT["bfloat16" if feed == "bfloat16" else "float32"]
    for s in LSTM_SHAPES:
        args = _lstm_inputs(s, dts)
        before = lstm_ops.lstm_cell_fused.launches
        got = lstm_ops.lstm_cell_fused(*args)
        torch.cuda.synchronize()
        assert lstm_ops.lstm_cell_fused.launches == before + 1
        want = lstm_cell_ref(*args)
        for g, w, ref_in in zip(got, want, args[1:3]):
            assert g.dtype == ref_in.dtype and g.shape == ref_in.shape
            np.testing.assert_allclose(g.float().cpu().numpy(), w.float().cpu().numpy(), **tol,
                                       err_msg=f"{s} {feed}")


def test_lstm_backward_through_kernel_matches_plain(cuda):
    """fp32 grads of all six inputs through the kernel's Function (the
    analytic adjoint) equal autograd through the plain version."""
    for s in (LSTM_SHAPES[5], LSTM_SHAPES[7], LSTM_SHAPES[8]):
        args = _lstm_inputs(s, (torch.float32,) * 6, seed=1)
        rng = np.random.default_rng(2)
        dh = torch.from_numpy(rng.normal(size=(s["B"], s["H"])).astype(np.float32)).cuda()
        dc = torch.from_numpy(rng.normal(size=(s["B"], s["H"])).astype(np.float32)).cuda()
        grads = []
        for fn in (lstm_ops.lstm_cell_fused, lstm_cell_ref):
            ins = [a.clone().requires_grad_() for a in args]
            h_new, c_new = fn(*ins)
            grads.append(torch.autograd.grad((h_new * dh).sum() + (c_new * dc).sum(), ins))
        for name, g, w in zip(("x", "h", "c", "wx", "wh", "b"), *grads):
            np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=1e-4, rtol=1e-4, err_msg=f"{s} d{name}")


def test_luong_backward_through_kernel_matches_plain(cuda):
    rng = np.random.default_rng(3)
    B, N, M, h = 4, 24, 20, 1024
    f = lambda shape, scale=1.0: torch.from_numpy(  # noqa: E731
        (rng.normal(size=shape) * scale).astype(np.float32)).cuda()
    H, S = torch.tanh(f((B, N, h))), torch.tanh(f((B, M, h)))
    wa, wc = f((h, h), h**-0.5), f((2 * h, h), (2 * h) ** -0.5)
    mask = torch.from_numpy(rng.random((B, M)) > 0.2).cuda()
    mask[:, 0] = True
    dout = f((B, N, h))
    grads = []
    for fused in (True, False):
        ins = [t.clone().requires_grad_() for t in (H, S, wa, wc)]
        if fused:
            out = ops.luong_attention_fused(ins[0], ins[1], mask, ins[2], ins[3])
        else:
            out = luong_attention_ref(ins[0], ins[1], mask, ins[2], ins[3][:h], ins[3][h:])
        grads.append(torch.autograd.grad((out * dout).sum(), ins))
    for name, g, w in zip(("H", "S", "w_alpha", "w_c"), *grads):
        np.testing.assert_allclose(g.cpu().numpy(), w.cpu().numpy(), atol=1e-4, rtol=1e-4, err_msg=f"d{name}")


def test_luong_kernel_matches_plain(cuda):
    for s, masked in CASES:
        for dname, dt in TORCH_DT.items():
            rng = np.random.default_rng(0)
            B, N, M, h = s["B"], s["N"], s["M"], s["h"]
            f = lambda shape, scale=1.0: torch.from_numpy(  # noqa: E731
                (rng.normal(size=shape) * scale).astype(np.float32)).to("cuda", dt)
            H, S, wa, wc = f((B, N, h)), f((B, M, h)), f((h, h), 0.1), f((2 * h, h), 0.1)
            mask = rng.random((B, M)) > 0.2
            mask[:, 0] = True
            if masked is not None:
                mask[masked] = False
            mask = torch.from_numpy(mask).cuda()
            before = ops.luong_attention_fused.launches
            got = ops.luong_attention_fused(H, S, mask, wa, wc)
            torch.cuda.synchronize()
            assert ops.luong_attention_fused.launches == before + 1
            want = luong_attention_ref(H, S, mask, wa, wc[:h], wc[h:])
            np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(), **TOL_ATTN[dname],
                                       err_msg=f"{s} {dname}")
