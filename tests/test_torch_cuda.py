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

from repro_torch.kernels.luong_attn import ops  # noqa: E402
from repro_torch.kernels.luong_attn.ref import luong_attention_ref  # noqa: E402

pytestmark = [pytest.mark.torch_port, pytest.mark.cuda]

TOL_ATTN = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}  # kernel_harness's
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


def test_luong_kernel_matches_plain():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
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
