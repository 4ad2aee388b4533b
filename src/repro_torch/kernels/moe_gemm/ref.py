"""Plain PyTorch version of the grouped expert FFN, in the layout of
``repro/kernels/moe_gemm/kernel.py``:

    out[e] = (silu(x[e] @ w1[e]) * (x[e] @ wg[e])) @ w2[e]

x [E, C, d] (the MoE dispatch buffer), w1/wg [E, d, F], w2 [E, F, d] ->
[E, C, d] in x's dtype.  Every product and the gate run in fp32 and the
result is cast once at the end, as in ``repro/kernels/moe_gemm/ref.py::
moe_gemm_ref``.  With ``rows`` (int [E]) only the first ``rows[e]`` rows of
expert e hold a slot: the others are taken as zero rows, whatever x holds
there, and come back exactly zero.  ``ops.moe_gemm_fused`` runs it on CPU
tensors, and ``chip_smoke.py`` holds the CUDA kernels against it on the card.
"""
from __future__ import annotations

import torch


def moe_gemm_plain(x, w1, wg, w2, rows=None):
    xf = x.float()
    live = None
    if rows is not None:
        live = (torch.arange(x.shape[1], device=x.device)[None, :] < rows.to(x.device)[:, None])[..., None]
        xf = torch.where(live, xf, 0.0)  # a select, so NaN or Inf past rows[e] cannot leak
    h = torch.nn.functional.silu(torch.einsum("ecd,edf->ecf", xf, w1.float()))
    h = h * torch.einsum("ecd,edf->ecf", xf, wg.float())
    out = torch.einsum("ecf,efd->ecd", h, w2.float())
    if live is not None:
        out = torch.where(live, out, 0.0)
    return out.to(x.dtype)
