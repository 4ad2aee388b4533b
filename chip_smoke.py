#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits nonzero:

1. environment: torch / CUDA / nvcc versions, the card's name and power limit;
   TF32 switched off for matmuls and cuDNN;
2. build: every CUDA kernel of the port, from the sources in the checkout;
3. kernel vs plain: the ``luong_attn`` kernel against its plain PyTorch
   version at the decode shape, a training-like ragged shape, the
   ``tests/kernel_harness.py`` shapes and an all-masked row, fp32 and bf16;
4. serving: the full-width ``seq2seq-rnn`` (4 layers, h=1024, V=32000, bf16,
   random weights from seed 0) through ``ContinuousEngine``: 8 requests on
   4 slots, so slots recycle; the kernel must have launched once per decode
   tick;
5. kernel path vs plain path in the model, fp32: one ``decode_step`` and a
   16-step ``greedy_decode``;
6. timing with CUDA events at the decode shape (K=4, M=64, bf16).

Then one JSON line with the kernels' numbers, the ``nvidia-smi`` name and
power-limit line, and, last, ``{"ok": true, "device": {...}}``.  Imports
nothing of the JAX package.  Without CUDA, or without the repository
beside it, it exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.plan import ServePlan  # noqa: E402
from repro_torch.kernels.luong_attn import ops as luong_ops  # noqa: E402
from repro_torch.kernels.luong_attn.ref import luong_attention_ref  # noqa: E402
from repro_torch.models import seq2seq as s2s  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.serve.engine import ContinuousEngine  # noqa: E402

# tolerances of tests/kernel_harness.py (TOL_ATTN)
TOL_ATTN = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# tests/kernel_harness.py's luong_attn shapes, copied (block sizes dropped)
HARNESS_SHAPES = [
    dict(B=2, N=16, M=12, h=64),
    dict(B=4, N=32, M=8, h=32),
    dict(B=1, N=64, M=33, h=128),
    dict(B=3, N=10, M=7, h=48),
    dict(B=2, N=1, M=1, h=16),
]
# (label, shape, all-masked row, model scales).  The two h=1024 shapes take
# the model's own input scales: at the harness's, the scores at h=1024 have a
# standard deviation near 100, the softmax is all but one-hot, and two fp32
# evaluations of the same head (different summation orders) can differ by
# more than TOL_ATTN's fp32 bound.
PARITY_CASES = (
    [("decode", dict(B=8, N=1, M=64, h=1024), None, True),
     ("train-ragged", dict(B=4, N=48, M=40, h=1024), None, True)]
    + [(f"harness-{i}", s, None, False) for i, s in enumerate(HARNESS_SHAPES)]
    + [("all-masked-row", dict(B=3, N=2, M=5, h=16), 1, False)]
)
TIMING_SHAPE = dict(B=4, N=1, M=64, h=1024)  # the serving phase's decode tick: 4 slots, max_len 64
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
LUONG_REPLACES = "src/repro/kernels/luong_attn/kernel.py:30"
LUONG_SOURCE = "src/repro_torch/kernels/luong_attn/csrc/luong_attn.cu"


def fail(msg: str):
    raise RuntimeError(msg)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def luong_inputs(s: dict, dtype: torch.dtype, seed: int = 0, masked_row=None, model_scales: bool = False):
    """Inputs on the card: the harness's (states N(0,1), weights 0.1 N(0,1)),
    or with ``model_scales`` the model's own (states tanh-bounded like LSTM
    outputs, weights at the initializer's fan-in scales).  Mask: 20% masked,
    column 0 real, ``masked_row`` all masked."""
    rng = np.random.default_rng(seed)
    B, N, M, h = s["B"], s["N"], s["M"], s["h"]
    f = lambda shape, scale=1.0: torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).cuda()
    H, S = f((B, N, h)), f((B, M, h))
    if model_scales:
        H, S, wa, wc = torch.tanh(H), torch.tanh(S), f((h, h), h**-0.5), f((2 * h, h), (2 * h) ** -0.5)
    else:
        wa, wc = f((h, h), 0.1), f((2 * h, h), 0.1)
    mask = rng.random((B, M)) > 0.2
    mask[:, 0] = True
    if masked_row is not None:
        mask[masked_row] = False
    return H.to(dtype), S.to(dtype), torch.from_numpy(mask).cuda(), wa.to(dtype), wc.to(dtype)


def phase_environment():
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    nvcc = subprocess.run([kernels.nvcc_path(), "--version"], capture_output=True, text=True, timeout=60, check=True)
    print(f"[env] python {sys.version.split()[0]} torch {torch.__version__} cuda {torch.version.cuda} "
          f"nvcc {nvcc.stdout.strip().splitlines()[-1]}")
    print(f"[env] gpu: {nvidia_smi_line()} ({torch.cuda.device_count()} visible)")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"[settings] torch.backends.cuda.matmul.allow_tf32 = {torch.backends.cuda.matmul.allow_tf32}, "
          f"torch.backends.cudnn.allow_tf32 = {torch.backends.cudnn.allow_tf32}")


def phase_build():
    t0 = time.perf_counter()
    kernels.build_all()
    for name in kernels.LIBRARIES:
        kernels.load_library(name)
    print(f"[build] {', '.join(kernels.LIBRARIES)} built and loaded in {time.perf_counter() - t0:.2f}s")


def phase_parity() -> float:
    worst = 0.0
    for label, s, masked, model_scales in PARITY_CASES:
        for dname, dtype in DTYPES.items():
            H, S, mask, wa, wc = luong_inputs(s, dtype, masked_row=masked, model_scales=model_scales)
            h = s["h"]
            got = luong_ops.luong_attention_fused(H, S, mask, wa, wc)
            torch.cuda.synchronize()
            want = luong_attention_ref(H, S, mask, wa, wc[:h], wc[h:])
            if got.dtype != dtype or got.shape != H.shape:
                fail(f"luong_attn {label} {dname}: got {got.dtype} {tuple(got.shape)}")
            if not torch.isfinite(got.float()).all():
                fail(f"luong_attn {label} {dname}: non-finite output")
            err = (got.float() - want.float()).abs().max().item()
            ok = torch.allclose(got.float(), want.float(), **TOL_ATTN[dname])
            print(f"[parity] luong_attn {label} {s} {dname}: max_abs_err {err:.3e} "
                  f"(atol/rtol {TOL_ATTN[dname]['atol']}) {'ok' if ok else 'FAIL'}")
            if not ok:
                fail(f"luong_attn kernel disagrees with its plain version at {label} {dname}")
            worst = max(worst, err)
    return worst


def phase_serve(params, cfg):
    """The slice's main path: ContinuousEngine on the full-width model."""
    V = cfg.vocab_size
    plan = ServePlan.for_config(cfg, max_slots=4, max_len=64, prefill_chunk=16, stage_kernel="cuda")
    engine = ContinuousEngine(cfg, params, plan, bos=1, eos=2, poison_on_recycle=True, check_live_finite=True)
    rng = np.random.default_rng(0)
    lens = rng.integers(12, 49, size=8)
    prompts = [rng.integers(3, V, size=int(L)) for L in lens]
    engine.run(prompts[:2], 2)  # warm-up: first cuBLAS calls, allocator
    torch.cuda.synchronize()
    luong_ops.luong_attention_fused.launches = 0
    t0 = time.perf_counter()
    outs = engine.run(prompts, 24)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = luong_ops.luong_attention_fused.launches
    tok = 0
    for i, o in enumerate(outs):
        if not isinstance(o, np.ndarray) or not 1 <= len(o) <= 24:
            fail(f"request {i}: bad output {o!r}")
        if o.min() < 0 or o.max() >= V:
            fail(f"request {i}: token out of [0, {V})")
        tok += len(o)
    if engine.decode_ticks <= 0 or launches != engine.decode_ticks:
        fail(f"luong_attn launches {launches} != decode ticks {engine.decode_ticks}")
    if engine.finite_checks != engine.decode_ticks:
        fail("the live-slot finiteness check did not run on every tick")
    print(f"[serve] [{cfg.name} | {plan.cache_policy} | {plan.admission}] {len(outs)} requests, "
          f"{tok} tokens in {dt:.2f}s ({tok / dt:.1f} tok/s)")
    print(f"[serve] source lengths {lens.tolist()}, output lengths {[len(o) for o in outs]}, "
          f"{engine.prefill_steps} prefill steps, {engine.decode_ticks} decode ticks, "
          f"luong_attn launches {launches}, live slots finite on every tick (poison canary on)")
    return launches, engine.decode_ticks


def phase_model_paths(params, cfg):
    """fp32: the kernel path and the plain path of the head inside the model."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rng = np.random.default_rng(1)
    B, M = 4, 20
    src = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(B, M))).cuda()
    mask = torch.ones((B, M), dtype=torch.bool, device="cuda")
    mask[1, 15:] = False
    mask[3, 5:] = False
    cache = s2s.init_seq2seq_cache(cfg32, B, M, device="cuda")
    cache = s2s.encode_extend(params, cfg32, src, cache, chunk_mask=mask)
    tok = torch.ones((B,), dtype=torch.int64, device="cuda")
    lk, _ = s2s.decode_step(params, cfg32, tok, cache, stage_kernel="cuda")
    lp, _ = s2s.decode_step(params, cfg32, tok, cache, stage_kernel="torch")
    err = (lk - lp).abs().max().item()
    if not torch.allclose(lk, lp, atol=1e-3, rtol=1e-3):
        fail(f"decode_step logits: kernel path vs plain path max_abs_err {err:.3e} > 1e-3")
    gk = s2s.greedy_decode(params, cfg32, src, mask, 16, bos=1, eos=2, stage_kernel="cuda")
    gp = s2s.greedy_decode(params, cfg32, src, mask, 16, bos=1, eos=2, stage_kernel="torch")
    if not torch.equal(gk, gp):
        fail("greedy_decode tokens differ between the kernel path and the plain path")
    print(f"[model] fp32 decode_step logits kernel vs plain max_abs_err {err:.3e} (atol/rtol 1e-3); "
          f"16-step greedy_decode tokens equal on {B} sources")


def _median_ms(fn, runs: int, flush: torch.Tensor, hide_host: bool) -> float:
    """Median of ``runs`` single calls timed with CUDA events, the L2 cache
    flushed before each (the decode tick streams 100+ MB of other weights
    between two head calls, so the head finds its weights cold).  With
    ``hide_host`` the device spins before the timed region while the host
    enqueues the whole call, so the events time the device's work alone;
    without it they also take in any wait for the host's enqueue."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        if hide_host:
            torch.cuda._sleep(2_000_000)  # about a millisecond of device clock cycles
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def phase_timing(launches: int, ticks: int, max_err: float) -> dict:
    s = TIMING_SHAPE
    B, N, M, h = s["B"], s["N"], s["M"], s["h"]
    H, S, mask, wa, wc = luong_inputs(s, torch.bfloat16, seed=2, model_scales=True)
    mask = mask.to(torch.int32)  # the kernel's input
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    runs = 60
    kernel = lambda: luong_ops.luong_attention_fused(H, S, mask, wa, wc)
    plain = lambda: luong_attention_ref(H, S, mask, wa, wc[:h], wc[h:])
    kernel_ms, plain_ms = _median_ms(kernel, runs, flush, True), _median_ms(plain, runs, flush, True)
    kernel_call_ms, plain_call_ms = _median_ms(kernel, runs, flush, False), _median_ms(plain, runs, flush, False)
    got = luong_ops.luong_attention_fused(H, S, mask, wa, wc)
    want = luong_attention_ref(H, S, mask, wa, wc[:h], wc[h:])
    max_err = max(max_err, (got.float() - want.float()).abs().max().item())
    # least work: each input read once, the output written once; the flops of eq. 1-4
    nbytes = 2 * (B * N * h + B * M * h + 3 * h * h + B * N * h) + 4 * B * M
    flops = 2 * B * N * h * h * 3 + 2 * 2 * B * N * M * h
    bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S) * 1e3
    bound_by = "bytes" if nbytes / HBM_BYTES_PER_S >= flops / BF16_FLOP_PER_S else "operations"
    print(f"[timing] luong_attn at K={B} M={M} h={h} bf16, median of {runs} runs, L2 flushed: "
          f"device time kernel {kernel_ms:.4f} ms, plain {plain_ms:.4f} ms; with the host's enqueue "
          f"kernel {kernel_call_ms:.4f} ms, plain {plain_call_ms:.4f} ms; bound {bound_ms * 1e3:.2f} us "
          f"({nbytes} B at 3.35 TB/s; {bound_by}), {launches / ticks:.2f} launches per decode tick; "
          "library_ms: none (no single PyTorch call computes eq. 1-4)")
    return {
        "name": "luong_attn", "route": "cuda", "source": LUONG_SOURCE, "replaces": LUONG_REPLACES,
        "launches": launches, "max_abs_err": max_err, "ms": kernel_ms, "plain_ms": plain_ms,
        "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
    }


def main():
    phase_environment()
    phase_build()
    max_err = phase_parity()
    cfg = dataclasses.replace(get_config("seq2seq-rnn"), dropout=0.0, dtype="bfloat16")
    t0 = time.perf_counter()
    params = s2s.init_seq2seq(0, cfg, device="cuda")
    n = sum(p.numel() for p in tree_leaves(params))
    if n != cfg.param_count():
        fail(f"parameter count {n} != config's {cfg.param_count()}")
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, h={cfg.d_model}, emb={cfg.emb_size}, V={cfg.vocab_size}, "
          f"{n} parameters ({n * 4 / 1e6:.1f} MB fp32), initialized in {time.perf_counter() - t0:.2f}s")
    launches, ticks = phase_serve(params, cfg)
    phase_model_paths(params, cfg)
    record = phase_timing(launches, ticks, max_err)
    print(json.dumps({"kernels": [record]}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
