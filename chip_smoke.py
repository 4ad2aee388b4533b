#!/usr/bin/env python3
"""Chip smoke test of the PyTorch + CUDA port (``src/repro_torch``) on one
NVIDIA GPU.  Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases, each printed as it runs; any failure exits nonzero:

1. environment: torch / CUDA / nvcc versions, the card's name and power limit;
   TF32 switched off for matmuls and cuDNN;
2. build: every CUDA kernel of the port, from the sources in the checkout,
   one ``nvcc`` per kernel, all started together;
3. kernel vs plain, forward: the ``luong_attn`` kernels, on every route
   that takes each shape ("decode": bf16 up to 32 rows; "wgmma": bf16, h a
   multiple of 64; "fma": all), at the decode ticks (8 and 4 slots, 32
   rows), the training step's shape (2048 rows), ragged rows (N=48, R=129),
   one and 129 source positions, the ``tests/kernel_harness.py`` shapes and
   an all-masked row, fp32 and bf16 at TOL_ATTN; bf16 on the new routes
   also against the plain version's fp32 output, within twice that
   output's own bf16 rounding error (relative L2 and max abs), two calls
   bit-identical, and a control with each row's last unmasked source
   position dropped must miss that bound; the ``lstm_cell`` kernels at the harness's shapes, a shape
   of three ragged row tiles and the model's two full-width shapes, fp32 and
   bf16, the old mixed feed (fp32 weights: the FMA kernel), the model's feed
   (x and weights bf16, h and c fp32: the tensor-core kernel, held to
   LSTM_MMA_TOL, with a control that rounds h to bf16 and must miss it), and a
   cross-check against ``torch.lstm_cell``;
4. kernel vs plain, backward: fp32 grads through each kernel's
   ``autograd.Function`` against autograd through its plain version, at the
   full-width training shapes (and the Luong forward output beside them);
5. serving: the full-width ``seq2seq-rnn`` (4 layers, h=1024, V=32000, bf16,
   random weights from seed 0) through ``ContinuousEngine``: 8 requests on
   4 slots, so slots recycle; ``luong_attn`` launches once per decode tick,
   every one on the "decode" route;
6. kernel path vs plain path in the serving model, fp32: one ``decode_step``
   and a 16-step ``greedy_decode``;
7. training: the full-width model through ``Trainer`` (bf16 compute over fp32
   masters, dropout 0.3, Adam, clip 5.0) on ``MTBatchIterator`` batches of 64,
   8 steps; ``lstm_cell`` launches layers x (M + N), every one on the
   tensor-core kernel, and ``luong_attn`` once per step on the "wgmma"
   route; then one step under
   ``torch.profiler``;
8. kernel path vs plain path in one fp32 training step: loss and every grad
   leaf;
8b. hybrid: the paper's hybrid data-model parallel step at full width
   (``core/pipeline.py``'s wavefront, the phase boundary, the data-parallel
   head).  (a) The trivial 1 x 1 grid over NCCL (world 1), HYBRID, pipelined,
   2 microbatches interleaved through one wavefront: an fp32 step at dropout
   0.3 on each of gpipe, 1f1b and zerobubble against the meshless step on the
   same batch of 64 and generator seed (loss within STEP_LOSS_TOL, every grad
   leaf at STEP_TOL); then 4 bf16 steps through ``Trainer`` on each
   schedule, median step time beside the card's name and power limit, with
   ``lstm_cell`` launching the meshless micro_batches=2 step's k x layers x
   (M + N) plus the backward's recompute of as many again, every one on the
   tensor-core kernel, and ``luong_attn`` once (the meshless step: once per
   microbatch), on the "wgmma" route.  (b) A 1 x 2 grid of two processes on
   this card over gloo (NCCL refuses two ranks on one card; the hand-offs go
   through host memory): one fp32 step on gpipe and 1f1b, its grads
   gathered from the two stages, against (a)'s meshless step; a rank that
   fails or outlives its time limit fails the script;
9. timing with CUDA events: ``luong_attn`` at the decode tick on the
   "decode" route and at the training shape on the "wgmma" route, each
   beside the first kernel (the "fma" route), the plain version and the "torch" stage
   path's bf16 eq. 1-4 (cuBLAS GEMMs: the yardstick), with the scratch each
   allocates; ``lstm_cell`` at the training shape on the model's feed
   (L2 flushed and warm; and at In=512), beside the fp32-masters feed's FMA
   kernel, the plain version and ``torch.lstm_cell`` in bf16;
10. ``flash_attn`` kernel vs plain, on every route that takes the inputs:
    fp32 on the FMA kernel ("fma"); bf16 on the wgmma kernel ("wgmma", D=64
    and 128), the mma.sync kernel ("mma", D a multiple of 16) and the FMA
    kernel (not at the three full-width shapes): the ``tests/kernel_harness.py``
    shapes, four edge shapes (S=77 against T=131 with G=3, D=64 at G=1
    without the causal mask, one row, G=8 with a window of 100), the
    full-width prefill's per-layer call (B=4, S=2048, 16 q heads on 8 kv
    heads, D=128, window 4096), a window-binding one (B=1, S=8192) and the
    MoE LM's prefill call (B=4, S=2048, 32 q heads on 4 kv heads).  Each
    launch must count on its route; two wgmma calls must be bit-identical.
    bf16 is also held against the plain version's fp32 output on the same
    bf16 inputs (FLASH_BF16_TOL and a relative L2 bound), and a control with
    the window 64 keys short must miss that bound;
11. LM serving: the full-width ``qwen3-1.7b`` (28 layers, d=2048, V=151936,
    bf16 over fp32 masters, random weights from seed 0) through
    ``ServeEngine.generate``: (a) 4 prompts of 2048 tokens, 32 new tokens;
    (b) 1 prompt of 8192 tokens (past the 4096 window: the rolling cache and
    the window's tile pruning run), 16 new tokens; exactly 28 ``flash_attn``
    launches per generate, all on the wgmma route, i.e. per prefill and none
    per decode step (greedy
    decode replays a CUDA graph of the step); then one prefill and 8 eager
    decode steps under ``torch.profiler``;
12. kernel path vs plain path in the LM, fp32: one prefill of 2 prompts of
    512 tokens (logits) and 8 greedy tokens through ``ServeEngine``, graphed
    and eager decode alike;
13. kernel path vs plain path in the LM, bf16, at (a)'s and (b)'s prompts:
    each of the 28 kernel calls of the prefill against the plain version's
    fp32 output on its own inputs, and the last-position logits against the
    plain path's (relative L2); at (b) a control with the kernel's window one
    tile short must miss the logits bound;
14. ``moe_gemm`` kernel vs plain, on every route that takes the inputs:
    fp32 on the FMA kernels ("fma"); bf16 on the wgmma kernels ("wgmma", d
    and F multiples of 64), the decode kernels ("decode", the same at C <=
    16), the mma.sync kernels ("mma", multiples of 8) and the FMA
    kernels: the ``tests/kernel_harness.py`` shapes, a shape ragged in every
    tile, the MoE serving run's two calls, prefill [128, 641, 2048] x [128,
    2048, 768] and decode (C=1), three shapes at the wide routes' edges and
    the decode route at C of 2-16; each without and with ``rows`` (0, C and
    values between), with NaN and 1e4 planted past ``rows[e]``; empty slots
    and the rows past ``rows[e]`` must come back exactly zero, and each
    launch must count on its route.  bf16 is also held against the plain
    version's fp32 output on the same bf16 inputs (MOE_BF16_TOL, relative
    L2), and a control that drops the last 64 columns of F must miss that
    bound;
15. MoE serving: ``qwen3-moe-30b-a3b`` at full width, its depth cut to 8 of
    48 layers (bf16 over fp32 masters, random weights from seed 0), through
    ``ServeEngine.generate`` at (a)'s shape: 4 prompts of 2048 tokens, 32 new
    tokens; exactly 8 ``flash_attn`` launches (the prefill, all on the wgmma
    route) and 24
    ``moe_gemm`` launches (8 in the prefill, on the wgmma route; 8 in the
    eager decode step and 8 in the capture of the CUDA graph, on the decode
    route; the replays launch from the graph); then one prefill and 8 eager
    decode steps under ``torch.profiler``, and one replay of a captured
    decode graph, whose kernels must include the decode route's two
    ``moe_gemm`` kernels 8 times each and no other ``moe_gemm`` kernel;
16. kernel path vs plain path in the MoE LM, fp32: one prefill of 2 prompts
    of 512 tokens (last-position logits within 1e-4) and 8 greedy tokens
    through ``ServeEngine``, graphed and eager;
17. kernel path vs plain path in the MoE LM, bf16, at (a): each of the 8
    ``moe_gemm`` calls (with the rows the dispatch passes; zeros past them)
    and each of the 8 ``flash_attn`` calls of the prefill
    against its plain version's fp32 output on its own inputs, and the
    last-position logits against the plain path's (relative L2), with two
    controls that must miss that bound: 64 columns of F dropped in every
    ``moe_gemm`` call, and the flat query heads regrouped under the wrong
    kv heads in every ``flash_attn`` call;
18. timing with CUDA events: ``flash_attn`` at (a)'s per-layer call against
    the mma route's kernel, its plain version and
    ``scaled_dot_product_attention`` (the library yardstick, used nowhere in
    the port), at the MoE prefill's call (G=8) against the mma route's
    kernel and SDPA, and at (b)'s against the mma route's kernel; ``moe_gemm`` at the
    MoE prefill's call on a dense buffer and on a served prefill's layer-0
    buffer with its rows, and at a decode step's call on a dense buffer
    (every expert has a row) and on a served step's buffer with its rows
    (the bounds count only the rows and experts with a slot), against the
    first tensor-core kernels (the mma route), its plain version and, as a yardstick used
    nowhere in the port, ``torch.bmm`` x 3 plus the gate.

Then one JSON line with the kernels' numbers (``launches`` counts the
launches of the serving runs, the training run and the hybrid phase's bf16
steps, each counted from 0 around its run, the last also as
``hybrid_launches``; ``luong_attn`` one record per route on the main path,
``flash_attn`` and ``moe_gemm`` also by route), the ``nvidia-smi`` name and
power-limit line, and, last,
``{"ok": true, "device": {...}}``.  Imports nothing of the JAX package.
Without CUDA, or without the repository beside it, it exits nonzero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core.plan import ExecutionPlan, ServePlan  # noqa: E402
from repro_torch.data import MTBatchIterator, SyntheticMTTask  # noqa: E402
from repro_torch.kernels.flash_attn import ops as flash_ops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import flash_attention_plain  # noqa: E402
from repro_torch.kernels.lstm_cell import ops as lstm_ops  # noqa: E402
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref  # noqa: E402
from repro_torch.kernels.luong_attn import ops as luong_ops  # noqa: E402
from repro_torch.kernels.luong_attn.ref import luong_attention_ref  # noqa: E402
from repro_torch.kernels.moe_gemm import ops as moe_ops  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import moe_gemm_plain  # noqa: E402
from repro_torch.models import moe as moe_model  # noqa: E402
from repro_torch.models import seq2seq as s2s  # noqa: E402
from repro_torch.models import transformer as tfm  # noqa: E402
from repro_torch.models.common import tree_leaves  # noqa: E402
from repro_torch.optim import adam  # noqa: E402
from repro_torch.serve.engine import ContinuousEngine, ServeEngine, pad_cache, prefill_fn  # noqa: E402
from repro_torch.train import Trainer  # noqa: E402
from repro_torch.train.trainer import batch_to_device, make_grad_fn  # noqa: E402

# tolerances of tests/kernel_harness.py
TOL_ATTN = {"float32": dict(atol=1e-4, rtol=1e-4), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
TOL_TIGHT = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=5e-2, rtol=5e-2)}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
# tests/kernel_harness.py's luong_attn shapes, copied (block sizes dropped)
HARNESS_SHAPES = [
    dict(B=2, N=16, M=12, h=64),
    dict(B=4, N=32, M=8, h=32),
    dict(B=1, N=64, M=33, h=128),
    dict(B=3, N=10, M=7, h=48),
    dict(B=2, N=1, M=1, h=16),
]
# (label, shape, all-masked row, model scales).  The h=1024 shapes take
# the model's own input scales: at the harness's, the scores at h=1024 have a
# standard deviation near 100, the softmax is all but one-hot, and two fp32
# evaluations of the same head (different summation orders) can differ by
# more than TOL_ATTN's fp32 bound.  Each case runs on every route that takes
# it: the decode ticks (R <= 32 rows) on "decode", the rest of h a multiple
# of 64 on "wgmma", every case on "fma"; ragged rows (R = 129, N = 48), one
# source position and 129 of them, and an all-masked row on each route.
TIMING_SHAPE = dict(B=4, N=1, M=64, h=1024)  # the serving phase's decode tick: 4 slots, max_len 64
LUONG_TRAIN_SHAPE = dict(B=64, N=32, M=32, h=1024)  # the training step's head: 2048 rows
PARITY_CASES = (
    [("decode", dict(B=8, N=1, M=64, h=1024), None, True),
     ("decode-tick", TIMING_SHAPE, None, True),
     ("train", LUONG_TRAIN_SHAPE, None, True),
     ("train-ragged", dict(B=4, N=48, M=40, h=1024), None, True),
     ("rows-129", dict(B=3, N=43, M=20, h=1024), None, True),
     ("M-1-decode", dict(B=4, N=1, M=1, h=1024), None, True),
     ("M-1", dict(B=2, N=40, M=1, h=1024), None, True),
     ("M-129-decode", dict(B=8, N=1, M=129, h=1024), None, True),
     ("M-129", dict(B=2, N=24, M=129, h=1024), None, True),
     ("rows-32-decode", dict(B=32, N=1, M=64, h=1024), None, True)]
    + [(f"harness-{i}", s, None, False) for i, s in enumerate(HARNESS_SHAPES)]
    + [("all-masked-row", dict(B=3, N=2, M=5, h=16), 1, False),
       ("all-masked-row-h64", dict(B=3, N=2, M=5, h=64), 1, False),
       ("all-masked-row-train-ragged", dict(B=4, N=48, M=40, h=1024), 2, True)]
)
# W_a at an eighth of its fan-in scale in the model-scale inputs: the scores' standard deviation is
# then about 1.6 (a head that attends, neither flat nor one-hot).  At the full fan-in scale it is about
# 13 at h=1024, the softmax all but one-hot, and dropping a source position moves the output less than
# its bf16 rounding: no check could see a position go missing.
LUONG_WA_SCALE = 1 / 8
LUONG_NEW_ROUTES = ("decode", "wgmma")  # bf16 on these is also held to LUONG_BOUND_FACTOR x the rounding
LUONG_BOUND_FACTOR = 2.0  # of the plain version's own bf16-rounded output's error (relative L2 and max abs)
# tests/kernel_harness.py's lstm_cell shapes, copied (block sizes dropped)
LSTM_HARNESS_SHAPES = [
    dict(B=8, In=16, H=32), dict(B=4, In=64, H=64), dict(B=16, In=24, H=128),
    dict(B=1, In=8, H=16), dict(B=6, In=24, H=40), dict(B=7, In=13, H=24),
]
# the training step's cells: layer 0 (emb 512 in) and layers 1-3 (h 1024 in), batch 64
LSTM_MODEL_SHAPES = [dict(B=64, In=512, H=1024), dict(B=64, In=1024, H=1024)]
LSTM_ROW_TILES_SHAPE = dict(B=130, In=40, H=72)  # three of the kernel's 64-row tiles, the last ragged
LSTM_TIMING_SHAPE = LSTM_MODEL_SHAPES[1]
# fp32 comparisons of a whole training step (tests/test_plan.py's tolerance)
STEP_TOL = dict(atol=1e-4, rtol=1e-3)
STEP_LOSS_TOL = 1e-4
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOP_PER_S = 989e12  # H100 SXM dense bf16 tensor-core peak
LUONG_REPLACES = "src/repro/kernels/luong_attn/kernel.py:30"
LUONG_SOURCE = "src/repro_torch/kernels/luong_attn/csrc/luong_attn.cu"
LSTM_REPLACES = "src/repro/kernels/lstm_cell/kernel.py:27"
LSTM_SOURCE = "src/repro_torch/kernels/lstm_cell/csrc/lstm_cell.cu"
TRAIN_STEPS = 8
FLASH_REPLACES = "src/repro/kernels/flash_attn/kernel.py:31"
FLASH_SOURCE = "src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu"
# tests/kernel_harness.py's flash_attn shapes (blocks dropped), then the LM
# prefill's per-layer calls: (a) 4 x 2048 tokens, (b) 1 x 8192 past the window
FLASH_HARNESS_SHAPES = [
    dict(B=2, S=128, KV=2, G=2, D=32, causal=True, window=None),
    dict(B=1, S=256, KV=1, G=4, D=64, causal=True, window=64),
    dict(B=2, S=64, KV=4, G=1, D=16, causal=False, window=None),
    dict(B=1, S=128, KV=2, G=1, D=128, causal=True, window=32),
    dict(B=1, S=96, KV=1, G=2, D=32, causal=True, window=None),
    dict(B=1, S=32, KV=1, G=1, D=8, causal=True, window=1),
]
# shapes for the wgmma kernel at its edges: ragged S != T with odd G, D=64 at
# G=1 without the causal mask, one row, and G=8 with a window
FLASH_EDGE_SHAPES = [
    dict(B=2, S=77, T=131, KV=2, G=3, D=128, causal=True, window=50),
    dict(B=2, S=200, KV=3, G=1, D=64, causal=False, window=None),
    dict(B=2, S=1, KV=2, G=2, D=128, causal=True, window=None),
    dict(B=1, S=300, KV=2, G=8, D=128, causal=True, window=100),
]
FLASH_PREFILL_SHAPE = dict(B=4, S=2048, KV=8, G=2, D=128, causal=True, window=4096)
FLASH_LONG_SHAPE = dict(B=1, S=8192, KV=8, G=2, D=128, causal=True, window=4096)
FLASH_MOE_SHAPE = dict(B=4, S=2048, KV=4, G=8, D=128, causal=True, window=4096)  # the MoE LM's prefill call
LM_SERVE_RUNS = [("a", 4, 2048, 32), ("b", 1, 8192, 16)]  # (label, prompts, prompt tokens, new tokens)
LM_PATHS_TOL = dict(atol=1e-3, rtol=1e-3)  # fp32 logits after 28 layers, two summation orders of attention
# bf16 flash_attn against the plain version's fp32 output on the same bf16
# inputs: only the kernel's own rounding is left (P and the output in bf16),
# where TOL_ATTN's bf16 bound is as large as a typical output at S=2048
FLASH_BF16_TOL = dict(atol=1e-2, rtol=1e-2)
FLASH_BF16_REL_L2 = 1e-2  # ||kernel - plain|| / ||plain||
FLASH_TILE = 64  # keys the window control drops from each late row's window
# bf16 last-position logits, kernel path vs plain path after 28 layers (8 in the MoE LM)
LM_BF16_LOGITS_REL_L2 = 5e-2
MOE_REPLACES = "src/repro/kernels/moe_gemm/kernel.py:23"
MOE_SOURCE = "src/repro_torch/kernels/moe_gemm/csrc/moe_gemm.cu"
# tests/kernel_harness.py's moe_gemm shapes (blocks dropped), a shape ragged in
# every tile of the tensor-core path, then the MoE serving run's two calls:
# the prefill of 4 x 2048 tokens (65,536 slots on 128 experts, capacity 641)
# and a decode step (32 slots, capacity 1)
MOE_HARNESS_SHAPES = [
    dict(E=4, C=16, d=32, F=64), dict(E=2, C=8, d=64, F=96), dict(E=8, C=32, d=16, F=16),
    dict(E=1, C=1, d=16, F=16), dict(E=3, C=10, d=24, F=36),
]
MOE_RAGGED_SHAPE = dict(E=2, C=70, d=40, F=72)
MOE_PREFILL_SHAPE = dict(E=128, C=641, d=2048, F=768)
MOE_DECODE_SHAPE = dict(E=128, C=1, d=2048, F=768)
# shapes for the "wgmma" and "decode" routes (d and F multiples of 64): a row
# tile whose second half holds no row, column tiles past F and d, several row
# tiles of C=641; then the decode route at C of 2-16 at the model's widths
MOE_WIDE_SHAPES = [dict(E=2, C=130, d=128, F=128), dict(E=3, C=200, d=320, F=192), dict(E=5, C=641, d=256, F=384)]
MOE_DECODE_C_SHAPES = [dict(E=16, C=c, d=2048, F=768) for c in (2, 3, 5, 8, 12, 16)]
# bf16 moe_gemm against the plain version's fp32 output on the same bf16
# inputs: only the kernel's own rounding is left (h and the output in bf16)
MOE_BF16_TOL = dict(atol=1e-2, rtol=1e-2)
MOE_BF16_REL_L2 = 1e-2
MOE_CONTROL_COLS = 64  # the control drops this many columns of F
MOE_LAYERS = 8  # of qwen3-moe-30b-a3b's 48: the fp32 masters of 48 are 122 GB
MOE_SERVE_RUN = ("a", 4, 2048, 32)  # (label, prompts, prompt tokens, new tokens)
MOE_PATHS_TOL = dict(atol=1e-4, rtol=1e-4)  # fp32 logits after 8 MoE layers


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
    outputs, W_c at the initializer's fan-in scale, W_a at LUONG_WA_SCALE of
    it).  Mask: 20% masked, column 0 real, ``masked_row`` all masked."""
    rng = np.random.default_rng(seed)
    B, N, M, h = s["B"], s["N"], s["M"], s["h"]
    f = lambda shape, scale=1.0: torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).cuda()
    H, S = f((B, N, h)), f((B, M, h))
    if model_scales:
        H, S = torch.tanh(H), torch.tanh(S)
        wa, wc = f((h, h), LUONG_WA_SCALE * h**-0.5), f((2 * h, h), (2 * h) ** -0.5)
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


def luong_want_fp32(H, S, mask, wa, wc):
    """The plain version's fp32 output on the same (bf16) inputs."""
    h = H.shape[-1]
    return luong_attention_ref(H.float(), S.float(), mask, wa.float(), wc[:h].float(), wc[h:].float())


def luong_bound(want) -> tuple:
    """(relative L2, max abs) that a bf16 output may miss ``want`` by:
    LUONG_BOUND_FACTOR x the error of ``want`` itself rounded to bf16."""
    own = want.to(torch.bfloat16).float()
    return LUONG_BOUND_FACTOR * _rel_l2(own, want), LUONG_BOUND_FACTOR * (own - want).abs().max().item()


def luong_errors(got, want) -> tuple:
    """(relative L2, max abs) of a bf16 output against ``want``."""
    return _rel_l2(got, want), (got.float() - want).abs().max().item()


def drop_last_position(mask):
    """The control's mask: each row's last unmasked source position masked too."""
    m = mask.clone().bool()
    last = torch.where(m, torch.arange(m.shape[1], device=m.device), -1).max(dim=1).values
    rows = torch.nonzero(last >= 0).squeeze(1)
    m[rows, last[rows]] = False
    return m


def luong_routes(s: dict, dtype: torch.dtype) -> list:
    """Every route that takes the inputs, the wrapper's pick first."""
    pick = luong_ops.pick_route(dtype, s["h"], s["B"] * s["N"])
    return [pick] + [r for r in luong_ops.ROUTES
                     if r != pick and luong_ops.route_fits(r, dtype, s["h"], s["B"] * s["N"])]


def luong_bf16_check(label: str, route: str, args: tuple, control: bool) -> tuple:
    """A new route's bf16 output against the plain version's fp32 output on the
    same inputs, within luong_bound; two calls bit-identical; with ``control``
    the same call with each row's last unmasked position dropped must miss the
    bound.  Returns (relative L2, max abs, bounds)."""
    H, S, mask, wa, wc = args
    want = luong_want_fp32(*args)
    got = luong_ops.luong_attention_fused(*args, route=route)
    again = luong_ops.luong_attention_fused(*args, route=route)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail(f"luong_attn {label} {route}: two calls differ")
    rel, err = luong_errors(got, want)
    b_rel, b_err = luong_bound(want)
    if rel > b_rel or err > b_err:
        fail(f"luong_attn {label} {route} bf16 vs the plain version's fp32 output: relative L2 {rel:.3e} (bound "
             f"{b_rel:.3e}), max_abs_err {err:.3e} (bound {b_err:.3e})")
    note = ""
    if control:
        cut = luong_ops.luong_attention_fused(H, S, drop_last_position(mask), wa, wc, route=route)
        c_rel, c_err = luong_errors(cut, want)
        if c_rel <= b_rel and c_err <= b_err:
            fail(f"luong_attn {label} {route}: the control (last unmasked position dropped) is within the bound: "
                 f"relative L2 {c_rel:.3e}, max_abs_err {c_err:.3e}")
        note = f"; control with the last position dropped misses it: relative L2 {c_rel:.3e}, max abs {c_err:.3e}"
    print(f"[parity] luong_attn {label} {route} bf16 vs plain fp32 output: relative L2 {rel:.3e} (bound {b_rel:.3e}), "
          f"max_abs_err {err:.3e} (bound {b_err:.3e}); two calls bit-identical{note}")
    return rel, err, b_rel, b_err


def phase_parity() -> float:
    """Every luong route against the plain version at the shapes it takes:
    at TOL_ATTN in the inputs' dtype, and (bf16 on the new routes) within
    luong_bound of the plain version's fp32 output.  Each call must count
    on its route."""
    worst = 0.0
    for label, s, masked, model_scales in PARITY_CASES:
        for dname, dtype in DTYPES.items():
            args = luong_inputs(s, dtype, masked_row=masked, model_scales=model_scales)
            H, S, mask, wa, wc = args
            h = s["h"]
            want = luong_attention_ref(H, S, mask, wa, wc[:h], wc[h:])
            for route in luong_routes(s, dtype):
                before = luong_ops.luong_attention_fused.launches_by_route[route]
                got = luong_ops.luong_attention_fused(*args, route=route)
                torch.cuda.synchronize()
                if luong_ops.luong_attention_fused.launches_by_route[route] != before + 1:
                    fail(f"luong_attn {label} {dname}: the call did not count on the {route} route")
                if got.dtype != dtype or got.shape != H.shape:
                    fail(f"luong_attn {label} {dname} {route}: got {got.dtype} {tuple(got.shape)}")
                if not torch.isfinite(got.float()).all():
                    fail(f"luong_attn {label} {dname} {route}: non-finite output")
                err = (got.float() - want.float()).abs().max().item()
                ok = torch.allclose(got.float(), want.float(), **TOL_ATTN[dname])
                print(f"[parity] luong_attn {label} {s} {dname} {route}: max_abs_err {err:.3e} "
                      f"(atol/rtol {TOL_ATTN[dname]['atol']}) {'ok' if ok else 'FAIL'}")
                if not ok:
                    fail(f"luong_attn {route} kernel disagrees with its plain version at {label} {dname}")
                worst = max(worst, err)
                if dtype == torch.bfloat16 and route in LUONG_NEW_ROUTES:
                    luong_bf16_check(label, route, args, control=s["M"] > 1)
    return worst


def lstm_inputs(s: dict, dtypes, seed: int = 0, model_scales: bool = False):
    """x, h, c, wx, wh, b on the card in ``dtypes``: the harness's scales
    (N(0,1) inputs, weights 0.1 N(0,1)), or with ``model_scales`` the model's
    (tanh-bounded x and h, the initializer's fan-in weights)."""
    rng = np.random.default_rng(seed)
    B, In, H = s["B"], s["In"], s["H"]
    f = lambda shape, scale=1.0: torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).cuda()
    x, h, c = f((B, In)), f((B, H)), f((B, H))
    if model_scales:
        x, h = torch.tanh(x), torch.tanh(h)
        wx, wh, b = f((In, 4, H), In**-0.5), f((H, 4, H), H**-0.5), f((4, H), 0.1)
    else:
        wx, wh, b = f((In, 4, H), 0.1), f((H, 4, H), 0.1), f((4, H), 0.1)
    return tuple(t.to(dt) for t, dt in zip((x, h, c, wx, wh, b), dtypes))


MODEL_FEED = (torch.bfloat16,) + (torch.float32,) * 5  # the old mixed feed: x bf16; h, c and the masters fp32
# the model's feed: x and the weights cast to bf16 once per layer call; h and c fp32 carries
BF16W_FEED = (torch.bfloat16, torch.float32, torch.float32, torch.bfloat16, torch.bfloat16, torch.bfloat16)
# The tensor-core kernel against the plain version on the same inputs: both form exact bf16 x bf16
# products in fp32; the kernel keeps h as h_hi + h_lo (to about 2^-17 of itself) and sums in another
# order, so the two agree to a few 1e-6 at the model's scales.  1e-4 leaves room for that and is
# 10-30 times below what rounding h to bf16 alone costs (the control), so the check tells them apart.
LSTM_MMA_TOL = dict(atol=1e-4, rtol=1e-4)


def _lstm_check(label, fname, args, tol, *, path=None):
    """One kernel call against the plain version on the same inputs; fails
    past ``tol`` or, with ``path``, unless that kernel ran.  Returns the error."""
    before = {p: getattr(lstm_ops.lstm_cell_fused, f"{p}_launches") for p in ("mma", "fma")}
    got = lstm_ops.lstm_cell_fused(*args)
    torch.cuda.synchronize()
    ran = [p for p in before if getattr(lstm_ops.lstm_cell_fused, f"{p}_launches") != before[p]]
    if path is not None and ran != [path]:
        fail(f"lstm_cell {label} {fname}: ran {ran}, expected the {path} kernel")
    want = lstm_cell_ref(*args)
    err = 0.0
    for g, w, like in zip(got, want, args[1:3]):
        if g.dtype != like.dtype or g.shape != like.shape:
            fail(f"lstm_cell {label} {fname}: got {g.dtype} {tuple(g.shape)}")
        if not torch.isfinite(g.float()).all():
            fail(f"lstm_cell {label} {fname}: non-finite output")
        err = max(err, (g.float() - w.float()).abs().max().item())
        if not torch.allclose(g.float(), w.float(), **tol):
            fail(f"lstm_cell kernel disagrees with its plain version at {label} {fname}: {err:.3e}")
    print(f"[parity] lstm_cell {label} {fname}: max_abs_err {err:.3e} (atol/rtol {tol['atol']}; "
          f"{'/'.join(ran)} kernel) ok")
    return err


def phase_lstm_parity() -> float:
    """The lstm_cell kernels against the plain version: the harness's shapes,
    three row tiles and the model's two full-width shapes, all inputs fp32 or
    all bf16 (TOL_TIGHT), the old mixed feed (x bf16; h, c, fp32 weights: the
    FMA kernel, products in fp32 on both sides), and the model's feed (x and
    weights bf16, h and c fp32: the tensor-core kernel wherever In and H are
    multiples of 8) at LSTM_MMA_TOL; at the full-width shapes a control that
    rounds h to bf16 before the kernel must miss LSTM_MMA_TOL; then
    ``torch.lstm_cell`` at fp32."""
    cases = [(f"harness-{i}", s, False) for i, s in enumerate(LSTM_HARNESS_SHAPES)]
    cases += [("row-tiles", LSTM_ROW_TILES_SHAPE, False)]
    cases += [(f"model-In{s['In']}", s, True) for s in LSTM_MODEL_SHAPES]
    worst = 0.0
    for label, s, model_scales in cases:
        mma_shape = s["In"] % 8 == 0 and s["H"] % 8 == 0
        feeds = [(d, (dt,) * 6, TOL_TIGHT[d], ("mma" if d == "bfloat16" and mma_shape else "fma"))
                 for d, dt in DTYPES.items()]
        feeds += [("mixed", MODEL_FEED, TOL_TIGHT["float32"], "fma"),
                  ("model_bf16w", BF16W_FEED, LSTM_MMA_TOL, "mma" if mma_shape else "fma")]
        for fname, dts, tol, path in feeds:
            args = lstm_inputs(s, dts, model_scales=model_scales)
            worst = max(worst, _lstm_check(label, fname, args, tol, path=path))
        if model_scales:  # the control: h rounded to bf16 (h_lo dropped) must miss LSTM_MMA_TOL
            args = lstm_inputs(s, BF16W_FEED, model_scales=True)
            got = lstm_ops.lstm_cell_fused(args[0], args[1].bfloat16().float(), *args[2:])
            want = lstm_cell_ref(*args)
            err = max((g - w).abs().max().item() for g, w in zip(got, want))
            caught = not all(torch.allclose(g, w, **LSTM_MMA_TOL) for g, w in zip(got, want))
            print(f"[parity] lstm_cell {label} control, h rounded to bf16: max_abs_err {err:.3e} "
                  f"{'misses' if caught else 'MEETS'} atol/rtol {LSTM_MMA_TOL['atol']}")
            if not caught:
                fail("the h-rounding control met LSTM_MMA_TOL: the check cannot tell the h split apart")
    # cross-check against PyTorch's own cell (gate order i, f, g, o; weight = W.reshape(in, 4H).T)
    for s in LSTM_MODEL_SHAPES:
        x, h, c, wx, wh, b = lstm_inputs(s, (torch.float32,) * 6, seed=1, model_scales=True)
        In, H = s["In"], s["H"]
        lh, lc = torch.lstm_cell(x, (h, c), wx.reshape(In, 4 * H).t().contiguous(),
                                 wh.reshape(H, 4 * H).t().contiguous(), b.reshape(-1), torch.zeros_like(b.reshape(-1)))
        kh, kc = lstm_ops.lstm_cell_fused(x, h, c, wx, wh, b)
        err = max((kh - lh).abs().max().item(), (kc - lc).abs().max().item())
        if not (torch.allclose(kh, lh, **TOL_TIGHT["float32"]) and torch.allclose(kc, lc, **TOL_TIGHT["float32"])):
            fail(f"lstm_cell kernel disagrees with torch.lstm_cell at {s}: {err:.3e}")
        print(f"[parity] lstm_cell {s} fp32 vs torch.lstm_cell: max_abs_err {err:.3e} (atol/rtol 1e-05) ok")
    return worst


BWD_TOL = dict(atol=1e-4, rtol=1e-4)


def phase_backward():
    """fp32 grads through each kernel's autograd.Function (the lstm_cell
    adjoint; the Luong recompute) against autograd through the plain
    version, at the full-width training shapes, within BWD_TOL.  The Luong
    grads come from the same plain recompute on both sides, so the kernel's
    forward output there is held against the plain one too (TOL_ATTN)."""
    rng = np.random.default_rng(5)
    for s in LSTM_MODEL_SHAPES:
        args = lstm_inputs(s, (torch.float32,) * 6, seed=2, model_scales=True)
        dh = torch.from_numpy(rng.normal(size=(s["B"], s["H"])).astype(np.float32)).cuda()
        dc = torch.from_numpy(rng.normal(size=(s["B"], s["H"])).astype(np.float32)).cuda()
        grads = []
        for fn in (lstm_ops.lstm_cell_fused, lstm_cell_ref):
            ins = [a.clone().requires_grad_() for a in args]
            hn, cn = fn(*ins)
            grads.append(torch.autograd.grad((hn * dh).sum() + (cn * dc).sum(), ins))
        err = max((g - w).abs().max().item() for g, w in zip(*grads))
        for name, g, w in zip(("x", "h", "c", "wx", "wh", "b"), *grads):
            if not torch.allclose(g, w, **BWD_TOL):
                fail(f"lstm_cell backward d{name} at {s}: kernel path vs plain max_abs_err "
                     f"{(g - w).abs().max().item():.3e}")
        print(f"[backward] lstm_cell {s} fp32: grads of x, h, c, wx, wh, b max_abs_err {err:.3e} "
              f"(atol/rtol {BWD_TOL['atol']}) ok")
    sh = LUONG_TRAIN_SHAPE
    H, S, mask, wa, wc = luong_inputs(sh, torch.float32, seed=3, model_scales=True)
    ct = torch.from_numpy(rng.normal(size=(sh["B"], sh["N"], sh["h"])).astype(np.float32)).cuda()
    h = sh["h"]
    grads, outs = [], []
    for fused in (True, False):
        ins = [t.clone().requires_grad_() for t in (H, S, wa, wc)]
        if fused:
            out = luong_ops.luong_attention_fused(ins[0], ins[1], mask, ins[2], ins[3])
        else:
            out = luong_attention_ref(ins[0], ins[1], mask, ins[2], ins[3][:h], ins[3][h:])
        outs.append(out.detach())
        grads.append(torch.autograd.grad((out * ct).sum(), ins))
    out_err = (outs[0] - outs[1]).abs().max().item()
    if not torch.allclose(outs[0], outs[1], **TOL_ATTN["float32"]):
        fail(f"luong_attn forward under autograd at {sh}: kernel vs plain max_abs_err {out_err:.3e}")
    err = max((g - w).abs().max().item() for g, w in zip(*grads))
    for name, g, w in zip(("H", "S", "w_alpha", "w_c"), *grads):
        if not torch.allclose(g, w, **BWD_TOL):
            fail(f"luong_attn backward d{name} at {sh}: kernel path vs plain max_abs_err "
                 f"{(g - w).abs().max().item():.3e}")
    print(f"[backward] luong_attn {sh} fp32: output max_abs_err {out_err:.3e} (atol/rtol "
          f"{TOL_ATTN['float32']['atol']}); grads of H, S, w_alpha, w_c max_abs_err {err:.3e} "
          f"(atol/rtol {BWD_TOL['atol']}) ok")


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
    luong_ops.reset_launches()
    lstm_ops.lstm_cell_fused.launches = 0
    t0 = time.perf_counter()
    outs = engine.run(prompts, 24)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches, by_route = luong_ops.luong_attention_fused.launches, dict(luong_ops.luong_attention_fused.launches_by_route)
    tok = 0
    for i, o in enumerate(outs):
        if not isinstance(o, np.ndarray) or not 1 <= len(o) <= 24:
            fail(f"request {i}: bad output {o!r}")
        if o.min() < 0 or o.max() >= V:
            fail(f"request {i}: token out of [0, {V})")
        tok += len(o)
    if engine.decode_ticks <= 0 or launches != engine.decode_ticks:
        fail(f"luong_attn launches {launches} != decode ticks {engine.decode_ticks}")
    if by_route["decode"] != launches:
        fail(f"luong_attn launches by route {by_route}: every decode tick must run the decode route")
    if engine.finite_checks != engine.decode_ticks:
        fail("the live-slot finiteness check did not run on every tick")
    print(f"[serve] [{cfg.name} | {plan.cache_policy} | {plan.admission}] {len(outs)} requests, "
          f"{tok} tokens in {dt:.2f}s ({tok / dt:.1f} tok/s)")
    print(f"[serve] source lengths {lens.tolist()}, output lengths {[len(o) for o in outs]}, "
          f"{engine.prefill_steps} prefill steps, {engine.decode_ticks} decode ticks, "
          f"luong_attn launches {launches} (by route {by_route}), live slots finite on every tick (poison canary on)")
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


def train_config():
    """The full-width model as users train it: bf16 compute over fp32 masters
    and the config's dropout."""
    return dataclasses.replace(get_config("seq2seq-rnn"), dtype="bfloat16")


def phase_train(cfg):
    """The slice's main path: Trainer on the full-width model, 8 steps of
    batches of 64 (lengths 4-24, bucketed to 32).  Returns the two kernels'
    launch counts over the 8 steps."""
    plan = ExecutionPlan(stage_kernel="cuda", compute_dtype="bfloat16")
    it = MTBatchIterator(SyntheticMTTask(vocab_size=cfg.vocab_size), batch_size=64, seed=0)
    trainer = Trainer(cfg, adam(lr=1e-3), it, plan=plan, clip_norm=5.0, seed=0, device="cuda")
    twin = MTBatchIterator(SyntheticMTTask(vocab_size=cfg.vocab_size), batch_size=64, seed=0)  # the same batches
    lstm_launches = luong_launches = 0
    cell = lstm_ops.lstm_cell_fused
    for step in range(1, TRAIN_STEPS + 1):
        cell.launches = cell.mma_launches = cell.fma_launches = 0
        luong_ops.reset_launches()
        trainer.run(1, log_every=1, log=lambda line: None)
        n_lstm, n_luong = cell.launches, luong_ops.luong_attention_fused.launches
        n_luong_wgmma = luong_ops.luong_attention_fused.launches_by_route["wgmma"]
        h = trainer.history[-1]
        if not (np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])):
            fail(f"training step {step}: loss {h['loss']} grad norm {h['grad_norm']}")
        batch = next(twin)
        M, N = batch["src"].shape[1], batch["tgt_in"].shape[1]
        want = cfg.num_layers * (M + N)
        if n_lstm != want or n_luong != 1 or n_luong_wgmma != 1:
            fail(f"training step {step}: lstm_cell launches {n_lstm} != layers x (M + N) = {want}, "
                 f"or luong_attn launches {n_luong} (wgmma route {n_luong_wgmma}) != 1")
        if cell.mma_launches != n_lstm:
            fail(f"training step {step}: {cell.fma_launches} of {n_lstm} lstm_cell launches took the FMA "
                 "kernel, not the tensor-core one")
        print(f"[train] step {step}: loss {h['loss']:.4f} grad_norm {h['grad_norm']:.4f} "
              f"{h['tokens']:.0f} target tokens M={M} N={N} in {h['step_s'] * 1e3:.1f} ms; "
              f"launches lstm_cell {n_lstm} (tensor-core {cell.mma_launches}) luong_attn {n_luong} (wgmma route)")
        lstm_launches += n_lstm
        luong_launches += n_luong
    steady = trainer.history[2:]
    step_ms = float(np.median([h["step_s"] for h in steady])) * 1e3
    tok_s = sum(h["tokens"] for h in steady) / sum(h["step_s"] for h in steady)
    print(f"[train] {cfg.name} bf16 over fp32 masters, Adam lr 1e-3, clip 5.0, dropout {cfg.dropout}, batch 64: "
          f"median step {step_ms:.1f} ms over steps 3-{TRAIN_STEPS}, {tok_s:.0f} target tok/s; "
          f"losses {[round(h['loss'], 4) for h in trainer.history]}")
    if int(trainer.state.opt_state.step) != TRAIN_STEPS:
        fail("the optimizer did not take every step")
    profile_step(trainer)
    return lstm_launches, luong_launches


def profile_step(trainer):
    """One more step under torch.profiler: the device ops that take the
    step's time, and the device's busy share of the step's wall time."""
    _profile(lambda: trainer.run(1, log_every=1, log=lambda line: None), "one training step", top=15)


def phase_step_paths(cfg):
    """One fp32 training step's loss and grads on the kernel path and on the
    plain path: same weights, same batch, no dropout."""
    cfg32 = dataclasses.replace(cfg, dtype="float32", dropout=0.0)
    params = s2s.init_seq2seq(0, cfg32, device="cuda")
    batch = batch_to_device(next(MTBatchIterator(SyntheticMTTask(vocab_size=cfg.vocab_size), 64, seed=1)), "cuda")
    out = {sk: make_grad_fn(cfg32, ExecutionPlan(stage_kernel=sk))(params, batch) for sk in ("cuda", "torch")}
    (lk, _, gk), (lp, _, gp) = out["cuda"], out["torch"]
    dloss = abs(float(lk) - float(lp))
    if dloss > STEP_LOSS_TOL:
        fail(f"fp32 step loss: kernel path {float(lk)} vs plain path {float(lp)}")
    err, bad = _grad_errors(gk, gp)
    if bad is not None:
        fail(f"fp32 step grad leaf {bad}: kernel path vs plain outside atol {STEP_TOL['atol']} rtol "
             f"{STEP_TOL['rtol']} (max abs err over the leaves {err:.3e})")
    print(f"[train] fp32 step, kernel path vs plain path: loss {float(lk):.6f} vs {float(lp):.6f} "
          f"(|diff| {dloss:.2e} <= {STEP_LOSS_TOL}); {len(tree_leaves(gk))} grad leaves max_abs_err {err:.3e} "
          f"(atol {STEP_TOL['atol']}, rtol {STEP_TOL['rtol']})")


HYBRID_SCHEDULES = ("gpipe", "1f1b", "zerobubble")
HYBRID_MICRO = 2  # microbatches interleaved through the wavefront
HYBRID_BF16_STEPS = 4  # per schedule; the median is over steps 2-4
HYBRID_SEED = 7  # the dropout generator's seed, on every rank and in the meshless reference
HYBRID_RANK_LIMIT_S = 600  # phase (b): both ranks, build and checks included


def _hybrid_batch(cfg, device):
    return batch_to_device(next(MTBatchIterator(SyntheticMTTask(vocab_size=cfg.vocab_size), 64, seed=2)), device)


def _hybrid_generator(device):
    g = torch.Generator(device=device)
    g.manual_seed(HYBRID_SEED)
    return g


def _grad_errors(grads, want) -> tuple:
    """(max abs error, index of the first leaf outside STEP_TOL or None)."""
    err, bad = 0.0, None
    for i, (a, b) in enumerate(zip(tree_leaves(grads), tree_leaves(want))):
        err = max(err, (a - b).abs().max().item())
        if bad is None and not torch.allclose(a, b, **STEP_TOL):
            bad = i
    return err, bad


def hybrid_rank(grid, cfg, ref_path: str, schedules: tuple) -> dict:
    """Phase (b) on one rank of a 1 x 2 grid on the one card (gloo, the
    hand-offs through host memory): the fp32 HYBRID pipelined step of
    ``cfg``; rank 0 holds the grads, each leaf from its owner, against the
    meshless step's saved by the parent.  Returns each rank's launches and,
    from rank 0, the errors."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    params = s2s.init_seq2seq(0, cfg, device=grid.device)
    batch = _hybrid_batch(cfg, grid.device)
    ref = torch.load(ref_path, weights_only=False) if grid.rank == 0 else None
    out = {}
    for sched in schedules:
        plan = ExecutionPlan(strategy="hybrid", mesh=grid, use_pipeline=True, micro_batches=HYBRID_MICRO,
                             schedule=sched, stage_kernel="cuda")
        lstm_ops.lstm_cell_fused.launches = 0
        luong_ops.reset_launches()
        t0 = time.perf_counter()
        loss, _, grads = make_grad_fn(cfg, plan)(params, batch, _hybrid_generator(grid.device))
        float(loss)  # waits for the step
        step_s = time.perf_counter() - t0
        res = {"lstm": lstm_ops.lstm_cell_fused.launches, "luong": luong_ops.luong_attention_fused.launches,
               "step_s": step_s}
        whole = plan.gather_params(grads)
        if grid.rank == 0:
            err, bad = _grad_errors(whole, [g.to(grid.device) for g in ref["grads"]])
            res.update(loss=float(loss), loss_err=abs(float(loss) - ref["loss"]), max_abs_err=err, bad_leaf=bad)
        out[sched] = res
    return out


def phase_hybrid(tcfg, device="cuda") -> tuple:
    """The slice's main path: the paper's hybrid data-model parallel step at
    full width.  (a) the trivial 1 x 1 grid over NCCL: HYBRID, pipelined,
    2 microbatches; fp32 at dropout 0.3 on each schedule against the meshless
    step (same batch, same generator seed), then bf16 steps through Trainer
    with the kernels' launches counted; (b) a 1 x 2 grid of two processes on
    this card over gloo, fp32, against (a)'s meshless step.  Returns the
    lstm_cell and luong_attn launches of (a)'s bf16 steps."""
    from repro_torch.launch.mesh import make_grid, spawn_grid

    cfg32 = dataclasses.replace(tcfg, dtype="float32")
    params = s2s.init_seq2seq(0, cfg32, device=device)
    batch = _hybrid_batch(cfg32, device)
    M, N, L = batch["src"].shape[1], batch["tgt_in"].shape[1], cfg32.num_layers
    loss, _, ref = make_grad_fn(cfg32, ExecutionPlan(stage_kernel="cuda"))(params, batch, _hybrid_generator(device))
    cell = lstm_ops.lstm_cell_fused
    with make_grid(1, 1, device=device) as grid:
        for sched in HYBRID_SCHEDULES:
            plan = ExecutionPlan(strategy="hybrid", mesh=grid, use_pipeline=True, micro_batches=HYBRID_MICRO,
                                 schedule=sched, stage_kernel="cuda")
            ploss, _, grads = make_grad_fn(cfg32, plan)(params, batch, _hybrid_generator(device))
            dloss = abs(float(ploss) - float(loss))
            err, bad = _grad_errors(grads, ref)
            if dloss > STEP_LOSS_TOL or bad is not None:
                fail(f"hybrid (a) {sched}: loss {float(ploss)} vs meshless {float(loss)}, grad leaf {bad} outside "
                     f"atol {STEP_TOL['atol']} rtol {STEP_TOL['rtol']} (max abs err {err:.3e})")
            print(f"[hybrid] (a) 1x1 grid, {grid.backend}, {sched}, micro_batches {HYBRID_MICRO}, fp32, dropout {cfg32.dropout}, "
                  f"batch 64 M={M} N={N}: loss {float(ploss):.6f} vs meshless {float(loss):.6f} (|diff| {dloss:.2e} <= "
                  f"{STEP_LOSS_TOL}); {len(tree_leaves(grads))} grad leaves max_abs_err {err:.3e} (atol "
                  f"{STEP_TOL['atol']}, rtol {STEP_TOL['rtol']})")
        del grads

        # launches: the meshless step with the same micro_batches, then the pipelined bf16 steps
        it = lambda: MTBatchIterator(SyntheticMTTask(vocab_size=tcfg.vocab_size), batch_size=64, seed=3)  # noqa: E731
        cell.launches = cell.mma_launches = 0
        luong_ops.reset_launches()
        meshless = Trainer(tcfg, adam(lr=1e-3), it(), plan=ExecutionPlan(stage_kernel="cuda", compute_dtype="bfloat16",
                                                                           micro_batches=HYBRID_MICRO), seed=0,
                           device=device)
        meshless.run(1, log_every=1, log=lambda line: None)
        first = next(it())
        M1, N1 = first["src"].shape[1], first["tgt_in"].shape[1]
        accum_lstm, accum_luong = cell.launches, luong_ops.luong_attention_fused.launches
        if accum_lstm != HYBRID_MICRO * L * (M1 + N1) or accum_luong != HYBRID_MICRO:
            fail(f"meshless micro_batches={HYBRID_MICRO} step: lstm_cell {accum_lstm} launches, luong_attn {accum_luong}")
        lstm_total = luong_total = 0
        for sched in HYBRID_SCHEDULES:
            plan = ExecutionPlan(strategy="hybrid", mesh=grid, use_pipeline=True, micro_batches=HYBRID_MICRO,
                                 schedule=sched, stage_kernel="cuda", compute_dtype="bfloat16")
            trainer = Trainer(tcfg, adam(lr=1e-3), it(), plan=plan, seed=0)
            twin = it()
            for step in range(1, HYBRID_BF16_STEPS + 1):
                cell.launches = cell.mma_launches = 0
                luong_ops.reset_launches()
                trainer.run(1, log_every=1, log=lambda line: None)
                b = next(twin)
                recompute = HYBRID_MICRO * L * (b["src"].shape[1] + b["tgt_in"].shape[1])
                h = trainer.history[-1]
                n_luong = luong_ops.luong_attention_fused.launches
                if not (np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])):
                    fail(f"hybrid bf16 {sched} step {step}: loss {h['loss']} grad norm {h['grad_norm']}")
                if cell.launches != 2 * recompute or cell.mma_launches != cell.launches or n_luong != 1 \
                        or luong_ops.luong_attention_fused.launches_by_route["wgmma"] != 1:
                    fail(f"hybrid bf16 {sched} step {step}: lstm_cell {cell.launches} launches ({cell.mma_launches} "
                         f"tensor-core), want forward + recompute = 2 x {recompute}; luong_attn {n_luong}, want 1 "
                         "on the wgmma route")
                step_lstm = cell.launches
                lstm_total += step_lstm
                luong_total += n_luong
            if sched == HYBRID_SCHEDULES[0]:  # one more step, not counted: where its time goes
                _profile(lambda: trainer.run(1, log_every=1, log=lambda line: None),
                         f"one hybrid pipelined step ({sched}, 1 x 1 grid, bf16)", top=10)
                trainer.history.pop()
            ms = [x["step_s"] * 1e3 for x in trainer.history[1:]]
            print(f"[hybrid] (a) bf16 over fp32 masters, {sched}, dropout {tcfg.dropout}, batch 64: median step "
                  f"{float(np.median(ms)):.1f} ms over steps 2-{HYBRID_BF16_STEPS} ({nvidia_smi_line()}); losses "
                  f"{[round(x['loss'], 4) for x in trainer.history]}; per step lstm_cell {step_lstm} launches, all "
                  f"tensor-core = the meshless micro_batches={HYBRID_MICRO} step's {accum_lstm} (k x layers x (M + N) "
                  f"at M={M1} N={N1}) + the backward's recompute of every group, k x layers x (M + N) = {recompute} "
                  f"at this step's M, N; luong_attn 1 (wgmma route) vs the meshless step's {accum_luong}: the head "
                  "runs once on the whole batch")
    # (b): two ranks on this card over gloo, against (a)'s meshless step
    with tempfile.TemporaryDirectory(prefix="hybrid-") as tmp:
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save({"loss": float(loss), "grads": [g.cpu() for g in tree_leaves(ref)]}, ref_path)
        del ref, params
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn_grid(hybrid_rank, 1, 2, args=(cfg32, ref_path, ("gpipe", "1f1b")), device=str(grid.device),
                           backend="gloo",
                           timeout_s=HYBRID_RANK_LIMIT_S, collective_timeout_s=120.0, threads=0)
        wall = time.perf_counter() - t0
    for sched in ("gpipe", "1f1b"):
        r0, r1 = ranks[0][sched], ranks[1][sched]
        if r0["loss_err"] > STEP_LOSS_TOL or r0["bad_leaf"] is not None:
            fail(f"hybrid (b) {sched}: loss |diff| {r0['loss_err']:.2e}, grad leaf {r0['bad_leaf']} outside tolerance "
                 f"(max abs err {r0['max_abs_err']:.3e})")
        if r0["lstm"] + r1["lstm"] != 2 * HYBRID_MICRO * L * (M + N) or (r0["luong"], r1["luong"]) != (1, 1):
            fail(f"hybrid (b) {sched}: lstm_cell launches {r0['lstm']} + {r1['lstm']}, luong_attn {r0['luong']}, "
                 f"{r1['luong']}")
        print(f"[hybrid] (b) 1x2 grid, two processes on this card over gloo (hand-offs through host memory), {sched}, "
              f"fp32, dropout {cfg32.dropout}: loss {r0['loss']:.6f} vs meshless {float(loss):.6f} (|diff| "
              f"{r0['loss_err']:.2e}); grads gathered from the stages, max_abs_err {r0['max_abs_err']:.3e} (atol "
              f"{STEP_TOL['atol']}, rtol {STEP_TOL['rtol']}); lstm_cell launches per rank {r0['lstm']}, {r1['lstm']} "
              f"(stage of 2 layers each); luong_attn 1 per rank (32 rows each); step {r0['step_s'] * 1e3:.0f} ms "
              "(host-staged, not a speed figure)")
    print(f"[hybrid] (b) both ranks done in {wall:.1f}s")
    return lstm_total, luong_total


def _median_ms(fn, runs: int, flush, hide_host: bool) -> float:
    """Median of ``runs`` single calls timed with CUDA events, the L2 cache
    flushed before each by zeroing ``flush`` (the decode tick streams 100+ MB
    of other weights between two head calls, so the head finds its weights
    cold), or left warm when ``flush`` is None.  With
    ``hide_host`` the device spins before the timed region while the host
    enqueues the whole call, so the events time the device's work alone;
    without it they also take in any wait for the host's enqueue."""
    for _ in range(5):
        fn()
    times = []
    for _ in range(runs):
        if flush is not None:
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


def luong_torch_path(H, S, mask, wa, wc):
    """models/seq2seq.py's "torch" stage path of eq. 1-4 in the inputs' dtype
    (cuBLAS GEMMs): the yardstick, used nowhere on the kernel path."""
    scores = torch.matmul(torch.matmul(H, wa), S.transpose(1, 2))
    scores = torch.where(mask[:, None, :] != 0, scores.float(), torch.full((), -1e30, device=H.device))
    alpha = torch.softmax(scores, dim=-1).to(H.dtype)
    return torch.tanh(torch.matmul(torch.cat([H, alpha @ S], dim=-1), wc))


def luong_bound_ms(s: dict) -> tuple:
    """(bound ms, bound_by, bytes, flops) of one head call: H, S, the mask and
    the three weights read once and Hc written once, in bf16; the flops of
    eq. 1-4."""
    B, N, M, h = s["B"], s["N"], s["M"], s["h"]
    nbytes = 2 * (2 * B * N * h + B * M * h + 3 * h * h) + 4 * B * M
    flops = 2 * B * N * h * h * 3 + 2 * 2 * B * N * M * h
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def phase_timing(serve_launches: int, train_launches: int, ticks: int, max_err: float) -> list:
    """luong_attn, bf16, model scales, L2 flushed (the decode tick streams 100+
    MB of other weights between two head calls, and the training step far
    more), at the serving tick's call on the "decode" route and the training
    step's on the "wgmma" route; beside each, the first kernel (the "fma" route), the plain
    version and the "torch" stage path (the yardstick).  One record per
    route: its launches are those of the main path's run that takes it."""
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")  # > the 50 MB L2
    records = []
    for route, s, runs, launches in (("decode", TIMING_SHAPE, 60, serve_launches),
                                     ("wgmma", LUONG_TRAIN_SHAPE, 20, train_launches)):
        B, N, M, h = s["B"], s["N"], s["M"], s["h"]
        args = luong_inputs(s, torch.bfloat16, seed=2 if route == "decode" else 4, model_scales=True)
        H, S, mask, wa, wc = args
        args = (H, S, mask.to(torch.int32), wa, wc)  # the kernels' mask
        if luong_ops.pick_route(torch.bfloat16, h, B * N) != route:
            fail(f"luong_attn at {s}: the wrapper picks {luong_ops.pick_route(torch.bfloat16, h, B * N)}, not {route}")
        fns = {"kernel": lambda: luong_ops.luong_attention_fused(*args),
               "fma": lambda: luong_ops.luong_attention_fused(*args, route="fma"),
               "plain": lambda: luong_attention_ref(H, S, mask, wa, wc[:h], wc[h:]),
               "torch": lambda: luong_torch_path(*args)}
        t = {k: _median_ms(fn, runs, flush, True) for k, fn in fns.items()}
        enqueue = {k: _median_ms(fns[k], runs, flush, False) for k in ("kernel", "fma")}
        want = luong_want_fp32(*args)
        got = luong_ops.luong_attention_fused(*args)
        max_err = max(max_err, (got.float() - luong_attention_ref(H, S, mask, wa, wc[:h], wc[h:]).float()).abs().max().item())
        rel, err = luong_errors(got, want)
        b_rel, b_err = luong_bound(want)
        f_rel, f_err = luong_errors(fns["fma"](), want)
        y_rel, y_err = luong_errors(fns["torch"](), want)
        bound_ms, bound_by, nbytes, flops = luong_bound_ms(s)
        scratch = {r: luong_ops.scratch_bytes(B, N, M, h, r) / 1e6 for r in (route, "fma")}
        print(f"[timing] luong_attn at {s} bf16 on the {route} route, median of {runs} runs, L2 flushed: device time "
              f"kernel {t['kernel']:.4f} ms, the fma route's kernel {t['fma']:.4f} ms, plain {t['plain']:.4f} ms, the "
              f"torch stage path (yardstick, cuBLAS) {t['torch']:.4f} ms; with the host's enqueue kernel "
              f"{enqueue['kernel']:.4f} ms, fma {enqueue['fma']:.4f} ms; bound {bound_ms:.5f} ms ({bound_by}: {nbytes} B "
              f"at 3.35 TB/s, {flops} FLOP at 989 TFLOP/s), kernel {t['kernel'] / bound_ms:.2f}x its bound; scratch "
              f"per call {scratch[route]:.1f} MB ({route}), {scratch['fma']:.1f} MB (fma); against the plain version's "
              f"fp32 output: kernel relative L2 {rel:.3e} max abs {err:.3e} (bound {b_rel:.3e} / {b_err:.3e}), fma "
              f"{f_rel:.3e} / {f_err:.3e}, torch path {y_rel:.3e} / {y_err:.3e}")
        records.append({
            "name": f"luong_attn:{route}", "route": "cuda", "source": LUONG_SOURCE, "replaces": LUONG_REPLACES,
            "launches": launches, "max_abs_err": max_err, "ms": t["kernel"], "plain_ms": t["plain"],
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
            "fma_route_ms": t["fma"], "torch_path_ms": t["torch"], "scratch_mb": scratch[route],
            "shape": s,
        })
    print(f"[timing] luong_attn: {serve_launches} decode-route launches in the serving run ({ticks} decode ticks), "
          f"{train_launches} wgmma-route launches in the training run ({TRAIN_STEPS} steps); library_ms: none (no "
          "single PyTorch call computes eq. 1-4; the torch stage path above is the yardstick)")
    return records


def _lstm_bound(args, outs) -> tuple:
    """(bound ms, bound_by, bytes, flops) of one cell call: each tensor passed
    read once and each output written once, at their element sizes, against
    the gate products' flops at the bf16 tensor-core peak."""
    x, h = args[0], args[1]
    B, In, H = x.shape[0], x.shape[1], h.shape[1]
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs))
    flops = 2 * B * (In + H) * 4 * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def phase_lstm_timing(launches: int, max_err: float) -> dict:
    """The lstm_cell kernel at the training step's shape on the model's feed
    (x bf16, the weights cast and packed once as a layer call does, h and c
    fp32: the tensor-core kernel), with the L2 flushed and warm (a layer's
    16.8 MB of bf16 weights stay in the 50 MB L2 between timesteps), and at
    In=512; beside it the old fp32-masters feed (the FMA kernel), the plain
    version on the model's feed and ``torch.lstm_cell`` in bf16 (all inputs
    bf16, its weights in PyTorch's [4H, in] layout) as the library yardstick."""
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    runs = 40
    times = {}
    for s in (LSTM_TIMING_SHAPE, LSTM_MODEL_SHAPES[0]):
        B, In, H = s["B"], s["In"], s["H"]
        x, h, c, wx, wh, b = lstm_inputs(s, (torch.float32,) * 6, seed=6, model_scales=True)
        xb = x.bfloat16()
        w = lstm_ops.cast_weights(wx, wh, b, torch.bfloat16)
        kernel = lambda: lstm_ops.lstm_cell_fused(xb, h, c, wx, wh, b, weights=w)  # noqa: E731
        before = lstm_ops.lstm_cell_fused.mma_launches
        got = kernel()
        if lstm_ops.lstm_cell_fused.mma_launches != before + 1:
            fail("the timed model feed did not take the tensor-core kernel")
        plain_args = (xb, h, c, wx.bfloat16(), wh.bfloat16(), b.bfloat16())
        want = lstm_cell_ref(*plain_args)
        max_err = max([max_err] + [(g - v).abs().max().item() for g, v in zip(got, want)])
        t = {"kernel": _median_ms(kernel, runs, flush, True), "kernel_warm": _median_ms(kernel, runs, None, True)}
        bound_ms, bound_by, nbytes, flops = _lstm_bound((xb, h, c, w.packed, w.b), got)
        print(f"[timing] lstm_cell at B={B} In={In} H={H} on the model's feed (x, weights bf16; h, c fp32), "
              f"median of {runs} runs: device time {t['kernel']:.4f} ms with the L2 flushed, "
              f"{t['kernel_warm']:.4f} ms warm; bound {bound_ms * 1e3:.2f} us ({bound_by}: {nbytes} B at "
              f"3.35 TB/s, {flops} FLOP at 989 TFLOP/s)")
        if s is LSTM_TIMING_SHAPE:
            lib_args = (xb, (h.bfloat16(), c.bfloat16()), wx.reshape(In, 4 * H).t().contiguous().bfloat16(),
                        wh.reshape(H, 4 * H).t().contiguous().bfloat16(), b.reshape(-1).bfloat16(),
                        torch.zeros(4 * H, dtype=torch.bfloat16, device="cuda"))
            fp32_feed = lambda: lstm_ops.lstm_cell_fused(xb, h, c, wx, wh, b)  # noqa: E731
            t["fp32_masters"] = _median_ms(fp32_feed, runs, flush, True)
            t["plain"] = _median_ms(lambda: lstm_cell_ref(*plain_args), runs, flush, True)
            t["library"] = _median_ms(lambda: torch.lstm_cell(*lib_args), runs, flush, True)
            t["kernel_call"] = _median_ms(kernel, runs, flush, False)
            old_bound, _, old_bytes, _ = _lstm_bound((xb, h, c, wx, wh, b), got)
            print(f"[timing] lstm_cell at B={B} In={In} H={H}, L2 flushed: the old fp32-masters feed (FMA kernel) "
                  f"{t['fp32_masters']:.4f} ms (bound {old_bound * 1e3:.2f} us, {old_bytes} B); plain version "
                  f"{t['plain']:.4f} ms; torch.lstm_cell (bf16) {t['library']:.4f} ms; the model's feed with the "
                  f"host's enqueue {t['kernel_call']:.4f} ms; {launches} launches in {TRAIN_STEPS} training steps")
            times, record_bound = t, (bound_ms, bound_by)
    return {
        "name": "lstm_cell", "route": "cuda", "source": LSTM_SOURCE, "replaces": LSTM_REPLACES,
        "launches": launches, "max_abs_err": max_err, "ms": times["kernel"], "plain_ms": times["plain"],
        "bound_ms": record_bound[0], "bound_by": record_bound[1], "library_ms": times["library"],
    }


def flash_inputs(s: dict, dtype: torch.dtype, seed: int = 0):
    """q [B*KV*G, S, D], k/v [B*KV, T, D] (T = S unless given) on the card,
    N(0,1) (the harness's scales)."""
    rng = np.random.default_rng(seed)
    B, S, KV, G, D = s["B"], s["S"], s["KV"], s["G"], s["D"]
    T = s.get("T", S)
    f = lambda shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", dtype)  # noqa: E731
    return f((B * KV * G, S, D)), f((B * KV, T, D)), f((B * KV, T, D))


def _rel_l2(got: torch.Tensor, want: torch.Tensor) -> float:
    return ((got.float() - want.float()).norm() / want.float().norm()).item()


def _flash_bf16_check(got, q, k, v, kw, label: str) -> tuple:
    """A bf16 kernel output against the plain version's fp32 output on the
    same bf16 inputs: FLASH_BF16_TOL elementwise and FLASH_BF16_REL_L2.
    Returns (max_abs_err, relative L2 error)."""
    want = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    err, rel = (got.float() - want).abs().max().item(), _rel_l2(got, want)
    if not torch.allclose(got.float(), want, **FLASH_BF16_TOL) or rel > FLASH_BF16_REL_L2:
        fail(f"flash_attn {label} bf16 vs the plain version's fp32 output: max_abs_err {err:.3e} "
             f"(atol/rtol {FLASH_BF16_TOL['atol']}), relative L2 {rel:.3e} (bound {FLASH_BF16_REL_L2})")
    return err, rel


def _flash_routes(s: dict, dtype: torch.dtype) -> list:
    """The kernels to check at shape ``s``: every route that takes (dtype, D),
    the wrapper's pick first; at the full-width shapes not the bf16 FMA
    kernel (its fp32 case runs there)."""
    pick = flash_ops.pick_route(dtype, s["D"])
    routes = [pick] + [r for r in flash_ops.ROUTES if r != pick and flash_ops.route_fits(r, dtype, s["D"])]
    if dtype == torch.bfloat16 and s["S"] >= 2048:
        routes = [r for r in routes if r != "fma"]
    return routes


def phase_flash_parity() -> float:
    """Every kernel route against the plain version: fp32 at TOL_ATTN; bf16
    at TOL_ATTN and against the plain version's fp32 output. Each launch must
    count on the route it named, and two calls of the wgmma route must be
    bit-identical. Returns the worst max_abs_err."""
    worst = 0.0
    cases = [(f"harness-{i}", s) for i, s in enumerate(FLASH_HARNESS_SHAPES)]
    cases += [(f"edge-{i}", s) for i, s in enumerate(FLASH_EDGE_SHAPES)]
    cases += [("prefill-a", FLASH_PREFILL_SHAPE), ("prefill-b", FLASH_LONG_SHAPE), ("moe-prefill", FLASH_MOE_SHAPE)]
    for label, s in cases:
        for dname, dtype in DTYPES.items():
            q, k, v = flash_inputs(s, dtype)
            kw = dict(causal=s["causal"], window=s["window"], group=s["G"])
            want = None
            for route in _flash_routes(s, dtype):
                before = dict(flash_ops.flash_attention_fused.launches_by_route)
                got = flash_ops.flash_attention_fused(q, k, v, route=route, **kw)
                torch.cuda.synchronize()
                after = flash_ops.flash_attention_fused.launches_by_route
                if {r: after[r] - before[r] for r in after} != {r: int(r == route) for r in after}:
                    fail(f"flash_attn {label} {dname}: route {route} counted {after} after {before}")
                if want is None:
                    want = flash_attention_plain(q, k, v, **kw)
                if got.dtype != dtype or got.shape != q.shape:
                    fail(f"flash_attn {label} {dname} {route}: got {got.dtype} {tuple(got.shape)}")
                if not torch.isfinite(got.float()).all():
                    fail(f"flash_attn {label} {dname} {route}: non-finite output")
                err = (got.float() - want.float()).abs().max().item()
                if not torch.allclose(got.float(), want.float(), **TOL_ATTN[dname]):
                    fail(f"flash_attn {route} kernel disagrees with its plain version at {label} {dname}: {err:.3e}")
                line = (f"[parity] flash_attn {label} {s} {dname} {route}: max_abs_err {err:.3e} (atol/rtol "
                        f"{TOL_ATTN[dname]['atol']})")
                if dname == "bfloat16":
                    err, rel = _flash_bf16_check(got, q, k, v, kw, f"{label} {route}")
                    line += (f"; vs the plain version's fp32 output max_abs_err {err:.3e} (atol/rtol "
                             f"{FLASH_BF16_TOL['atol']}), relative L2 {rel:.3e} (bound {FLASH_BF16_REL_L2})")
                if route == "wgmma":
                    again = flash_ops.flash_attention_fused(q, k, v, route=route, **kw)
                    if not torch.equal(again, got):
                        fail(f"flash_attn {label} wgmma: two calls on the same inputs differ")
                    line += "; two calls bit-identical"
                print(line + " ok")
                worst = max(worst, err)
    # control: the window one tile short drops each late row's oldest 64 keys; the bound must see it
    s = FLASH_LONG_SHAPE
    q, k, v = flash_inputs(s, torch.bfloat16)
    kw = dict(causal=s["causal"], window=s["window"], group=s["G"])
    short = flash_ops.flash_attention_fused(q, k, v, **dict(kw, window=s["window"] - FLASH_TILE))
    want = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
    rel = _rel_l2(short, want)
    caught_tol = not torch.allclose(short.float(), want, **FLASH_BF16_TOL)
    caught_attn = not torch.allclose(short.float(), want, **TOL_ATTN["bfloat16"])
    if rel <= FLASH_BF16_REL_L2:
        fail(f"control: a window {FLASH_TILE} keys short passes the bf16 bound (relative L2 {rel:.3e})")
    print(f"[parity] flash_attn control at prefill-b, window {s['window'] - FLASH_TILE} against {s['window']}: "
          f"relative L2 {rel:.3e} > {FLASH_BF16_REL_L2} (caught); max_abs_err "
          f"{(short.float() - want).abs().max().item():.3e}, caught by FLASH_BF16_TOL: {caught_tol}, "
          f"by TOL_ATTN's bf16 bound: {caught_attn}")
    return worst


def lm_plan(cfg, stage_kernel: str = "cuda"):
    """Static batches of up to 4 prompts; max_len = the 4096 window, so a
    prompt past the window decodes on the rolling buffer."""
    return ServePlan.for_config(cfg, max_slots=4, max_len=cfg.sliding_window, admission="static",
                                stage_kernel=stage_kernel)


def _profile(fn, label: str, top: int = 12) -> list:
    """Device time by op of one call of ``fn`` under torch.profiler, and the
    device's busy share of its wall time (the profiler's overhead included).
    Returns the device-side events."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # device-side events (kernels, copies, sets); operator rows repeat their kernels' time
    events = [e for e in prof.key_averages()
              if e.device_type == torch.autograd.DeviceType.CUDA and e.self_device_time_total > 0]
    device_us = sum(e.self_device_time_total for e in events)
    if device_us <= 0:
        fail(f"torch.profiler recorded no device time for {label}")
    events.sort(key=lambda e: e.self_device_time_total, reverse=True)
    print(f"[profile] {label}: wall {wall * 1e3:.1f} ms (profiler on), device busy {device_us / 1e3:.1f} ms "
          f"({100 * device_us / 1e3 / (wall * 1e3):.1f}% of wall); top device ops by self time:")
    for e in events[:top]:
        print(f"[profile]   {e.self_device_time_total / 1e3:9.3f} ms  {e.count:6d} calls  "
              f"{100 * e.self_device_time_total / device_us:5.1f}%  {e.key[:90]}")
    return events


def phase_lm_serve(params, cfg) -> tuple:
    """The slice's main path: ServeEngine.generate on the full-width LM.
    Returns the flash_attn launches of the two serving runs, in all and by
    route."""
    V, L = cfg.vocab_size, cfg.num_layers
    plan = lm_plan(cfg)
    engine = ServeEngine(cfg, params, plan=plan, device="cuda")
    rng = np.random.default_rng(0)
    engine.generate(rng.integers(3, V, size=(2, 256)), 2)  # warm-up: first cuBLAS calls, allocator
    torch.cuda.synchronize()
    total, routes = 0, dict.fromkeys(flash_ops.ROUTES, 0)
    for label, B, S, new in LM_SERVE_RUNS:
        prompts = rng.integers(3, V, size=(B, S))
        _reset_launches()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        out = engine.generate(prompts, new)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        n = flash_ops.flash_attention_fused.launches
        by_route = dict(flash_ops.flash_attention_fused.launches_by_route)
        if n != L or by_route != {"fma": 0, "mma": 0, "wgmma": L}:
            fail(f"serve ({label}): flash_attn launches {n} ({by_route}) != {L} on the wgmma route (one per layer in "
                 "the prefill, none per decode step)")
        if tuple(out.shape) != (B, new) or out.min().item() < 0 or out.max().item() >= V:
            fail(f"serve ({label}): bad output {tuple(out.shape)} in [{out.min().item()}, {out.max().item()}]")
        total += n
        routes = {r: routes[r] + by_route[r] for r in routes}
        decode_tok_s = B * (new - 1) / engine.decode_s
        print(f"[lm-serve] ({label}) [{cfg.name} | {plan.cache_policy} {plan.window} | static] {B} x {S} prompt "
              f"tokens, {new} new tokens each, in {dt:.3f}s: prefill {engine.prefill_s * 1e3:.1f} ms "
              f"({B * S / engine.prefill_s:.0f} prompt tok/s), decode {engine.decode_s * 1e3:.1f} ms for "
              f"{new - 1} steps ({decode_tok_s:.1f} tok/s, {engine.decode_s / (new - 1) * 1e3:.2f} ms/step, CUDA "
              f"graph); flash_attn launches {n} = {L} layers x 1 prefill, all on the wgmma route; peak device memory "
              f"{torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; tokens[0][:8] {out[0, :8].tolist()}")
    # where a prefill's and a decode step's device time goes: (a)'s prefill, then 8 decode steps
    params_c = tfm.cast_params(engine.params, cfg)
    tokens = torch.from_numpy(rng.integers(3, V, size=(4, 2048))).cuda()
    _profile(lambda: engine._prefill(params_c, tokens), "one prefill of 4 x 2048 tokens (bf16)")
    logits, cache = engine._prefill(params_c, tokens)
    cache = pad_cache(cfg, cache, 2080)
    tok = logits.argmax(-1)

    def decode8():
        nonlocal cache, tok
        for _ in range(8):
            lg, cache = engine._step(params_c, tok, cache)
            tok = lg.argmax(-1)

    decode8()  # warm
    _profile(decode8, "8 decode steps of 4 sequences at 2048-2080 cached tokens (bf16)")
    return total, routes


def phase_lm_model_paths(params, cfg):
    """fp32: the kernel path and the plain path of the prefill attention in
    the full-width model: last-position logits, and 8 greedy tokens through
    ServeEngine."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(2, 512))).cuda()
    logits = {}
    for sk in ("cuda", "torch"):
        lg, _ = prefill_fn(cfg32, window=cfg.sliding_window, stage_kernel=sk)(params, prompts)
        logits[sk] = lg
    err = (logits["cuda"] - logits["torch"]).abs().max().item()
    if not torch.allclose(logits["cuda"], logits["torch"], **LM_PATHS_TOL):
        fail(f"fp32 prefill logits: kernel path vs plain path max_abs_err {err:.3e}")
    engines = {sk: ServeEngine(cfg32, params, plan=lm_plan(cfg32, sk), device="cuda") for sk in ("cuda", "torch")}
    toks = {sk: e.generate(prompts, 8) for sk, e in engines.items()}
    if not torch.equal(toks["cuda"], toks["torch"]):
        fail(f"greedy tokens differ between the kernel path and the plain path: {toks['cuda'].tolist()} vs "
             f"{toks['torch'].tolist()}")
    eager = engines["cuda"].generate(prompts, 8, cuda_graph=False)
    if not torch.equal(eager, toks["cuda"]):
        fail(f"greedy tokens differ between the graphed and the eager decode: {toks['cuda'].tolist()} vs "
             f"{eager.tolist()}")
    print(f"[lm-model] fp32 prefill of 2 x 512 tokens, logits kernel vs plain max_abs_err {err:.3e} "
          f"(atol/rtol {LM_PATHS_TOL['atol']}; |logits| up to {logits['torch'].abs().max().item():.2f}); "
          f"8 greedy tokens equal on both paths and with the decode graphed or eager: {toks['cuda'][0].tolist()}")


@contextlib.contextmanager
def _flash_wrapped(wrapper):
    """Route the model's flash_attn calls through ``wrapper(kernel, q, k, v,
    **kw)`` for the duration (``ops.flash_attention`` looks the wrapper up by
    name at each call).  Launches made meanwhile count on the stand-in, not
    on the kernel's counter: they are comparison launches."""
    kernel = flash_ops.flash_attention_fused
    stand_in = lambda q, k, v, **kw: wrapper(kernel, q, k, v, **kw)  # noqa: E731
    stand_in.launches, stand_in.launches_by_route = 0, dict.fromkeys(flash_ops.ROUTES, 0)
    flash_ops.flash_attention_fused = stand_in
    try:
        yield
    finally:
        flash_ops.flash_attention_fused = kernel


def phase_lm_bf16_paths(params, cfg):
    """bf16, the serving runs' prompt shapes: every flash_attn call of a
    kernel-path prefill against the plain version's fp32 output on that
    call's inputs, and the last-position logits of the kernel path against
    the plain path's.  At (b), a control with the kernel's window one tile
    short must miss the logits bound."""
    params_c = tfm.cast_params(params, cfg)
    rng = np.random.default_rng(2)
    for label, B, S, _ in LM_SERVE_RUNS:
        tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(B, S))).cuda()
        calls = []

        def checked(kernel, q, k, v, **kw):
            out = kernel(q, k, v, **kw)
            calls.append(_flash_bf16_check(out, q, k, v, kw, f"({label}) layer {len(calls)}"))
            return out

        with _flash_wrapped(checked):
            lk, _ = prefill_fn(cfg, window=cfg.sliding_window, stage_kernel="cuda")(params_c, tokens)
        if len(calls) != cfg.num_layers:
            fail(f"({label}) bf16 prefill made {len(calls)} flash_attn calls, not {cfg.num_layers}")
        lp, _ = prefill_fn(cfg, window=cfg.sliding_window, stage_kernel="torch")(params_c, tokens)
        rel = _rel_l2(lk, lp)
        agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
        if rel > LM_BF16_LOGITS_REL_L2:
            fail(f"({label}) bf16 prefill logits: kernel path vs plain path relative L2 {rel:.3e} > "
                 f"{LM_BF16_LOGITS_REL_L2}")
        line = (f"[lm-bf16] ({label}) {B} x {S}: {len(calls)} kernel calls vs the plain version's fp32 output, "
                f"worst max_abs_err {max(c[0] for c in calls):.3e}, worst relative L2 {max(c[1] for c in calls):.3e} "
                f"(bound {FLASH_BF16_REL_L2}); logits kernel path vs plain path relative L2 {rel:.3e} (bound "
                f"{LM_BF16_LOGITS_REL_L2}), argmax equal on {100 * agree:.0f}% of rows")
        if label == "b":
            short = lambda kernel, q, k, v, window, **kw: kernel(q, k, v, window=window - FLASH_TILE, **kw)  # noqa: E731
            with _flash_wrapped(short):
                lf, _ = prefill_fn(cfg, window=cfg.sliding_window, stage_kernel="cuda")(params_c, tokens)
            frel = _rel_l2(lf, lp)
            if frel <= LM_BF16_LOGITS_REL_L2:
                fail(f"control: a kernel window {FLASH_TILE} keys short passes the logits bound ({frel:.3e})")
            line += f"; control with the kernel's window {FLASH_TILE} keys short: relative L2 {frel:.3e} (caught)"
        print(line)


def _attention_pairs(S: int, window) -> int:
    """(query, key) pairs a causal prefill of S tokens attends, with the window."""
    w = S if window is None else min(window, S)
    return w * (w + 1) // 2 + (S - w) * w


def _flash_bound(s: dict) -> tuple:
    """The least time of a causal bf16 call at shape ``s`` (window counted):
    q, k, v and o moved once, 4 D FLOP per attended (query, key) pair.
    Returns (bound ms, bound_by, bytes, flops)."""
    B, S, KV, G, D = s["B"], s["S"], s["KV"], s["G"], s["D"]
    nbytes = 2 * D * (2 * B * KV * G * S + 2 * B * KV * S)
    flops = 4 * D * B * KV * G * _attention_pairs(S, s["window"])  # q.k and p.v: two multiply-adds per (pair, d)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def phase_flash_timing(launches: int, routes: dict, max_err: float) -> dict:
    """flash_attn, bf16, L2 flushed, at the serving runs' calls: (a)'s
    per-layer call (the kernel, the old "mma" route's kernel, the plain
    version, and scaled_dot_product_attention with is_causal and enable_gqa:
    the window of 4096 does not bind at S=2048, so it is the same function);
    the MoE prefill's call at G=8 (the kernel, "mma", SDPA); (b)'s call (the
    kernel and "mma"; SDPA has no window)."""
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    rows = {}
    for label, s, seed in (("a", FLASH_PREFILL_SHAPE, 9), ("moe", FLASH_MOE_SHAPE, 11), ("b", FLASH_LONG_SHAPE, 10)):
        B, S, KV, G, D = s["B"], s["S"], s["KV"], s["G"], s["D"]
        q, k, v = flash_inputs(s, torch.bfloat16, seed=seed)
        kw = dict(causal=True, window=s["window"], group=G)
        q4, k4, v4 = q.view(B, KV * G, S, D), k.view(B, KV, S, D), v.view(B, KV, S, D)  # head h reads kv head h // G
        kernel = lambda: flash_ops.flash_attention_fused(q, k, v, **kw)  # noqa: E731
        mma = lambda: flash_ops.flash_attention_fused(q, k, v, route="mma", **kw)  # noqa: E731
        library = lambda: torch.nn.functional.scaled_dot_product_attention(q4, k4, v4, is_causal=True, enable_gqa=True)  # noqa: E731
        t = {"kernel": _median_ms(kernel, 20, flush, True), "mma": _median_ms(mma, 20, flush, True)}
        got = kernel()
        max_err = max(max_err, _flash_bf16_check(got, q, k, v, kw, f"({label}) timing inputs")[0])
        if label != "b":
            t["library"] = _median_ms(library, 20, flush, True)
            t["lib_err"] = (got.float() - library().reshape(got.shape).float()).abs().max().item()
        if label == "a":
            t["plain"] = _median_ms(lambda: flash_attention_plain(q, k, v, **kw), 10, flush, True)
        bound_ms, bound_by, nbytes, flops = _flash_bound(s)
        rows[label] = (t, bound_ms, bound_by)
        print(f"[timing] flash_attn ({label}) B={B} S={S} H={KV * G} KV={KV} D={D} causal window {s['window']} bf16, "
              f"median, L2 flushed: device time kernel (wgmma) {t['kernel']:.4f} ms, the mma route's kernel "
              f"{t['mma']:.4f} ms"
              + (f", plain {t['plain']:.4f} ms" if "plain" in t else "")
              + (f", scaled_dot_product_attention {t['library']:.4f} ms (kernel vs sdpa max_abs_err "
                 f"{t['lib_err']:.3e})" if "library" in t else ", no SDPA (it has no window)")
              + f"; bound {bound_ms:.4f} ms ({bound_by}: {nbytes} B at 3.35 TB/s = "
              f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms, {flops} FLOP at 989 TFLOP/s = "
              f"{flops / BF16_FLOP_PER_S * 1e3:.4f} ms); kernel at {flops / t['kernel'] / 1e9:.2f} TFLOP/s, "
              f"{t['kernel'] / bound_ms:.2f}x its bound")
    print(f"[timing] flash_attn: {launches} launches in the serving runs (qwen3-1.7b (a) and (b), qwen3-moe-30b-a3b "
          f"(a)), by route {routes}")
    t, bound_ms, bound_by = rows["a"]
    return {
        "name": "flash_attn", "route": "cuda", "source": FLASH_SOURCE, "replaces": FLASH_REPLACES,
        "launches": launches, "launches_by_route": routes, "max_abs_err": max_err, "ms": t["kernel"],
        "plain_ms": t["plain"], "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": t["library"],
        "mma_route_ms": t["mma"],
    }


def moe_inputs(s: dict, dtype: torch.dtype, seed: int = 0):
    """x, w1, wg, w2 on the card: the harness's scales (x N(0,1), weights
    0.1 N(0,1)) below d=256; the model's from there (unit-RMS rows, the
    initializer's fan-in weights), where the harness's make the sums too
    large for a fair fp32 bound.  Rows 2-3 of every expert are empty slots.
    Drawn on the card from ``seed`` (the full-width calls take 0.8 G values)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    E, C, d, F = s["E"], s["C"], s["d"], s["F"]
    model = d >= 256
    f = lambda shape, scale: scale * torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    x = f((E, C, d), 1.0)
    x[:, 2:4] = 0
    w1, wg = f((E, d, F), d**-0.5 if model else 0.1), f((E, d, F), d**-0.5 if model else 0.1)
    w2 = f((E, F, d), F**-0.5 if model else 0.1)
    return tuple(t.to(dtype) for t in (x, w1, wg, w2))


def moe_rows(x: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """rows int32 [E] on the card (0 for expert 0, C for expert 1, others
    drawn from [0, C]), and garbage planted in x past rows[e], in place: 1e4,
    and NaN in every other such row.  The kernel must return exact zeros
    there."""
    E, C = x.shape[:2]
    gen = torch.Generator(device="cuda").manual_seed(seed)
    rows = torch.randint(0, C + 1, (E,), generator=gen, device="cuda").to(torch.int32)
    rows[0], rows[min(1, E - 1)] = 0, C
    dead = torch.arange(C, device="cuda")[None, :] >= rows[:, None]
    x[dead] = 1e4
    x[:, ::2][dead[:, ::2]] = float("nan")
    return rows


def _moe_bf16_check(got, args, label: str, rows=None) -> tuple:
    """A bf16 moe_gemm output against the plain version's fp32 output on the
    same bf16 inputs: MOE_BF16_TOL elementwise and MOE_BF16_REL_L2.  Returns
    (max_abs_err, relative L2 error)."""
    want = moe_gemm_plain(*(t.float() for t in args), rows)
    err, rel = (got.float() - want).abs().max().item(), _rel_l2(got, want)
    if not torch.allclose(got.float(), want, **MOE_BF16_TOL) or rel > MOE_BF16_REL_L2:
        fail(f"moe_gemm {label} bf16 vs the plain version's fp32 output: max_abs_err {err:.3e} "
             f"(atol/rtol {MOE_BF16_TOL['atol']}), relative L2 {rel:.3e} (bound {MOE_BF16_REL_L2})")
    return err, rel


def _moe_cut(x, w1, wg, w2, rows=None):
    """The kernel with the last MOE_CONTROL_COLS columns of F dropped: a
    planted fault for the controls."""
    F = w1.shape[2] - MOE_CONTROL_COLS
    return moe_ops.moe_gemm_fused(x, w1[:, :, :F].contiguous(), wg[:, :, :F].contiguous(), w2[:, :F].contiguous(),
                                  rows)


def _moe_route_check(label: str, s: dict, dname: str, route: str, with_rows: bool) -> tuple:
    """One call on ``route`` against the plain version; returns (max_abs_err
    against the plain version in the inputs' dtype, and in bf16 against its
    fp32 output and the relative L2 error), or fails."""
    dtype = DTYPES[dname]
    args = moe_inputs(s, dtype)
    rows = moe_rows(args[0]) if with_rows else None
    before = moe_ops.moe_gemm_fused.launches_by_route[route]
    got = moe_ops.moe_gemm_fused(*args, rows, route=route)
    torch.cuda.synchronize()
    tag = f"moe_gemm {label} {dname} {route}{' rows' if with_rows else ''}"
    if moe_ops.moe_gemm_fused.launches_by_route[route] != before + 1:
        fail(f"{tag}: the launch did not count on its route")
    if got.dtype != dtype or got.shape != args[0].shape:
        fail(f"{tag}: got {got.dtype} {tuple(got.shape)}")
    if not torch.isfinite(got.float()).all():
        fail(f"{tag}: non-finite output")
    if s["C"] > 3 and torch.count_nonzero(got[:, 2:4]).item():
        fail(f"{tag}: empty slots did not come back zero")
    if with_rows:
        dead = torch.arange(s["C"], device="cuda")[None, :] >= rows[:, None]
        if torch.count_nonzero(got[dead]).item():
            fail(f"{tag}: the rows past rows[e] (NaN and 1e4 planted) are not exact zeros")
    want = moe_gemm_plain(*args, rows)
    err = (got.float() - want.float()).abs().max().item()
    if not torch.allclose(got.float(), want.float(), **TOL_TIGHT[dname]):
        fail(f"moe_gemm kernel disagrees with its plain version at {tag}: {err:.3e}")
    if dname == "bfloat16":
        return (err, *_moe_bf16_check(got, args, tag, rows))
    return err, err, 0.0


def phase_moe_parity() -> float:
    """Every route that takes a shape, with rows and without.  Returns the
    worst max_abs_err: fp32 against the plain version, bf16 against the
    plain version's fp32 output."""
    worst = 0.0
    cases = [(f"harness-{i}", s) for i, s in enumerate(MOE_HARNESS_SHAPES)]
    cases += [("ragged", MOE_RAGGED_SHAPE), ("prefill", MOE_PREFILL_SHAPE), ("decode", MOE_DECODE_SHAPE)]
    cases += [(f"wide-{i}", s) for i, s in enumerate(MOE_WIDE_SHAPES)]
    cases += [(f"decode-C{s['C']}", s) for s in MOE_DECODE_C_SHAPES]
    n = 0
    for label, s in cases:
        for dname, dtype in DTYPES.items():
            for route in moe_ops.ROUTES:
                if not moe_ops.route_fits(route, dtype, s["E"], s["C"], s["d"], s["F"]):
                    continue
                res = [_moe_route_check(label, s, dname, route, with_rows) for with_rows in (False, True)]
                n += 2
                line = (f"[parity] moe_gemm {label} {s} {dname} {route}: vs plain max_abs_err "
                        f"{max(r[0] for r in res):.3e} (atol/rtol {TOL_TIGHT[dname]['atol']})")
                if dname == "bfloat16":
                    line += (f"; vs the plain version's fp32 output max_abs_err {max(r[1] for r in res):.3e} "
                             f"(atol/rtol {MOE_BF16_TOL['atol']}), relative L2 {max(r[2] for r in res):.3e} (bound "
                             f"{MOE_BF16_REL_L2})")
                print(line + "; without and with rows (exact zeros past rows[e]) ok")
                worst = max(worst, *(r[1] for r in res))
    print(f"[parity] moe_gemm: {n} calls checked, every route that takes each shape, with and without rows")
    # control: 64 columns of F dropped; the bound must see it
    args = moe_inputs(MOE_PREFILL_SHAPE, torch.bfloat16)
    short = _moe_cut(*args)
    want = moe_gemm_plain(*(t.float() for t in args))
    rel = _rel_l2(short, want)
    if rel <= MOE_BF16_REL_L2:
        fail(f"control: moe_gemm with {MOE_CONTROL_COLS} columns of F dropped passes the bf16 bound ({rel:.3e})")
    print(f"[parity] moe_gemm control at prefill, the last {MOE_CONTROL_COLS} of F={MOE_PREFILL_SHAPE['F']} columns "
          f"dropped: relative L2 {rel:.3e} > {MOE_BF16_REL_L2} (caught); caught by MOE_BF16_TOL: "
          f"{not torch.allclose(short.float(), want, **MOE_BF16_TOL)}")
    return worst


def moe_config():
    """qwen3-moe-30b-a3b at full width, its depth cut to MOE_LAYERS."""
    return dataclasses.replace(get_config("qwen3-moe-30b-a3b"), num_layers=MOE_LAYERS, dtype="bfloat16")


def _reset_launches():
    lstm_ops.lstm_cell_fused.launches = 0
    luong_ops.reset_launches()
    flash_ops.reset_launches()
    moe_ops.reset_launches()


def phase_moe_serve(params, cfg) -> tuple:
    """The slice's main path: ServeEngine.generate on the MoE LM at (a)'s
    shape.  Returns the moe_gemm launches of the run in all and by route, its
    flash_attn launches in all and by route, and the dispatch buffers (with
    their rows) of the first MoE layer in a served prefill and in a served
    decode step."""
    V, L = cfg.vocab_size, cfg.num_layers
    label, B, S, new = MOE_SERVE_RUN
    plan = lm_plan(cfg)
    engine = ServeEngine(cfg, params, plan=plan, device="cuda")
    rng = np.random.default_rng(0)
    engine.generate(rng.integers(3, V, size=(2, 256)), 2)  # warm-up: first cuBLAS calls, allocator
    torch.cuda.synchronize()
    prompts = rng.integers(3, V, size=(B, S))
    _reset_launches()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    out = engine.generate(prompts, new)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    n_moe, n_flash = moe_ops.moe_gemm_fused.launches, flash_ops.flash_attention_fused.launches
    by_route = dict(flash_ops.flash_attention_fused.launches_by_route)
    moe_routes = dict(moe_ops.moe_gemm_fused.launches_by_route)
    if n_flash != L or by_route != {"fma": 0, "mma": 0, "wgmma": L} or n_moe != 3 * L:
        fail(f"moe serve ({label}): flash_attn launches {n_flash} ({by_route}) != {L} on the wgmma route (the "
             f"prefill's), or moe_gemm launches {n_moe} != {3 * L} (the prefill's, the eager decode step's and the "
             "graph capture's)")
    if moe_routes != {"fma": 0, "mma": 0, "wgmma": L, "decode": 2 * L}:
        fail(f"moe serve ({label}): moe_gemm launches by route {moe_routes}, not {L} on the wgmma route (the "
             f"prefill's) and {2 * L} on the decode route (the eager step's and the capture's)")
    if tuple(out.shape) != (B, new) or out.min().item() < 0 or out.max().item() >= V:
        fail(f"moe serve ({label}): bad output {tuple(out.shape)} in [{out.min().item()}, {out.max().item()}]")
    print(f"[moe-serve] ({label}) [{cfg.name} x{L} layers | {plan.cache_policy} {plan.window} | static] {B} x {S} "
          f"prompt tokens, {new} new tokens each, in {dt:.3f}s: prefill {engine.prefill_s * 1e3:.1f} ms "
          f"({B * S / engine.prefill_s:.0f} prompt tok/s), decode {engine.decode_s * 1e3:.1f} ms for {new - 1} steps "
          f"({B * (new - 1) / engine.decode_s:.1f} tok/s, {engine.decode_s / (new - 1) * 1e3:.2f} ms/step, CUDA "
          f"graph); launches flash_attn {n_flash} = {L} layers x 1 prefill on the wgmma route, moe_gemm {n_moe} = {L} layers x (prefill "
          f"+ eager step + capture), by route {moe_routes}; peak device memory {torch.cuda.max_memory_allocated() / 2**30:.1f} GiB; "
          f"tokens[0][:8] {out[0, :8].tolist()}")
    # where a prefill's and a decode step's device time goes
    params_c = tfm.cast_params(engine.params, cfg)
    tokens = torch.from_numpy(rng.integers(3, V, size=(B, S))).cuda()
    _profile(lambda: engine._prefill(params_c, tokens), f"one MoE prefill of {B} x {S} tokens (bf16)")
    served = []

    def record(kernel, *args):  # the first call's dispatch buffer and rows (layer 0); comparison launches
        if not served:
            served.append((args[0].clone(), args[4].clone()))
        return kernel(*args)

    with _moe_wrapped(record):
        logits, cache = engine._prefill(params_c, tokens)
    prefill_buf = served.pop()
    rows = prefill_buf[1]
    print(f"[moe-serve] a served prefill's layer-0 dispatch buffer {list(prefill_buf[0].shape)}: {int(rows.sum())} of "
          f"{B * S * cfg.moe.top_k} slots kept, rows per expert {int(rows.min())}-{int(rows.max())} of capacity "
          f"{prefill_buf[0].shape[1]}, {int((rows == 0).sum())} experts empty")
    cache = pad_cache(cfg, cache, S + new)
    tok = logits.argmax(-1)

    def decode8():
        nonlocal cache, tok
        for _ in range(8):
            lg, cache = engine._step(params_c, tok, cache)
            tok = lg.argmax(-1)

    def record_step(kernel, *args):  # the first decode step's dispatch buffers and rows, one a layer
        if len(served) < L:
            served.append((args[0].clone(), args[4].clone()))
        return kernel(*args)

    with _moe_wrapped(record_step):
        decode8()  # warm
    occupied = [int((r > 0).sum().item()) for _, r in served]
    held = [int((b != 0).any(-1).any(-1).sum().item()) for b, _ in served]
    if occupied != held:
        fail(f"a served decode step's rows name {occupied} experts with a row, its buffers hold rows in {held}")
    print(f"[moe-serve] a served decode step's dispatch buffers {list(served[0][0].shape)}: experts with a row, layer "
          f"by layer, {occupied} of {cfg.moe.num_experts} ({B} tokens x top-{cfg.moe.top_k} slots, colliding slots "
          "dropped; the rows passed to moe_gemm agree)")
    _profile(decode8, f"8 eager MoE decode steps of {B} sequences at {S + 8}-{S + 16} cached tokens (bf16)")
    # one replay of the captured decode step: its kernels are the graph's
    moe_ops.moe_gemm_fused.launches = 0
    graph, _tok_buf, _state = engine.capture_decode(params_c, tok, cache)
    if moe_ops.moe_gemm_fused.launches != 2 * L:
        fail(f"capture_decode: moe_gemm launches {moe_ops.moe_gemm_fused.launches} != {2 * L} (eager step + capture)")
    events = _profile(graph.replay, "one replay of the captured MoE decode step (bf16)", top=8)
    per_kernel = {e.key: e.count for e in events if "moe_dec_kernel" in e.key}
    others = [e.key for e in events if "moe_" in e.key and "moe_dec_kernel" not in e.key]
    if len(per_kernel) != 2 or any(c != L for c in per_kernel.values()) or others:
        fail(f"the decode graph's replay ran the decode route's moe_gemm kernels {per_kernel}, not both {L} times, "
             f"or other moe kernels {others}")
    print(f"[moe-serve] the decode graph's replay ran each of the decode route's moe_gemm kernels {L} times: "
          f"{ {k[:60]: c for k, c in per_kernel.items()} }")
    return n_moe, moe_routes, n_flash, by_route, prefill_buf, served[0]


@contextlib.contextmanager
def _moe_wrapped(wrapper):
    """Route the MoE blocks' moe_gemm calls through ``wrapper(kernel, x, w1,
    wg, w2, rows)`` for the duration (``models/moe.py`` looks the wrapper up
    by name at each call).  Launches made meanwhile are comparison launches."""
    kernel = moe_model.moe_gemm_fused
    moe_model.moe_gemm_fused = lambda *args: wrapper(kernel, *args)
    try:
        yield
    finally:
        moe_model.moe_gemm_fused = kernel


def phase_moe_model_paths(params, cfg):
    """fp32: the kernel path (flash_attn, moe_gemm) and the plain path of the
    MoE LM: last-position logits of a prefill, and 8 greedy tokens through
    ServeEngine, graphed and eager."""
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    rng = np.random.default_rng(1)
    prompts = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(2, 512))).cuda()
    logits = {sk: prefill_fn(cfg32, window=cfg.sliding_window, stage_kernel=sk)(params, prompts)[0]
              for sk in ("cuda", "torch")}
    err = (logits["cuda"] - logits["torch"]).abs().max().item()
    if not torch.allclose(logits["cuda"], logits["torch"], **MOE_PATHS_TOL):
        fail(f"MoE fp32 prefill logits: kernel path vs plain path max_abs_err {err:.3e}")
    engines = {sk: ServeEngine(cfg32, params, plan=lm_plan(cfg32, sk), device="cuda") for sk in ("cuda", "torch")}
    toks = {sk: e.generate(prompts, 8) for sk, e in engines.items()}
    if not torch.equal(toks["cuda"], toks["torch"]):
        fail(f"MoE greedy tokens differ between the kernel path and the plain path: {toks['cuda'].tolist()} vs "
             f"{toks['torch'].tolist()}")
    eager = engines["cuda"].generate(prompts, 8, cuda_graph=False)
    if not torch.equal(eager, toks["cuda"]):
        fail(f"MoE greedy tokens differ between the graphed and the eager decode: {toks['cuda'].tolist()} vs "
             f"{eager.tolist()}")
    print(f"[moe-model] fp32 prefill of 2 x 512 tokens, logits kernel vs plain max_abs_err {err:.3e} (atol/rtol "
          f"{MOE_PATHS_TOL['atol']}; |logits| up to {logits['torch'].abs().max().item():.2f}); 8 greedy tokens equal "
          f"on both paths and with the decode graphed or eager: {toks['cuda'][0].tolist()}")


def phase_moe_bf16_paths(params, cfg):
    """bf16 at (a)'s prompts: every moe_gemm call and every flash_attn call
    (32 q heads on 4 kv heads, G=8, regrouped from the flat layout) of a
    kernel-path prefill against its plain version's fp32 output on that
    call's inputs, and the last-position logits of the kernel path against
    the plain path's, with two controls that must miss the bound: 64 columns
    of F dropped in every moe_gemm call, and every flash_attn call's flat
    query head h paired with kv head h % KV instead of h // G."""
    params_c = tfm.cast_params(params, cfg)
    label, B, S, _ = MOE_SERVE_RUN
    rng = np.random.default_rng(2)
    tokens = torch.from_numpy(rng.integers(3, cfg.vocab_size, size=(B, S))).cuda()
    calls, flash_calls = [], []

    def checked(kernel, x, w1, wg, w2, rows):
        out = kernel(x, w1, wg, w2, rows)
        if torch.count_nonzero(out[torch.arange(x.shape[1], device="cuda")[None, :] >= rows[:, None]]).item():
            fail(f"({label}) layer {len(calls)}: moe_gemm rows past rows[e] are not zero")
        calls.append(_moe_bf16_check(out, (x, w1, wg, w2), f"({label}) layer {len(calls)}", rows))
        return out

    def flash_checked(kernel, q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        flash_calls.append(_flash_bf16_check(out, q, k, v, kw, f"({label}) MoE layer {len(flash_calls)}"))
        return out

    def regrouped(kernel, q, k, v, group, **kw):
        KV = k.shape[0] // B
        swap = lambda t, a, b: t.view(B, a, b, *t.shape[1:]).transpose(1, 2).reshape(t.shape)  # noqa: E731
        return swap(kernel(swap(q, group, KV), k, v, group=group, **kw), KV, group)

    run = lambda sk: prefill_fn(cfg, window=cfg.sliding_window, stage_kernel=sk)(params_c, tokens)[0]  # noqa: E731
    with _moe_wrapped(checked), _flash_wrapped(flash_checked):
        lk = run("cuda")
    if len(calls) != cfg.num_layers or len(flash_calls) != cfg.num_layers:
        fail(f"({label}) bf16 MoE prefill made {len(calls)} moe_gemm and {len(flash_calls)} flash_attn calls, not "
             f"{cfg.num_layers} each")
    lp = run("torch")
    rel = _rel_l2(lk, lp)
    agree = (lk.argmax(-1) == lp.argmax(-1)).float().mean().item()
    if rel > LM_BF16_LOGITS_REL_L2:
        fail(f"({label}) bf16 MoE prefill logits: kernel path vs plain path relative L2 {rel:.3e} > "
             f"{LM_BF16_LOGITS_REL_L2}")
    with _moe_wrapped(lambda kernel, *args: _moe_cut(*args)):
        lf = run("cuda")
    frel = _rel_l2(lf, lp)
    if frel <= LM_BF16_LOGITS_REL_L2:
        fail(f"control: moe_gemm with {MOE_CONTROL_COLS} columns of F dropped passes the logits bound ({frel:.3e})")
    with _flash_wrapped(regrouped):
        lg = run("cuda")
    grel = _rel_l2(lg, lp)
    if grel <= LM_BF16_LOGITS_REL_L2:
        fail(f"control: flash_attn with the query heads regrouped wrongly passes the logits bound ({grel:.3e})")
    print(f"[moe-bf16] ({label}) {B} x {S}: {len(calls)} moe_gemm calls vs the plain version's fp32 output, worst "
          f"max_abs_err {max(c[0] for c in calls):.3e}, worst relative L2 {max(c[1] for c in calls):.3e} (bound "
          f"{MOE_BF16_REL_L2}); {len(flash_calls)} flash_attn calls (G={cfg.num_heads // cfg.num_kv_heads}) likewise, "
          f"worst max_abs_err {max(c[0] for c in flash_calls):.3e}, worst relative L2 "
          f"{max(c[1] for c in flash_calls):.3e} (bound {FLASH_BF16_REL_L2}); logits kernel path vs plain path "
          f"relative L2 {rel:.3e} (bound {LM_BF16_LOGITS_REL_L2}), argmax equal on {100 * agree:.0f}% of rows; "
          f"controls: {MOE_CONTROL_COLS} columns of F dropped, relative L2 {frel:.3e}; query head h on kv head "
          f"h % KV, relative L2 {grel:.3e} (both caught)")


def _moe_bmm(x, w1, wg, w2):
    """The yardstick: the same function as three torch.bmm calls and the gate,
    all in x's dtype (used nowhere in the port)."""
    return torch.bmm(torch.nn.functional.silu(torch.bmm(x, w1)) * torch.bmm(x, wg), w2)


def phase_moe_timing(launches: int, routes: dict, max_err: float, prefill_buf: tuple, decode_buf: tuple) -> dict:
    """moe_gemm, bf16, model scales, L2 flushed, at the MoE serving run's
    calls: the prefill's on a dense buffer (every row of C=641 holds a slot
    but two) and on a served prefill's layer-0 buffer with its rows; a
    decode step's on a dense buffer (every expert has a row) and on a served
    step's buffer with its rows (most experts have none).  Each beside the
    first tensor-core kernels (the "mma" route, every row computed, without
    rows), the plain version and the bmm yardstick.  The bound counts the rows, and
    the experts' weights, that the data needs: x's rows with a slot (x whole
    without rows), the output whole."""
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    res = {}
    for label, s, served, runs in (("prefill, dense buffer", MOE_PREFILL_SHAPE, None, 10),
                                   ("prefill, served buffer", MOE_PREFILL_SHAPE, prefill_buf, 10),
                                   ("decode, dense buffer", MOE_DECODE_SHAPE, None, 30),
                                   ("decode, served buffer", MOE_DECODE_SHAPE, decode_buf, 30)):
        args = moe_inputs(s, torch.bfloat16, seed=11)
        rows = None
        if served is not None:
            args, rows = (served[0],) + args[1:], served[1]
        route = moe_ops.pick_route(torch.bfloat16, *args[0].shape, args[1].shape[2])
        t = {"kernel": _median_ms(lambda: moe_ops.moe_gemm_fused(*args, rows), runs, flush, True),
             "mma": _median_ms(lambda: moe_ops.moe_gemm_fused(*args, route="mma"), runs, flush, True),
             "plain": _median_ms(lambda: moe_gemm_plain(*args, rows), max(3, runs // 3), flush, True),
             "bmm": _median_ms(lambda: _moe_bmm(*args), runs, flush, True)}
        got = moe_ops.moe_gemm_fused(*args, rows)
        max_err = max(max_err, _moe_bf16_check(got, args, f"{label} timing inputs", rows)[0])
        bmm_err = (got.float() - _moe_bmm(*args).float()).abs().max().item()
        mma_err = (got.float() - moe_ops.moe_gemm_fused(*args, route="mma").float()).abs().max().item()
        E, C, d, F = s["E"], s["C"], s["d"], s["F"]
        if rows is None:
            kept = (args[0] != 0).any(-1)  # [E, C]: the rows that hold a slot
            n_rows, n_experts, x_rows = int(kept.sum().item()), int(kept.any(-1).sum().item()), E * C
        else:
            n_rows, n_experts = int(rows.sum().item()), int((rows > 0).sum().item())
            x_rows = n_rows
        nbytes = 2 * (x_rows * d + E * C * d + 3 * n_experts * d * F)  # x, out, the weights of experts with a row
        flops = 2 * n_rows * d * F * 3  # x.W1, x.Wg and h.W2 over the rows with a slot
        t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
        bound_ms = max(t_bytes, t_ops) * 1e3
        bound_by = "bytes" if t_bytes >= t_ops else "operations"
        res[label] = (t, bound_ms, bound_by)
        print(f"[timing] moe_gemm at the MoE {label} call E={E} C={C} d={d} F={F} bf16, {n_rows} rows with a slot "
              f"in {n_experts} experts{' (rows passed)' if rows is not None else ''}, median, L2 flushed: device time "
              f"kernel ({route} route) {t['kernel']:.4f} ms, the mma route's kernel (every row) {t['mma']:.4f} ms, "
              f"plain {t['plain']:.4f} ms, torch.bmm x 3 + gate (yardstick) {t['bmm']:.4f} ms (kernel vs bmm "
              f"max_abs_err {bmm_err:.3e}, vs the mma route {mma_err:.3e}); bound {bound_ms:.4f} ms ({bound_by}: "
              f"{nbytes} B at 3.35 TB/s = {t_bytes * 1e3:.4f} ms, {flops} FLOP at 989 TFLOP/s = {t_ops * 1e3:.4f} "
              f"ms); kernel at {flops / t['kernel'] / 1e9:.2f} TFLOP/s, {nbytes / t['kernel'] / 1e6:.1f} GB/s of the "
              f"needed bytes, {t['kernel'] / bound_ms:.2f}x its bound")
    print(f"[timing] moe_gemm: {launches} launches in the MoE serving run, by route {routes}; library_ms: none (no "
          "single PyTorch call computes the gated expert FFN; the bmm yardstick is printed above)")
    t, bound_ms, bound_by = res["prefill, dense buffer"]
    ts, sbound, _ = res["prefill, served buffer"]
    td, dbound, _ = res["decode, served buffer"]
    tdd, ddbound, _ = res["decode, dense buffer"]
    return {
        "name": "moe_gemm", "route": "cuda", "source": MOE_SOURCE, "replaces": MOE_REPLACES,
        "launches": launches, "launches_by_route": routes, "max_abs_err": max_err, "ms": t["kernel"],
        "plain_ms": t["plain"], "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None,
        "mma_route_ms": t["mma"], "bmm_ms": t["bmm"],
        "served_prefill_ms": ts["kernel"], "served_prefill_bound_ms": sbound, "served_prefill_mma_route_ms": ts["mma"],
        "decode_ms": td["kernel"], "decode_bound_ms": dbound, "decode_mma_route_ms": td["mma"],
        "decode_dense_ms": tdd["kernel"], "decode_dense_bound_ms": ddbound,
    }


def main():
    t_start = time.perf_counter()
    phase_environment()
    phase_build()
    max_err = phase_parity()
    lstm_err = phase_lstm_parity()
    phase_backward()
    cfg = dataclasses.replace(get_config("seq2seq-rnn"), dropout=0.0, dtype="bfloat16")
    t0 = time.perf_counter()
    params = s2s.init_seq2seq(0, cfg, device="cuda")
    n = sum(p.numel() for p in tree_leaves(params))
    if n != cfg.param_count():
        fail(f"parameter count {n} != config's {cfg.param_count()}")
    print(f"[serve] {cfg.name}: {cfg.num_layers} layers, h={cfg.d_model}, emb={cfg.emb_size}, V={cfg.vocab_size}, "
          f"{n} parameters ({n * 4 / 1e6:.1f} MB fp32), initialized in {time.perf_counter() - t0:.2f}s")
    serve_launches, ticks = phase_serve(params, cfg)
    phase_model_paths(params, cfg)
    del params
    tcfg = train_config()
    lstm_launches, train_luong_launches = phase_train(tcfg)
    phase_step_paths(tcfg)
    hybrid_lstm, hybrid_luong = phase_hybrid(tcfg)
    records = phase_timing(serve_launches, train_luong_launches + hybrid_luong, ticks, max_err)
    records.append(phase_lstm_timing(lstm_launches + hybrid_lstm, lstm_err))
    records[1]["hybrid_launches"], records[-1]["hybrid_launches"] = hybrid_luong, hybrid_lstm
    flash_err = phase_flash_parity()
    lm_cfg = dataclasses.replace(get_config("qwen3-1.7b"), dtype="bfloat16")
    t0 = time.perf_counter()
    lm_params = tfm.init_lm(0, lm_cfg, device="cuda")
    n = sum(p.numel() for p in tree_leaves(lm_params))
    qk_norm_scales = lm_cfg.num_layers * 2 * lm_cfg.head_dim  # not in param_count, as in the JAX package
    if n != lm_cfg.param_count() + qk_norm_scales:
        fail(f"parameter count {n} != config's {lm_cfg.param_count()} + {qk_norm_scales} qk-norm scales")
    print(f"[lm-serve] {lm_cfg.name}: {lm_cfg.num_layers} layers, d={lm_cfg.d_model}, {lm_cfg.num_heads} q / "
          f"{lm_cfg.num_kv_heads} kv heads of {lm_cfg.head_dim}, d_ff={lm_cfg.d_ff}, V={lm_cfg.vocab_size}, window "
          f"{lm_cfg.sliding_window}: {n} parameters ({n * 4 / 1e9:.2f} GB fp32), initialized in "
          f"{time.perf_counter() - t0:.1f}s")
    flash_launches, flash_routes = phase_lm_serve(lm_params, lm_cfg)
    phase_lm_model_paths(lm_params, lm_cfg)
    phase_lm_bf16_paths(lm_params, lm_cfg)
    del lm_params
    torch.cuda.empty_cache()
    moe_err = phase_moe_parity()
    moe_cfg = moe_config()
    t0 = time.perf_counter()
    moe_params = tfm.init_lm(0, moe_cfg, device="cuda")
    n = sum(p.numel() for p in tree_leaves(moe_params))
    qk_norm_scales = moe_cfg.num_layers * 2 * moe_cfg.head_dim
    if n != moe_cfg.param_count() + qk_norm_scales:
        fail(f"parameter count {n} != config's {moe_cfg.param_count()} + {qk_norm_scales} qk-norm scales")
    m = moe_cfg.moe
    print(f"[moe-serve] {moe_cfg.name}: {moe_cfg.num_layers} of 48 layers, d={moe_cfg.d_model}, {moe_cfg.num_heads} q / "
          f"{moe_cfg.num_kv_heads} kv heads of {moe_cfg.head_dim}, {m.num_experts} experts top-{m.top_k} of width "
          f"{m.d_ff_expert}, capacity factor {m.capacity_factor}, V={moe_cfg.vocab_size}, window "
          f"{moe_cfg.sliding_window}: {n} parameters ({n * 4 / 1e9:.2f} GB fp32), initialized in "
          f"{time.perf_counter() - t0:.1f}s")
    moe_launches, moe_routes, moe_flash_launches, moe_flash_routes, prefill_buf, decode_buf = phase_moe_serve(
        moe_params, moe_cfg)
    phase_moe_model_paths(moe_params, moe_cfg)
    phase_moe_bf16_paths(moe_params, moe_cfg)
    del moe_params
    torch.cuda.empty_cache()
    records.append(phase_flash_timing(flash_launches + moe_flash_launches,
                                      {r: flash_routes[r] + moe_flash_routes[r] for r in flash_routes}, flash_err))
    records.append(phase_moe_timing(moe_launches, moe_routes, moe_err, prefill_buf, decode_buf))
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": records}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
