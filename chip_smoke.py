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
   rows), the training step's shape (2048 rows), the input-feeding step's
   per-step calls (N=1, M=32: 64 rows, and a rank's row block of 32),
   ragged rows (N=48, R=129),
   one and 129 source positions, the ``tests/kernel_harness.py`` shapes and
   an all-masked row, fp32 and bf16 at TOL_ATTN; bf16 on the new routes
   also against the plain version's fp32 output, within twice that
   output's own bf16 rounding error (relative L2 and max abs), two calls
   bit-identical, and a control with each row's last unmasked source
   position dropped must miss that bound; the ``lstm_cell`` kernels at the harness's shapes, a shape
   of three ragged row tiles and the model's three full-width shapes (In 512,
   1024 and the input-feeding decoder's layer 0, 1536 = 40 chunks of 64
   with h), fp32 and
   bf16, the old mixed feed (fp32 weights: the FMA kernel), the model's feed
   (x and weights bf16, h and c fp32: the tensor-core kernel, held to
   LSTM_MMA_TOL, with a control that rounds h to bf16 and must miss it), and a
   cross-check against ``torch.lstm_cell``;
4. kernel vs plain, backward: fp32 grads through each kernel's
   ``autograd.Function`` against autograd through its plain version, at the
   full-width training shapes (and the Luong forward output beside them);
   then the column-shard ``lstm_cell`` of the tensor-parallel backbone (h
   [64, 1024] whole, c and the weights of Hs = 512 or 256 units, In 512,
   1024 and 1536): every shard on the tensor-core kernel (LSTM_MMA_TOL, with the
   h-rounding control) and on the FMA kernel (TOL_TIGHT) against the plain
   version, each bit-identical to the square kernel's column block on the
   same inputs, and its adjoint against autograd through the plain version;
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
   fails or outlives its time limit fails the script.  (a) also runs the
   interleaved ring (``schedule="interleaved"`` at v = 2 and 4 layer chunks)
   as the other schedules, and one fp32 HYBRID_OPT step (its sharded code
   paths, every placement trivial) against the meshless step.  (c) One
   more spawn of two ranks on the card over gloo, with its own time limit:
   one fp32 step each of MODEL and HYBRID on the tensor-parallel backbone at
   1 x 2 (column-shard cells of 512 units), HYBRID_OPT at 2 x 1 (FSDP over
   two ranks) and at 1 x 2 (the vocab-parallel head), and HYBRID on the ring
   at 1 x 2 with v = 2, every grad leaf gathered whole against (a)'s
   meshless step; then one bf16 step of each tensor-parallel layout, its
   ``lstm_cell`` launches (layers x (M + N) a rank, every one on the
   tensor-core kernel at the shard's shape) counted; each rank's allocated
   bytes of params and Adam moments beside the meshless step's;
8c. input feeding (the paper's HybridNMTIF): the full-width model with
   Hc_{t-1} fed into decoder layer 0 ([emb; Hc], In 1536), the decoder
   step-major with eq. 1-4 inside its recurrence (but at the last step,
   whose Hc feeds none).  (a) The meshless step: one fp32 step at dropout
   0.3 on the kernel path against the plain path (loss within
   STEP_LOSS_TOL, every grad leaf at STEP_TOL), then 4 bf16 steps through
   ``Trainer``, each launching ``lstm_cell`` layers x (M + N) times, every
   one on the tensor-core kernel (the wrapper counts them by depth: N at
   In=1536), and ``luong_attn`` N times on the "wgmma" route (N - 1
   per-step calls on 64 rows, one over all steps; counted by rows), median
   step time beside the card's name and power limit, then one step under
   ``torch.profiler``.  (b) One spawn of two ranks on the card over gloo,
   with its own time limit: one fp32 step each of MODEL, HYBRID, HYBRID
   pipelined (2 microbatches; it runs tensor-parallel) and HYBRID_OPT at
   1 x 2 and HYBRID_OPT at 2 x 1, every grad leaf gathered whole against
   (a)'s fp32 step; then one bf16 step of MODEL and HYBRID at 1 x 2 against
   (a)'s bf16 step on the same batch, each rank's launches counted by
   shape: layers x (M + N) column-shard cells, all tensor-core, N - 1
   per-step calls on its row block of 32 ("decode") and one over all steps
   ("wgmma"); then faults planted in MODEL 1 x 2 (IF_FAULTS): the fp32
   checks and the bf16 bounds must catch the wrong Hc row order and the
   dropped Hc grad, and read eq. 1-4 on all rows as the sound step;
9. timing with CUDA events: ``luong_attn`` at the decode tick on the
   "decode" route and at the training shape on the "wgmma" route, each
   beside the first kernel (the "fma" route), the plain version and the "torch" stage
   path's bf16 eq. 1-4 (cuBLAS GEMMs: the yardstick), with the scratch each
   allocates; ``lstm_cell`` at the training shape on the model's feed
   (L2 flushed and warm; and at In=512), beside the fp32-masters feed's FMA
   kernel, the plain version and ``torch.lstm_cell`` in bf16; and the
   column shard (Hs = 512) beside its plain version and ``torch.lstm_cell``
   on the same GEMM; both again at the input-feeding decoder's layer 0
   (In=1536); ``luong_attn``'s input-feeding per-step call at 64 rows
   ("wgmma") and 32 ("decode") beside its bound, its plain version and the
   "torch" stage path;
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
    kernel and SDPA, and at (b)'s against the mma route's kernel and SDPA
    with the window's causal band as a boolean mask; ``moe_gemm`` at the
    MoE prefill's call on a dense buffer and on a served prefill's layer-0
    buffer with its rows, and at a decode step's call on a dense buffer
    (every expert has a row) and on a served step's buffer with its rows
    (the bounds count only the rows and experts with a slot), against the
    first tensor-core kernels (the mma route), its plain version and, as a yardstick used
    nowhere in the port, ``torch.bmm`` x 3 plus the gate;
19. LM training (run after phase 13, on phase 11's fp32 masters, which the
    trainer copies): ``qwen3-1.7b`` at full width and depth through
    ``Trainer`` (bf16 over fp32 masters, Adam 1e-3, clip 5.0, remat on; the
    step donates its state) on 6 batches of 4 x 2048 tokens from
    ``LMBatchIterator(SyntheticLMTask(151936, branching=16))``, made before
    the steps; every step launches ``flash_attn`` 56 times (28 layers,
    forward and remat recompute), all on the "wgmma" route; median step
    over steps 3-6, target tokens per second, one more step whose kernel
    outputs are fingerprinted (each layer's recompute must give its
    forward's bits), one step under ``torch.profiler`` (device busy share
    against the median step), peak ``max_memory_allocated``; before it,
    phase 21 (a);
20. MoE training (run after phase 17): ``qwen3-moe-30b-a3b`` at full width,
    its depth cut to 4 of 48 layers (16 B of training state a parameter:
    49.8 GB at 4 layers, 70 GB at 6 before activations), as phase 19 with
    the load-balance term in the loss (its aux printed) and ``moe_gemm``
    launched 8 times a step with ``rows`` (forward and recompute), all on
    "wgmma", ``flash_attn`` 8; before it, phase 21 (b);
21. kernel path vs plain path in one fp32 training step of each LM
    (``qwen3-1.7b`` cut to 8 layers, the MoE model at 4; batch 2 x 2048):
    the loss within LM_STEP_LOSS_TOL and every grad leaf within
    LM_STEP_GRAD_REL of its norm;
22. each new backward alone at the training calls' shapes, fp32 and bf16:
    ``flash_attn`` (B=4, S=2048, 16/8 and 32/4 heads) and ``moe_gemm``
    ([128, 641, 2048] x 768 with ``rows``, NaN and 1e4 planted past them)
    through the wrapper's ``autograd.Function`` against autograd through
    the plain version (BACKWARD_REL), dx past ``rows`` exactly zero, with a
    planted fault each that must miss the bound (dk dropped; the backward
    recomputed without ``rows``); each backward's device time per layer, and
    SDPA's backward beside the attention's (a yardstick);
23. LM training on the grid: (a) the trivial 1 x 1 grid over NCCL:
    ``qwen3-1.7b`` cut to 8 layers and ``qwen3-moe-30b-a3b`` to 4 (full
    width, fp32, 2 x 2048 tokens), one step each of DATA, MODEL, HYBRID and
    HYBRID_OPT against the meshless step (phase 21's bounds); then 4 bf16
    steps of the full-depth ``qwen3-1.7b`` on HYBRID through ``Trainer``
    (56 ``flash_attn`` launches a step, all "wgmma"), median step beside the
    card's name and power limit.  (b) Two ranks on the card over gloo, both
    models at 2 layers (full width): one fp32 step each of DATA 2 x 1, MODEL,
    HYBRID and HYBRID_OPT 1 x 2 and HYBRID_OPT 2 x 1 against the meshless
    step (the MoE's DATA at capacity factor 1.0, where slots drop; the
    expert-parallel layouts at E / k = 16 on 2 x 1024 tokens, where none
    can), three
    planted faults that must miss it (DATA at each rank's own capacity and
    positions; the load-balance statistics multiplied before their mean; a
    row-parallel partial not summed); one bf16 step each, every
    ``flash_attn`` launch on "wgmma" at the rank's head counts and every
    ``moe_gemm`` launch on "wgmma" with ``rows`` at the dispatch buffer's
    shape, the first of each held against its plain version, the loss (and
    the dense model's grads) against the meshless bf16 step's.
    ``python3 chip_smoke.py --only lm-grid`` runs phases 1, 2 and 23 alone.

Then one JSON line with the kernels' numbers (``launches`` counts the
launches of the serving runs, the training run, the hybrid phase's and the
input-feeding phase's bf16 steps, the LM training runs' steps 1-6 and the
grid phase's bf16 steps, each counted from 0 around its run, the hybrid,
input-feeding, LM training and grid ones also as ``hybrid_launches``,
``input_feeding_launches``, ``train_launches`` and ``grid_launches``; ``luong_attn`` one record per route on the main path,
``flash_attn`` and ``moe_gemm`` also by route), the ``nvidia-smi`` name and
power-limit line, and, last,
``{"ok": true, "device": {...}}``.  Imports nothing of the JAX package.
Without CUDA, or without the repository beside it, it exits nonzero and
prints no result.
"""
from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import json
import math
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
from repro_torch.core import strategy as stg  # noqa: E402
from repro_torch.core.plan import ExecutionPlan, ServePlan, _placed_leaves  # noqa: E402
from repro_torch.data import LMBatchIterator, MTBatchIterator, SyntheticLMTask, SyntheticMTTask  # noqa: E402
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
from repro_torch.models.common import Initializer, tree_leaves, tree_map  # noqa: E402
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
# the input-feeding step's eq. 1-4 of one target step: the meshless step's 64 rows ("wgmma"), and one
# rank's row block of 32 on a model axis of 2 ("decode"), against the source bucket of 32
LUONG_IF_STEP_SHAPE = dict(B=64, N=1, M=32, h=1024)
LUONG_IF_BLOCK_SHAPE = dict(B=32, N=1, M=32, h=1024)
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
     ("rows-32-decode", dict(B=32, N=1, M=64, h=1024), None, True),
     ("if-step", LUONG_IF_STEP_SHAPE, None, True),
     ("if-step-row-block", LUONG_IF_BLOCK_SHAPE, None, True)]
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
# the training step's cells: layer 0 (emb 512 in) and layers 1-3 (h 1024 in), batch 64; with input feeding
# decoder layer 0 takes [emb; Hc] (In 1536: with H 1024 a depth of 40 chunks of 64)
LSTM_MODEL_SHAPES = [dict(B=64, In=512, H=1024), dict(B=64, In=1024, H=1024), dict(B=64, In=1536, H=1024)]
LSTM_ROW_TILES_SHAPE = dict(B=130, In=40, H=72)  # three of the kernel's 64-row tiles, the last ragged
LSTM_TIMING_SHAPE = LSTM_MODEL_SHAPES[1]
# the tensor-parallel backbone's column-shard cells at full width: h [64, 1024] whole, Hs of the 1024 units
# (Hs = 512 on a model axis of 2, 256 on 4), layer 0 (emb 512 in), layers 1-3 (h 1024 in) and the
# input-feeding decoder's layer 0 (1536 in)
LSTM_SHARD_SHAPES = [dict(B=64, In=i, H=1024, Hs=hs) for i in (512, 1024, 1536) for hs in (512, 256)]
LSTM_SHARD_TIMING_SHAPE = dict(B=64, In=1024, H=1024, Hs=512)
LSTM_IF_TIMING_SHAPE = LSTM_MODEL_SHAPES[2]  # the input-feeding decoder's layer 0
LSTM_IF_SHARD_TIMING_SHAPE = dict(B=64, In=1536, H=1024, Hs=512)
# fp32 comparisons of a whole training step (tests/test_plan.py's tolerance)
STEP_TOL = dict(atol=1e-4, rtol=1e-3)
STEP_LOSS_TOL = 1e-4
# phase (c)'s bf16 tensor-parallel steps against the meshless bf16 step: the shard cells' h is the square
# cell's column block bit for bit and its gather exact, so the loss reads |diff| 0 on the H100; each
# rank's dx is its bf16 term of a sum over ``model``, rounded before the sum where the meshless dx is
# rounded once, so the embeddings' grads read up to 5.5e-3 of their norm (one bf16 rounding); a wrong
# block order, a stale or mis-typed h moves the grads by O(1) of their norm
BF16_TP_LOSS_TOL = 1e-4
BF16_TP_GRAD_REL = 2e-2  # per leaf, ||grad - meshless|| / ||meshless||
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
# LM training (phases 19-22): Trainer steps of 4 x 2048 tokens, the median over steps 3-6
LM_TRAIN_STEPS = 6
LM_TRAIN_BATCH, LM_TRAIN_SEQ = 4, 2048
# of qwen3-moe-30b-a3b's 48 layers: 16 B of training state a parameter (fp32 masters, grads, Adam m and v)
# is 49.8 GB at 4 layers (3.11e9 parameters), 70 GB at 6 before any activation, 90 GB at the serving phase's 8
MOE_TRAIN_LAYERS = 4
# phase 21: the fp32 step on both paths, the dense model cut to 8 layers and both at batch 2, to keep the
# phase's time down.  Two summation orders of attention (the fp32 kernel vs chunked_attention) and of the
# expert FFN agree to about 1e-6 of a leaf's norm; 1e-3 leaves room for a router top-k pick that a tie within
# that error flips, and is far below what a wrong grad moves
LM_PATHS_LAYERS = 8
LM_PATHS_BATCH = 2
LM_STEP_LOSS_TOL = 1e-4
LM_STEP_GRAD_REL = 1e-3  # per leaf, ||kernel path - plain path|| / ||plain path||
# phase 22: the autograd.Function's grads against autograd through the plain version on the same inputs: the
# backward is that recompute, so only a fault (or nondeterminism) moves them
BACKWARD_REL = 1e-5
BACKWARD_SPIN_CYCLES = 600_000_000  # about 0.3 s of device clock: longer than the host takes to enqueue a backward
FLASH_TRAIN_SHAPE = dict(B=4, S=2048, KV=8, G=2, D=128, causal=True, window=None)  # qwen3-1.7b's training call
FLASH_MOE_TRAIN_SHAPE = dict(B=4, S=2048, KV=4, G=8, D=128, causal=True, window=None)  # the MoE model's


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
        if g.dtype != like.dtype or g.shape != args[2].shape:  # h' and c' have c's shape (a column shard's)
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


def _shard_args(args, r: int, Hs: int) -> tuple:
    """Column shard r of a whole cell's inputs: h whole, c and the weights'
    units [r*Hs, (r+1)*Hs)."""
    x, h, c, wx, wh, b = args
    cols = slice(r * Hs, (r + 1) * Hs)
    return x, h, c[:, cols].contiguous(), wx[..., cols].contiguous(), wh[..., cols].contiguous(), b[:, cols].contiguous()


def phase_lstm_shard() -> float:
    """The column-shard lstm_cell (the tensor-parallel backbone's cell: h
    [64, 1024] whole, Hs of the units) at LSTM_SHARD_SHAPES, every shard: the
    model's feed on the tensor-core kernel at LSTM_MMA_TOL and fp32 on the
    FMA kernel at TOL_TIGHT, each against the plain version, and each shard's
    output bit-identical to the whole (square) kernel's column block on the
    same inputs; the h-rounding control must miss LSTM_MMA_TOL; then the
    adjoint at fp32 against autograd through the plain version."""
    worst = 0.0
    rng = np.random.default_rng(9)
    for s in LSTM_SHARD_SHAPES:
        Hs, parts = s["Hs"], s["H"] // s["Hs"]
        for fname, dts, tol, path in (("model_bf16w", BF16W_FEED, LSTM_MMA_TOL, "mma"),
                                      ("float32", (torch.float32,) * 6, TOL_TIGHT["float32"], "fma")):
            args = lstm_inputs(s, dts, seed=4, model_scales=True)
            whole = lstm_ops.lstm_cell_fused(*args)
            for r in range(parts):
                sa = _shard_args(args, r, Hs)
                worst = max(worst, _lstm_check(f"B{s['B']}-In{s['In']}-Hin{s['H']}-Hs{Hs} shard {r}", fname, sa, tol,
                                               path=path))
                got = lstm_ops.lstm_cell_fused(*sa)
                cols = slice(r * Hs, (r + 1) * Hs)
                if not (torch.equal(got[0], whole[0][:, cols]) and torch.equal(got[1], whole[1][:, cols])):
                    fail(f"lstm_cell column shard {r} of {parts} at {s} {fname}: not bit-identical to the whole "
                         "kernel's column block")
            print(f"[parity] lstm_cell {s} {fname}: the {parts} shards' outputs are the whole {path} kernel's "
                  "column blocks, bit for bit")
            if path == "mma":  # the control: h rounded to bf16 must miss LSTM_MMA_TOL on a shard too
                sa = _shard_args(args, 0, Hs)
                got = lstm_ops.lstm_cell_fused(sa[0], sa[1].bfloat16().float(), *sa[2:])
                want = lstm_cell_ref(*sa)
                if all(torch.allclose(g, w, **LSTM_MMA_TOL) for g, w in zip(got, want)):
                    fail(f"the h-rounding control met LSTM_MMA_TOL on the shard at {s}")
                print(f"[parity] lstm_cell {s} shard control, h rounded to bf16: max_abs_err "
                      f"{max((g - w).abs().max().item() for g, w in zip(got, want)):.3e} misses atol/rtol "
                      f"{LSTM_MMA_TOL['atol']}")
        sa = _shard_args(lstm_inputs(s, (torch.float32,) * 6, seed=5, model_scales=True), parts - 1, Hs)
        dh = torch.from_numpy(rng.normal(size=(s["B"], Hs)).astype(np.float32)).cuda()
        dc = torch.from_numpy(rng.normal(size=(s["B"], Hs)).astype(np.float32)).cuda()
        grads = []
        for fn in (lstm_ops.lstm_cell_fused, lstm_cell_ref):
            ins = [a.clone().requires_grad_() for a in sa]
            hn, cn = fn(*ins)
            grads.append(torch.autograd.grad((hn * dh).sum() + (cn * dc).sum(), ins))
        for name, g, w in zip(("x", "h", "c", "wx", "wh", "b"), *grads):
            if g.shape != w.shape or not torch.allclose(g, w, **BWD_TOL):
                fail(f"lstm_cell column-shard backward d{name} at {s}: kernel path vs plain max_abs_err "
                     f"{(g - w).abs().max().item():.3e}")
        print(f"[backward] lstm_cell column shard {s} fp32: grads of x, h (partial, [B, {s['H']}]), c, wx, wh, b "
              f"max_abs_err {max((g - w).abs().max().item() for g, w in zip(*grads)):.3e} (atol/rtol "
              f"{BWD_TOL['atol']}) ok")
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
    lstm_ops.reset_launches()
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
        lstm_ops.reset_launches()
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


# (schedule, virtual stages): the wavefront's three tables, then the interleaved ring at v = 2 and 4 chunks
HYBRID_SCHEDULES = (("gpipe", 1), ("1f1b", 1), ("zerobubble", 1), ("interleaved", 2), ("interleaved", 4))
HYBRID_MICRO = 2  # microbatches interleaved through the wavefront
HYBRID_BF16_STEPS = 4  # per schedule; the median is over steps 2-4
HYBRID_SEED = 7  # the dropout generator's seed, on every rank and in the meshless reference
HYBRID_RANK_LIMIT_S = 600  # phase (b): both ranks, build and checks included
LAYOUT_RANK_LIMIT_S = 600  # phase (c): both ranks, every layout
# phase (c): (label, grid, plan keywords) of the layouts on two ranks of the card; the first two also take a bf16 step
LAYOUT_CASES = (
    ("model TP 1x2", (1, 2), dict(strategy="model")),
    ("hybrid TP 1x2", (1, 2), dict(strategy="hybrid")),
    ("hybrid_opt 2x1 (FSDP)", (2, 1), dict(strategy="hybrid_opt")),
    ("hybrid_opt 1x2 (vocab-parallel head)", (1, 2), dict(strategy="hybrid_opt")),
    ("hybrid interleaved v=2 1x2", (1, 2), dict(strategy="hybrid", use_pipeline=True, micro_batches=HYBRID_MICRO,
                                                schedule="interleaved", virtual_stages=2)),
)


def _sched_label(sched: str, v: int) -> str:
    return sched if v == 1 else f"{sched} v={v}"


def _hybrid_batch(cfg, device):
    return batch_to_device(next(MTBatchIterator(SyntheticMTTask(vocab_size=cfg.vocab_size), 64, seed=2)), device)


def _hybrid_generator(device):
    g = torch.Generator(device=device)
    g.manual_seed(HYBRID_SEED)
    return g


def _grad_rel_errors(grads, want) -> tuple:
    """(largest ||a - b|| / ||b|| over the leaves, the index of that leaf)."""
    rel = [((a - b).norm() / b.norm().clamp(min=1e-30)).item() for a, b in zip(tree_leaves(grads), tree_leaves(want))]
    i = int(np.argmax(rel))
    return rel[i], i


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
        lstm_ops.reset_launches()
        luong_ops.reset_launches()
        t0 = time.perf_counter()
        loss, _, grads = make_grad_fn(cfg, plan)(params, batch, _hybrid_generator(grid.device))
        float(loss)  # waits for the step
        step_s = time.perf_counter() - t0
        res = {"lstm": lstm_ops.lstm_cell_fused.launches, "luong": luong_ops.luong_attention_fused.launches,
               "step_s": step_s}
        whole = plan.gather_params(grads, cfg)
        if grid.rank == 0:
            err, bad = _grad_errors(whole, [g.to(grid.device) for g in ref["grads"]])
            res.update(loss=float(loss), loss_err=abs(float(loss) - ref["loss"]), max_abs_err=err, bad_leaf=bad)
        out[sched] = res
    return out


def _tree_bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in tree_leaves(tree))


@contextlib.contextmanager
def _planted(patch: dict):
    """``core/strategy.py::Sharding`` with the methods of ``patch`` ({name:
    (the method) -> its faulty replacement}) replaced, in this process."""
    from repro_torch.core.strategy import Sharding

    saved = {name: getattr(Sharding, name) for name in patch}
    for name, make in patch.items():
        setattr(Sharding, name, make(saved[name]))
    try:
        yield
    finally:
        for name, method in saved.items():
            setattr(Sharding, name, method)


def layouts_rank(grid, cfg, ref_path: str, cases: tuple = LAYOUT_CASES, faults: bool = False) -> dict:
    """Phase 8b (c) and 8c (b) on one rank of the two on the card (gloo,
    every collective through host memory): for each of ``cases`` on a grid
    of its shape over these two ranks, one fp32 step of the full-width
    ``cfg`` on this rank's blocks, its kernels' launches counted, the grads
    gathered whole and held (rank 0) against the meshless step's saved by
    the parent; the bytes of params and Adam moments this rank stores; then
    for the tensor-parallel MODEL and HYBRID without the pipeline one bf16
    step, its kernels' launches counted (by shape, and ``luong_attn`` by
    route) and its loss and grads (gathered whole) held against the meshless
    bf16 step's.  With ``faults``, on the first case one fp32 and one bf16
    step with each of IF_FAULTS planted (:func:`_planted`), read the same
    way."""
    from repro_torch.launch.mesh import ProcessGrid
    from repro_torch.train.trainer import init_train_state

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    whole = s2s.init_seq2seq(0, cfg, device=grid.device)
    batch = _hybrid_batch(cfg, grid.device)
    ref = torch.load(ref_path, weights_only=False) if grid.rank == 0 else None
    grids = {grid.shape: grid}
    out = {}
    cell, luong = lstm_ops.lstm_cell_fused, luong_ops.luong_attention_fused

    def bf16_step(plan, params) -> dict:
        lstm_ops.reset_launches()
        luong_ops.reset_launches()
        bloss, _, bgrads = make_grad_fn(cfg, plan)(params, batch, _hybrid_generator(grid.device))
        res = dict(bf16_loss=float(bloss), bf16_lstm=cell.launches, bf16_lstm_mma=cell.mma_launches,
                   bf16_lstm_shapes=dict(cell.launches_by_shape), bf16_luong=luong.launches,
                   bf16_luong_routes=dict(luong.launches_by_route), bf16_luong_shapes=dict(luong.launches_by_shape))
        full = plan.gather_params(bgrads, cfg)
        del bgrads
        if grid.rank == 0:
            rel, leaf = _grad_rel_errors(full, [x.to(grid.device) for x in ref["bf16_grads"]])
            res.update(bf16_loss_err=abs(float(bloss) - ref["bf16_loss"]), bf16_grad_rel=rel, bf16_grad_leaf=leaf)
        return res

    def fp32_step(plan, params) -> dict:
        t0 = time.perf_counter()
        loss, _, grads = make_grad_fn(cfg, plan)(params, batch, _hybrid_generator(grid.device))
        loss = float(loss)  # waits for the step
        step_s = time.perf_counter() - t0
        full = plan.gather_params(grads, cfg)
        del grads
        if grid.rank != 0:
            return {"step_s": step_s}
        want = [x.to(grid.device) for x in ref["grads"]]
        err, bad = _grad_errors(full, want)
        rel, leaf = _grad_rel_errors(full, want)
        return dict(step_s=step_s, loss=loss, loss_err=abs(loss - ref["loss"]), max_abs_err=err,
                    bad_leaf=bad, grad_rel=rel, grad_leaf=leaf)

    for label, shape, kw in cases:
        if shape not in grids:
            grids[shape] = ProcessGrid(*shape, device=grid.device, timeout_s=grid.timeout.total_seconds())
        g = grids[shape]
        plan = ExecutionPlan(mesh=g, stage_kernel="cuda", **kw)
        params = plan.shard_params(whole, cfg)
        state = init_train_state(params, adam(lr=1e-3), plan=plan, cfg=cfg)
        torch.cuda.synchronize()
        res = {"param_bytes": _tree_bytes(state.params), "moment_bytes": _tree_bytes(state.opt_state.m)
               + _tree_bytes(state.opt_state.v)}
        del state
        lstm_ops.reset_launches()
        luong_ops.reset_launches()
        res.update(fp32_step(plan, params))
        res.update(lstm=cell.launches, lstm_fma=cell.fma_launches,
                   luong=luong.launches, tensor_parallel=plan.for_config(cfg).tensor_parallel)
        bplan = ExecutionPlan(mesh=g, stage_kernel="cuda", compute_dtype="bfloat16", **kw)
        if plan.tensor_parallel and kw["strategy"] in ("model", "hybrid"):
            res.update(bf16_step(bplan, params))
        if faults and label == cases[0][0]:
            res["faults"] = {}
            for name, patch, _ in IF_FAULTS:
                with _planted(patch):
                    res["faults"][name] = {**fp32_step(plan, params), **bf16_step(bplan, params)}
        del params
        torch.cuda.empty_cache()
        out[label] = res
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
    # the meshless bf16 step, for phase (c)'s bf16 tensor-parallel steps
    bloss, _, bref = make_grad_fn(cfg32, ExecutionPlan(stage_kernel="cuda", compute_dtype="bfloat16"))(
        params, batch, _hybrid_generator(device))
    bf16_ref = {"bf16_loss": float(bloss), "bf16_grads": [g.cpu() for g in tree_leaves(bref)]}
    del bref
    cell = lstm_ops.lstm_cell_fused
    with make_grid(1, 1, device=device) as grid:
        fp32_plans = [(_sched_label(sched, v), dict(strategy="hybrid", use_pipeline=True, micro_batches=HYBRID_MICRO,
                                                     schedule=sched, virtual_stages=v))
                      for sched, v in HYBRID_SCHEDULES]
        fp32_plans.append(("hybrid_opt (sharded paths, trivial placement)", dict(strategy="hybrid_opt")))
        for label, kw in fp32_plans:
            plan = ExecutionPlan(mesh=grid, stage_kernel="cuda", **kw)
            ploss, _, grads = make_grad_fn(cfg32, plan)(plan.shard_params(params, cfg32), batch, _hybrid_generator(device))
            grads = plan.gather_params(grads, cfg32)
            dloss = abs(float(ploss) - float(loss))
            err, bad = _grad_errors(grads, ref)
            if dloss > STEP_LOSS_TOL or bad is not None:
                fail(f"hybrid (a) {label}: loss {float(ploss)} vs meshless {float(loss)}, grad leaf {bad} outside "
                     f"atol {STEP_TOL['atol']} rtol {STEP_TOL['rtol']} (max abs err {err:.3e})")
            print(f"[hybrid] (a) 1x1 grid, {grid.backend}, {label}, micro_batches {plan.micro_batches}, fp32, dropout "
                  f"{cfg32.dropout}, batch 64 M={M} N={N}: loss {float(ploss):.6f} vs meshless {float(loss):.6f} "
                  f"(|diff| {dloss:.2e} <= {STEP_LOSS_TOL}); {len(tree_leaves(grads))} grad leaves max_abs_err "
                  f"{err:.3e} (atol {STEP_TOL['atol']}, rtol {STEP_TOL['rtol']})")
        del grads

        # launches: the meshless step with the same micro_batches, then the pipelined bf16 steps
        it = lambda: MTBatchIterator(SyntheticMTTask(vocab_size=tcfg.vocab_size), batch_size=64, seed=3)  # noqa: E731
        lstm_ops.reset_launches()
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
        for sched, v in HYBRID_SCHEDULES:
            label = _sched_label(sched, v)
            plan = ExecutionPlan(strategy="hybrid", mesh=grid, use_pipeline=True, micro_batches=HYBRID_MICRO,
                                 schedule=sched, virtual_stages=v, stage_kernel="cuda", compute_dtype="bfloat16")
            trainer = Trainer(tcfg, adam(lr=1e-3), it(), plan=plan, seed=0)
            twin = it()
            for step in range(1, HYBRID_BF16_STEPS + 1):
                lstm_ops.reset_launches()
                luong_ops.reset_launches()
                trainer.run(1, log_every=1, log=lambda line: None)
                b = next(twin)
                recompute = HYBRID_MICRO * L * (b["src"].shape[1] + b["tgt_in"].shape[1])
                h = trainer.history[-1]
                n_luong = luong_ops.luong_attention_fused.launches
                if not (np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])):
                    fail(f"hybrid bf16 {label} step {step}: loss {h['loss']} grad norm {h['grad_norm']}")
                if cell.launches != 2 * recompute or cell.mma_launches != cell.launches or n_luong != 1 \
                        or luong_ops.luong_attention_fused.launches_by_route["wgmma"] != 1:
                    fail(f"hybrid bf16 {label} step {step}: lstm_cell {cell.launches} launches ({cell.mma_launches} "
                         f"tensor-core), want forward + recompute = 2 x {recompute}; luong_attn {n_luong}, want 1 "
                         "on the wgmma route")
                step_lstm = cell.launches
                lstm_total += step_lstm
                luong_total += n_luong
            if (sched, v) in (HYBRID_SCHEDULES[0], HYBRID_SCHEDULES[3]):  # one more step, not counted: where its time goes
                _profile(lambda: trainer.run(1, log_every=1, log=lambda line: None),
                         f"one hybrid pipelined step ({label}, 1 x 1 grid, bf16)", top=10)
                trainer.history.pop()
            ms = [x["step_s"] * 1e3 for x in trainer.history[1:]]
            print(f"[hybrid] (a) bf16 over fp32 masters, {label}, dropout {tcfg.dropout}, batch 64: median step "
                  f"{float(np.median(ms)):.1f} ms over steps 2-{HYBRID_BF16_STEPS} ({nvidia_smi_line()}); losses "
                  f"{[round(x['loss'], 4) for x in trainer.history]}; per step lstm_cell {step_lstm} launches, all "
                  f"tensor-core = the meshless micro_batches={HYBRID_MICRO} step's {accum_lstm} (k x layers x (M + N) "
                  f"at M={M1} N={N1}) + the backward's recompute of every group, k x layers x (M + N) = {recompute} "
                  f"at this step's M, N; luong_attn 1 (wgmma route) vs the meshless step's {accum_luong}: the head "
                  "runs once on the whole batch")
    # (b): two ranks on this card over gloo, against (a)'s meshless step
    ref_loss, ref_grads = float(loss), [g.cpu() for g in tree_leaves(ref)]
    meshless_bytes = (_tree_bytes(params), 2 * _tree_bytes(params))  # params; Adam's m and v
    with tempfile.TemporaryDirectory(prefix="hybrid-") as tmp:
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save({"loss": ref_loss, "grads": ref_grads}, ref_path)
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
    tp_lstm, tp_luong = phase_layouts(cfg32, {"loss": ref_loss, "grads": ref_grads, **bf16_ref}, meshless_bytes,
                                      M, N, L)
    return lstm_total, luong_total, tp_lstm, tp_luong


def phase_layouts(cfg32, ref: dict, meshless_bytes: tuple, M: int, N: int, L: int) -> tuple:
    """Phase (c): LAYOUT_CASES on two ranks of this card over gloo, fp32
    against (a)'s meshless step (``ref``: its loss and grads, and its bf16
    twin's), then bf16 steps of the tensor-parallel layouts against the
    meshless bf16 step, their launches counted (see ``layouts_rank``).
    Returns those bf16 steps' lstm_cell (column-shard) and luong_attn
    launches, both ranks summed."""
    from repro_torch.launch.mesh import spawn_grid

    ref_loss = ref["loss"]
    with tempfile.TemporaryDirectory(prefix="layouts-") as tmp:
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save(ref, ref_path)
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        ranks = spawn_grid(layouts_rank, 1, 2, args=(cfg32, ref_path), device="cuda:0", backend="gloo",
                           timeout_s=LAYOUT_RANK_LIMIT_S, collective_timeout_s=120.0, threads=0)
        wall = time.perf_counter() - t0
    for label, shape, kw in LAYOUT_CASES:
        r0, r1 = ranks[0][label], ranks[1][label]
        if r0["loss_err"] > STEP_LOSS_TOL or r0["bad_leaf"] is not None:
            fail(f"layouts (c) {label}: loss |diff| {r0['loss_err']:.2e}, grad leaf {r0['bad_leaf']} outside tolerance "
                 f"(max abs err {r0['max_abs_err']:.3e})")
        print(f"[layouts] (c) {label}, two processes on this card over gloo (collectives through host memory), fp32, "
              f"dropout {cfg32.dropout}: loss {r0['loss']:.6f} vs meshless {ref_loss:.6f} (|diff| {r0['loss_err']:.2e}); "
              f"grads gathered whole, max_abs_err {r0['max_abs_err']:.3e} (atol {STEP_TOL['atol']}, rtol "
              f"{STEP_TOL['rtol']}); lstm_cell launches per rank {r0['lstm']}, {r1['lstm']} (FMA {r0['lstm_fma']}, "
              f"{r1['lstm_fma']}); luong_attn {r0['luong']}, {r1['luong']}; stored params {r0['param_bytes']}, "
              f"{r1['param_bytes']} B and Adam moments {r0['moment_bytes']}, {r1['moment_bytes']} B per rank vs the "
              f"meshless step's {meshless_bytes[0]} and {meshless_bytes[1]}; step {r0['step_s'] * 1e3:.0f} ms "
              "(host-staged, not a speed figure)")
        if kw.get("use_pipeline"):
            continue
        sharded = r0["param_bytes"] < meshless_bytes[0] and r0["moment_bytes"] < meshless_bytes[1]
        if not sharded:
            fail(f"layouts (c) {label}: rank 0 stores {r0['param_bytes']} B of params, {r0['moment_bytes']} B of "
                 f"moments, not less than the whole tree's {meshless_bytes}")
        if "bf16_lstm" in r0:
            want = L * (M + N)  # each rank: every layer's every step, on its column shard
            for r, rr in enumerate((r0, r1)):
                if rr["bf16_lstm"] != want or rr["bf16_lstm_mma"] != want or rr["bf16_luong"] != 1 \
                        or rr["bf16_luong_routes"]["wgmma"] != 1 or not np.isfinite(rr["bf16_loss"]):
                    fail(f"layouts (c) {label} bf16 rank {r}: lstm_cell {rr['bf16_lstm']} launches "
                         f"({rr['bf16_lstm_mma']} tensor-core), want {want}; luong_attn {rr['bf16_luong']} "
                         f"({rr['bf16_luong_routes']}), want 1 on wgmma; loss {rr['bf16_loss']}")
            if not r0["bf16_loss_err"] <= BF16_TP_LOSS_TOL or not r0["bf16_grad_rel"] <= BF16_TP_GRAD_REL:
                fail(f"layouts (c) {label} bf16: loss |diff| {r0['bf16_loss_err']:.3e} from the meshless bf16 step "
                     f"(bound {BF16_TP_LOSS_TOL}), grad leaf {r0['bf16_grad_leaf']} relative error "
                     f"{r0['bf16_grad_rel']:.3e} (bound {BF16_TP_GRAD_REL})")
            print(f"[layouts] (c) {label} bf16: loss {r0['bf16_loss']:.6f} vs meshless bf16 {ref['bf16_loss']:.6f} "
                  f"(|diff| {r0['bf16_loss_err']:.3e} <= {BF16_TP_LOSS_TOL}); grads gathered whole, largest "
                  f"||diff|| / ||meshless|| {r0['bf16_grad_rel']:.3e} (leaf {r0['bf16_grad_leaf']}, bound "
                  f"{BF16_TP_GRAD_REL}); lstm_cell {r0['bf16_lstm']} + "
                  f"{r1['bf16_lstm']} launches, all on the tensor-core kernel at the column shard (B=64, "
                  f"H_in={cfg32.d_model}, Hs={cfg32.d_model // 2}) = layers x (M + N) a rank; luong_attn 1 a rank "
                  "(wgmma route)")
    print(f"[layouts] (c) both ranks done in {wall:.1f}s")
    bf16 = [r[label] for r in ranks for label, _, _ in LAYOUT_CASES if "bf16_lstm" in r[label]]
    return sum(x["bf16_lstm"] for x in bf16), sum(x["bf16_luong"] for x in bf16)


IF_BF16_STEPS = 4  # phase 8c (a): the meshless input-feeding step through Trainer; the median is over steps 2-4
IF_RANK_LIMIT_S = 600  # phase 8c (b): both ranks, every layout
# phase 8c (b): (label, grid, plan keywords) of the input-feeding layouts on two ranks of the card, every one
# tensor-parallel (the pipelined plan too: its decoder has no backbone to pipeline); the first two also
# take a bf16 step
IF_LAYOUT_CASES = (
    ("model TP 1x2", (1, 2), dict(strategy="model")),
    ("hybrid TP 1x2", (1, 2), dict(strategy="hybrid")),
    ("hybrid pipelined 1x2", (1, 2), dict(strategy="hybrid", use_pipeline=True, micro_batches=HYBRID_MICRO)),
    ("hybrid_opt 1x2 (vocab-parallel head)", (1, 2), dict(strategy="hybrid_opt")),
    ("hybrid_opt 2x1 (FSDP)", (2, 1), dict(strategy="hybrid_opt")),
)
# phase 8c (b)'s bf16 tensor-parallel input-feeding steps against the meshless bf16 step: the loss as
# phase (c)'s (BF16_TP_LOSS_TOL: it read |diff| 0 on MODEL and HYBRID); the grads take phase (c)'s dx
# rounding and, each step, eq. 1-4 on a rank's 32 rows on the "decode" route where the meshless step's 64
# take "wgmma", the difference carried through the recurrence.  The grad bound lies between what the sound
# step reads and what the planted faults below read (PERF.md §6, the input-feeding findings)
BF16_IF_LOSS_TOL = 1e-4
BF16_IF_GRAD_REL = 2e-2  # per leaf, ||grad - meshless|| / ||meshless||
# the fp32 steps of phase 8c (b) are also held to a relative bound per leaf: STEP_TOL's atol is above most of
# a grad leaf's entries at this model's random initialization, so it alone lets a grad that is wrong by a
# tenth of its norm pass
IF_FP32_GRAD_REL = 1e-4
# phase 8c (b)'s planted faults, each one fp32 and one bf16 step of the first layout with methods of its
# ``Sharding`` replaced (:func:`_planted`), read as the sound steps: (name, {method: (method) -> faulty
# method}, whether both the fp32 check and the bf16 bounds must catch it).  The gathered Hc's row blocks in
# the wrong order; Hc's grad dropped (the gather's output detached); eq. 1-4 on all the data shard's rows
# on every model rank, with no gather, which must read as the sound step does: each rank's dHc is its term
# of the sum (the next step's shard cells' dx), eq. 1-4's backward is linear in it, and the reduce-scatter
# of h adds the terms
IF_FAULTS = (
    ("Hc row blocks swapped", {"gather_rows": lambda f: lambda self, t: torch.roll(f(self, t), t.shape[0], 0)},
     True),
    ("Hc grad dropped", {"gather_rows": lambda f: lambda self, t: f(self, t).detach()}, True),
    ("eq. 1-4 on all rows, no gather", {"step_rows": lambda f: lambda self, t: t,
                                        "gather_rows": lambda f: lambda self, t: t}, False),
)


def _if_cell_shapes(cfg, M: int, N: int, Hs: int) -> dict:
    """{("mma", In, Hs): launches} of one input-feeding step's cells: the
    encoder's layer 0 (In = emb) and the layers above (In = h) M times, the
    decoder's layer 0 (In = emb + h) and the layers above N times."""
    E, H, L = cfg.emb_size, cfg.d_model, cfg.num_layers
    want: dict = {}
    for In, n in ((E, M), (H, (L - 1) * (M + N)), (E + H, N)):
        want[("mma", In, Hs)] = want.get(("mma", In, Hs), 0) + n
    return want


def phase_input_feeding(tcfg, device="cuda") -> tuple:
    """Phase 8c: the paper's input-feeding step (HybridNMTIF) at full width:
    Hc_{t-1} joins decoder layer 0's input ([emb; Hc], In 1536), so the
    decoder runs step-major with eq. 1-4 inside its recurrence (not at the
    last step, whose Hc feeds none).  (a) The meshless step: one fp32 step
    on the kernel path against the plain path (dropout 0.3, the encoder's),
    then IF_BF16_STEPS bf16 steps through Trainer, each launching lstm_cell
    layers x (M + N) times, every one on the tensor-core kernel (counted by
    depth), and luong_attn N times (N - 1 per-step calls on 64 rows, one
    over all steps), with the median step time and one profiled step.  (b)
    Two ranks on this card over gloo: one fp32 step of each of
    IF_LAYOUT_CASES against (a)'s fp32 step, then one bf16 step of MODEL and
    HYBRID at 1 x 2 against (a)'s bf16 step on the same batch, each rank's
    launches counted by shape: layers x (M + N) column-shard cells, N - 1
    per-step calls on its 32 rows ("decode") and one over all steps
    ("wgmma"); and IF_FAULTS planted in MODEL 1 x 2.  Returns (lstm_cell
    launches of the bf16 steps, their In=1536 launches (square, shard),
    luong_attn launches by route, the per-step calls' by route), every count
    read from the wrappers' counters."""
    from repro_torch.launch.mesh import spawn_grid

    icfg = dataclasses.replace(tcfg, input_feeding=True)
    cfg32 = dataclasses.replace(icfg, dtype="float32")
    L, E, Hd = cfg32.num_layers, cfg32.emb_size, cfg32.d_model
    params = s2s.init_seq2seq(0, cfg32, device=device)
    batch = _hybrid_batch(cfg32, device)
    M, N = batch["src"].shape[1], batch["tgt_in"].shape[1]
    cell, luong = lstm_ops.lstm_cell_fused, luong_ops.luong_attention_fused
    steps = {}
    for sk in ("cuda", "torch"):
        lstm_ops.reset_launches()
        luong_ops.reset_launches()
        steps[sk] = make_grad_fn(cfg32, ExecutionPlan(stage_kernel=sk))(params, batch, _hybrid_generator(device))
        float(steps[sk][0])
        steps[sk] += ((cell.launches, luong.launches),)
    (lk, _, gk, nk), (lp, _, gp, npl) = steps["cuda"], steps["torch"]
    if nk != (L * (M + N), N) or npl != (0, 0):
        fail(f"input feeding fp32 step: launches (lstm_cell, luong_attn) {nk} on the kernel path, want "
             f"({L * (M + N)}, {N}); {npl} on the plain path, want none")
    dloss = abs(float(lk) - float(lp))
    err, bad = _grad_errors(gk, gp)
    if dloss > STEP_LOSS_TOL or bad is not None:
        fail(f"input feeding fp32 step: kernel path loss {float(lk)} vs plain {float(lp)}, grad leaf {bad} outside "
             f"atol {STEP_TOL['atol']} rtol {STEP_TOL['rtol']} (max abs err {err:.3e})")
    print(f"[input-feeding] (a) fp32 step, dropout {cfg32.dropout}, batch 64 M={M} N={N}, kernel path vs plain path: "
          f"loss {float(lk):.6f} vs {float(lp):.6f} (|diff| {dloss:.2e} <= {STEP_LOSS_TOL}); {len(tree_leaves(gk))} "
          f"grad leaves max_abs_err {err:.3e} (atol {STEP_TOL['atol']}, rtol {STEP_TOL['rtol']}); kernel path "
          f"launches lstm_cell {nk[0]} = layers x (M + N), luong_attn {nk[1]} = N (N - 1 per-step calls, one over "
          "all steps)")
    ref = {"loss": float(lk), "grads": [g.cpu() for g in tree_leaves(gk)]}
    del steps, gk, gp
    bloss, _, bgrads = make_grad_fn(cfg32, ExecutionPlan(stage_kernel="cuda", compute_dtype="bfloat16"))(
        params, batch, _hybrid_generator(device))
    ref.update(bf16_loss=float(bloss), bf16_grads=[g.cpu() for g in tree_leaves(bgrads)])
    del bgrads, params
    torch.cuda.empty_cache()

    it = lambda: MTBatchIterator(SyntheticMTTask(vocab_size=icfg.vocab_size), batch_size=64, seed=3)  # noqa: E731
    trainer = Trainer(icfg, adam(lr=1e-3), it(), plan=ExecutionPlan(stage_kernel="cuda", compute_dtype="bfloat16"),
                      seed=0, device=device)
    twin = it()
    lstm_total = square_1536 = 0
    routes = dict.fromkeys(luong_ops.ROUTES, 0)
    step_routes = dict.fromkeys(luong_ops.ROUTES, 0)
    for step in range(1, IF_BF16_STEPS + 1):
        lstm_ops.reset_launches()
        luong_ops.reset_launches()
        trainer.run(1, log_every=1, log=lambda line: None)
        b = next(twin)
        Mb, Nb, Bb = b["src"].shape[1], b["tgt_in"].shape[1], b["src"].shape[0]
        h = trainer.history[-1]
        cells, heads = dict(cell.launches_by_shape), dict(luong.launches_by_shape)
        want_cells = _if_cell_shapes(icfg, Mb, Nb, Hd)
        want_heads = {("wgmma", Bb, 1): Nb - 1, ("wgmma", Bb, Nb): 1}
        if not (np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])):
            fail(f"input feeding bf16 step {step}: loss {h['loss']} grad norm {h['grad_norm']}")
        if cells != want_cells or heads != want_heads:
            fail(f"input feeding bf16 step {step}: lstm_cell launches by (kernel, In, Hs) {cells}, want {want_cells} "
                 f"(every one on the tensor-core kernel); luong_attn by (route, rows, N) {heads}, want {want_heads}")
        print(f"[input-feeding] (a) bf16 step {step}: loss {h['loss']:.4f} grad_norm {h['grad_norm']:.4f} M={Mb} "
              f"N={Nb} in {h['step_s'] * 1e3:.1f} ms; launches lstm_cell {cell.launches} by (kernel, In, Hs) {cells}, "
              f"luong_attn {luong.launches} by (route, rows, N) {heads}")
        lstm_total += cell.launches
        square_1536 += cells.get(("mma", E + Hd, Hd), 0)
        routes["wgmma"] += luong.launches_by_route["wgmma"]
        step_routes["wgmma"] += heads.get(("wgmma", Bb, 1), 0)
    ms = [x["step_s"] * 1e3 for x in trainer.history[1:]]
    tok_s = sum(x["tokens"] for x in trainer.history[1:]) / sum(x["step_s"] for x in trainer.history[1:])
    print(f"[input-feeding] (a) bf16 over fp32 masters, Adam lr 1e-3, dropout {icfg.dropout}, batch 64: median step "
          f"{float(np.median(ms)):.1f} ms over steps 2-{IF_BF16_STEPS}, {tok_s:.0f} target tok/s ({nvidia_smi_line()}); "
          f"losses {[round(x['loss'], 4) for x in trainer.history]}")
    _profile(lambda: trainer.run(1, log_every=1, log=lambda line: None),
             "one input-feeding training step (meshless, bf16)", top=12)
    del trainer
    torch.cuda.empty_cache()

    with tempfile.TemporaryDirectory(prefix="input-feeding-") as tmp:
        ref_path = os.path.join(tmp, "ref.pt")
        torch.save(ref, ref_path)
        t0 = time.perf_counter()
        ranks = spawn_grid(layouts_rank, 1, 2, args=(cfg32, ref_path, IF_LAYOUT_CASES, True), device="cuda:0",
                           backend="gloo", timeout_s=IF_RANK_LIMIT_S, collective_timeout_s=120.0, threads=0)
        wall = time.perf_counter() - t0
    shard_1536 = 0
    Hs = Hd // 2
    for label, shape, kw in IF_LAYOUT_CASES:
        r0, r1 = ranks[0][label], ranks[1][label]
        if not (r0["tensor_parallel"] and r1["tensor_parallel"]):
            fail(f"input feeding (b) {label}: the plan does not run tensor-parallel")
        if r0["loss_err"] > STEP_LOSS_TOL or r0["bad_leaf"] is not None or r0["grad_rel"] > IF_FP32_GRAD_REL:
            fail(f"input feeding (b) {label}: loss |diff| {r0['loss_err']:.2e}, grad leaf {r0['bad_leaf']} outside "
                 f"tolerance (max abs err {r0['max_abs_err']:.3e}), largest ||diff|| / ||meshless|| "
                 f"{r0['grad_rel']:.3e} (bound {IF_FP32_GRAD_REL})")
        for r, rr in enumerate((r0, r1)):
            if (rr["lstm"], rr["luong"]) != (L * (M + N), N):
                fail(f"input feeding (b) {label} rank {r}: launches lstm_cell {rr['lstm']}, luong_attn {rr['luong']}; "
                     f"want {L * (M + N)}, {N}")
        print(f"[input-feeding] (b) {label}, two processes on this card over gloo (collectives through host memory), "
              f"fp32, dropout {cfg32.dropout}: loss {r0['loss']:.6f} vs meshless {ref['loss']:.6f} (|diff| "
              f"{r0['loss_err']:.2e}); grads gathered whole, max_abs_err {r0['max_abs_err']:.3e} (atol "
              f"{STEP_TOL['atol']}, rtol {STEP_TOL['rtol']}), largest ||diff|| / ||meshless|| {r0['grad_rel']:.3e} "
              f"(bound {IF_FP32_GRAD_REL}); "
              f"launches per rank lstm_cell {r0['lstm']}, {r1['lstm']}, luong_attn {r0['luong']}, {r1['luong']}; "
              f"stored params {r0['param_bytes']}, {r1['param_bytes']} B per rank; step {r0['step_s'] * 1e3:.0f} ms "
              "(host-staged, not a speed figure)")
        if "bf16_lstm" not in r0:
            continue
        rows = 64 // 2 if kw["strategy"] == "hybrid" else 64  # HYBRID's phase boundary: a rank's row block
        want_cells = _if_cell_shapes(cfg32, M, N, Hs)
        want_heads = {("decode", 32, 1): N - 1, ("wgmma", rows, N): 1}
        for r, rr in enumerate((r0, r1)):
            if rr["bf16_lstm_shapes"] != want_cells or rr["bf16_luong_shapes"] != want_heads \
                    or not np.isfinite(rr["bf16_loss"]):
                fail(f"input feeding (b) {label} bf16 rank {r}: lstm_cell launches by (kernel, In, Hs) "
                     f"{rr['bf16_lstm_shapes']}, want {want_cells}; luong_attn by (route, rows, N) "
                     f"{rr['bf16_luong_shapes']}, want {want_heads}; loss {rr['bf16_loss']}")
            lstm_total += rr["bf16_lstm"]
            shard_1536 += rr["bf16_lstm_shapes"].get(("mma", E + Hd, Hs), 0)
            for route in ("decode", "wgmma"):
                routes[route] += rr["bf16_luong_routes"][route]
            step_routes["decode"] += rr["bf16_luong_shapes"].get(("decode", 32, 1), 0)
        if not r0["bf16_loss_err"] <= BF16_IF_LOSS_TOL or not r0["bf16_grad_rel"] <= BF16_IF_GRAD_REL:
            fail(f"input feeding (b) {label} bf16: loss |diff| {r0['bf16_loss_err']:.3e} from the meshless bf16 step "
                 f"(bound {BF16_IF_LOSS_TOL}), grad leaf {r0['bf16_grad_leaf']} relative error "
                 f"{r0['bf16_grad_rel']:.3e} (bound {BF16_IF_GRAD_REL})")
        print(f"[input-feeding] (b) {label} bf16: loss {r0['bf16_loss']:.6f} vs meshless bf16 {ref['bf16_loss']:.6f} "
              f"(|diff| {r0['bf16_loss_err']:.3e} <= {BF16_IF_LOSS_TOL}); grads gathered whole, largest ||diff|| / "
              f"||meshless|| {r0['bf16_grad_rel']:.3e} (leaf {r0['bf16_grad_leaf']}, bound {BF16_IF_GRAD_REL}); "
              f"launches a rank, counted by shape: lstm_cell {r0['bf16_lstm_shapes']}, {r1['bf16_lstm_shapes']} "
              f"(kernel, In, Hs: the tensor-core column shard); luong_attn {r0['bf16_luong_shapes']}, "
              f"{r1['bf16_luong_shapes']} (route, rows, N)")
    faults = ranks[0][IF_LAYOUT_CASES[0][0]]["faults"]
    wrong = []
    for name, _, must_catch in IF_FAULTS:
        f = faults[name]
        fp32_caught = f["loss_err"] > STEP_LOSS_TOL or f["bad_leaf"] is not None or f["grad_rel"] > IF_FP32_GRAD_REL
        bf16_caught = not (f["bf16_loss_err"] <= BF16_IF_LOSS_TOL and f["bf16_grad_rel"] <= BF16_IF_GRAD_REL)
        print(f"[input-feeding] (b) {IF_LAYOUT_CASES[0][0]} with a planted fault, {name}: fp32 loss |diff| "
              f"{f['loss_err']:.3e}, max_abs_err {f['max_abs_err']:.3e}, largest ||diff|| / ||meshless|| "
              f"{f['grad_rel']:.3e} (leaf {f['grad_leaf']}, bound {IF_FP32_GRAD_REL}): "
              f"{'caught' if fp32_caught else 'passes'}; "
              f"bf16 loss |diff| {f['bf16_loss_err']:.3e} (bound {BF16_IF_LOSS_TOL}), largest ||diff|| / ||meshless|| "
              f"{f['bf16_grad_rel']:.3e} (leaf {f['bf16_grad_leaf']}, bound {BF16_IF_GRAD_REL}): "
              f"{'caught' if bf16_caught else 'passes'}")
        if (fp32_caught, bf16_caught) != (must_catch, must_catch):
            wrong.append(f"{name!r}: fp32 caught {fp32_caught}, bf16 caught {bf16_caught}, want {must_catch} for both")
    if wrong:
        fail(f"input feeding (b): planted faults read against the checks: {'; '.join(wrong)}")
    print(f"[input-feeding] (b) both ranks done in {wall:.1f}s")
    return lstm_total, {"square": square_1536, "shard": shard_1536}, routes, step_routes


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


def luong_if_step_timing(route: str, s: dict, flush, runs: int, launches: int) -> dict:
    """One input-feeding step's eq. 1-4 call (N = 1) on ``route``, bf16,
    model scales, L2 flushed (the step's cells stream the decoder's 25 MB of
    bf16 weights between two head calls), beside the plain version and the
    "torch" stage path's bf16 eq. 1-4 (the yardstick)."""
    H, S, mask, wa, wc = luong_inputs(s, torch.bfloat16, seed=6, model_scales=True)
    h = s["h"]
    args = (H, S, mask.to(torch.int32), wa, wc)
    if luong_ops.pick_route(torch.bfloat16, h, s["B"] * s["N"]) != route:
        fail(f"luong_attn at {s}: the wrapper picks {luong_ops.pick_route(torch.bfloat16, h, s['B'] * s['N'])}, "
             f"not {route}")
    plain = lambda: luong_attention_ref(H, S, mask, wa, wc[:h], wc[h:])  # noqa: E731
    t = {"kernel": _median_ms(lambda: luong_ops.luong_attention_fused(*args), runs, flush, True),
         "plain": _median_ms(plain, runs, flush, True),
         "torch": _median_ms(lambda: luong_torch_path(*args), runs, flush, True)}
    err = (luong_ops.luong_attention_fused(*args).float() - plain().float()).abs().max().item()
    bound_ms, bound_by, nbytes, flops = luong_bound_ms(s)
    print(f"[timing] luong_attn, one input-feeding step's call at {s} bf16 on the {route} route, median of {runs} "
          f"runs, L2 flushed: kernel {t['kernel']:.4f} ms, plain {t['plain']:.4f} ms, the torch stage path "
          f"(yardstick, cuBLAS) {t['torch']:.4f} ms; bound {bound_ms:.5f} ms ({bound_by}: {nbytes} B, {flops} FLOP), "
          f"kernel {t['kernel'] / bound_ms:.2f}x its bound; max_abs_err vs plain {err:.3e}; {launches} launches of "
          "per-step calls on this route in the input-feeding bf16 steps")
    return {"shape": dict(s), "launches": launches, "ms": t["kernel"], "plain_ms": t["plain"],
            "torch_path_ms": t["torch"], "bound_ms": bound_ms, "bound_by": bound_by, "max_abs_err": err}


def phase_timing(serve_launches: int, train_launches: int, ticks: int, max_err: float, if_step: dict) -> list:
    """luong_attn, bf16, model scales, L2 flushed (the decode tick streams 100+
    MB of other weights between two head calls, and the training step far
    more), at the serving tick's call on the "decode" route and the training
    step's on the "wgmma" route; beside each, the first kernel (the "fma" route), the plain
    version and the "torch" stage path (the yardstick).  One record per
    route: its launches are those of the main path's run that takes it.
    Then the input-feeding step's per-step call on each route
    (``luong_if_step_timing``; ``if_step``: their launches by route)."""
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
            "input_feeding_step": luong_if_step_timing(
                route, LUONG_IF_BLOCK_SHAPE if route == "decode" else LUONG_IF_STEP_SHAPE, flush, runs, if_step[route]),
        })
    print(f"[timing] luong_attn: {serve_launches} decode-route launches in the serving run ({ticks} decode ticks) "
          f"and the input-feeding ranks' per-step calls, {train_launches} wgmma-route launches in the training "
          "runs (the meshless, hybrid, tensor-parallel and input-feeding bf16 steps); library_ms: none (no "
          "single PyTorch call computes eq. 1-4; the torch stage path above is the yardstick)")
    return records


def _lstm_bound(args, outs) -> tuple:
    """(bound ms, bound_by, bytes, flops) of one cell call: each tensor passed
    read once and each output written once, at their element sizes, against
    the gate products' flops at the bf16 tensor-core peak."""
    x, h = args[0], args[1]
    B, In, Hin, H = x.shape[0], x.shape[1], h.shape[1], outs[0].shape[1]  # H < Hin: a column shard
    nbytes = sum(t.numel() * t.element_size() for t in (*args, *outs))
    flops = 2 * B * (In + Hin) * 4 * H
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / BF16_FLOP_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations"), nbytes, flops


def lstm_shard_timing(flush, runs: int, launches: int, s: dict = LSTM_SHARD_TIMING_SHAPE) -> dict:
    """The column-shard cell at ``s`` (h [64, 1024] whole, 512 units: the
    tensor-parallel layouts' cell on a model axis of 2; In 1024, or 1536 for
    the input-feeding decoder's layer 0) on the model's feed, L2 flushed,
    beside its plain version; no PyTorch call
    computes a column shard (``torch.lstm_cell`` takes c as wide as h), so
    the yardstick is ``torch.lstm_cell`` on the same GEMM: a cell of Hs
    units whose input is [x | h's other units], all bf16."""
    B, In, Hin, Hs = s["B"], s["In"], s["H"], s["Hs"]
    x, h, c, wx, wh, b = _shard_args(lstm_inputs(s, (torch.float32,) * 6, seed=8, model_scales=True), 0, Hs)
    xb = x.bfloat16()
    w = lstm_ops.cast_weights(wx, wh, b, torch.bfloat16)
    kernel = lambda: lstm_ops.lstm_cell_fused(xb, h, c, wx, wh, b, weights=w)  # noqa: E731
    before = lstm_ops.lstm_cell_fused.mma_launches
    got = kernel()
    if lstm_ops.lstm_cell_fused.mma_launches != before + 1:
        fail("the timed column shard did not take the tensor-core kernel")
    plain_args = (xb, h, c, wx.bfloat16(), wh.bfloat16(), b.bfloat16())
    err = max((g - v).abs().max().item() for g, v in zip(got, lstm_cell_ref(*plain_args)))
    t = {"kernel": _median_ms(kernel, runs, flush, True),
         "plain": _median_ms(lambda: lstm_cell_ref(*plain_args), runs, flush, True)}
    # the yardstick: the same [B, In + Hin] x [In + Hin, 4 Hs] GEMM and update, as a cell of Hs units
    x2 = torch.cat([xb, h[:, Hs:].bfloat16()], dim=1)
    w2 = torch.cat([wx, wh[Hs:]], dim=0)
    lib_args = (x2, (h[:, :Hs].bfloat16(), c.bfloat16()), w2.reshape(-1, 4 * Hs).t().contiguous().bfloat16(),
                wh[:Hs].reshape(Hs, 4 * Hs).t().contiguous().bfloat16(), b.reshape(-1).bfloat16(),
                torch.zeros(4 * Hs, dtype=torch.bfloat16, device="cuda"))
    t["yardstick"] = _median_ms(lambda: torch.lstm_cell(*lib_args), runs, flush, True)
    bound_ms, bound_by, nbytes, flops = _lstm_bound((xb, h, c, w.packed, w.b), got)
    print(f"[timing] lstm_cell column shard at B={B} In={In} H_in={Hin} Hs={Hs} on the model's feed, median of "
          f"{runs} runs, L2 flushed: {t['kernel']:.4f} ms; bound {bound_ms * 1e3:.2f} us ({bound_by}: {nbytes} B at "
          f"3.35 TB/s, {flops} FLOP at 989 TFLOP/s), {t['kernel'] / bound_ms:.2f}x its bound; plain version "
          f"{t['plain']:.4f} ms; yardstick torch.lstm_cell on the same GEMM (bf16, not a column shard) "
          f"{t['yardstick']:.4f} ms; max_abs_err vs plain {err:.3e}; {launches} column-shard launches at this "
          "shape in the tensor-parallel bf16 steps")
    return {"shape": dict(s), "ms": t["kernel"], "plain_ms": t["plain"], "bound_ms": bound_ms, "bound_by": bound_by,
            "yardstick_ms": t["yardstick"], "launches": launches, "max_abs_err": err}


def phase_lstm_timing(launches: int, max_err: float, shard_launches: int, if_launches: dict) -> dict:
    """The lstm_cell kernel at the training step's shape on the model's feed
    (x bf16, the weights cast and packed once as a layer call does, h and c
    fp32: the tensor-core kernel), with the L2 flushed and warm (a layer's
    16.8 MB of bf16 weights stay in the 50 MB L2 between timesteps), at
    In=512, and at the input-feeding decoder's layer 0 (In=1536); beside it
    the old fp32-masters feed (the FMA kernel), the plain version on the
    model's feed and ``torch.lstm_cell`` in bf16 (all inputs bf16, its
    weights in PyTorch's [4H, in] layout) as the library yardstick; then the
    column shards at In 1024 and 1536.  ``if_launches``: the input-feeding
    bf16 steps' launches at In=1536, square and column shard."""
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    runs = 40
    times = {}
    for s in (LSTM_TIMING_SHAPE, LSTM_MODEL_SHAPES[0], LSTM_IF_TIMING_SHAPE):
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
        if s is LSTM_MODEL_SHAPES[0]:
            continue
        lib_args = (xb, (h.bfloat16(), c.bfloat16()), wx.reshape(In, 4 * H).t().contiguous().bfloat16(),
                    wh.reshape(H, 4 * H).t().contiguous().bfloat16(), b.reshape(-1).bfloat16(),
                    torch.zeros(4 * H, dtype=torch.bfloat16, device="cuda"))
        t["plain"] = _median_ms(lambda: lstm_cell_ref(*plain_args), runs, flush, True)
        t["library"] = _median_ms(lambda: torch.lstm_cell(*lib_args), runs, flush, True)
        if s is LSTM_IF_TIMING_SHAPE:
            print(f"[timing] lstm_cell at B={B} In={In} H={H} (the input-feeding decoder's layer 0), L2 flushed: "
                  f"plain version {t['plain']:.4f} ms; torch.lstm_cell (bf16) {t['library']:.4f} ms; "
                  f"{if_launches['square']} launches at this shape in the meshless input-feeding bf16 steps")
            if_square = {"shape": dict(s), "launches": if_launches["square"], "ms": t["kernel"],
                         "ms_warm": t["kernel_warm"], "plain_ms": t["plain"], "bound_ms": bound_ms,
                         "bound_by": bound_by, "library_ms": t["library"]}
        else:
            fp32_feed = lambda: lstm_ops.lstm_cell_fused(xb, h, c, wx, wh, b)  # noqa: E731
            t["fp32_masters"] = _median_ms(fp32_feed, runs, flush, True)
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
        "column_shard": lstm_shard_timing(flush, runs, shard_launches),
        "input_feeding": {"square": if_square,
                          "column_shard": lstm_shard_timing(flush, runs, if_launches["shard"],
                                                            LSTM_IF_SHARD_TIMING_SHAPE)},
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
    kernel, "mma", and SDPA with the causal band of the window as a boolean
    ``attn_mask``, which computes the same function)."""
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    rows = {}
    for label, s, seed in (("a", FLASH_PREFILL_SHAPE, 9), ("moe", FLASH_MOE_SHAPE, 11), ("b", FLASH_LONG_SHAPE, 10)):
        B, S, KV, G, D = s["B"], s["S"], s["KV"], s["G"], s["D"]
        q, k, v = flash_inputs(s, torch.bfloat16, seed=seed)
        kw = dict(causal=True, window=s["window"], group=G)
        q4, k4, v4 = q.view(B, KV * G, S, D), k.view(B, KV, S, D), v.view(B, KV, S, D)  # head h reads kv head h // G
        kernel = lambda: flash_ops.flash_attention_fused(q, k, v, **kw)  # noqa: E731
        mma = lambda: flash_ops.flash_attention_fused(q, k, v, route="mma", **kw)  # noqa: E731
        if label == "b":  # the window binds: SDPA with a boolean causal band as its mask computes the same function
            pos = torch.arange(S, device="cuda")
            band = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - s["window"])
            library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                q4, k4, v4, attn_mask=band, enable_gqa=True)
        else:
            library = lambda: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
                q4, k4, v4, is_causal=True, enable_gqa=True)
        t = {"kernel": _median_ms(kernel, 20, flush, True), "mma": _median_ms(mma, 20, flush, True)}
        got = kernel()
        max_err = max(max_err, _flash_bf16_check(got, q, k, v, kw, f"({label}) timing inputs")[0])
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
              + f", scaled_dot_product_attention{' with the causal band as a boolean mask' if label == 'b' else ''} "
              f"{t['library']:.4f} ms (kernel vs sdpa max_abs_err {t['lib_err']:.3e})"
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
        "mma_route_ms": t["mma"], "window_ms": rows["b"][0]["kernel"], "window_bound_ms": rows["b"][1],
        "window_library_ms": rows["b"][0]["library"],
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
    lstm_ops.reset_launches()
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


# ---------------------------------------------------------------------------
# LM training (phases 19-22)
# ---------------------------------------------------------------------------


def _cut_layers(params: dict, layers: int) -> dict:
    """The LM tree with its stacked [G, ...] blocks cut to the first ``layers``
    (views of ``params``)."""
    out = dict(params)
    out["blocks"] = [tree_map(lambda a: a[:layers], blk) for blk in params["blocks"]]
    return out


def _digest(t: torch.Tensor) -> str:
    """The bytes of ``t`` hashed on the host: equal digests are equal bits."""
    return hashlib.blake2b(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes(),
                           digest_size=16).hexdigest()


def _check_recompute_identical(trainer, cfg, label: str) -> str:
    """One more training step with every flash_attn and moe_gemm kernel
    output fingerprinted: the remat recompute of layer l (in the backward,
    last layer first) must give the forward's bits, i.e. see the same
    dispatch and the same kernel on the same inputs."""
    L = cfg.num_layers
    seen = {"flash_attn": [], "moe_gemm": []}

    def flash_rec(kernel, q, k, v, **kw):
        out = kernel(q, k, v, **kw)
        seen["flash_attn"].append(_digest(out))
        return out

    def moe_rec(kernel, *args):
        out = kernel(*args)
        seen["moe_gemm"].append(_digest(out))
        return out

    with _flash_wrapped(flash_rec), _moe_wrapped(moe_rec):
        trainer.run(1, log_every=1, log=lambda line: None)
    want = {"flash_attn": 2 * L, "moe_gemm": 2 * L if cfg.moe is not None else 0}
    for name, digests in seen.items():
        if len(digests) != want[name]:
            fail(f"({label}) the fingerprinted step made {len(digests)} {name} calls, not {want[name]}")
        if digests[:len(digests) // 2] != digests[len(digests) // 2:][::-1]:
            fail(f"({label}) the remat recompute of some layer's {name} call differs from its forward's bits")
    return (f"{want['flash_attn']} flash_attn and {want['moe_gemm']} moe_gemm outputs in a step, each recompute's "
            "bits equal to its forward's")


def phase_lm_train(cfg, label: str, params_box: list, cut_note: str) -> dict:
    """(19 / 20) The slice's main path: Trainer on the LM at full width, bf16
    over fp32 masters, Adam 1e-3, clip 5.0, remat on, LM_TRAIN_STEPS steps of
    LM_TRAIN_BATCH x LM_TRAIN_SEQ tokens from ``LMBatchIterator(SyntheticLMTask(
    V, branching=16))``; each step must launch flash_attn twice per layer (the
    forward and the remat recompute), all on the "wgmma" route, and an MoE
    model's moe_gemm likewise.  Then a step that checks the recompute's bits
    and a step under torch.profiler.  ``params_box`` holds the fp32 masters
    (the trainer copies them; the box is emptied so the caller's copy can go).
    Returns the launch counts and the step's numbers."""
    L, moe = cfg.num_layers, cfg.moe is not None
    it = LMBatchIterator(SyntheticLMTask(cfg.vocab_size, branching=16), LM_TRAIN_BATCH, LM_TRAIN_SEQ, seed=0)
    t0 = time.perf_counter()
    batches = [next(it) for _ in range(LM_TRAIN_STEPS + 2)]  # made before the steps: set-up, not step time
    make_s = (time.perf_counter() - t0) / len(batches)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    trainer = Trainer(cfg, adam(lr=1e-3), iter(batches), plan=ExecutionPlan(stage_kernel="cuda"),
                      params=params_box.pop(), clip_norm=5.0, seed=0, device="cuda")
    torch.cuda.empty_cache()
    state = trainer.state
    n = sum(p.numel() for p in tree_leaves(state.params))
    state_bytes = sum(t.numel() * t.element_size() for t in tree_leaves((state.params, state.opt_state.m,
                                                                          state.opt_state.v)))
    print(f"[lm-train] ({label}) {cfg.name}: {L} layers{cut_note}, d={cfg.d_model}, V={cfg.vocab_size}: {n} "
          f"parameters; training state at 16 B a parameter {16 * n / 1e9:.2f} GB (fp32 masters and Adam m, v "
          f"resident: {state_bytes / 1e9:.2f} GB; fp32 grads in a step); batches {LM_TRAIN_BATCH} x "
          f"{LM_TRAIN_SEQ} made in {make_s * 1e3:.0f} ms each on the host before the steps; {cfg.dtype} compute, "
          "remat on, kernel path")
    totals = {"flash_attn": 0, "moe_gemm": 0}
    for step in range(1, LM_TRAIN_STEPS + 1):
        _reset_launches()
        trainer.run(1, log_every=1, log=lambda line: None)
        h = trainer.history[-1]
        nf, wf = flash_ops.flash_attention_fused.launches, flash_ops.flash_attention_fused.launches_by_route["wgmma"]
        nm, wm = moe_ops.moe_gemm_fused.launches, moe_ops.moe_gemm_fused.launches_by_route["wgmma"]
        if not (np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"])) or (moe and not np.isfinite(h["moe_aux"])):
            fail(f"({label}) training step {step}: loss {h['loss']} grad norm {h['grad_norm']} aux {h.get('moe_aux')}")
        if nf != 2 * L or wf != nf:
            fail(f"({label}) training step {step}: flash_attn launches {nf} (wgmma route {wf}) != 2 x {L} layers "
                 "(forward and remat recompute), all on wgmma")
        if (nm, wm) != ((2 * L, 2 * L) if moe else (0, 0)):
            fail(f"({label}) training step {step}: moe_gemm launches {nm} (wgmma route {wm}), want "
                 f"{2 * L if moe else 0} all on wgmma")
        totals["flash_attn"] += nf
        totals["moe_gemm"] += nm
        aux = f" aux {h['moe_aux']:.4f}" if moe else ""
        print(f"[lm-train] ({label}) step {step}: loss {h['loss']:.4f}{aux} grad_norm {h['grad_norm']:.4f} "
              f"{h['tokens']:.0f} target tokens in {h['step_s'] * 1e3:.1f} ms; launches flash_attn {nf} (wgmma "
              f"{wf}) moe_gemm {nm} (wgmma {wm})")
    steady = trainer.history[2:]
    step_ms = float(np.median([h["step_s"] for h in steady])) * 1e3
    tok_s = sum(h["tokens"] for h in steady) / sum(h["step_s"] for h in steady)
    recompute = _check_recompute_identical(trainer, cfg, label)
    events = _profile(lambda: trainer.run(1, log_every=1, log=lambda line: None),
                      f"({label}) one {cfg.name} training step", top=18)
    device_ms = sum(e.self_device_time_total for e in events) / 1e3
    busy = device_ms / step_ms  # the profiled step's device time against the unprofiled median step
    peak = torch.cuda.max_memory_allocated()
    if int(trainer.state.opt_state.step) != LM_TRAIN_STEPS + 2:
        fail(f"({label}) the optimizer did not take every step")
    print(f"[lm-train] ({label}) {cfg.name}: median step {step_ms:.1f} ms over steps 3-{LM_TRAIN_STEPS}, "
          f"{tok_s:.0f} target tok/s; {device_ms:.1f} ms of device time in a profiled step, {100 * busy:.1f}% of "
          f"the median step (device busy share); peak "
          f"torch.cuda.max_memory_allocated {peak / 1e9:.2f} GB; {recompute}; losses "
          f"{[round(h['loss'], 4) for h in trainer.history]}; card {nvidia_smi_line()}")
    del trainer, state
    torch.cuda.empty_cache()
    return {"flash_attn": totals["flash_attn"], "moe_gemm": totals["moe_gemm"], "step_ms": step_ms, "tok_s": tok_s,
            "device_ms": device_ms, "busy": busy, "peak_bytes": peak}


def phase_lm_step_paths(cfg, params, layers: int, label: str):
    """(21) One fp32 training step of the LM, its depth cut to ``layers``, on
    the kernel path (flash_attn and moe_gemm: their fp32 kernels forward,
    the plain recompute backward) and on the plain path (chunked_attention,
    expert_ffn) on the same weights and batch: the loss within
    LM_STEP_LOSS_TOL and every grad leaf within LM_STEP_GRAD_REL of its norm."""
    cfg32 = dataclasses.replace(cfg, dtype="float32", num_layers=layers)
    cut = _cut_layers(params, layers)
    it = LMBatchIterator(SyntheticLMTask(cfg.vocab_size, branching=16), LM_PATHS_BATCH, LM_TRAIN_SEQ, seed=1)
    batch = batch_to_device(next(it), "cuda")
    out = {}
    for sk in ("cuda", "torch"):
        loss, extras, grads = make_grad_fn(cfg32, ExecutionPlan(stage_kernel=sk))(cut, batch)
        out[sk] = (float(loss), float(extras["aux"]), grads)
    (lk, ak, gk), (lp, ap, gp) = out["cuda"], out["torch"]
    rels = [_rel_l2(a, b) for a, b in zip(tree_leaves(gk), tree_leaves(gp))]
    worst = int(np.argmax(rels))
    if abs(lk - lp) > LM_STEP_LOSS_TOL or not max(rels) <= LM_STEP_GRAD_REL:
        fail(f"({label}) fp32 LM step, kernel path vs plain path: loss {lk} vs {lp}, worst grad leaf {worst} "
             f"relative L2 {rels[worst]:.3e} (bound {LM_STEP_GRAD_REL})")
    aux = f", aux {ak:.6f} vs {ap:.6f}" if cfg.moe is not None else ""
    print(f"[lm-paths] ({label}) {cfg.name} fp32 step at {layers} layers, {LM_PATHS_BATCH} x {LM_TRAIN_SEQ}: loss "
          f"kernel path {lk:.6f} vs plain path {lp:.6f} (|diff| {abs(lk - lp):.2e} <= {LM_STEP_LOSS_TOL}){aux}; "
          f"{len(rels)} grad leaves, worst relative L2 {rels[worst]:.3e} (leaf {worst}; bound {LM_STEP_GRAD_REL})")
    del out, gk, gp
    torch.cuda.empty_cache()


def _grads_of(fn, ins, cot):
    """(output, grads of ``fn(*ins)`` with cotangent ``cot``) through autograd."""
    live = [t.detach().requires_grad_() for t in ins]
    out = fn(*live)
    return out, torch.autograd.grad(out, live, cot)


def _timed_backward_ms(fn, ins, cot, runs: int = 5) -> tuple:
    """Medians of the backward alone of ``fn(*ins)``: (device ms between two
    CUDA events, with the device spinning before the first while the host
    enqueues the backward, so host time is hidden; host ms from the call to
    its end on the device, without the spin)."""
    dev, host = [], []
    for i in range(runs + 2):
        for hide in (True, False):
            live = [t.detach().requires_grad_() for t in ins]
            out = fn(*live)
            torch.cuda.synchronize()
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            if hide:
                torch.cuda._sleep(BACKWARD_SPIN_CYCLES)
            t0 = time.perf_counter()
            start.record()
            torch.autograd.grad(out, live, cot)
            end.record()
            end.synchronize()
            if i >= 2:
                (dev if hide else host).append(start.elapsed_time(end) if hide else (time.perf_counter() - t0) * 1e3)
    return float(np.median(dev)), float(np.median(host))


@contextlib.contextmanager
def _replaced(obj, name: str, value):
    """``obj.name`` replaced by ``value`` for the duration: a planted fault."""
    old = vars(obj)[name]  # the attribute itself (a class's staticmethod as it is)
    setattr(obj, name, value)
    try:
        yield
    finally:
        setattr(obj, name, old)


def _backward_rel(got: tuple, want: tuple) -> float:
    """The worst relative L2 error over the grads (inf if any is not finite)."""
    if not all(torch.isfinite(g).all().item() for g in got):
        return float("inf")
    return max(_rel_l2(g, w) for g, w in zip(got, want))


def phase_lm_backward():
    """(22) Each new backward alone at the training calls' shapes, fp32 and
    bf16: the grads through the wrapper's ``autograd.Function`` (the kernel
    forward, the plain recompute backward) against autograd through the
    plain version on the same inputs, within BACKWARD_REL per grad; a planted
    fault in each must miss that bound: dk dropped in flash_attn's backward,
    and moe_gemm's backward recomputed without ``rows`` (the garbage x holds
    past them leaks into the grads).  Then the backward's device time per
    layer in bf16, beside scaled_dot_product_attention's backward (a
    yardstick, used nowhere in the port).  Returns {kernel: backward ms}."""
    out = {}
    sound_backward = flash_ops._FlashAttention.backward

    def drop_dk(ctx, do):
        g = list(sound_backward(ctx, do))
        g[1] = torch.zeros_like(g[1])
        return tuple(g)

    for label, s in (("dense", FLASH_TRAIN_SHAPE), ("moe", FLASH_MOE_TRAIN_SHAPE)):
        kw = dict(causal=True, window=None, group=s["G"])
        for dt in (torch.float32, torch.bfloat16):
            ins = flash_inputs(s, dt, seed=21)
            cot = torch.randn_like(ins[0])
            kernel = lambda q, k, v: flash_ops.flash_attention_fused(q, k, v, **kw)  # noqa: E731
            block = dict(block_q=flash_ops.BACKWARD_BLOCK, block_kv=flash_ops.BACKWARD_BLOCK)
            _, want = _grads_of(lambda q, k, v: flash_attention_plain(q, k, v, **kw, **block), ins, cot)
            _, got = _grads_of(kernel, ins, cot)
            rel = _backward_rel(got, want)
            if not rel <= BACKWARD_REL or any(g.dtype != dt for g in got):
                fail(f"flash_attn backward ({label}, {dt}): relative L2 {rel:.3e} against autograd through the plain "
                     f"version (bound {BACKWARD_REL}), grads {[g.dtype for g in got]}")
            with _replaced(flash_ops._FlashAttention, "backward", staticmethod(drop_dk)):
                frel = _backward_rel(_grads_of(kernel, ins, cot)[1], want)
            if frel <= BACKWARD_REL:
                fail(f"control: flash_attn backward with dk dropped passes the bound ({frel:.3e})")
            print(f"[lm-backward] flash_attn ({label}) q {tuple(ins[0].shape)} k/v {tuple(ins[1].shape)} G={s['G']} "
                  f"causal {dt}: grads vs autograd through the plain version, worst relative L2 {rel:.3e} (bound "
                  f"{BACKWARD_REL}); control with dk dropped {frel:.3e} (caught)")
        q, k, v = flash_inputs(s, torch.bfloat16, seed=22)
        cot = torch.randn_like(q)
        B, S, KV, G, D = s["B"], s["S"], s["KV"], s["G"], s["D"]
        sdpa = lambda q_, k_, v_: torch.nn.functional.scaled_dot_product_attention(  # noqa: E731
            q_.view(B, KV * G, S, D), k_.view(B, KV, S, D), v_.view(B, KV, S, D), is_causal=True, enable_gqa=True)
        t_fn, h_fn = _timed_backward_ms(lambda q_, k_, v_: flash_ops.flash_attention_fused(q_, k_, v_, **kw),
                                        (q, k, v), cot)
        t_sdpa, _ = _timed_backward_ms(sdpa, (q, k, v), cot.view(B, KV * G, S, D))
        out[f"flash_attn_{label}"] = t_fn
        print(f"[lm-backward] flash_attn ({label}) bf16 backward per layer (the plain version's fp32 recompute and "
              f"its autograd): {t_fn:.3f} ms of device time, {h_fn:.3f} ms from the call to its end (host enqueue "
              f"included), medians of 5; scaled_dot_product_attention's backward at the same shape (yardstick) "
              f"{t_sdpa:.3f} ms of device time")
    s = MOE_PREFILL_SHAPE
    for dt in (torch.float32, torch.bfloat16):
        x, w1, wg, w2 = moe_inputs(s, dt, seed=23)
        rows = moe_rows(x, seed=23)  # NaN and 1e4 planted past rows[e]
        cot = torch.randn_like(x)
        kernel = lambda x_, a, b, c: moe_ops.moe_gemm_fused(x_, a, b, c, rows)  # noqa: E731
        _, want = _grads_of(lambda x_, a, b, c: moe_gemm_plain(x_, a, b, c, rows), (x, w1, wg, w2), cot)
        _, got = _grads_of(kernel, (x, w1, wg, w2), cot)
        rel = _backward_rel(got, want)
        dead = torch.arange(s["C"], device="cuda")[None, :] >= rows[:, None]
        if not rel <= BACKWARD_REL or torch.count_nonzero(got[0][dead]).item():
            fail(f"moe_gemm backward ({dt}): relative L2 {rel:.3e} against autograd through the plain version "
                 f"(bound {BACKWARD_REL}), or dx past rows[e] not zero")
        plain = moe_ops.moe_gemm_plain
        with _replaced(moe_ops, "moe_gemm_plain", lambda x_, a, b, c, rows_=None: plain(x_, a, b, c, None)):
            frel = _backward_rel(_grads_of(kernel, (x, w1, wg, w2), cot)[1], want)
        if frel <= BACKWARD_REL:
            fail(f"control: moe_gemm backward with rows ignored passes the bound ({frel:.3e})")
        print(f"[lm-backward] moe_gemm x {tuple(x.shape)} F={s['F']} {dt} with rows ({int(rows.sum())} rows hold a "
              f"slot; NaN and 1e4 past them): dx, dw1, dwg, dw2 vs autograd through the plain version, worst relative "
              f"L2 {rel:.3e} (bound {BACKWARD_REL}), dx past rows exactly zero; control with rows ignored in the "
              f"backward {frel:.3e} (caught)")
    x, w1, wg, w2 = moe_inputs(s, torch.bfloat16, seed=24)
    rows = torch.full((s["E"],), s["C"] - 1, dtype=torch.int32, device="cuda")
    out["moe_gemm"], host_ms = _timed_backward_ms(lambda x_, a, b, c: moe_ops.moe_gemm_fused(x_, a, b, c, rows),
                                                  (x, w1, wg, w2), torch.randn_like(x))
    print(f"[lm-backward] moe_gemm bf16 backward per layer at [{s['E']}, {s['C']}, {s['d']}] x {s['F']} (the plain "
          f"version's fp32 recompute and its autograd): {out['moe_gemm']:.3f} ms of device time, {host_ms:.3f} ms from "
          "the call to its end, medians of 5")
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# LM training on the grid (phase 23)
# ---------------------------------------------------------------------------

GRID_DENSE_LAYERS = 8  # qwen3-1.7b cut to 8 of 28 layers for (a)'s fp32 comparisons
GRID_MOE_LAYERS = 4  # qwen3-moe-30b-a3b cut to 4 of 48 in (a), as phase 21's fp32 comparison
# (b): two ranks on one card, every collective staged through host memory; the embedding and head (311 M
# parameters each) cost as much as 6 dense layers, so the depth is cut to 2 for both models
GRID_DENSE_RANK_LAYERS = 2
GRID_MOE_RANK_LAYERS = 2  # the MoE's two ranks hold the whole model under DATA, params and grads in fp32
GRID_BATCH = 2  # x LM_TRAIN_SEQ tokens, the fp32 comparisons' batch (phase 21's)
GRID_BF16_STEPS = 4  # (a): full-depth qwen3-1.7b on HYBRID through Trainer; the median is over steps 2-4
# the expert-parallel layouts' fp32 comparisons: capacity factor E / k, at which no slot can drop on any path
# (the global capacity is at least the token count, and so are Cs and Ce on every rank), at 2 x GRID_EP_SEQ
# tokens: the [64, 4097, 2048] fp32 expert buffer of a rank and its backward fit two ranks on the card
GRID_EP_SEQ = 1024
GRID_TIGHT_CF = 1.0  # DATA's fp32 comparison: slots dropped (the global dispatch drops them as the meshless step)
GRID_BF16_LOSS_TOL = 0.03  # bf16 steps' loss against the meshless bf16 step's (the repo's bf16 loss bound)
# the dense model's bf16 grads against the meshless bf16 step's, per leaf ||diff|| / ||meshless||: the
# tensor-parallel partial sums round differently from one bf16 product (tests/test_torch_lm_train.py's 0.1)
GRID_BF16_GRAD_REL = 0.1
GRID_RANK_LIMIT_S = 600  # (b): both ranks, every layout
GRID_LAYOUTS = ("data", "model", "hybrid", "hybrid_opt")
# (b): (label, grid, strategy) on two ranks of the card
GRID_RANK_LAYOUTS = (("data 2x1", (2, 1), "data"), ("model 1x2", (1, 2), "model"), ("hybrid 1x2", (1, 2), "hybrid"),
                     ("hybrid_opt 1x2", (1, 2), "hybrid_opt"), ("hybrid_opt 2x1", (2, 1), "hybrid_opt"))


def _own_dispatch(ids, m, grid):
    """Planted fault (i): DATA dispatching each rank's slots at its own
    capacity and positions."""
    C = moe_model._capacity(ids.shape[0], m.num_experts, m.capacity_factor)
    dest, keep, rows = moe_model._dispatch(ids, m.num_experts, C)
    return dest, keep, rows, C


def _product_then_mean(stats, m, grid, loss_axis):
    """Planted fault (ii): the load-balance statistics multiplied on each
    rank, the products averaged over the grid."""
    return stg.grid_mean(moe_model.aux_from_stats(stats, m), grid, "all", loss_axis)


def _partial_unsummed(x, grid, axis):
    """Planted fault (iii): a row-parallel partial output not summed over ``model``."""
    return x


# (fault, model, layout): each must make its layout miss the meshless fp32 step
GRID_FAULTS = (("own capacity", "moe", "data 2x1", ("models.moe", "_global_dispatch", _own_dispatch)),
               ("product before mean", "moe", "model 1x2", ("models.moe", "_grid_aux", _product_then_mean)),
               ("partial not summed", "dense", "model 1x2", ("core.strategy", "sum_from_model", _partial_unsummed)))


class _DeviceInitializer(Initializer):
    """The port's initializer (its per-path seeds and scales) drawing on the
    card: the values differ from the host draw's, and are the same in every
    process on the card; a full-width model draws in milliseconds, not the
    tens of seconds the host takes."""

    def _draw(self, path: str, shape) -> torch.Tensor:
        g = torch.Generator(device=self.device)
        g.manual_seed(self._gen(path).initial_seed())
        return torch.randn(shape, generator=g, device=self.device)

    def normal(self, path, shape, scale=None):
        if scale is None:
            scale = 1.0 / np.sqrt(max(shape[-2] if len(shape) >= 2 else shape[-1], 1))
        return self._place(scale * self._draw(path, shape))

    def embedding(self, path, shape, scale=0.02):
        return self._place(scale * self._draw(path, shape))


def _grid_params(cfg, device) -> dict:
    """``init_lm(0, cfg)``'s tree, drawn on the card (:class:`_DeviceInitializer`)."""
    with _replaced(tfm, "Initializer", _DeviceInitializer):
        return tfm.init_lm(0, cfg, device=device)


def _grid_batch(cfg, device, batch: int = GRID_BATCH, seed: int = 1, seq=None) -> dict:
    return batch_to_device(next(LMBatchIterator(SyntheticLMTask(cfg.vocab_size, branching=16), batch,
                                                seq or LM_TRAIN_SEQ, seed=seed)), device)


def _ample_cf(cfg) -> float:
    """The capacity factor E / k: every capacity of the global and the
    expert-parallel dispatch is then at least the tokens that could fill it."""
    return cfg.moe.num_experts / cfg.moe.top_k


def _grid_config(name: str, layers: int, cf=None, dtype: str = "float32"):
    cfg = dataclasses.replace(get_config(name), num_layers=layers, dtype=dtype)
    return cfg if cf is None else dataclasses.replace(cfg, moe=dataclasses.replace(cfg.moe, capacity_factor=cf))


def _grid_step(cfg, plan, params, batch):
    """One step of ``make_grad_fn`` on this rank's blocks of ``params``:
    (loss, aux, this rank's blocks of the grads)."""
    mine = plan.shard_params(params, cfg)
    loss, extras, grads = make_grad_fn(cfg, plan)(mine, batch)
    del mine
    return float(loss), float(extras["aux"]), grads


def _block_rel_errors(plan, cfg, grads, want) -> tuple:
    """:func:`_grad_rel_errors` of this rank's blocks of the grads against
    the same blocks of the whole tree ``want``, with no gather of the grads
    (gloo stages every byte through host memory): each leaf's two squared
    norms summed over the ranks, a rank's share of a leaf that some axes do
    not shard divided by their ranks (one all-reduce of two numbers a leaf).
    The same on every rank; every rank must call it."""
    grid = plan.mesh
    terms = []
    for g, w, placed in zip(tree_leaves(grads), tree_leaves(plan.shard_params(want, cfg)),
                            _placed_leaves(want, plan.placement(cfg))):
        copies = grid.world // math.prod(grid.size(a) for a in stg.leaf_axes(placed))
        terms.append(torch.stack([(g.double() - w.double()).square().sum(), w.double().square().sum()]) / copies)
    sums = torch.stack(terms)
    grid.all_reduce(sums).wait()
    rel = (sums[:, 0].sqrt() / sums[:, 1].sqrt().clamp(min=1e-30)).tolist()
    i = int(np.argmax(rel))
    return rel[i], i


def _expected_calls(cfg, shape: tuple, strategy: str, batch: int) -> dict:
    """The shapes of one rank's flash_attn (q and k/v, kernel layout) and
    moe_gemm (x) calls in a bf16 step of ``cfg`` on a grid of ``shape``."""
    D, M = shape
    tp = strategy != "data" and (M > 1 or strategy == "hybrid_opt")
    B = batch // (D * M if strategy == "data" else D)
    H, KV = cfg.num_heads // (M if tp else 1), cfg.num_kv_heads // (M if tp and cfg.num_kv_heads % M == 0 else 1)
    if tp and cfg.num_kv_heads % M:
        KV = 1
    S = LM_TRAIN_SEQ
    out = {"q": (B * H, S, cfg.head_dim), "kv": (B * KV, S, cfg.head_dim), "rows": B, "heads": (H, KV)}
    if cfg.moe is not None:
        m, T, cap = cfg.moe, B * S, moe_model._capacity
        if strategy == "data":
            C = min(cap(T * m.top_k * D * M, m.num_experts, m.capacity_factor), T * m.top_k)
            out["x"] = (m.num_experts, C, cfg.d_model)
        else:
            Cs = cap(T // M * m.top_k, M, m.capacity_factor)
            out["x"] = (m.num_experts // M, cap(M * Cs, m.num_experts // M, m.capacity_factor), cfg.d_model)
    return out


def lm_grid_rank(grid) -> dict:
    """Phase 23 (b) on one of two ranks on the card (gloo, every collective
    through host memory).  For each model (qwen3-1.7b at GRID_DENSE_RANK_LAYERS,
    qwen3-moe-30b-a3b at GRID_MOE_RANK_LAYERS, full width, weights from
    :func:`_grid_params`): each rank takes the meshless fp32 step; each of
    GRID_RANK_LAYOUTS takes one fp32 step on a grid of its shape over these
    ranks, each rank's blocks of the grads held against the same blocks of
    the meshless step's (:func:`_block_rel_errors`; DATA at GRID_TIGHT_CF,
    the expert-parallel layouts at :func:`_ample_cf` on GRID_BATCH x
    GRID_EP_SEQ tokens); GRID_FAULTS the same with a fault planted; then one
    bf16 step per layout at the config's capacity factor, its flash_attn and
    moe_gemm calls recorded (route, shape, rows) and the first of each held
    against its plain version, its loss (and the dense model's grads)
    against the meshless bf16 step's.  Returns each rank's numbers."""
    from repro_torch.launch.mesh import ProcessGrid

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    grids = {grid.shape: grid}
    dev = grid.device
    out = {}

    def on(shape):
        if shape not in grids:
            grids[shape] = ProcessGrid(*shape, device=dev, timeout_s=grid.timeout.total_seconds())
        return grids[shape]

    def compare(res, ref, loss, aux, grads, plan, cfg):
        rel, leaf = _block_rel_errors(plan, cfg, grads, ref[2])
        torch.cuda.empty_cache()
        res.update(loss=loss, loss_err=abs(loss - ref[0]), aux=aux, aux_err=abs(aux - ref[1]), grad_rel=rel,
                   grad_leaf=leaf, ref_loss=ref[0])

    for model, name, layers in (("dense", "qwen3-1.7b", GRID_DENSE_RANK_LAYERS),
                                ("moe", "qwen3-moe-30b-a3b", GRID_MOE_RANK_LAYERS)):
        base = _grid_config(name, layers)
        whole = _grid_params(base, dev)
        batch = _grid_batch(base, dev)
        groups = [(None, GRID_RANK_LAYOUTS, batch)] if model == "dense" else \
            [(GRID_TIGHT_CF, GRID_RANK_LAYOUTS[:1], batch),
             (_ample_cf(base), GRID_RANK_LAYOUTS[1:], _grid_batch(base, dev, seq=GRID_EP_SEQ))]
        for cf, layouts, batch in groups:
            cfg = _grid_config(name, layers, cf)
            loss, extras, g = make_grad_fn(cfg, ExecutionPlan(stage_kernel="cuda"))(whole, batch)
            ref = (float(loss), float(extras["aux"]), g)
            for label, shape, strategy in layouts:
                res = {"cf": cf, "tokens": tuple(batch["tokens"].shape)}
                plan = ExecutionPlan(strategy=strategy, mesh=on(shape), stage_kernel="cuda")
                t0 = time.perf_counter()
                loss, aux, grads = _grid_step(cfg, plan, whole, batch)
                res["step_s"] = time.perf_counter() - t0
                compare(res, ref, loss, aux, grads, plan, cfg)
                del grads
                for fault, fmodel, flabel, (module, attr, fn) in GRID_FAULTS:
                    if (fmodel, flabel) == (model, label):
                        mod = sys.modules[f"repro_torch.{module}"]
                        with _replaced(mod, attr, fn):
                            floss, faux, fgrads = _grid_step(cfg, plan, whole, batch)
                        res["fault"] = {"name": fault}
                        compare(res["fault"], ref, floss, faux, fgrads, plan, cfg)
                        del fgrads
                out[(model, label)] = res
            del ref, g
            torch.cuda.empty_cache()
        batch = groups[0][2]
        # bf16 at the config's capacity factor
        cfg16 = _grid_config(name, layers, dtype="bfloat16")
        plan16 = lambda shape, strategy: ExecutionPlan(strategy=strategy, mesh=on(shape), stage_kernel="cuda")  # noqa: E731
        loss, extras, g = make_grad_fn(cfg16, ExecutionPlan(stage_kernel="cuda"))(whole, batch)
        ref16 = (float(loss), float(extras["aux"]), g if model == "dense" else None)
        del g
        for label, shape, strategy in GRID_RANK_LAYOUTS:
            flash, moe_calls, first = [], [], {}

            def flash_rec(kernel, q, k, v, **kw):
                o = kernel(q, k, v, **kw)
                flash.append((tuple(q.shape), tuple(k.shape)))
                first.setdefault("flash", (o.detach().clone(), q.detach().clone(), k.detach().clone(),
                                           v.detach().clone(), dict(causal=kw["causal"], window=kw["window"],
                                                                    group=kw["group"])))
                return o

            def moe_rec(kernel, x, w1, wg, w2, rows):
                o = kernel(x, w1, wg, w2, rows)
                moe_calls.append((tuple(x.shape), rows is not None))
                first.setdefault("moe", (o.detach().clone(), tuple(t.detach().clone() for t in (x, w1, wg, w2)),
                                         rows.clone()))
                return o

            _reset_launches()
            with _flash_wrapped(flash_rec), _moe_wrapped(moe_rec):
                plan = plan16(shape, strategy)
                loss, aux, grads = _grid_step(cfg16, plan, whole, batch)
                fr = dict(flash_ops.flash_attention_fused.launches_by_route)
            res = {"loss": loss, "flash_routes": fr, "flash_calls": flash, "moe_routes":
                   dict(moe_ops.moe_gemm_fused.launches_by_route), "moe_calls": moe_calls}
            o, q, k, v, kw = first["flash"]
            res["flash_err"] = _flash_bf16_check(o, q, k, v, kw, f"(lm-grid b) {model} {label} rank {grid.rank}")
            if "moe" in first:
                o, args, rows = first["moe"]
                res["moe_err"] = _moe_bf16_check(o, args, f"(lm-grid b) {label} rank {grid.rank}", rows)
            first.clear()
            res.update(loss_err=abs(loss - ref16[0]), ref_loss=ref16[0])
            if ref16[2] is not None:
                res["grad_rel"], res["grad_leaf"] = _block_rel_errors(plan, cfg16, grads, ref16[2])
            del grads
            out[(model, label, "bf16")] = res
        del whole, ref16
        torch.cuda.empty_cache()
    out["peak_bytes"] = torch.cuda.max_memory_allocated(dev)
    return out


def phase_lm_grid(device="cuda") -> dict:
    """Phase 23, the slice's main path: the LMs trained on a grid.  (a) The
    trivial 1 x 1 grid over NCCL: qwen3-1.7b at GRID_DENSE_LAYERS and
    qwen3-moe-30b-a3b at GRID_MOE_LAYERS (full width, fp32, batch GRID_BATCH
    x LM_TRAIN_SEQ), one step on each of DATA, MODEL, HYBRID and HYBRID_OPT
    against the meshless step (the loss within LM_STEP_LOSS_TOL, every grad
    leaf within LM_STEP_GRAD_REL of its norm); then GRID_BF16_STEPS bf16
    steps of the full-depth qwen3-1.7b on HYBRID through Trainer, 2 x 28
    flash_attn launches a step, all on "wgmma".  (b) Two ranks on the card
    over gloo (:func:`lm_grid_rank`).  Returns the launches of the bf16
    steps, (a)'s and (b)'s."""
    from repro_torch.launch.mesh import make_grid, spawn_grid

    t_phase = time.perf_counter()
    launches = {"flash_attn": 0, "moe_gemm": 0}
    with make_grid(1, 1, device=device) as grid:
        for name, layers in (("qwen3-1.7b", GRID_DENSE_LAYERS), ("qwen3-moe-30b-a3b", GRID_MOE_LAYERS)):
            cfg = _grid_config(name, layers)
            params = _grid_params(cfg, device)
            batch = _grid_batch(cfg, device)
            loss, extras, ref = make_grad_fn(cfg, ExecutionPlan(stage_kernel="cuda"))(params, batch)
            loss, aux = float(loss), float(extras["aux"])
            for strategy in GRID_LAYOUTS:
                plan = ExecutionPlan(strategy=strategy, mesh=grid, stage_kernel="cuda")
                gl, ga, grads = _grid_step(cfg, plan, params, batch)
                rel, leaf = _block_rel_errors(plan, cfg, grads, ref)
                del grads
                if abs(gl - loss) > LM_STEP_LOSS_TOL or abs(ga - aux) > LM_STEP_LOSS_TOL or not rel <= LM_STEP_GRAD_REL:
                    fail(f"(lm-grid a) {name} {strategy} 1x1: loss {gl} vs meshless {loss}, aux {ga} vs {aux}, grad "
                         f"leaf {leaf} relative L2 {rel:.3e} (bound {LM_STEP_GRAD_REL})")
                print(f"[lm-grid] (a) 1x1 grid over {grid.backend}, {name} at {layers} layers, full width, fp32, "
                      f"{GRID_BATCH} x {LM_TRAIN_SEQ}, {strategy}: loss {gl:.6f} vs meshless {loss:.6f} (|diff| "
                      f"{abs(gl - loss):.2e})" + (f", aux {ga:.6f} vs {aux:.6f}" if cfg.moe is not None else "")
                      + f"; {len(tree_leaves(ref))} grad leaves, worst relative L2 {rel:.3e} (leaf {leaf}; bound "
                      f"{LM_STEP_GRAD_REL})")
            del params, ref, batch
            torch.cuda.empty_cache()
        cfg = dataclasses.replace(get_config("qwen3-1.7b"), dtype="bfloat16")
        it = LMBatchIterator(SyntheticLMTask(cfg.vocab_size, branching=16), LM_TRAIN_BATCH, LM_TRAIN_SEQ, seed=0)
        batches = [next(it) for _ in range(GRID_BF16_STEPS)]
        torch.cuda.reset_peak_memory_stats()
        trainer = Trainer(cfg, adam(lr=1e-3), iter(batches), plan=ExecutionPlan(strategy="hybrid", mesh=grid,
                                                                                  stage_kernel="cuda"),
                          params=_grid_params(cfg, device), clip_norm=5.0, device=device)
        torch.cuda.empty_cache()
        L = cfg.num_layers
        for step in range(1, GRID_BF16_STEPS + 1):
            _reset_launches()
            trainer.run(1, log_every=1, log=lambda line: None)
            h = trainer.history[-1]
            nf, wf = flash_ops.flash_attention_fused.launches, flash_ops.flash_attention_fused.launches_by_route["wgmma"]
            if nf != 2 * L or wf != nf or not np.isfinite(h["loss"]):
                fail(f"(lm-grid a) HYBRID 1x1 bf16 step {step}: flash_attn {nf} launches ({wf} wgmma), want 2 x {L}; "
                     f"loss {h['loss']}")
            launches["flash_attn"] += nf
        ms = [h["step_s"] * 1e3 for h in trainer.history[1:]]
        print(f"[lm-grid] (a) qwen3-1.7b full depth ({L} layers) on HYBRID, 1x1 grid over {grid.backend}, bf16 over "
              f"fp32 masters through Trainer, {LM_TRAIN_BATCH} x {LM_TRAIN_SEQ}: median step {float(np.median(ms)):.1f} "
              f"ms over steps 2-{GRID_BF16_STEPS} ({LM_TRAIN_BATCH * LM_TRAIN_SEQ / float(np.median(ms)) * 1e3:.0f} "
              f"tok/s); losses {[round(x['loss'], 4) for x in trainer.history]}; flash_attn {2 * L} launches a step, "
              f"all wgmma; peak torch.cuda.max_memory_allocated {torch.cuda.max_memory_allocated() / 1e9:.2f} GB; "
              f"card {nvidia_smi_line()}")
        del trainer
        torch.cuda.empty_cache()
    # (b) two ranks on the card over gloo
    t0 = time.perf_counter()
    ranks = spawn_grid(lm_grid_rank, 1, 2, device="cuda:0" if device == "cuda" else device, backend="gloo",
                       timeout_s=GRID_RANK_LIMIT_S,
                       collective_timeout_s=120.0, threads=0)
    wall = time.perf_counter() - t0
    r0 = ranks[0]
    for model, name, layers in (("dense", "qwen3-1.7b", GRID_DENSE_RANK_LAYERS),
                                ("moe", "qwen3-moe-30b-a3b", GRID_MOE_RANK_LAYERS)):
        for label, shape, strategy in GRID_RANK_LAYOUTS:
            r = r0[(model, label)]
            cf = f" at {r['tokens'][0]} x {r['tokens'][1]}" + ("" if r["cf"] is None else f", capacity factor {r['cf']}")
            if r["loss_err"] > LM_STEP_LOSS_TOL or r["aux_err"] > LM_STEP_LOSS_TOL or not r["grad_rel"] <= LM_STEP_GRAD_REL:
                fail(f"(lm-grid b) {name} {label}: loss |diff| {r['loss_err']:.2e}, aux |diff| {r['aux_err']:.2e}, grad "
                     f"leaf {r['grad_leaf']} relative L2 {r['grad_rel']:.3e}")
            print(f"[lm-grid] (b) {name} at {layers} layers, full width, {label}, two processes on this card over gloo, "
                  f"fp32{cf}: loss {r['loss']:.6f} vs meshless {r['ref_loss']:.6f} (|diff| {r['loss_err']:.2e}), aux "
                  f"|diff| {r['aux_err']:.2e}; grads held by block on each rank, worst relative L2 {r['grad_rel']:.3e} (leaf "
                  f"{r['grad_leaf']}; bound {LM_STEP_GRAD_REL}); step {r['step_s'] * 1e3:.0f} ms (host-staged, not a "
                  "speed figure)")
            if "fault" in r:
                f = r["fault"]
                caught = f["loss_err"] > LM_STEP_LOSS_TOL or f["aux_err"] > LM_STEP_LOSS_TOL or \
                    not f["grad_rel"] <= LM_STEP_GRAD_REL
                if not caught:
                    fail(f"control: (lm-grid b) {label} with '{f['name']}' planted passes the checks")
                print(f"[lm-grid] (b) control {label} with '{f['name']}' planted: loss |diff| {f['loss_err']:.2e}, aux "
                      f"|diff| {f['aux_err']:.2e}, worst grad relative L2 {f['grad_rel']:.3e} (caught)")
            cfg16 = _grid_config(name, layers, dtype="bfloat16")
            want = _expected_calls(cfg16, shape, strategy, GRID_BATCH)
            for rank, rr in enumerate(ranks):
                b = rr[(model, label, "bf16")]
                n = 2 * layers
                if b["flash_routes"]["wgmma"] != n or len(b["flash_calls"]) != n or \
                        any(c != (want["q"], want["kv"]) for c in b["flash_calls"]):
                    fail(f"(lm-grid b) {name} {label} bf16 rank {rank}: flash_attn {b['flash_routes']}, calls "
                         f"{set(b['flash_calls'])}, want {n} on wgmma at q {want['q']} k/v {want['kv']}")
                if cfg16.moe is not None and (b["moe_routes"]["wgmma"] != n or len(b["moe_calls"]) != n or
                                              any(c != (want["x"], True) for c in b["moe_calls"])):
                    fail(f"(lm-grid b) {name} {label} bf16 rank {rank}: moe_gemm {b['moe_routes']}, calls "
                         f"{set(b['moe_calls'])}, want {n} on wgmma at x {want['x']} with rows")
                launches["flash_attn"] += b["flash_routes"]["wgmma"]
                launches["moe_gemm"] += b["moe_routes"]["wgmma"]
            b = r0[(model, label, "bf16")]
            if not b["loss_err"] <= GRID_BF16_LOSS_TOL or not b.get("grad_rel", 0.0) <= GRID_BF16_GRAD_REL:
                fail(f"(lm-grid b) {name} {label} bf16: loss |diff| {b['loss_err']:.3e} from the meshless bf16 step "
                     f"(bound {GRID_BF16_LOSS_TOL}), grad relative L2 {b.get('grad_rel')}")
            grads = (f"; grads held by block on each rank, worst relative L2 {b['grad_rel']:.3e} (leaf {b['grad_leaf']}, bound "
                     f"{GRID_BF16_GRAD_REL})" if "grad_rel" in b else "")
            moe = (f"; moe_gemm {2 * layers} a rank on wgmma at x {want['x']} with rows, the first against the plain "
                   f"version max_abs_err {b['moe_err'][0]:.3e} rel L2 {b['moe_err'][1]:.3e}" if "x" in want else "")
            print(f"[lm-grid] (b) {name} {label} bf16 (capacity factor as configured): loss {b['loss']:.6f} vs meshless "
                  f"bf16 {b['ref_loss']:.6f} (|diff| {b['loss_err']:.3e} <= {GRID_BF16_LOSS_TOL}){grads}; flash_attn "
                  f"{2 * layers} a rank on wgmma at q {want['q']} k/v {want['kv']} ({want['rows']} rows x "
                  f"{want['heads'][0]} q / {want['heads'][1]} kv heads a rank), the first against the plain version "
                  f"max_abs_err {b['flash_err'][0]:.3e} rel L2 {b['flash_err'][1]:.3e}{moe}")
    print(f"[lm-grid] (b) both ranks done in {wall:.1f}s; peak max_memory_allocated {ranks[0]['peak_bytes'] / 1e9:.2f} "
          f"and {ranks[1]['peak_bytes'] / 1e9:.2f} GB; phase 23 in {time.perf_counter() - t_phase:.1f}s")
    return launches


def main():
    t_start = time.perf_counter()
    if sys.argv[1:] == ["--only", "lm-grid"]:  # the grid phase alone (its build included), for work on it
        phase_environment()
        phase_build()
        phase_lm_grid()
        print(f"[done] phase 23 alone in {time.perf_counter() - t_start:.1f}s")
        return
    phase_environment()
    phase_build()
    max_err = phase_parity()
    lstm_err = phase_lstm_parity()
    phase_backward()
    lstm_err = max(lstm_err, phase_lstm_shard())
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
    hybrid_lstm, hybrid_luong, tp_lstm, tp_luong = phase_hybrid(tcfg)
    if_lstm, if_1536, if_routes, if_step_routes = phase_input_feeding(tcfg)
    records = phase_timing(serve_launches + if_routes["decode"],
                           train_luong_launches + hybrid_luong + tp_luong + if_routes["wgmma"], ticks, max_err,
                           if_step_routes)
    records.append(phase_lstm_timing(lstm_launches + hybrid_lstm + tp_lstm + if_lstm, lstm_err, tp_lstm, if_1536))
    records[1]["hybrid_launches"], records[-1]["hybrid_launches"] = hybrid_luong + tp_luong, hybrid_lstm + tp_lstm
    records[0]["input_feeding_launches"], records[1]["input_feeding_launches"] = if_routes["decode"], if_routes["wgmma"]
    records[-1]["input_feeding_launches"] = if_lstm
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
    phase_lm_step_paths(lm_cfg, lm_params, LM_PATHS_LAYERS, "a")
    lm_box = [lm_params]  # the trainer copies the masters; this copy goes once it has
    del lm_params
    dense_train = phase_lm_train(lm_cfg, "a", lm_box, "")
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
    train_cfg = dataclasses.replace(moe_cfg, num_layers=MOE_TRAIN_LAYERS)
    phase_lm_step_paths(train_cfg, moe_params, MOE_TRAIN_LAYERS, "b")
    moe_box = [_cut_layers(moe_params, MOE_TRAIN_LAYERS)]
    del moe_params
    moe_train = phase_lm_train(train_cfg, "b", moe_box,
                               f" of 48 (cut: 16 B of training state a parameter is 49.8 GB at {MOE_TRAIN_LAYERS} "
                               "layers, 70 GB at 6 before activations, 90 GB at the serving phase's 8)")
    backward_ms = phase_lm_backward()
    grid_launches = phase_lm_grid()
    records.append(phase_flash_timing(flash_launches + moe_flash_launches,
                                      {r: flash_routes[r] + moe_flash_routes[r] for r in flash_routes}, flash_err))
    records.append(phase_moe_timing(moe_launches, moe_routes, moe_err, prefill_buf, decode_buf))
    # the training runs' launches (phases 19-20, steps 1-6 each, every one on the wgmma route)
    for rec, name, train in ((records[-2], "flash_attn", dense_train["flash_attn"] + moe_train["flash_attn"]),
                             (records[-1], "moe_gemm", moe_train["moe_gemm"])):
        rec["launches"] += train
        rec["launches_by_route"] = dict(rec["launches_by_route"], wgmma=rec["launches_by_route"]["wgmma"] + train)
        rec["train_launches"] = train
        rec["train_backward_ms"] = {k: v for k, v in backward_ms.items() if k.startswith(name)}
        grid = grid_launches[name]  # phase 23's bf16 steps, (a)'s and both ranks' of (b), every one on wgmma
        rec["launches"] += grid
        rec["launches_by_route"]["wgmma"] += grid
        rec["grid_launches"] = grid
        print(f"[timing] {name}: {train} launches in the LM training runs (phases 19-20) and {grid} in the grid "
              f"phase's bf16 steps (23), all on the wgmma route; {rec['launches']} on the main paths in all")
    print(f"[done] all phases passed in {time.perf_counter() - t_start:.1f}s")
    print(json.dumps({"kernels": records}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                              "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
