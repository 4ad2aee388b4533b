#!/usr/bin/env python3
"""Build design variants of the ``lstm_cell`` tensor-core kernel and time
them on one NVIDIA GPU.  Run from the repository root:

    python3 tools/lstm_cell_variants.py [STAGES:KSPLIT ...]
    python3 tools/lstm_cell_variants.py --diag STAGES:KSPLIT,DIAG=BITS ...

Each variant is a copy of ``src/repro_torch/kernels/lstm_cell/csrc/lstm_cell.cu``
with its ``kStages`` and ``kSplit`` (ring depth, blocks of a cluster on one
tile's depth) set to the variant's values, built into a library of its own,
one ``nvcc -Xptxas -v`` per variant, all started together.  With ``--diag``
the copy also gets switches that take work out of the tensor-core kernel,
set by ``DIAG=BITS``: 1 no activation copies, 2 no weight copies, 4 no
products (the ring's handshakes stay), 8 no walk at all, 16 no cluster
exchange, 32 no preload of c; its results are wrong, so it is timed but not
checked.  For each variant it prints ptxas's registers and spills, the
largest error against the plain version (x and the weights bf16, h and c
fp32, the model's scales; plus a ragged and an all-bf16 feed, and the
control that rounds h to bf16), and the median device time (CUDA events)
at B=64, H=1024, In=1024 and 512: with the L2 flushed, warm, and per call
in a run of 16 back to back (the training loop's case).  Beside them: the
FMA kernel on the fp32-masters feed and ``torch.lstm_cell`` in bf16.
Writes everything to ``chiprun_out/lstm_cell_variants.json`` (``-diag.json``
with ``--diag``); the last line is the card's ``nvidia-smi`` name and power
limit.  Needs a card and ``nvcc``.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.lstm_cell import ops  # noqa: E402
from repro_torch.kernels.lstm_cell.ref import lstm_cell_ref  # noqa: E402

DEFAULT_VARIANTS = ["6:2", "4:2", "8:2"]
SOURCE = Path(kernels.__file__).resolve().parent / "lstm_cell" / "csrc" / "lstm_cell.cu"
RUNS = 50
LOOP = 16  # back-to-back calls, as the training loop makes them


# (anchor, replacement) edits that make the diagnostic copy; each anchor must occur once
DIAG_EDITS = [
    ("typedef __nv_bfloat16 bf16;\n", "typedef __nv_bfloat16 bf16;\n#ifndef LSTM_MMA_DIAG\n#define LSTM_MMA_DIAG 0\n#endif\n"),
    ("  mbar_expect_bytes(bar, kWBytes + (f32 ? 2 : 1) * kMmaRows * kKC * 2);\n  bulk_copy(",
     "  mbar_expect_bytes(bar, ((LSTM_MMA_DIAG & 2) ? 0 : kWBytes) + "
     "((LSTM_MMA_DIAG & 1) ? 0 : (f32 ? 2 : 1) * kMmaRows * kKC * 2));\n  if (!(LSTM_MMA_DIAG & 2)) bulk_copy("),
    ("  tensor_copy(st + kWBytes, is_h ? th : tx, k0, r0, bar);",
     "  if (LSTM_MMA_DIAG & 1) return;\n  tensor_copy(st + kWBytes, is_h ? th : tx, k0, r0, bar);"),
    ("    consume<false>(smem, full, empty, 0, nxr, d);",
     "    if (LSTM_MMA_DIAG & 4) {\n      for (int i = 0; i < n; ++i) {\n"
     "        mbar_wait(&full[i % kStages], (i / kStages) & 1);\n        mbar_arrive(&empty[i % kStages]);\n"
     "      }\n    } else\n    consume<false>(smem, full, empty, 0, nxr, d);\n    if (!(LSTM_MMA_DIAG & 4))"),
    ("n = split_point<TH>(rank + 1, nx, nh) - q0;", "n = (LSTM_MMA_DIAG & 8) ? 0 : split_point<TH>(rank + 1, nx, nh) - q0;"),
    ("  if constexpr (kSplit > 1) {\n    // granule gl", "  if constexpr (kSplit > 1 && !(LSTM_MMA_DIAG & 16)) {\n    // granule gl"),
    ("c_prev[gl][hr][u] = mine && r < a.B ?", "c_prev[gl][hr][u] = !(LSTM_MMA_DIAG & 32) && mine && r < a.B ?"),
]


CONSTANTS = {"STAGES": "constexpr int kStages = 6;", "KSPLIT": "constexpr int kSplit = 2;"}


def edit(src: str, anchor: str, repl: str) -> str:
    if src.count(anchor) != 1:
        sys.exit(f"the source no longer holds this anchor once: {anchor!r}")
    return src.replace(anchor, repl)


def variant_source(v: str, diag: bool, out_dir: Path, i: int) -> Path:
    """A copy of the source with the variant's constants (and the switches)."""
    fields, *extra = v.split(",")
    src = SOURCE.read_text()
    for (name, anchor), value in zip(CONSTANTS.items(), fields.split(":")):
        src = edit(src, anchor, anchor.replace(anchor.split("= ")[1], f"{value};"))
    if diag:
        for anchor, repl in DIAG_EDITS:
            src = edit(src, anchor, repl)
        src = src.replace("#define LSTM_MMA_DIAG 0", f"#define LSTM_MMA_DIAG {extra[0].split('=')[1]}")
    out = out_dir / f"lstm_cell-variant{i}.cu"
    out.write_text(src)
    return out


def build(variants, diag):
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, v in enumerate(variants):
        lib = out_dir / f"liblstm_cell-variant{i}.so"
        cmd = [kernels.nvcc_path(), *kernels.nvcc_flags(), "-Xptxas", "-v", "-o", str(lib),
               str(variant_source(v, diag, out_dir, i))]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for v, (p, lib) in procs.items():
        log, _ = p.communicate()
        lines = log.splitlines()
        # ptxas's report on the tensor-core kernels: the lines after each of their entry names
        mma = [ln.strip() for i, ln in enumerate(lines) if ("spill" in ln or "registers" in ln)
               and any("mma_kernel" in x for x in lines[max(0, i - 3):i])]
        mma += sorted({ln.strip() for ln in lines if "wgmma" in ln or "arning" in ln})
        print(f"[build] {v}: exit {p.returncode}; ptxas on the tensor-core kernels: {' | '.join(mma)}")
        if p.returncode != 0:
            print(log[-4000:])
            continue
        built[v] = (lib, mma)
    return built


def use_library(lib_path):
    """Point the wrapper at one variant's library."""
    import ctypes

    kernels._loaded["lstm_cell"] = ctypes.CDLL(str(lib_path))


def inputs(B, In, H, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda shape, scale=1.0: torch.from_numpy((rng.normal(size=shape) * scale).astype(np.float32)).cuda()  # noqa: E731
    x, h, c = torch.tanh(f((B, In))), torch.tanh(f((B, H))), f((B, H))
    return x, h, c, f((In, 4, H), In**-0.5), f((H, 4, H), H**-0.5), f((4, H), 0.1)


def median_ms(fn, flush=None, spin=2_000_000):
    for _ in range(5):
        fn()
    times = []
    for _ in range(RUNS):
        if flush is not None:
            flush.zero_()
        torch.cuda._sleep(spin)  # the host enqueues the call while the device spins
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def max_err(got, want):
    return max((g.float() - w.float()).abs().max().item() for g, w in zip(got, want))


def check(v):
    """Largest error against the plain version over the feeds and shapes."""
    errs = {}
    for B, In, H in ((64, 1024, 1024), (64, 512, 1024), (130, 40, 72), (6, 24, 40), (1, 8, 16)):
        x, h, c, wx, wh, b = inputs(B, In, H, seed=1)
        args = (x.bfloat16(), h, c, wx.bfloat16(), wh.bfloat16(), b.bfloat16())
        before = ops.lstm_cell_fused.mma_launches
        got = ops.lstm_cell_fused(*args)
        torch.cuda.synchronize()
        if ops.lstm_cell_fused.mma_launches != before + 1:
            raise RuntimeError(f"{v}: {B, In, H} did not take the tensor-core kernel")
        errs[f"B{B}-In{In}-H{H}"] = max_err(got, lstm_cell_ref(*args))
        if B == 64 and In == 1024:  # the control: h rounded to bf16, h_lo dropped
            ctl = ops.lstm_cell_fused(args[0], h.bfloat16().float(), *args[2:])
            errs["control-h-rounded"] = max_err(ctl, lstm_cell_ref(*args))
        if B == 130:  # every input bf16: h' and c' in bf16
            a16 = tuple(t.bfloat16() for t in args)
            errs["all-bf16-B130"] = max_err(ops.lstm_cell_fused(*a16), lstm_cell_ref(*a16))
    return errs


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
    args = sys.argv[1:]
    diag = args[:1] == ["--diag"]
    variants = args[diag:] or DEFAULT_VARIANTS
    built = build(variants, diag)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    results = {"variants": {}}
    shapes = {"In1024": (64, 1024, 1024), "In512": (64, 512, 1024)}
    feeds = {k: inputs(*s, seed=6) for k, s in shapes.items()}
    results["events_only_ms"] = median_ms(lambda: None)  # the timing method's own floor
    for v, (lib, ptxas) in built.items():
        use_library(lib)
        try:
            errs = "not checked" if diag else check(v)
        except RuntimeError as e:
            print(f"[variant] {v}: FAILED {e}")
            results["variants"][v] = {"error": str(e)}
            continue
        rec = {"max_abs_err": errs}
        for name, (x, h, c, wx, wh, b) in feeds.items():
            w = ops.cast_weights(wx, wh, b, torch.bfloat16)
            xb = x.bfloat16()
            fn = lambda: ops.lstm_cell_fused(xb, h, c, wx, wh, b, weights=w)  # noqa: E731
            rec[name] = {"flushed_ms": median_ms(fn, flush), "warm_ms": median_ms(fn),
                         "loop_ms": median_ms(lambda: [fn() for _ in range(LOOP)], spin=40_000_000) / LOOP}
        print(f"[variant] {v}: {json.dumps(rec)}")
        rec["ptxas"] = ptxas
        results["variants"][v] = rec
    # yardsticks, with the default library
    kernels._loaded.pop("lstm_cell", None)
    for name, (x, h, c, wx, wh, b) in feeds.items():
        In, H = wx.shape[0], wx.shape[2]
        lib_args = (x.bfloat16(), (h.bfloat16(), c.bfloat16()), wx.reshape(In, 4 * H).t().contiguous().bfloat16(),
                    wh.reshape(H, 4 * H).t().contiguous().bfloat16(), b.reshape(-1).bfloat16(),
                    torch.zeros(4 * H, dtype=torch.bfloat16, device="cuda"))
        xb = x.bfloat16()
        results[name] = {
            "fma_fp32_masters_flushed_ms": median_ms(lambda: ops.lstm_cell_fused(xb, h, c, wx, wh, b), flush),
            "torch_lstm_cell_bf16_flushed_ms": median_ms(lambda: torch.lstm_cell(*lib_args), flush),
        }
        print(f"[yardstick] {name}: {json.dumps(results[name])}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    results["nvidia_smi"] = smi
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    name = "lstm_cell_variants-diag.json" if diag else "lstm_cell_variants.json"
    with open(os.path.join(ROOT, "chiprun_out", name), "w") as f:
        json.dump(results, f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()
