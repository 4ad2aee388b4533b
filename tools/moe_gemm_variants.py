#!/usr/bin/env python3
"""Build design variants of the ``moe_gemm`` kernels, check them and time
them on one NVIDIA GPU.  Run from the repository root:

    python3 tools/moe_gemm_variants.py [--sass] [UP:DOWN[,DIAG=BITS] ...]

Each variant is ``src/repro_torch/kernels/moe_gemm/csrc/moe_gemm.cu`` built
with ``-DMOE_WG_UP_STAGES=UP -DMOE_WG_STAGES=DOWN`` (stages in the ring of
the wgmma route's gate-up and down kernels) into a library of its own, one
``nvcc -Xptxas -v`` per variant, all started together.  ``DIAG=BITS`` builds a copy of the source with switches that take
work out of the wgmma kernels: 2 no products, 4 no epilogue (nothing
stored), 8 no gate in the epilogue (x W1 stored as h), 16 no TMA store
issued, 32 no proxy fence, 64 no stmatrix, 128 no wait for the last
tile's store; such a variant is timed but not checked.  ``--sass`` writes the first variant's SASS to
``chiprun_out/moe_gemm_sass.txt`` and counts, per wgmma kernel, its HGMMA
instructions and the ``WARPGROUP.DEPBAR`` waits among them (one wait per
HGMMA means ptxas serialised them).

For each variant it prints ptxas's registers, spills and any note that it
serialised the wgmma, the largest error of the "wgmma" and "decode" routes
against the plain version's fp32 output on the same bf16 inputs at the
checked shapes (``CHECKS``: with and without ``rows``, NaN and large values
planted past ``rows[e]``, which must come back exactly zero), two calls'
bit-equality, and the median device time (CUDA events, L2 flushed) at the
calls of the MoE serving run (qwen3-moe-30b-a3b, E=128 d=2048 F=768): the
prefill's [128, 641] buffer dense and with ``rows`` of a served prefill's
shape (65,536 slots over 128 experts), and the decode step's [128, 1] buffer
dense and with 29 experts holding a row.  Beside them, with the default
library: the "mma" route's kernels (the first tensor-core ones), and ``torch.bmm`` x 3 + the
gate, the yardstick.  Writes ``chiprun_out/moe_gemm_variants.json``; the last
line is the card's ``nvidia-smi`` name and power limit.  Needs a card and
``nvcc``.
"""
from __future__ import annotations

import ctypes
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))

from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.moe_gemm import ops  # noqa: E402
from repro_torch.kernels.moe_gemm.ref import moe_gemm_plain  # noqa: E402

DEFAULT_VARIANTS = ["4:3", "3:3", "4:3,DIAG=4"]
SOURCE = Path(kernels.__file__).resolve().parent / "moe_gemm" / "csrc" / "moe_gemm.cu"
RUNS = 20
BF16_TOL = dict(atol=1e-2, rtol=1e-2)  # chip_smoke.py's MOE_BF16_TOL
BF16_REL_L2 = 1e-2
# (E, C, d, F, rows): rows None (every row), "ragged" (0, C, and values between, per expert) or "served"
CHECKS = [
    (2, 130, 128, 128, None), (3, 200, 320, 192, None), (3, 200, 320, 192, "ragged"), (5, 641, 256, 384, "ragged"),
    (4, 64, 64, 64, "ragged"), (128, 641, 2048, 768, None), (128, 641, 2048, 768, "served"),
    (8, 1, 2048, 768, None), (128, 1, 2048, 768, "served"), (6, 16, 256, 192, "ragged"), (5, 7, 128, 64, "ragged"),
    (3, 2, 64, 128, "ragged"),
]
PREFILL, DECODE = (128, 641, 2048, 768), (128, 1, 2048, 768)
DIAG_EDITS = [
    ("using namespace hopper;\n", "using namespace hopper;\n#ifndef MOE_WG_DIAG\n#define MOE_WG_DIAG 0\n#endif\n"),
    ("        wgmma_fence();\n#pragma unroll\n        for (int kk = 0; kk < kWgBK / 16; ++kk) {",
     "        if (!(MOE_WG_DIAG & 2)) wgmma_fence();\n#pragma unroll\n"
     "        for (int kk = 0; kk < kWgBK / 16 && !(MOE_WG_DIAG & 2); ++kk) {"),
    ("      unsigned char* buf = outs + wg * kOut;\n",
     "      if (MOE_WG_DIAG & 4) continue;\n      unsigned char* buf = outs + wg * kOut;\n"),
    ("          if constexpr (GATED) r[q] =", "          if constexpr (GATED && (MOE_WG_DIAG & 8)) r[q] = pack_bf16(acc[i], acc[i + 1]);\n"
     "          else if constexpr (GATED) r[q] ="),
    ("        bulk_commit();\n", "        if (MOE_WG_DIAG & 16) continue;\n        bulk_commit();\n"),
    ("      fence_proxy_async();\n", "      if (!(MOE_WG_DIAG & 32)) fence_proxy_async();\n"),
    ("        stmatrix_x4(", "        if (!(MOE_WG_DIAG & 64)) stmatrix_x4("),
    ("      named_sync(1 + wg, 128);\n      const int mi", "      if (!(MOE_WG_DIAG & 128)) named_sync(1 + wg, 128);\n      const int mi"),
]


def edited_source(out_dir: Path, i: int) -> Path:
    src = SOURCE.read_text()
    for anchor, repl in DIAG_EDITS:
        if src.count(anchor) != 1:
            sys.exit(f"the source no longer holds this anchor once: {anchor!r}")
        src = src.replace(anchor, repl)
    out = out_dir / f"moe_gemm-edited{i}.cu"
    out.write_text(src)
    return out


def build(variants):
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, v in enumerate(variants):
        fields, *extra = v.split(",")
        up, down = fields.split(":")
        defs = [f"-DMOE_WG_UP_STAGES={up}", f"-DMOE_WG_STAGES={down}"]
        defs += [f"-DMOE_WG_DIAG={e.split('=')[1]}" for e in extra if e.startswith("DIAG=")]
        defs += [f"-D{e[2:]}" for e in extra if e.startswith("D:")]  # any other define, D:NAME=VALUE
        lib = out_dir / f"libmoe_gemm-variant{i}.so"
        src = edited_source(out_dir, i) if any(e.startswith("DIAG=") for e in extra) else SOURCE
        cmd = [kernels.nvcc_path(), *kernels.nvcc_flags(), "-Xptxas", "-v", *defs, "-o", str(lib), str(src)]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for v, (p, lib) in procs.items():
        log, _ = p.communicate()
        lines = log.splitlines()
        # ptxas's report on the new kernels: the lines after each of their entry names
        rep = [ln.strip() for i, ln in enumerate(lines) if ("spill" in ln or "registers" in ln)
               and any("moe_wg_kernel" in x or "moe_dec_kernel" in x for x in lines[max(0, i - 3):i])]
        rep += sorted({ln.strip() for ln in lines if "arning" in ln and "never referenced" not in ln})
        rep += [ln.strip() for ln in lines if "C7513" in ln or "C7515" in ln]
        print(f"[build] {v}: exit {p.returncode}; ptxas: {' | '.join(rep)}")
        if p.returncode != 0:
            print(log[-6000:])
            continue
        built[v] = (lib, rep)
    return built


def use_library(lib_path):
    """Point the wrapper at one library (None: the default build)."""
    kernels._loaded.pop("moe_gemm", None)
    if lib_path is not None:
        kernels._loaded["moe_gemm"] = ctypes.CDLL(str(lib_path))


def served_rows(E, C, slots, gen):
    """rows of a served buffer: ``slots`` draws over E experts (uniform, as a
    random router spreads them), each expert's count capped at C."""
    counts = torch.bincount(torch.randint(0, E, (slots,), generator=gen, device="cuda"), minlength=E)
    return counts.clamp(max=C).to(torch.int32)


def inputs(E, C, d, F, rows_kind, seed=0):
    """bf16 x (unit-RMS rows), fan-in weights, rows; x past rows[e] holds NaN
    and 1e4 (garbage the kernels must not let through)."""
    gen = torch.Generator(device="cuda").manual_seed(seed)
    f = lambda shape, scale: scale * torch.randn(shape, generator=gen, device="cuda")  # noqa: E731
    x, w1, wg, w2 = f((E, C, d), 1.0), f((E, d, F), d**-0.5), f((E, d, F), d**-0.5), f((E, F, d), F**-0.5)
    rows = None
    if rows_kind == "ragged":
        rows = torch.randint(0, C + 1, (E,), generator=gen, device="cuda").to(torch.int32)
        rows[0], rows[-1] = 0, C
        if E > 2:
            rows[1] = min(C, 1)
    elif rows_kind == "served":
        rows = served_rows(E, C, 65536 if C > 1 else 32, gen)
    if rows is not None:
        dead = torch.arange(C, device="cuda")[None, :] >= rows[:, None]
        x[dead] = 1e4
        x[:, ::3][dead[:, ::3]] = float("nan")
    return tuple(t.to(torch.bfloat16) for t in (x, w1, wg, w2)), rows


def check(route):
    """Worst max_abs_err and relative L2 of ``route`` over the CHECKS it takes;
    raises on a miss, a non-zero row past rows[e] or two calls that differ."""
    worst = [0.0, 0.0]
    for E, C, d, F, kind in CHECKS:
        if not ops.route_fits(route, torch.bfloat16, E, C, d, F):
            continue
        args, rows = inputs(E, C, d, F, kind, seed=1)
        before = ops.moe_gemm_fused.launches_by_route[route]
        got = ops.moe_gemm_fused(*args, rows, route=route)
        again = ops.moe_gemm_fused(*args, rows, route=route)
        torch.cuda.synchronize()
        if ops.moe_gemm_fused.launches_by_route[route] != before + 2:
            raise RuntimeError(f"{E, C, d, F} did not count on the {route} route")
        if not torch.equal(got, again):
            raise RuntimeError(f"{route} {E, C, d, F, kind}: two calls differ")
        want = moe_gemm_plain(*(t.float() for t in args), rows)
        if rows is not None:
            dead = torch.arange(C, device="cuda")[None, :] >= rows[:, None]
            if torch.count_nonzero(got[dead]).item() or torch.isnan(got[dead]).any():
                raise RuntimeError(f"{route} {E, C, d, F, kind}: rows past rows[e] are not exact zeros")
        err = (got.float() - want).abs().max().item()
        rel = ((got.float() - want).norm() / want.norm().clamp(min=1e-30)).item()
        ok = torch.allclose(got.float(), want, **BF16_TOL) and rel <= BF16_REL_L2 and torch.isfinite(got).all()
        print(f"[check] {route} E={E} C={C} d={d} F={F} rows={kind}: max_abs_err {err:.3e} relative L2 {rel:.3e} "
              f"{'ok' if ok else 'MISS'}")
        if not ok:
            raise RuntimeError(f"{route} {E, C, d, F, kind}: max_abs_err {err:.3e}, relative L2 {rel:.3e}")
        worst = [max(worst[0], err), max(worst[1], rel)]
    return worst


def median_ms(fn, flush, runs=RUNS):
    for _ in range(3):
        fn()
    times = []
    for _ in range(runs):
        flush.zero_()
        torch.cuda._sleep(2_000_000)  # the host enqueues the call while the device spins
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


CALLS = {"prefill dense": (PREFILL, None), "prefill served": (PREFILL, "served"),
         "decode dense": (DECODE, None), "decode served": (DECODE, "served")}


def time_calls(flush, route=None):
    out = {}
    for name, (shape, kind) in CALLS.items():
        args, rows = inputs(*shape, kind, seed=9)
        if route == "mma":  # timed as first run, without rows: the dead rows as the dispatch leaves them, zeros
            if rows is not None:
                dead = torch.arange(shape[1], device="cuda")[None, :] >= rows[:, None]
                args[0][dead] = 0
            out[name] = median_ms(lambda: ops.moe_gemm_fused(*args, route="mma"), flush)
        else:
            out[name] = median_ms(lambda: ops.moe_gemm_fused(*args, rows, route=route), flush)
    return out


def kernel_split(flush):
    """Device time of each kernel of one prefill call (dense buffer), from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    args, _ = inputs(*PREFILL, None, seed=9)
    ops.moe_gemm_fused(*args)
    flush.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.moe_gemm_fused(*args)
        torch.cuda.synchronize()
    return {e.key[:70]: round(e.self_device_time_total / 1e3, 4) for e in prof.key_averages()
            if "moe_" in e.key and e.self_device_time_total > 0}


def sass_report(lib):
    cuobjdump = str(Path(kernels.nvcc_path()).parent / "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, timeout=300).stdout
    with open(os.path.join(ROOT, "chiprun_out", "moe_gemm_sass.txt"), "w") as f:
        f.write(out)
    report = {}
    for block in re.split(r"\n\s*Function : ", out)[1:]:
        name = block.split("\n", 1)[0].strip()
        if "moe_wg_kernel" in name:
            report["gate-up" if "ILb1E" in name else "down"] = {
                op: block.count(op) for op in ("HGMMA", "WARPGROUP.DEPBAR", "WARPGROUP.ARRIVE", "STSM", "SHFL",
                                               "ENDCOLLECTIVE", "CALL")}
            report["gate-up" if "ILb1E" in name else "down"]["instructions"] = len(re.findall(r"/\*[0-9a-f]{4}\*/", block))
    print(f"[sass] {json.dumps(report)}")
    return report


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    args = sys.argv[1:]
    sass = args[:1] == ["--sass"]
    variants = args[sass:] or DEFAULT_VARIANTS
    t0 = time.perf_counter()
    built = build(variants)
    print(f"[build] {len(built)} of {len(variants)} variants built in {time.perf_counter() - t0:.1f}s", flush=True)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    results = {"variants": {}}
    if sass and built:
        results["sass"] = sass_report(next(iter(built.values()))[0])
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    out_json = os.path.join(ROOT, "chiprun_out", "moe_gemm_variants.json")
    for v, (lib, ptxas) in built.items():
        t0 = time.perf_counter()
        use_library(lib)
        rec = {"ptxas": ptxas}
        try:
            if "DIAG" not in v:
                rec["wgmma_err"] = check("wgmma")
                rec["decode_err"] = check("decode")
            rec["ms"] = time_calls(flush)
            rec["prefill_kernels_ms"] = kernel_split(flush)
        except RuntimeError as e:
            print(f"[variant] {v}: FAILED {e}")
            rec["error"] = str(e)
        rec["seconds"] = round(time.perf_counter() - t0, 1)
        print(f"[variant] {v}: {json.dumps({k: x for k, x in rec.items() if k != 'ptxas'})}", flush=True)
        results["variants"][v] = rec
        with open(out_json, "w") as f:  # after each variant, so a cut run keeps what it measured
            json.dump(results, f, indent=1)
    use_library(None)
    results["mma_route_ms"] = time_calls(flush, route="mma")
    bmm = {}
    for name, (shape, kind) in CALLS.items():
        (x, w1, wg, w2), _ = inputs(*shape, None, seed=9)
        bmm[name] = median_ms(lambda: torch.bmm(torch.nn.functional.silu(torch.bmm(x, w1)) * torch.bmm(x, wg), w2),
                              flush)
    results["bmm_ms"] = bmm
    print(f"[yardstick] mma route {json.dumps(results['mma_route_ms'])}; bmm x 3 + gate {json.dumps(bmm)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    results["nvidia_smi"] = smi
    with open(out_json, "w") as f:
        json.dump(results, f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()
