#!/usr/bin/env python3
"""Build design variants of the ``flash_attn`` wgmma kernel, check them and
time them on one NVIDIA GPU.  Run from the repository root:

    python3 tools/flash_attn_variants.py [--sass] [BN:STAGES[,DIAG=BITS] ...]

Each variant is ``src/repro_torch/kernels/flash_attn/csrc/flash_attn.cu``
built with ``-DFLASH_WG_BN=BN -DFLASH_WG_STAGES=STAGES`` (keys per k/v tile,
tiles in the ring) into a library of its own, one ``nvcc -Xptxas -v`` per
variant, all started together.  ``DIAG=BITS`` builds a copy of the source
with switches that take work out of the wgmma kernel: 1 no k/v copies (the
ring's barriers are still arrived on), 2 no products, 4 no softmax, 8 no k/v
tiles at all (q's copy, the launch and the stores are left); such a variant
is timed but not checked.  ``--sass`` writes the first variant's SASS to
``chiprun_out/flash_attn_sass.txt``.

For each variant it prints ptxas's registers, spills and any note that it
serialised the wgmma, the largest error of the wgmma route against the
plain version's fp32 output on the same bf16 inputs at the checked shapes
(``CHECKS``), two calls' bit-equality, and the median device time (CUDA
events, L2 flushed) at the calls of the serving runs: qwen3-1.7b prefill
(a) B=4 S=2048 16/8 heads, (b) B=1 S=8192 window 4096, and
qwen3-moe-30b-a3b's prefill B=4 S=2048 32/4 heads (G=8), all D=128 causal.
Beside them, with the default library: the "mma" route's kernel and
``scaled_dot_product_attention`` (``enable_gqa``), the yardstick.  Writes
``chiprun_out/flash_attn_variants.json``; the last line is the card's
``nvidia-smi`` name and power limit.  Needs a card and ``nvcc``.
"""
from __future__ import annotations

import ctypes
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
from repro_torch.kernels.flash_attn import ops  # noqa: E402
from repro_torch.kernels.flash_attn.ref import flash_attention_plain  # noqa: E402

DEFAULT_VARIANTS = ["128:3", "128:2", "64:4"]
SOURCE = Path(kernels.__file__).resolve().parent / "flash_attn" / "csrc" / "flash_attn.cu"
RUNS = 20
BF16_TOL = dict(atol=1e-2, rtol=1e-2)  # chip_smoke.py's FLASH_BF16_TOL
BF16_REL_L2 = 1e-2
# (B, S, T, KV, G, D, causal, window): ragged, odd G, G = 1 and 8, one row, the serving calls
CHECKS = [
    (1, 256, 256, 1, 4, 64, True, 64), (1, 128, 128, 2, 1, 128, True, 32), (2, 77, 131, 2, 3, 128, True, 50),
    (2, 64, 64, 4, 1, 64, False, None), (1, 1, 1, 2, 2, 128, True, None), (1, 300, 300, 2, 8, 128, True, 100),
    (2, 200, 90, 1, 2, 64, True, None), (4, 2048, 2048, 8, 2, 128, True, 4096),
    (1, 8192, 8192, 8, 2, 128, True, 4096), (4, 2048, 2048, 4, 8, 128, True, 4096),
]
CALLS = {"a": (4, 2048, 8, 2), "b": (1, 8192, 8, 2), "moe": (4, 2048, 4, 8)}  # (B, S, KV, G), D=128, window 4096
# (anchor, replacement) edits that make the diagnostic copy; each anchor must occur once
DIAG_EDITS = [
    ("typedef __nv_bfloat16 bf16;\n", "typedef __nv_bfloat16 bf16;\n#ifndef FLASH_WG_DIAG\n#define FLASH_WG_DIAG 0\n#endif\n"),
    ("        mbar_expect_bytes(&fullk[s], L::kKVBytes);\n",
     "        if (FLASH_WG_DIAG & 1) {\n          mbar_arrive(&fullk[s]);\n          mbar_arrive(&fullv[s]);\n"
     "          continue;\n        }\n        mbar_expect_bytes(&fullk[s], L::kKVBytes);\n"),
    ("    wgmma_fence();\n    if constexpr (QK) {", "    if (FLASH_WG_DIAG & 2) return;\n    wgmma_fence();\n    if constexpr (QK) {"),
    ("    const int k0 = j * kWgBN;\n", "    if (FLASH_WG_DIAG & 4) return;\n    const int k0 = j * kWgBN;\n"),
    ("  lo = a.window > 0 ? max(q0 + 1 - a.window, 0) / kWgBN : 0;\n",
     "  lo = a.window > 0 ? max(q0 + 1 - a.window, 0) / kWgBN : 0;\n  if (FLASH_WG_DIAG & 8) hi = lo;\n"),
]


def edited_source(out_dir: Path, i: int, edits) -> Path:
    src = SOURCE.read_text()
    for anchor, repl in edits:
        if src.count(anchor) != 1:
            sys.exit(f"the source no longer holds this anchor once: {anchor!r}")
        src = src.replace(anchor, repl)
    out = out_dir / f"flash_attn-edited{i}.cu"
    out.write_text(src)
    return out


def build(variants):
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, v in enumerate(variants):
        fields, *extra = v.split(",")
        bn, stages = fields.split(":")
        defs = [f"-DFLASH_WG_BN={bn}", f"-DFLASH_WG_STAGES={stages}"]
        defs += [f"-DFLASH_WG_DIAG={e.split('=')[1]}" for e in extra if e.startswith("DIAG=")]
        lib = out_dir / f"libflash_attn-variant{i}.so"
        src = edited_source(out_dir, i, DIAG_EDITS) if any(e.startswith("DIAG=") for e in extra) else SOURCE
        cmd = [kernels.nvcc_path(), *kernels.nvcc_flags(), "-Xptxas", "-v", *defs, "-o", str(lib), str(src)]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for v, (p, lib) in procs.items():
        log, _ = p.communicate()
        lines = log.splitlines()
        # ptxas's report on the wgmma kernels: the lines after each of their entry names
        rep = [ln.strip() for i, ln in enumerate(lines) if ("spill" in ln or "registers" in ln)
               and any("wgmma_kernel" in x for x in lines[max(0, i - 3):i])]
        rep += sorted({ln.strip() for ln in lines if "arning" in ln and "never referenced" not in ln})
        # ptxas's (C7513) note that it serialised a kernel's wgmma, by the kernel's D
        rep += [f"wgmma serialised at D={'64' if 'ILi64E' in ln else '128'}" for ln in lines if "C7513" in ln]
        print(f"[build] {v}: exit {p.returncode}; ptxas on the wgmma kernels: {' | '.join(rep)}")
        if p.returncode != 0:
            print(log[-6000:])
            continue
        built[v] = (lib, rep)
    return built


def use_library(lib_path):
    """Point the wrapper at one library (None: the default build)."""
    kernels._loaded.pop("flash_attn", None)
    if lib_path is not None:
        kernels._loaded["flash_attn"] = ctypes.CDLL(str(lib_path))


def inputs(B, S, T, KV, G, D, seed=0):
    rng = np.random.default_rng(seed)
    f = lambda shape: torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to("cuda", torch.bfloat16)  # noqa: E731
    return f((B * KV * G, S, D)), f((B * KV, T, D)), f((B * KV, T, D))


def check():
    """Worst max_abs_err and relative L2 of the wgmma route over CHECKS;
    raises on a miss, a wrong route or two calls that differ."""
    worst = [0.0, 0.0]
    for B, S, T, KV, G, D, causal, window in CHECKS:
        q, k, v = inputs(B, S, T, KV, G, D, seed=1)
        kw = dict(causal=causal, window=window, group=G)
        before = ops.flash_attention_fused.launches_by_route["wgmma"]
        got = ops.flash_attention_fused(q, k, v, **kw)
        again = ops.flash_attention_fused(q, k, v, **kw)
        torch.cuda.synchronize()
        if ops.flash_attention_fused.launches_by_route["wgmma"] != before + 2:
            raise RuntimeError(f"{B, S, T, KV, G, D} did not take the wgmma route")
        if not torch.equal(got, again):
            raise RuntimeError(f"{B, S, T, KV, G, D}: two calls differ")
        want = flash_attention_plain(q.float(), k.float(), v.float(), **kw)
        err = (got.float() - want).abs().max().item()
        rel = ((got.float() - want).norm() / want.norm()).item()
        ok = torch.allclose(got.float(), want, **BF16_TOL) and rel <= BF16_REL_L2 and torch.isfinite(got).all()
        print(f"[check] B={B} S={S} T={T} KV={KV} G={G} D={D} causal={causal} window={window}: max_abs_err "
              f"{err:.3e} relative L2 {rel:.3e} {'ok' if ok else 'MISS'}")
        if not ok:
            raise RuntimeError(f"{B, S, T, KV, G, D}: max_abs_err {err:.3e}, relative L2 {rel:.3e}")
        worst = [max(worst[0], err), max(worst[1], rel)]
    return worst


def median_ms(fn, flush):
    for _ in range(3):
        fn()
    times = []
    for _ in range(RUNS):
        flush.zero_()
        torch.cuda._sleep(2_000_000)  # the host enqueues the call while the device spins
        s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        s.record()
        fn()
        e.record()
        e.synchronize()
        times.append(s.elapsed_time(e))
    return float(np.median(times))


def time_calls(flush, route=None):
    out = {}
    for name, (B, S, KV, G) in CALLS.items():
        q, k, v = inputs(B, S, S, KV, G, 128, seed=9)
        out[name] = median_ms(lambda: ops.flash_attention_fused(q, k, v, causal=True, window=4096, group=G,
                                                                route=route), flush)
    return out


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    args = sys.argv[1:]
    sass = args[:1] == ["--sass"]
    variants = args[sass:] or DEFAULT_VARIANTS
    built = build(variants)
    os.makedirs(os.path.join(ROOT, "chiprun_out"), exist_ok=True)
    if sass and built:
        lib = next(iter(built.values()))[0]
        cuobjdump = str(Path(kernels.nvcc_path()).parent / "cuobjdump")
        out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, timeout=300).stdout
        with open(os.path.join(ROOT, "chiprun_out", "flash_attn_sass.txt"), "w") as f:
            f.write(out)
    flush = torch.empty(96 * 2**20, dtype=torch.uint8, device="cuda")
    results = {"variants": {}}
    for v, (lib, ptxas) in built.items():
        use_library(lib)
        rec = {"ptxas": ptxas}
        try:
            if "DIAG" not in v:
                rec["max_abs_err"], rec["rel_l2"] = check()
            rec["ms"] = time_calls(flush)
        except RuntimeError as e:
            print(f"[variant] {v}: FAILED {e}")
            rec["error"] = str(e)
        print(f"[variant] {v}: {json.dumps({k: x for k, x in rec.items() if k != 'ptxas'})}")
        results["variants"][v] = rec
    use_library(None)
    results["mma_route_ms"] = time_calls(flush, route="mma")
    sdpa = {}
    for name, (B, S, KV, G) in CALLS.items():
        q, k, v = inputs(B, S, S, KV, G, 128, seed=9)
        q4, k4, v4 = q.view(B, KV * G, S, 128), k.view(B, KV, S, 128), v.view(B, KV, S, 128)
        sdpa[name] = median_ms(lambda: torch.nn.functional.scaled_dot_product_attention(
            q4, k4, v4, is_causal=True, enable_gqa=True), flush)
    results["sdpa_ms"] = sdpa  # (b): is_causal without the window, so more work than the kernel's
    print(f"[yardstick] mma route {json.dumps(results['mma_route_ms'])}; sdpa {json.dumps(sdpa)}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip().splitlines()[0]
    results["nvidia_smi"] = smi
    with open(os.path.join(ROOT, "chiprun_out", "flash_attn_variants.json"), "w") as f:
        json.dump(results, f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()
