#!/usr/bin/env python3
"""Build design variants of the ``luong_attn`` kernels, check them and time
them on one NVIDIA GPU.  Run from the repository root:

    python3 tools/luong_attn_variants.py [--sass] [STAGES:COLS[,SPLIT=0|1][,DIAG=BITS][,D:NAME=VALUE] ...]

Each variant is ``src/repro_torch/kernels/luong_attn/csrc/luong_attn.cu``
built with ``-DLUONG_WG_STAGES=STAGES`` (the ring depth of the "wgmma"
route's two GEMMs) and ``-DLUONG_DEC_COLS=COLS`` (columns of each weight a
block of the "decode" route owns: 8 gives h / 8 blocks, 128 at h = 1024; 16
gives 64), into a library of its own, one ``nvcc -Xptxas -v`` per variant,
all started together.  ``SPLIT=0`` writes C once in bf16 instead of C_hi +
C_lo (the "wgmma" route's depth 2h instead of 3h).  ``DIAG=BITS`` takes work
out (1 no wgmma products, 2 no epilogue stores, 4 no scores/softmax/context
kernel, 8 no TMA copies, 16 no grid barriers, 32 no weight loads in the
"decode" kernel, 64 the "decode" kernel returns at once, 128 no scores
products, 256 no context products, 512 no copies of S in the scores and
context kernel, 1024 no phase 2, 2048 no phase 3, 4096 no phase-4 product
in the "decode" kernel); such a variant is
timed but not checked; every variant's three "wgmma" kernels are also timed
one by one under ``torch.profiler`` at the training step's rows.  ``--sass``
writes the first variant's SASS to ``chiprun_out/luong_attn_sass.txt`` and
counts, per kernel, its HGMMA instructions and the ``WARPGROUP.DEPBAR``
waits among them (one wait per HGMMA means ptxas serialised them).

For each variant it prints ptxas's registers and spills, then checks the
"decode" and "wgmma" routes at ``CHECKS`` (bf16, against the plain
version's fp32 output on the same inputs, within twice the error of that
output's own bf16 rounding, by relative L2 and by max abs; two calls
bit-identical; a control with each row's last unmasked position dropped
must miss the bound), and times both routes (CUDA events, L2 flushed) at
R = 4, 16, 32 and 64 decode rows (B = R, N = 1, M = 64; the decode route
takes up to 32, or 16 at 16 columns a block) and at the training step's 2048 rows (B = 64, N = 32,
M = 32).  Beside them, with the default library: the "fma" route's kernel, the
plain version and the "torch" stage path (the yardstick).  Writes
``chiprun_out/luong_attn_variants.json``; the last line is the card's
``nvidia-smi`` name and power limit.  Needs a card and ``nvcc``.
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

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(ROOT, "src"))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from repro_torch import kernels  # noqa: E402
from repro_torch.kernels.luong_attn import ops  # noqa: E402
from repro_torch.kernels.luong_attn.ref import luong_attention_ref  # noqa: E402

DEFAULT_VARIANTS = ["5:8", "5:8,SPLIT=0", "4:8", "6:8", "5:16", "5:8,DIAG=1", "5:8,DIAG=3", "5:8,DIAG=8",
                    "5:8,DIAG=9", "5:8,DIAG=4", "5:8,DIAG=16", "5:8,DIAG=32", "5:8,DIAG=48", "5:8,DIAG=64"]
SOURCE = Path(kernels.__file__).resolve().parent / "luong_attn" / "csrc" / "luong_attn.cu"
RUNS = 30
# (B, N, M, h, all-masked row): the decode ticks, ragged rows, one and 129 positions, the training step
CHECKS = [
    (4, 1, 64, 1024, None), (8, 1, 64, 1024, None), (16, 1, 64, 1024, 3), (32, 1, 64, 1024, None),
    (8, 1, 129, 1024, None), (4, 1, 1, 1024, None), (3, 2, 5, 64, 1), (2, 16, 12, 64, None), (1, 64, 33, 128, None),
    (3, 43, 20, 1024, None), (4, 48, 40, 1024, 2), (2, 24, 129, 1024, None), (2, 40, 1, 1024, None),
    (64, 32, 32, 1024, None),
]
TIMED = [(4, 1, 64), (16, 1, 64), (32, 1, 64), (64, 1, 64), (64, 32, 32)]  # (B, N, M) at h = 1024


def build(variants):
    out_dir = kernels.BUILD_DIR / "variants"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for i, v in enumerate(variants):
        fields, *extra = v.split(",")
        stages, cols = fields.split(":")
        defs = [f"-DLUONG_WG_STAGES={stages}", f"-DLUONG_DEC_COLS={cols}"]
        defs += [f"-DLUONG_C_SPLIT={e.split('=')[1]}" for e in extra if e.startswith("SPLIT=")]
        defs += [f"-DLUONG_DIAG={e.split('=')[1]}" for e in extra if e.startswith("DIAG=")]
        defs += [f"-D{e[2:]}" for e in extra if e.startswith("D:")]  # any other define, D:NAME=VALUE
        lib = out_dir / f"libluong_attn-variant{i}.so"
        cmd = [kernels.nvcc_path(), *kernels.nvcc_flags(), "-Xptxas", "-v", *defs, "-o", str(lib), str(SOURCE)]
        procs[v] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True), lib)
    built = {}
    for v, (p, lib) in procs.items():
        log, _ = p.communicate()
        lines = log.splitlines()
        rep = []
        for i, ln in enumerate(lines):  # ptxas's report on the new kernels: the lines after each entry name
            m = re.search(r"Compiling entry function '\w*(luong_(wg|ctx|dec)_kernel\w*)'", ln)
            if m:
                tail = [x.strip() for x in lines[i + 1:i + 5] if "registers" in x or "spill" in x]
                rep.append(f"{m.group(1)[:32]}: {'; '.join(tail)}")
        rep += sorted({ln.strip() for ln in lines if "arning" in ln and "never referenced" not in ln})
        rep += [ln.strip() for ln in lines if "C7513" in ln or "C7515" in ln]
        print(f"[build] {v}: exit {p.returncode}")
        for r in rep:
            print(f"[build]   {r}")
        if p.returncode != 0:
            print(log[-8000:])
            continue
        built[v] = (lib, rep)
    return built


def use_library(lib_path):
    """Point the wrapper at one library (None: the default build)."""
    kernels._loaded.pop("luong_attn", None)
    if lib_path is not None:
        kernels._loaded["luong_attn"] = ctypes.CDLL(str(lib_path))


def fits(route, h, R, cols):
    """Whether the variant's ``route`` takes R rows of width h: at 16 columns a block, the decode
    kernel's shared memory holds 16 rows, not 32."""
    return ops.route_fits(route, torch.bfloat16, h, R) and not (route == "decode" and cols == 16 and R > 16)


def check(route, cols):
    """Worst (relative L2, max abs) of ``route`` over the CHECKS it takes, with
    the bounds beside them; raises on a miss, a control inside the bound or two
    calls that differ."""
    worst = {"rel": 0.0, "err": 0.0, "bound_rel": None, "bound_err": None}
    for B, N, M, h, masked in CHECKS:
        if not fits(route, h, B * N, cols):
            continue
        s = dict(B=B, N=N, M=M, h=h)
        args = cs.luong_inputs(s, torch.bfloat16, seed=1, masked_row=masked, model_scales=h >= 1024)
        rel, err, b_rel, b_err = cs.luong_bf16_check(f"{s}", route, args, control=M > 1)
        if rel >= worst["rel"]:
            worst.update(rel=rel, bound_rel=b_rel)
        if err >= worst["err"]:
            worst.update(err=err, bound_err=b_err)
    return worst


def time_routes(flush, routes, cols=8):
    """Median device ms of each route at each TIMED shape it takes, with the plain version's and the
    yardstick's beside them when "plain" is asked."""
    out = {}
    for B, N, M in TIMED:
        s = dict(B=B, N=N, M=M, h=1024)
        H, S, mask, wa, wc = cs.luong_inputs(s, torch.bfloat16, seed=9, model_scales=True)
        args = (H, S, mask.to(torch.int32), wa, wc)
        row = {}
        for r in routes:
            if r == "plain":
                row[r] = cs._median_ms(lambda: luong_attention_ref(H, S, mask, wa, wc[:1024], wc[1024:]), RUNS, flush, True)
            elif r == "torch":
                row[r] = cs._median_ms(lambda: cs.luong_torch_path(*args), RUNS, flush, True)
            elif fits(r, 1024, B * N, cols):
                try:
                    row[r] = cs._median_ms(lambda: ops.luong_attention_fused(*args, route=r), RUNS, flush, True)
                except RuntimeError as e:  # a launch the variant refuses; the other routes are still timed
                    row[r] = f"error: {e}"
        out[f"R={B * N} M={M}"] = row
        print(f"[time] R={B * N} (B={B} N={N}) M={M}: {json.dumps(row)}", flush=True)
    return out


def kernel_split(flush):
    """Device time of each kernel of one "wgmma" call at the training step's rows, from torch.profiler."""
    from torch.profiler import ProfilerActivity, profile

    H, S, mask, wa, wc = cs.luong_inputs(dict(B=64, N=32, M=32, h=1024), torch.bfloat16, seed=9, model_scales=True)
    args = (H, S, mask.to(torch.int32), wa, wc)
    ops.luong_attention_fused(*args, route="wgmma")
    flush.zero_()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        ops.luong_attention_fused(*args, route="wgmma")
        torch.cuda.synchronize()
    return {e.key[:60]: round(e.self_device_time_total / 1e3, 4) for e in prof.key_averages()
            if "luong_" in e.key and e.self_device_time_total > 0}


def sass_report(lib):
    cuobjdump = str(Path(kernels.nvcc_path()).parent / "cuobjdump")
    out = subprocess.run([cuobjdump, "-sass", str(lib)], capture_output=True, text=True, timeout=300).stdout
    with open(os.path.join(ROOT, "chiprun_out", "luong_attn_sass.txt"), "w") as f:
        f.write(out)
    report = {}
    for block in re.split(r"\n\s*Function : ", out)[1:]:
        name = block.split("\n", 1)[0].strip()
        m = re.search(r"luong_(wg|ctx|dec)_kernel\w{0,12}", name)
        if m:
            key = m.group(0)
            report[key] = {op: block.count(op) for op in ("HGMMA", "WARPGROUP.DEPBAR", "WARPGROUP.ARRIVE", "STSM",
                                                          "SHFL", "LDGSTS", "FFMA", "CALL")}
            report[key]["instructions"] = len(re.findall(r"/\*[0-9a-f]{4}\*/", block))
    print(f"[sass] {json.dumps(report)}")
    return report


def main():
    if not torch.cuda.is_available():
        print("needs an NVIDIA GPU", file=sys.stderr)
        sys.exit(2)
    torch.backends.cuda.matmul.allow_tf32 = False
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
    out_json = os.path.join(ROOT, "chiprun_out", "luong_attn_variants.json")
    for v, (lib, ptxas) in built.items():
        t0 = time.perf_counter()
        use_library(lib)
        rec = {"ptxas": ptxas}
        try:
            cols = int(v.split(",")[0].split(":")[1])
            if "DIAG" not in v:
                rec["decode_err"] = check("decode", cols)
                rec["wgmma_err"] = check("wgmma", cols)
            rec["ms"] = time_routes(flush, ("decode", "wgmma"), cols)
            rec["wgmma_kernels_ms"] = kernel_split(flush)
        except RuntimeError as e:
            print(f"[variant] {v}: FAILED {e}")
            rec["error"] = str(e)
        rec["seconds"] = round(time.perf_counter() - t0, 1)
        print(f"[variant] {v}: {json.dumps({k: x for k, x in rec.items() if k != 'ptxas'})}", flush=True)
        results["variants"][v] = rec
        with open(out_json, "w") as f:  # after each variant, so a cut run keeps what it measured
            json.dump(results, f, indent=1)
    use_library(None)
    results["beside"] = time_routes(flush, ("fma", "plain", "torch"))
    smi = cs.nvidia_smi_line()
    results["nvidia_smi"] = smi
    with open(out_json, "w") as f:
        json.dump(results, f, indent=1)
    print(smi)


if __name__ == "__main__":
    main()
