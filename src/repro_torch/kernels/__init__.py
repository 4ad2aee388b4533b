"""Hand-written Hopper kernels of the port, and how they are built.

Each kernel subpackage holds:
  csrc/*.cu  the CUDA C++ source for sm_90a, with a plain C entry point
  ops.py     the wrapper: checks inputs, launches the kernel on CUDA tensors
             (or raises), runs the plain version on CPU tensors, counts launches
  ref.py     the plain PyTorch version the tests and ``chip_smoke.py`` hold
             the kernel against

:func:`load_library` compiles a kernel's sources with ``nvcc`` into a shared
library under ``_build/`` at first use and loads it with ``ctypes``.  The
library's file name carries a hash of the sources and flags, so a rebuild
happens only when they change.  :func:`build_all` starts one ``nvcc`` per
library at once.  Nothing here runs when the module is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

BUILD_DIR = Path(__file__).resolve().parent / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")

# library name -> sources, relative to this directory
LIBRARIES = {
    "luong_attn": ("luong_attn/csrc/luong_attn.cu",),
    "lstm_cell": ("lstm_cell/csrc/lstm_cell.cu",),
    "flash_attn": ("flash_attn/csrc/flash_attn.cu",),
    "moe_gemm": ("moe_gemm/csrc/moe_gemm.cu",),
}

_loaded: dict = {}


def fit_block(n: int, want: int) -> int:
    """Largest divisor of ``n`` that is <= ``want`` (at least 1)."""
    want = max(1, min(want, n))
    while n % want:
        want -= 1
    return want


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for rel in LIBRARIES[name]:
        h.update((Path(__file__).resolve().parent / rel).read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start_build(name: str):
    """Start ``nvcc`` for one library unless its current build exists;
    returns (process, tmp path, final path) or None."""
    out = _library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(prefix=out.stem + ".", suffix=".so.tmp", dir=BUILD_DIR)
    os.close(fd)
    srcs = [str(Path(__file__).resolve().parent / rel) for rel in LIBRARIES[name]]
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp, *srcs]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish_build(name: str, started) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f"nvcc failed for {name} (exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)  # atomic: a concurrent loader sees the old or the whole new file


def build_all(names=None) -> None:
    """Compile every library (or ``names``) that is not built yet, one
    ``nvcc`` per library, all started together."""
    names = list(LIBRARIES) if names is None else list(names)
    started = {n: _start_build(n) for n in names}
    errors = []
    for n, s in started.items():
        if s is None:
            continue
        try:
            _finish_build(n, s)
        except RuntimeError as e:
            errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))


def load_library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name``, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build_all([name])
        lib = ctypes.CDLL(str(_library_path(name)))
        _loaded[name] = lib
    return lib
