"""Hand-written Hopper kernels of the port, and how they are built.

Each kernel subpackage holds:
  csrc/*.cu  the CUDA C++ source for sm_90a, with a plain C entry point
             (headers shared between kernels live in ``csrc/`` beside this
             file and are included by name, ``#include "hopper.cuh"``)
  ops.py     the wrapper: checks inputs, launches the kernel on CUDA tensors
             (or raises), runs the plain version on CPU tensors, counts launches
  ref.py     the plain PyTorch version the tests and ``chip_smoke.py`` hold
             the kernel against

:func:`load_library` compiles a kernel's sources with ``nvcc`` into a shared
library under ``_build/`` at first use and loads it with ``ctypes``.  The
library's file name carries a hash of the flags, the sources and every
header they include (``#include "..."``, followed recursively), so a
rebuild happens when any of them changes and only then.  :func:`build_all`
starts one ``nvcc`` per library at once.  Nothing here runs when the module
is imported.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from pathlib import Path

SOURCE_DIR = Path(__file__).resolve().parent  # LIBRARIES' paths are relative to it
INCLUDE_DIR = SOURCE_DIR / "csrc"  # headers shared between kernels
BUILD_DIR = SOURCE_DIR / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC")
_INCLUDE = re.compile(r'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.MULTILINE)

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


def nvcc_flags() -> tuple:
    """NVCC_FLAGS and the search path of the shared headers."""
    return (*NVCC_FLAGS, "-I", str(INCLUDE_DIR))


def library_files(name: str) -> list:
    """The sources of library ``name`` and every header they include with
    ``#include "..."``, recursively (found beside the including file, then in
    INCLUDE_DIR, as nvcc looks), each once, in the order first met."""
    files, todo = [], [SOURCE_DIR / rel for rel in LIBRARIES[name]]
    while todo:
        f = todo.pop(0)
        if f in files:
            continue
        files.append(f)
        for inc in _INCLUDE.findall(f.read_text()):
            found = next((c for c in (f.parent / inc, INCLUDE_DIR / inc) if c.is_file()), None)
            if found is None:
                raise FileNotFoundError(f'{f} includes "{inc}", found neither beside it nor in {INCLUDE_DIR}')
            todo.append(found.resolve())
    return files


def _library_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in library_files(name):
        h.update(f.name.encode() + b"\0" + f.read_bytes())
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
    srcs = [str(SOURCE_DIR / rel) for rel in LIBRARIES[name]]
    cmd = [nvcc_path(), *nvcc_flags(), "-o", tmp, *srcs]
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
