"""How the port's CUDA libraries are named, on the CPU (nothing is compiled).

``repro_torch.kernels`` builds each library once and loads it by a file
name that carries a hash of the flags, the sources and every header they
include.  A header shared between kernels (``kernels/csrc/hopper.cuh``)
that changes must change the name, or a stale library would be loaded.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")

from repro_torch import kernels  # noqa: E402

pytestmark = pytest.mark.torch_port


@pytest.fixture
def tree(tmp_path, monkeypatch):
    """A kernel tree of its own: lib/csrc/lib.cu includes a header beside it
    and a shared one, which includes another; other/csrc/other.cu includes
    nothing."""
    (tmp_path / "lib" / "csrc").mkdir(parents=True)
    (tmp_path / "other" / "csrc").mkdir(parents=True)
    (tmp_path / "csrc").mkdir()
    files = {
        "lib/csrc/lib.cu": '#include <cuda_runtime.h>\n#include "local.cuh"\n  #  include "shared.cuh"\nint f();\n',
        "lib/csrc/local.cuh": "#pragma once\nint local();\n",
        "csrc/shared.cuh": '#pragma once\n#include "nested.cuh"\nint shared();\n',
        "csrc/nested.cuh": "#pragma once\nint nested();\n",
        "csrc/unused.cuh": "#pragma once\nint unused();\n",
        "other/csrc/other.cu": "int g();\n",
    }
    for rel, text in files.items():
        (tmp_path / rel).write_text(text)
    monkeypatch.setattr(kernels, "SOURCE_DIR", tmp_path)
    monkeypatch.setattr(kernels, "INCLUDE_DIR", tmp_path / "csrc")
    monkeypatch.setattr(kernels, "BUILD_DIR", tmp_path / "_build")
    monkeypatch.setattr(kernels, "LIBRARIES", {"lib": ("lib/csrc/lib.cu",), "other": ("other/csrc/other.cu",)})
    return tmp_path


def test_library_files_follow_quoted_includes(tree):
    names = [str(f.relative_to(tree)) for f in kernels.library_files("lib")]
    assert names == ["lib/csrc/lib.cu", "lib/csrc/local.cuh", "csrc/shared.cuh", "csrc/nested.cuh"]
    assert [f.name for f in kernels.library_files("other")] == ["other.cu"]


@pytest.mark.parametrize("edited, changes", [
    ("lib/csrc/lib.cu", True), ("lib/csrc/local.cuh", True), ("csrc/shared.cuh", True), ("csrc/nested.cuh", True),
    ("csrc/unused.cuh", False), ("other/csrc/other.cu", False),
])
def test_editing_a_file_the_library_includes_renames_it(tree, edited, changes):
    """An edit to the source or to any header it includes, directly or
    through another header, gives the library a new file name; an edit
    elsewhere does not."""
    before = kernels._library_path("lib")
    assert before.parent == tree / "_build" and before.name.startswith("liblib-")
    f = tree / edited
    f.write_text(f.read_text() + "// edited\n")
    assert (kernels._library_path("lib") != before) == changes


def test_missing_header_raises(tree):
    (tree / "csrc" / "nested.cuh").unlink()
    with pytest.raises(FileNotFoundError, match="nested.cuh"):
        kernels._library_path("lib")


def test_the_port_libraries_hash_the_shared_header():
    """flash_attn and moe_gemm include kernels/csrc/hopper.cuh, and the build
    passes its directory to nvcc."""
    shared = kernels.INCLUDE_DIR / "hopper.cuh"
    for name in ("flash_attn", "moe_gemm"):
        assert shared in kernels.library_files(name), name
    flags = kernels.nvcc_flags()
    assert flags[: len(kernels.NVCC_FLAGS)] == kernels.NVCC_FLAGS
    assert flags[-2:] == ("-I", str(kernels.INCLUDE_DIR))
