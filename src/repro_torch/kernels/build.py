"""Build the port's CUDA sources with ``nvcc`` and load them with ctypes.

Each source under ``kernels/*/csrc`` has a plain C interface and is
compiled on first use (or by :func:`build_all`, all sources at once) into
a shared library under ``build/`` at the repository root (git-ignored):

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \\
         -Xcompiler -fPIC -o build/lib<name>-<hash>.so <source>

The file name carries a hash of the source and the flags, so an edited
source is rebuilt and a stale library is never loaded.  Nothing is
imported or compiled when this module is imported.  :func:`loads` counts
the libraries loaded in this process.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parent
BUILD_DIR = _PKG.parents[2] / "build"

#: name -> CUDA source, relative to this package
SOURCES = {
    "intersect": _PKG / "intersect" / "csrc" / "intersect.cu",
    "flash_attention": _PKG / "flash_attention" / "csrc" / "flash_attention.cu",
    "flash_attention_bwd": _PKG / "flash_attention" / "csrc"
    / "flash_attention_bwd.cu",
    "segsum": _PKG / "segsum" / "csrc" / "segsum.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v",
)

_LIBS: dict[str, ctypes.CDLL] = {}
#: one build or load at a time: the server's distributed attempts run on
#: worker threads, and two builds of one source would share a temp file
_LIB_LOCK = threading.Lock()

#: name -> (seconds, nvcc's stderr: register / shared-memory report)
BUILD_LOG: dict[str, tuple[float, str]] = {}


def nvcc_path() -> str:
    """The ``nvcc`` on ``PATH``, else the CUDA toolkit's."""
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found (looked on PATH and under CUDA_HOME or "
        "/usr/local/cuda); the port's kernels are built from source"
    )


def _target(name: str) -> Path:
    src = SOURCES[name]
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(name: str, out: Path) -> None:
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(SOURCES[name])]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {SOURCES[name]} (exit {proc.returncode}):\n"
            f"{proc.stdout}{proc.stderr}"
        )
    os.replace(tmp, out)  # atomic: a concurrent build never loads a stub
    BUILD_LOG[name] = (time.perf_counter() - t0, proc.stderr)


def build_all() -> None:
    """Build every source whose library is missing, one ``nvcc`` per
    source, all started together; raise if any build fails."""
    todo = [n for n in SOURCES if not _target(n).exists()]
    if not todo:
        return
    with ThreadPoolExecutor(len(todo)) as pool:
        for fut in [pool.submit(_build, n, _target(n)) for n in todo]:
            fut.result()


def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of source ``name``, built if needed."""
    lib = _LIBS.get(name)
    if lib is None:
        with _LIB_LOCK:
            lib = _LIBS.get(name)
            if lib is None:
                out = _target(name)
                if not out.exists():
                    _build(name, out)
                lib = ctypes.CDLL(str(out))
                _LIBS[name] = lib
    return lib


def loads() -> int:
    """How many libraries this process has loaded (each built first where
    it was missing): what the port compiles at first use, so the
    triangle server's ``jit_compiles`` counts it.  A library is never
    unloaded."""
    return len(_LIBS)
