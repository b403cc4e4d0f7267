"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``src/repro_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on its own into ``build/kernels/lib<name>-<hash>.so`` at the repo
root (a directory ``.gitignore`` lists), for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

The hash covers the source, every ``csrc/*.cuh`` header it includes
(``hopper.cuh``: the Hopper helpers of the flash and SSD kernels) and the
flags, so an edited kernel or header rebuilds and an unchanged one loads
from the previous build; ``csrc/`` is on the include path.  No
``--use_fast_math``: IEEE sqrt and division keep each kernel op-for-op with
its plain PyTorch version.  nvcc's output (``-Xptxas -v``: registers, spills) is kept beside
the library as ``.log``.  Nothing is built at import time: a kernel's first
launch builds it, and ``build_all`` starts one nvcc per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("masked_adam", "flash_attention", "ssd_chunk", "grouped_mm")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from source")


def headers(src: Path) -> list[Path]:
    """The ``csrc/*.cuh`` headers ``src`` includes (``#include "x.cuh"``),
    and theirs, in the order first met."""
    found: list[Path] = []
    todo = [src]
    while todo:
        text = todo.pop(0).read_text()
        for name in re.findall(r'^\s*#include\s+"([^"]+\.cuh)"', text, re.M):
            path = CSRC / name
            if path not in found:
                found.append(path)
                todo.append(path)
    return found


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes())
    for header in headers(src):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def nvcc_command(src: Path, out: Path) -> list[str]:
    """The nvcc command that builds ``src`` into ``out``, with ``csrc/`` on
    the include path (the phase-timing tools build copies from ``build/``)."""
    return [nvcc_path(), *NVCC_FLAGS, "-I", str(CSRC), "-o", str(out), str(src)]


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for ``name`` unless its library is built; the output goes
    to a per-process temporary name that ``_finish`` renames atomically."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    proc = subprocess.Popen(nvcc_command(CSRC / f"{name}.cu", tmp),
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started: tuple[subprocess.Popen, Path, Path]) -> None:
    proc, tmp, out = started
    log, _ = proc.communicate()
    out.with_suffix(".log").write_text(log)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    os.replace(tmp, out)


def build_all(names: tuple[str, ...] = KERNELS) -> dict[str, Path]:
    """Build every named kernel, all nvcc processes running at once."""
    started = {n: _start(n) for n in names}
    errors = []
    for n, s in started.items():
        if s is not None:
            try:
                _finish(n, s)
            except RuntimeError as e:
                errors.append(str(e))
    if errors:
        raise RuntimeError("\n".join(errors))
    return {n: library_path(n) for n in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``name``, building it first if needed."""
    if name not in _loaded:
        path = build_all((name,))[name]
        _loaded[name] = ctypes.CDLL(str(path))
    return _loaded[name]
