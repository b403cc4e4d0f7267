"""Build the port's CUDA kernels with nvcc and load them with ctypes.

Each ``src/repro_torch/csrc/<name>.cu`` has a plain C interface and is
compiled on its own into ``build/kernels/lib<name>-<hash>.so`` at the repo
root (a directory ``.gitignore`` lists), for ``sm_90a``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
         -Xcompiler -fPIC -Xptxas -v -o lib<name>-<hash>.so <name>.cu

The hash covers the source and the flags, so an edited kernel rebuilds and
an unchanged one loads from the previous build.  No ``--use_fast_math``:
IEEE sqrt and division keep each kernel op-for-op with its plain PyTorch
version.  nvcc's output (``-Xptxas -v``: registers, spills) is kept beside
the library as ``.log``.  Nothing is built at import time: a kernel's first
launch builds it, and ``build_all`` starts one nvcc per source at once.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent.parent / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
KERNELS = ("masked_adam", "flash_attention", "ssd_chunk")

_loaded: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for cand in (os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.isfile(cand) and os.access(cand, os.X_OK):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH): "
                       "the port's CUDA kernels are built from source")


def library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    h = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> tuple[subprocess.Popen, Path, Path] | None:
    """Start nvcc for ``name`` unless its library is built; the output goes
    to a per-process temporary name that ``_finish`` renames atomically."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
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
