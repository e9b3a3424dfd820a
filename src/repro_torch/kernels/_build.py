"""Build and load the port's hand-written CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface,
``build/cuda/<name>-<hash>.so``, at the first use of any of them, and
loaded with ``ctypes``.  The hash covers the source and the flags, so a
changed source builds anew; the sources are built in parallel, one
``nvcc`` each.  ``build/`` is listed in ``.gitignore``.

``nvcc`` is found through ``$CUDA_HOME``, then ``PATH``, then
``/usr/local/cuda``.  A missing ``nvcc`` or a failed build raises
``RuntimeError`` naming the command and its stderr: there is no fallback.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "cuda"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")


def nvcc_path() -> str:
    """The ``nvcc`` to build with, or ``RuntimeError`` if there is none."""
    home = os.environ.get("CUDA_HOME")
    candidates = ([str(Path(home) / "bin" / "nvcc")] if home else []) + [
        shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found ($CUDA_HOME/bin, PATH, /usr/local/cuda/bin): the "
        "hand-written CUDA kernels of src/repro_torch/csrc are built with "
        "nvcc on the machine with the card")


def _lib_path(src: Path) -> Path:
    h = hashlib.sha256(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{src.stem}-{h.hexdigest()[:16]}.so"


def build_all() -> dict[str, Path]:
    """Build every source whose library is missing, all ``nvcc`` runs
    started together; returns {name: library path}."""
    sources = sorted(CSRC.glob("*.cu"))
    libs = {s.stem: _lib_path(s) for s in sources}
    todo = [s for s in sources if not libs[s.stem].exists()]
    if not todo:
        return libs
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src in todo:
        # build under a temporary name, then rename: concurrent builders
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, str(src)]
        procs.append((src, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for src, tmp, cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"$ {' '.join(cmd)}\n{err}")
        else:
            os.replace(tmp, libs[src.stem])
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))
    return libs


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    libs = build_all()
    if name not in libs:
        raise RuntimeError(f"no CUDA source csrc/{name}.cu")
    return ctypes.CDLL(str(libs[name]))


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
