"""Build and load the port's hand-written CUDA kernels.

Each ``src/repro_torch/csrc/<name>.cu`` is compiled by ``nvcc`` for
``sm_90a`` into a shared library with a plain C interface,
``build/cuda/<name>-<hash>.so``, at the first use of any of them, and
loaded with ``ctypes``.  The hash covers the source and the flags, so a
changed source builds anew; the sources are built in parallel, one
``nvcc`` each.  ``build/`` is listed in ``.gitignore``.

Generated sources (the anchored kernels' instances, written by
``core/codegen_cuda.py``) build the same way through
``generated_library``: ``build/cuda/<name>-<hash>.so``, with ``csrc/``
on the include path.  Every generated source registered by then
(``register_generated``) builds in the same parallel round.  A library's
hash covers its source, the flags and every ``csrc/*.cuh`` header.

``nvcc`` is found through ``$CUDA_HOME``, then ``PATH``, then
``/usr/local/cuda``.  A missing ``nvcc`` or a failed build raises
``RuntimeError`` naming the command and its stderr: there is no fallback.
"""
from __future__ import annotations

import contextlib
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


def _headers_digest() -> bytes:
    h = hashlib.sha256()
    for hdr in sorted(CSRC.glob("*.cuh")):
        h.update(hdr.name.encode())
        h.update(hdr.read_bytes())
    return h.digest()


def _source_lib_path(stem: str, source: bytes) -> Path:
    h = hashlib.sha256(source)
    h.update(" ".join(NVCC_FLAGS).encode())
    h.update(_headers_digest())
    return BUILD_DIR / f"{stem}-{h.hexdigest()[:16]}.so"


def _lib_path(src: Path) -> Path:
    return _source_lib_path(src.stem, src.read_bytes())


def _build(jobs: list[tuple[Path, Path]]) -> None:
    """Compile each (source, library) pair, all ``nvcc`` runs started
    together, ``csrc/`` on the include path."""
    if not jobs:
        return
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = []
    for src, lib in jobs:
        # build under a temporary name, then rename: concurrent builders
        # never load a half-written library
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(src)]
        procs.append((lib, tmp, cmd, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    failures = []
    for lib, tmp, cmd, proc in procs:
        _, err = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"$ {' '.join(cmd)}\n{err}")
        else:
            os.replace(tmp, lib)
    if failures:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failures))


def build_all() -> dict[str, Path]:
    """Build every hand-written source whose library is missing, and every
    generated source registered so far, all ``nvcc`` runs started
    together; returns {name: library path} of the hand-written ones."""
    sources = sorted(CSRC.glob("*.cu"))
    libs = {s.stem: _lib_path(s) for s in sources}
    jobs = [(s, libs[s.stem]) for s in sources if not libs[s.stem].exists()]
    _build(jobs + _pending_generated())
    return libs


#: {name: source} of the generated sources registered for the build.
_GENERATED: dict[str, str] = {}


def register_generated(name: str, source: str) -> None:
    """Queue a generated source: the next build round compiles it."""
    _GENERATED[name] = source


def _generated_paths(name: str, source: str) -> tuple[Path, Path]:
    lib = _source_lib_path(name, source.encode())
    return lib.with_suffix(".cu"), lib


def _pending_generated() -> list[tuple[Path, Path]]:
    jobs = []
    for name, source in sorted(_GENERATED.items()):
        src, lib = _generated_paths(name, source)
        if not lib.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            src.write_text(source)
            jobs.append((src, lib))
    return jobs


def build_generated(name: str, source: str) -> Path:
    """The library of a generated source, built if missing -- together
    with every other registered generated source still unbuilt, and the
    hand-written ones (one ``nvcc`` each, all started together)."""
    register_generated(name, source)
    lib = _generated_paths(name, source)[1]
    if not lib.exists():
        build_all()
    return lib


@functools.cache
def generated_library(name: str, source: str) -> ctypes.CDLL:
    """The loaded library of a generated source (built on first use)."""
    return ctypes.CDLL(str(build_generated(name, source)))


@functools.cache
def library(name: str) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
    libs = build_all()
    if name not in libs:
        raise RuntimeError(f"no CUDA source csrc/{name}.cu")
    return ctypes.CDLL(str(libs[name]))


#: While ``core/capture.py`` captures a CUDA graph: {counter owner:
#: launches recorded into the graph}; else None.
capturing: dict | None = None

#: Depth of ``uncounted`` blocks: launches made inside one are not counted.
_uncounted = 0


@contextlib.contextmanager
def uncounted():
    """Launches inside this block count nowhere: the measured tuner's
    (``core/autotune.py``) are not the path's, even when a compile --
    and so the tuner -- runs inside a step's warm-up."""
    global _uncounted
    _uncounted += 1
    try:
        yield
    finally:
        _uncounted -= 1


class LaunchCount:
    """A launch counter of its own (``launches``) for one form of a
    kernel whose wrapper counts every form elsewhere too."""

    def __init__(self, name: str):
        self.name = name
        self.launches = 0


def count(owner, n: int = 1) -> None:
    """Count ``n`` launches of ``owner``'s kernel in ``owner.launches``
    (a wrapper calls this where it launches).  A launch recorded into a
    CUDA graph being captured runs only when the graph is replayed, so it
    is tallied for the graph, which counts it at each replay
    (``core/capture.py``).  Inside ``uncounted`` nothing is counted."""
    if _uncounted:
        return
    if capturing is None:
        owner.launches += n
    else:
        capturing[owner] = capturing.get(owner, 0) + n


def check(err: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
