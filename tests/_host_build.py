"""Generated CUDA C++ built for the host with g++, for the CPU tests:
``csrc/chain.cuh`` makes ``__host__`` and ``__device__`` empty there, so
the chains of the anchored kernels and the streaming groups build as
they stand, and their host harnesses run them on host arrays."""
import ctypes
import os
import shutil
import subprocess

import pytest

CSRC = os.path.join(os.path.dirname(__file__), "..", "src", "repro_torch",
                    "csrc")


def gxx(tmp_path, source: str, name: str) -> ctypes.CDLL:
    """``source`` compiled with g++ into a shared library and loaded."""
    exe = shutil.which("g++")
    if exe is None:
        pytest.skip("no g++ on this host")
    src = tmp_path / f"{name}.cpp"
    src.write_text(source)
    lib = tmp_path / f"{name}.so"
    r = subprocess.run([exe, "-std=c++17", "-O1", "-shared", "-fPIC", "-I",
                        CSRC, "-o", str(lib), str(src)],
                       capture_output=True, text=True)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(lib))


def ptrs(arrays):
    """A ``void*`` array of numpy arrays' data."""
    return (ctypes.c_void_p * max(1, len(arrays)))(
        *[a.ctypes.data for a in arrays])
