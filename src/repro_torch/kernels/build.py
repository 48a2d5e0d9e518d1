"""Build and load the port's CUDA kernels.

One ``nvcc`` call compiles every ``csrc/*.cu`` for ``sm_90a`` into one
shared library with a plain C interface, loaded with ``ctypes``.  The
build happens on first use, into ``kernels/_build/`` (listed in
``.gitignore``); the library's name carries a hash of the sources and
flags, so an edited source is rebuilt.  Each builder writes its own
temporary file and renames it into place, so concurrent builders never
load a half-written library.  ``--use_fast_math`` is never passed: the
kernels' divisions and roundings stay IEEE.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent / "_build"
FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC"]

_LIB = None
build_seconds = 0.0   # wall time of this process's build (0 on a cache hit)


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    found = shutil.which("nvcc") or shutil.which(
        os.path.join(cuda_home, "bin", "nvcc"))
    if found is None:
        raise RuntimeError(
            "nvcc not found (looked on PATH and in $CUDA_HOME/bin): the CUDA "
            "kernels cannot be built on this machine")
    return found


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def _tag(sources: list[Path]) -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources:
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, sources: list[Path], lib: Path) -> None:
    tmp = lib.with_name(f"{lib.name}.{os.getpid()}.tmp")
    proc = subprocess.run([nvcc, *FLAGS, "-shared", *map(str, sources),
                           "-o", str(tmp)], stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed\n{proc.stdout}")
    os.replace(tmp, lib)


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    sources = _sources()
    lib = BUILD_DIR / f"librepro_torch_kernels.{_tag(sources)}.so"
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        _compile(_nvcc(), sources, lib)
        build_seconds = time.perf_counter() - t0
    cdll = ctypes.CDLL(str(lib))
    p, i32, i64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_uint32)
    cdll.ssca_update_launch.argtypes = [p, p, p, p, p, p, p, p, i64, p]
    cdll.ssca_update_launch.restype = i32
    cdll.masked_sum_launch.argtypes = [p, i32, i64, i32, u32, u32, u32, i32,
                                       p, p, p]
    cdll.masked_sum_launch.restype = i32
    cdll.kernel_error_string.argtypes = [i32]
    cdll.kernel_error_string.restype = ctypes.c_char_p
    _LIB = cdll
    return cdll


def check(status: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if status:
        msg = load().kernel_error_string(status).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: {msg} ({status})")
