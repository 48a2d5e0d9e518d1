"""Build and load the port's CUDA kernels.

Every ``csrc/*.cu`` is compiled for ``sm_90a`` by its own ``nvcc -c``,
all started together, and the objects are linked into one shared library
with a plain C interface, loaded with ``ctypes``.  The build happens on
first use, into ``kernels/_build/`` (listed in ``.gitignore``); the
library's name carries a hash of every source the build reads (the
``*.cu`` files and the ``*.cuh`` headers they include) and of the flags,
so an edited source or header is rebuilt.  Each build process compiles
into a directory of its own and renames the library into place, so
concurrent builds never load a half-written library.
``--use_fast_math`` is never passed: the kernels' divisions and
roundings stay IEEE.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
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


def _sources(csrc: Path = CSRC) -> list[Path]:
    """The translation units: one object each."""
    return sorted(csrc.glob("*.cu"))


def _tag(csrc: Path = CSRC) -> str:
    """Hash of the flags and of every file the build reads: the sources
    and the headers they include."""
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sorted([*csrc.glob("*.cu"), *csrc.glob("*.cuh")]):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _compile(nvcc: str, sources: list[Path], lib: Path) -> None:
    with tempfile.TemporaryDirectory(dir=lib.parent) as tmp:
        objs = [Path(tmp) / f"{src.stem}.o" for src in sources]
        procs = [subprocess.Popen([nvcc, *FLAGS, "-c", str(src), "-o",
                                   str(obj)], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(sources, objs)]
        logs = [p.communicate()[0] for p in procs]
        failed = [f"{src.name}:\n{log}" for src, p, log in
                  zip(sources, procs, logs) if p.returncode]
        if failed:
            raise RuntimeError("nvcc failed\n" + "\n".join(failed))
        tmp_lib = Path(tmp) / lib.name
        proc = subprocess.run([nvcc, *FLAGS, "-shared", *map(str, objs),
                               "-o", str(tmp_lib)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        if proc.returncode:
            raise RuntimeError(f"nvcc link failed\n{proc.stdout}")
        os.replace(tmp_lib, lib)


def library_path() -> Path:
    """Where :func:`load` builds the kernels' shared library."""
    return BUILD_DIR / f"librepro_torch_kernels.{_tag()}.so"


def load() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _LIB, build_seconds
    if _LIB is not None:
        return _LIB
    lib = library_path()
    if not lib.exists():
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        t0 = time.perf_counter()
        _compile(_nvcc(), _sources(), lib)
        build_seconds = time.perf_counter() - t0
    cdll = ctypes.CDLL(str(lib))
    p, i32, i64, u32 = (ctypes.c_void_p, ctypes.c_int, ctypes.c_int64,
                        ctypes.c_uint32)
    cdll.ssca_update_launch.argtypes = [p, p, p, p, p, p, p, p, i64, p]
    cdll.ssca_update_launch.restype = i32
    cdll.empty_launch.argtypes = [p]
    cdll.empty_launch.restype = i32
    cdll.masked_sum_launch.argtypes = [p, i32, i64, i32, u32, u32, u32, i32,
                                       p, p, i32, i32, p]
    cdll.masked_sum_launch.restype = i32
    cdll.masked_ring_sum_launch.argtypes = [p, i32, i64, u32, u32, u32, i32,
                                            p, p, i32, i32, p]
    cdll.masked_ring_sum_launch.restype = i32
    cdll.masked_sum_attributes.argtypes = [i32, ctypes.POINTER(i32)]
    cdll.masked_sum_attributes.restype = None
    cdll.compress_launch.argtypes = [p, p, p, i32, i64, i32, i32, i32, p, p,
                                     p]
    cdll.compress_launch.restype = i32
    cdll.sketch_encode_launch.argtypes = [p, p, i32, i64, i32, i64, i32, p,
                                          p]
    cdll.sketch_encode_launch.restype = i32
    for fn in (cdll.flash_attention_launch, cdll.flash_attention_sm90_launch):
        fn.argtypes = [p, p, p, p, i32, i32, i32, i32, i32, i32,
                       ctypes.c_float, i32, i32, p]
        fn.restype = i32
    for fn in (cdll.flash_attention_attributes,
               cdll.flash_attention_sm90_attributes):
        fn.argtypes = [i32, i32, ctypes.POINTER(i32)]
        fn.restype = None
    cdll.rwkv6_wkv_sm90_launch.argtypes = [p, p, p, p, p, p, i32, i32, i32,
                                           i32, i64, i32, p]
    cdll.rwkv6_wkv_sm90_launch.restype = i32
    cdll.rwkv6_wkv_sm90_attributes.argtypes = [i32, i32, ctypes.POINTER(i32)]
    cdll.rwkv6_wkv_sm90_attributes.restype = None
    cdll.kernel_error_string.argtypes = [i32]
    cdll.kernel_error_string.restype = ctypes.c_char_p
    _LIB = cdll
    return cdll


@functools.lru_cache(maxsize=None)
def sm_count(device) -> int:
    """The number of SMs of a CUDA device, for the kernels' grids."""
    import torch
    return torch.cuda.get_device_properties(device).multi_processor_count


def check(status: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` returned by a launch."""
    if status:
        msg = load().kernel_error_string(status).decode()
        raise RuntimeError(f"{kernel}: CUDA launch failed: {msg} ({status})")
