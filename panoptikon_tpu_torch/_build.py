"""Build the port's CUDA kernels at first use and load them with ctypes.

Each ``csrc/<name>.cu`` compiles alone into a shared library with a plain C
interface:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared
         -Xcompiler -fPIC -Xptxas -v -o build/torch_kernels/<name>-<hash>.so

The file name carries a hash of the source and flags, so an edited kernel is
never served from a stale build. No PyTorch header is included: a build takes
seconds, where ``torch.utils.cpp_extension.load`` takes minutes and needs
``ninja``. ``ptxas``'s per-kernel register and shared-memory report is kept
beside the library as ``<name>-<hash>.log``.

Headers shared by the sources (``csrc/*.cuh``) enter every library's hash.
Every C entry point returns the ``cudaError_t`` of its launch; callers raise
on a non-zero value through :func:`check`.

Host libraries (``csrc/<name>.cpp``: the native host codec) build the same
way with the host compiler and no CUDA, by :func:`build_host`:

    g++ -O3 -march=native -fPIC -std=c++17 -Wall -shared
        -o build/torch_kernels/<name>-<hash>.so

Their hash also covers the target macros ``-march=native`` defines here, so a
library built for one processor is never loaded on another.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_kernels"
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]
HOST_CXX_FLAGS = ["-O3", "-march=native", "-fPIC", "-std=c++17", "-Wall", "-shared"]

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    from torch.utils.cpp_extension import CUDA_HOME

    if CUDA_HOME and (Path(CUDA_HOME) / "bin" / "nvcc").exists():
        return str(Path(CUDA_HOME) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found: the CUDA toolkit is required to build the kernels")


def _library_path(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    digest = hashlib.sha256(src.read_bytes() + " ".join(NVCC_FLAGS).encode())
    for header in sorted(CSRC.glob("*.cuh")):
        digest.update(header.read_bytes())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def _compile(command: list, so: Path, source: str) -> Path:
    """Run ``command`` with ``-o <tmp> <source>`` appended, then move the
    library into place (concurrent builds of one source each finish whole)."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = so.with_suffix(f".{os.getpid()}.{threading.get_ident()}.tmp")
    proc = subprocess.run([*command, "-o", str(tmp), str(CSRC / source)],
                          capture_output=True, text=True, timeout=600)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"{Path(command[0]).name} failed for {source}:\n{proc.stdout}{proc.stderr}")
    so.with_suffix(".log").write_text(proc.stdout + proc.stderr)
    os.replace(tmp, so)
    return so


def build(name: str) -> Path:
    """Compile ``csrc/<name>.cu`` unless a build of this exact source exists."""
    so = _library_path(name)
    if so.exists():
        return so
    return _compile([nvcc_path(), *NVCC_FLAGS], so, f"{name}.cu")


def cxx_path() -> str:
    found = shutil.which("g++")
    if found is None:
        raise RuntimeError("g++ not found: the host compiler is required to build the host codec")
    return found


@functools.cache
def _host_target() -> bytes:
    """The macros ``-march=native`` predefines on this processor: the
    instruction sets a host library is built for."""
    return subprocess.run([cxx_path(), "-march=native", "-dM", "-E", "-x", "c++", os.devnull],
                          capture_output=True, check=True, timeout=60).stdout


def host_library_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cpp").read_bytes()
                            + " ".join(HOST_CXX_FLAGS).encode() + _host_target())
    return BUILD_DIR / f"{name}-{digest.hexdigest()[:16]}.so"


def build_host(name: str, force: bool = False) -> Path:
    """Compile ``csrc/<name>.cpp`` with the host compiler unless a build of
    this exact source, these flags and this processor exists (or ``force``)."""
    so = host_library_path(name)
    if so.exists() and not force:
        return so
    return _compile([cxx_path(), *HOST_CXX_FLAGS], so, f"{name}.cpp")


def load(name: str, signatures: dict[str, list]) -> ctypes.CDLL:
    """Build if needed, load, and declare ``argtypes`` for each entry point
    (``restype`` is ``c_int``: the launch's ``cudaError_t``)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(build(name)))
            for fn, argtypes in signatures.items():
                getattr(lib, fn).argtypes = argtypes
                getattr(lib, fn).restype = ctypes.c_int
            _libs[name] = lib
        return lib


def ptxas_report(name: str) -> str:
    """The ``ptxas -v`` lines of the current build of ``name`` ('' if unbuilt)."""
    log = _library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def sass(name: str) -> str:
    """``cuobjdump -sass`` of the current build of ``name`` (built if needed):
    the instructions the card runs, by kernel."""
    tool = Path(nvcc_path()).parent / "cuobjdump"
    return subprocess.run([str(tool), "-sass", str(build(name))], capture_output=True, text=True,
                          check=True, timeout=300).stdout


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with cudaError_t {err}")
