"""Native code of the port, built at first use and loaded with ctypes.

Two kinds of shared library land in ``columba_tpu_torch/_build/`` (listed in
``.gitignore``; nothing built is committed):

- the host components (SA-IS, FASTQ parser, SAM emitter). Their C++ sources
  are the JAX package's ``columba_tpu/native/*.cpp``, compiled by path with
  g++; the sources are read, never imported, and nothing is written next to
  them;
- the CUDA kernels under ``columba_tpu_torch/csrc/*.cu``, compiled with nvcc
  for ``sm_90a`` into one library with a plain C interface (see
  :func:`load_kernels`).
"""

from __future__ import annotations

import ctypes
import glob
import os
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
HOST_SRC_DIR = os.path.join(os.path.dirname(_PKG), "columba_tpu", "native")
CUDA_SRC_DIR = os.path.join(_PKG, "csrc")
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                    "bin", "nvcc")

_LOCK = threading.Lock()
_LIBS: dict[str, ctypes.CDLL | None] = {}
build_seconds: dict[str, float] = {}
build_log: dict[str, str] = {}   # compiler stderr (ptxas register report)


def _fresh(so_path: str, srcs: list[str]) -> bool:
    return os.path.exists(so_path) and all(
        os.path.getmtime(so_path) >= os.path.getmtime(s) for s in srcs)


def _run_build(cmd: list[str], so_path: str, timeout: int) -> str:
    """Compile into a temporary file, then rename: a concurrent loader never
    sees a half-written library."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{so_path}.{os.getpid()}.tmp"
    done = subprocess.run([*cmd, "-o", tmp], check=True, capture_output=True,
                          timeout=timeout)
    os.replace(tmp, so_path)
    return done.stderr.decode(errors="replace")


def load(name: str, sources: list[str]) -> ctypes.CDLL | None:
    """Load (compiling if needed) a host library from the JAX package's C++
    sources; None if it cannot be built (callers that have a numpy path use
    it, the others raise)."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        srcs = [os.path.join(HOST_SRC_DIR, s) for s in sources]
        so_path = os.path.join(BUILD_DIR, f"lib{name}.so")
        lib = None
        try:
            if not _fresh(so_path, srcs):
                _run_build(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                            "-std=c++17", *srcs], so_path, 600)
            lib = ctypes.CDLL(so_path)
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired, OSError):
            lib = None
        _LIBS[name] = lib
        return lib


def load_kernels() -> ctypes.CDLL:
    """The CUDA kernels' library (every ``csrc/*.cu`` in one nvcc call),
    built on first use. Raises if it cannot be built: a CUDA tensor has no
    other path."""
    with _LOCK:
        lib = _LIBS.get("kernels")
        if lib is not None:
            return lib
        srcs = sorted(glob.glob(os.path.join(CUDA_SRC_DIR, "*.cu")))
        deps = srcs + glob.glob(os.path.join(CUDA_SRC_DIR, "*.cuh"))
        so_path = os.path.join(BUILD_DIR, "libcolumba_kernels.so")
        if not _fresh(so_path, deps):
            t0 = time.time()
            try:
                build_log["kernels"] = _run_build(
                    [NVCC, "-gencode", "arch=compute_90a,code=sm_90a",
                     "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                     "-Xptxas", "-v", "-I", CUDA_SRC_DIR, *srcs],
                    so_path, 900)
            except subprocess.CalledProcessError as e:
                raise RuntimeError(
                    "nvcc failed:\n" + e.stderr.decode(errors="replace")
                ) from e
            build_seconds["kernels"] = time.time() - t0
        lib = ctypes.CDLL(so_path)
        _LIBS["kernels"] = lib
        return lib


KERNELS: dict[str, "Kernel"] = {}


class Kernel:
    """One CUDA kernel's C entry point and its launch count.

    Each entry point takes its pointers and sizes followed by the CUDA
    stream, launches on that stream without synchronising, and returns
    ``cudaGetLastError()``. ``launches`` counts successful launches only;
    callers reset it to measure a run.
    """

    def __init__(self, name: str, symbol: str, argtypes: list,
                 source: str, replaces: str):
        self.name = name
        self.symbol = symbol
        self.argtypes = argtypes
        self.source = source        # CUDA source, relative to the repo
        self.replaces = replaces    # the JAX function it ports (file:line)
        self.launches = 0
        self._fn = None
        KERNELS[name] = self

    def __call__(self, *args) -> None:
        import torch

        if self._fn is None:
            lib = load_kernels()
            fn = getattr(lib, self.symbol)
            fn.argtypes = [*self.argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.columba_error_string.argtypes = [ctypes.c_int]
            lib.columba_error_string.restype = ctypes.c_char_p
            self._err = lib.columba_error_string
            self._fn = fn
        rc = self._fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kernel {self.name}: CUDA error {rc} "
                               f"({self._err(rc).decode()})")
        self.launches += 1
