"""Native code of the port, built at first use and loaded with ctypes.

Two kinds of shared library land in ``columba_tpu_torch/_build/`` (listed in
``.gitignore``; nothing built is committed):

- the host components (SA-IS, FASTQ parser, SAM emitter) from the port's own
  C++ sources under ``columba_tpu_torch/csrc/host/`` (copies of the JAX
  package's, kept in step by hand), compiled with g++;
- the CUDA kernels under ``columba_tpu_torch/csrc/*.cu``, compiled with nvcc
  for ``sm_90a`` (one nvcc per source, all started together) and linked
  into one library with a plain C interface (see :func:`load_kernels`).
"""

from __future__ import annotations

import ctypes
import glob
import os
import re
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BUILD_DIR = os.path.join(_PKG, "_build")
CUDA_SRC_DIR = os.path.join(_PKG, "csrc")
HOST_SRC_DIR = os.path.join(CUDA_SRC_DIR, "host")
NVCC = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                    "bin", "nvcc")

_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
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
    """Load (compiling if needed) a host library from the C++ sources under
    ``csrc/host``; None if it cannot be built (callers that have a numpy
    path use it, the others raise)."""
    with _LOCK:
        if name in _LIBS:
            return _LIBS[name]
        srcs = [os.path.join(HOST_SRC_DIR, s) for s in sources]
        so_path = os.path.join(BUILD_DIR, f"lib{name}.so")
        lib = None
        try:
            if not _fresh(so_path, srcs):
                _run_build(["g++", "-O3", "-march=native", "-shared", "-fPIC",
                            "-pthread", "-std=c++17", *srcs], so_path, 600)
            lib = ctypes.CDLL(so_path)
        except (subprocess.CalledProcessError, FileNotFoundError,
                subprocess.TimeoutExpired, OSError):
            lib = None
        _LIBS[name] = lib
        return lib


def _nvcc_objects(srcs: list[str]) -> tuple[list[str], str]:
    """Compile every source to an object file, one nvcc process each, all
    started together; each source's seconds go to ``build_seconds`` under
    its file name. Returns (object paths, the compilers' stderr)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    jobs = []
    t0 = time.time()
    for src in srcs:
        obj = os.path.join(
            BUILD_DIR, f"{os.path.basename(src)}.{os.getpid()}.o")
        jobs.append((src, obj, subprocess.Popen(
            [NVCC, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
             "-O3", "-c", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
             "-I", CUDA_SRC_DIR, src, "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE)))
    errs: dict[str, bytes] = {}

    def wait(src, proc):
        try:
            _, errs[src] = proc.communicate(timeout=900)
        except subprocess.TimeoutExpired:
            proc.kill()
            _, err = proc.communicate()
            errs[src] = err + b"\ntimed out"
        build_seconds[os.path.basename(src)] = time.time() - t0

    waits = [threading.Thread(target=wait, args=(src, proc))
             for src, _, proc in jobs]
    for w in waits:
        w.start()
    for w in waits:
        w.join()
    logs, failed = [], []
    for src, _, proc in jobs:
        err = errs[src].decode(errors="replace")
        logs.append(err)
        if proc.returncode != 0:
            failed.append(f"{src}:\n{err}")
    if failed:
        raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return [obj for _, obj, _ in jobs], "".join(logs)


_BUILD_ERROR: list = []


def load_kernels() -> ctypes.CDLL:
    """The CUDA kernels' library (every ``csrc/*.cu``), built on first use.
    Raises if it cannot be built: a CUDA tensor has no other path. A failed
    build raises again on every later call without compiling again."""
    with _LOCK:
        lib = _LIBS.get("kernels")
        if lib is not None:
            return lib
        if _BUILD_ERROR:
            raise RuntimeError("the CUDA kernels failed to build earlier in "
                               "this process") from _BUILD_ERROR[0]
        srcs = sorted(glob.glob(os.path.join(CUDA_SRC_DIR, "*.cu")))
        deps = srcs + glob.glob(os.path.join(CUDA_SRC_DIR, "*.cuh"))
        so_path = os.path.join(BUILD_DIR, "libcolumba_kernels.so")
        if not _fresh(so_path, deps):
            t0 = time.time()
            try:
                objs, build_log["kernels"] = _nvcc_objects(srcs)
            except RuntimeError as e:
                _BUILD_ERROR.append(e)
                raise
            try:
                _run_build([NVCC, "-shared", *objs], so_path, 900)
            except subprocess.CalledProcessError as e:
                err = RuntimeError(
                    "nvcc link failed:\n" + e.stderr.decode(errors="replace"))
                _BUILD_ERROR.append(err)
                raise err from e
            finally:
                for obj in objs:
                    os.remove(obj)
            build_seconds["kernels"] = time.time() - t0
        lib = ctypes.CDLL(so_path)
        _LIBS["kernels"] = lib
        return lib


def usable_device(device):
    """``device`` as a torch device; a CUDA device must be usable. The port
    never falls back to the CPU by itself: the caller names the device."""
    import torch

    device = torch.device(device)
    if device.type == "cuda":
        try:
            torch.zeros(1, device=device)
        except (RuntimeError, AssertionError) as e:
            raise RuntimeError(
                f"no usable CUDA device ({device}); the port never falls back "
                "to the CPU by itself (a CPU device runs the kernels' plain "
                "versions)") from e
    return device


KERNELS: dict[str, "Kernel"] = {}


class Kernel:
    """One CUDA kernel's C entry points and its launch count.

    Each entry point takes its pointers and sizes followed by the CUDA
    stream, launches on that stream without synchronising, and returns
    ``cudaGetLastError()``, so a launch goes to the calling thread's
    current stream. ``launches`` counts successful launches only, under a
    lock (the dispatch thread and an emitter thread that re-dispatches may
    both launch); ``by_entry`` splits the same launches by the entry the
    wrapper names (kernel B's per-lane entry, kernel E with lengths, the
    RLC entries), and ``by_shape`` by the shape it names (kernel B: entry,
    band radius, registers, templated instance, quad body or generic entry;
    kernel D its band radius; kernel F its part count; kernel G its band
    radius and part count). An entry named in ``symbols`` (entry -> (C symbol,
    argtypes) or (C symbol, argtypes, CUDA source) where the entry is built
    from a source of its own) has a C function of its own, with the
    index-specific arguments of the RLC index; the other entries share the
    main symbol and source.
    Callers :meth:`reset` the counts to measure a run.
    """

    def __init__(self, name: str, symbol: str, argtypes: list,
                 source: str, replaces: str, symbols: dict | None = None):
        self.name = name
        self.symbols = {"": (symbol, argtypes, source), **(symbols or {})}
        self.source = source        # CUDA source, relative to the repo
        self.replaces = replaces    # the JAX function it ports (file:line)
        self.launches = 0
        self.by_entry: dict[str, int] = {}
        self.by_shape: dict[str, int] = {}
        self._fns: dict[str, object] = {}
        KERNELS[name] = self

    def source_of(self, entry: str) -> str:
        """The CUDA source an entry's C function is built from."""
        spec = self.symbols.get(entry, self.symbols[""])
        return spec[2] if len(spec) > 2 else self.source

    def reset(self) -> None:
        with _COUNT_LOCK:
            self.launches = 0
            self.by_entry = {}
            self.by_shape = {}

    def __call__(self, *args, entry: str = "", shape: str = "") -> None:
        import torch

        key = entry if entry in self.symbols else ""
        fn = self._fns.get(key)
        if fn is None:
            lib = load_kernels()
            symbol, argtypes = self.symbols[key][:2]
            fn = getattr(lib, symbol)
            fn.argtypes = [*argtypes, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            lib.columba_error_string.argtypes = [ctypes.c_int]
            lib.columba_error_string.restype = ctypes.c_char_p
            self._err = lib.columba_error_string
            self._fns[key] = fn
        rc = fn(*args, torch.cuda.current_stream().cuda_stream)
        if rc != 0:
            raise RuntimeError(f"kernel {self.name}: CUDA error {rc} "
                               f"({self._err(rc).decode()})")
        with _COUNT_LOCK:
            self.launches += 1
            if entry:
                self.by_entry[entry] = self.by_entry.get(entry, 0) + 1
            if shape:
                self.by_shape[shape] = self.by_shape.get(shape, 0) + 1


def ptxas_report(build_log: str) -> list:
    """One line per kernel entry of nvcc's ``-Xptxas -v`` output: the entry
    (template arguments in <>, -1 = the generic entry), its registers, and
    its stack frame and spills where there are any."""
    out, entry, frame = [], "", ""
    for ln in build_log.splitlines():
        if "Compiling entry function" in ln:
            m = re.search(r"\d([a-z_]+_kernel)(?:ILi(n?\d+)E(?:Li(n?\d+)E)?"
                          r"(?:Lb(\d)E)?(?:Li(\d+)E)?)?", ln)
            args = [a.replace("n", "-") for a in m.groups()[1:] if a]
            entry = m.group(1) + (f"<{', '.join(args)}>" if args else "")
        elif "bytes stack frame" in ln:
            frame = "" if ln.strip().startswith("0 bytes stack frame, 0 bytes "
                                                "spill stores, 0 bytes spill "
                                                "loads") else ln.strip()
        elif "Used" in ln and "registers" in ln:
            regs = re.search(r"Used (\d+) registers", ln).group(1)
            out.append(f"{entry}: {regs} registers"
                       + (f"; {frame}" if frame else ", no spills"))
    return out
