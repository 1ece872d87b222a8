"""Hand-written CUDA kernels: launch counters and the kernel loader.

Launch counters: every kernel wrapper carries a plain integer attribute
``launches`` and calls :func:`note_kernel_launch` right where it launches
its kernel (the counterpart of ``ops/pallas/__init__.note_kernel_launch``;
it also bumps ``Counters.ndispatch``).  A run reads the counters to show
that its path went through the kernels.

Loader: at first use, each ``csrc/<name>.cu`` is compiled by ``nvcc`` into
``_build/lib<name>.so`` (a plain C interface, no PyTorch headers, so a
build takes seconds) and bound with ``ctypes``.  Nothing is compiled or
loaded at import time: the CPU tests import every module.  Set
``MRTPU_TORCH_PTXAS_VERBOSE=1`` to have ptxas report registers, shared
memory and spills for each kernel (:func:`build_all` returns that text).
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import threading
import time
from typing import Callable, Dict, List

from ...core.runtime import DeviceError, bump_dispatch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-shared", "-Xcompiler", "-fPIC"]

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}


def note_kernel_launch(wrapper: Callable) -> None:
    """Count one launch of ``wrapper``'s kernel."""
    wrapper.launches += 1
    bump_dispatch()


def sources() -> List[str]:
    """Kernel names: one per ``csrc/*.cu``."""
    return sorted(f[:-3] for f in os.listdir(CSRC) if f.endswith(".cu"))


def _nvcc() -> str:
    """CUDA_HOME's or CUDA_PATH's nvcc, else the one on PATH, else the
    toolkit's default install prefix."""
    homes = [os.environ.get("CUDA_HOME"), os.environ.get("CUDA_PATH")]
    cands = [os.path.join(h, "bin", "nvcc") for h in homes if h]
    cands += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in cands:
        if c and os.path.exists(c):
            return c
    raise DeviceError("nvcc not found: the CUDA kernels are built on first "
                      "use and need the CUDA toolkit (set CUDA_HOME)")


def _lib_path(name: str) -> str:
    return os.path.join(BUILD_DIR, f"lib{name}.so")


def _stale(name: str) -> bool:
    lib = _lib_path(name)
    return (not os.path.exists(lib) or os.path.getmtime(lib)
            < os.path.getmtime(os.path.join(CSRC, name + ".cu")))


def _start_build(name: str) -> subprocess.Popen:
    os.makedirs(BUILD_DIR, exist_ok=True)
    flags = list(NVCC_FLAGS)
    if os.environ.get("MRTPU_TORCH_PTXAS_VERBOSE") == "1":
        flags += ["-Xptxas", "-v"]
    tmp = _lib_path(name) + f".{os.getpid()}.tmp"
    cmd = [_nvcc(), *flags, "-o", tmp, os.path.join(CSRC, name + ".cu")]
    return subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)


def _finish_build(name: str, proc: subprocess.Popen) -> str:
    out, _ = proc.communicate()
    tmp = proc.args[proc.args.index("-o") + 1]
    if proc.returncode != 0:
        raise DeviceError(f"nvcc failed on csrc/{name}.cu "
                          f"(exit {proc.returncode}):\n{out}")
    os.replace(tmp, _lib_path(name))
    return out


def build_all() -> dict:
    """Compile every stale kernel source, one ``nvcc`` per source, all
    started together.  Returns ``{"seconds": s, "output": {name: text}}``
    with each compiler's output (ptxas's report when verbose)."""
    t0 = time.perf_counter()
    with _LOCK:
        procs = {n: _start_build(n) for n in sources() if _stale(n)}
        out = {}
        try:
            for n, p in procs.items():
                out[n] = _finish_build(n, p)
        finally:
            for p in procs.values():
                if p.poll() is None:
                    p.kill()
                    p.wait()
    return {"seconds": time.perf_counter() - t0, "output": out}


def library(name: str, bind: Callable[[ctypes.CDLL], None]) -> ctypes.CDLL:
    """The loaded ``lib<name>.so``, built first if missing or older than
    its source; ``bind`` declares the argtypes/restype of its functions
    once, at load."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    with _LOCK:
        lib = _LIBS.get(name)
        if lib is None:
            if _stale(name):
                _finish_build(name, _start_build(name))
            try:
                lib = ctypes.CDLL(_lib_path(name))
            except OSError as e:      # a kernel that will not load is fatal
                raise DeviceError(f"cannot load lib{name}.so: {e}") from e
            bind(lib)
            _LIBS[name] = lib
    return lib


def load_all() -> dict:
    """Build every stale kernel source (:func:`build_all`) and load each
    library: a resident process (the serve daemon) pays for both before
    its first request.  Returns :func:`build_all`'s record."""
    from . import group, match
    info = build_all()
    library("seg_table", group._bind)
    library("mark_words", match._bind)
    library("mark_bytes", match._bind_bytes)
    return info
