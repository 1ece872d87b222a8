"""Bindings layer — the C ABI over the port (the counterpart of
``gpu_mapreduce_tpu/bindings/``).

* ``cmapreduce.h`` / ``cmapreduce.c`` — the flat ``MR_*`` C interface with
  C function-pointer callbacks (reference ``src/cmapreduce.{h,cpp}``) plus
  the ``OINK_*`` script driver (reference ``oink/library.{h,cpp}``); the
  shim embeds CPython and forwards to :mod:`.cbridge`.  Two entries are
  the port's own: ``MR_create_device`` and ``OINK_open_device`` (a NULL
  device is the card).
* ``examples/{cwordfreq,coink,crmat,cblocked}.c`` — the JAX package's C
  examples, each taking an optional leading ``-device cpu|cuda``; without
  it they run on the card.

Builds land under ``_build/bindings/`` of this package, never in the
source tree.  Nothing here imports torch: building needs only a C
compiler and this interpreter's headers and ``libpython``.
"""

from __future__ import annotations

import os
import subprocess
import sysconfig
from typing import List, Optional

_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build", "bindings")


def embed_flags() -> List[str]:
    """Compiler/linker flags to embed this CPython (what
    ``python3-config --includes --ldflags --embed`` prints)."""
    inc = sysconfig.get_path("include")
    libdir = sysconfig.get_config_var("LIBDIR")
    libpl = sysconfig.get_config_var("LIBPL")  # static builds keep
    ver = sysconfig.get_config_var("LDVERSION")  # libpython here
    flags = [f"-I{inc}", f"-L{libdir}"]
    if libpl:
        flags.append(f"-L{libpl}")
    flags += [f"-lpython{ver}", "-ldl", "-lm", f"-Wl,-rpath,{libdir}"]
    return flags


def _compile(cmd: List[str], out: str) -> str:
    os.makedirs(os.path.dirname(os.path.abspath(out)), exist_ok=True)
    # written beside the target and renamed: a process building at once never
    # runs a half-written file
    tmp = f"{out}.{os.getpid()}.tmp"
    proc = subprocess.run(cmd + ["-o", tmp], capture_output=True, text=True,
                          timeout=180)
    if proc.returncode != 0:
        raise RuntimeError(f"{' '.join(cmd)}\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def build_example(name: str, out: Optional[str] = None,
                  cc: Optional[str] = None) -> str:
    """Compile ``examples/<name>.c`` + ``cmapreduce.c`` into an
    executable (default ``_build/bindings/<name>``); returns its path.
    Raises RuntimeError with the compiler output on failure."""
    cc = cc or os.environ.get("CC", "gcc")
    src = os.path.join(_DIR, "examples", f"{name}.c")
    shim = os.path.join(_DIR, "cmapreduce.c")
    out = out or os.path.join(BUILD_DIR, name)
    return _compile([cc, "-O2", src, shim] + embed_flags(), out)


def build_shared(out: Optional[str] = None, cc: Optional[str] = None) -> str:
    """Compile ``cmapreduce.c`` into a shared object for a running Python
    (default ``_build/bindings/libcmapreduce.so``): no ``libpython`` on
    its link line, so its Python symbols resolve to the interpreter that
    loads it with ``ctypes.PyDLL``."""
    cc = cc or os.environ.get("CC", "gcc")
    shim = os.path.join(_DIR, "cmapreduce.c")
    out = out or os.path.join(BUILD_DIR, "libcmapreduce.so")
    inc = sysconfig.get_path("include")
    return _compile([cc, "-O2", "-shared", "-fPIC", f"-I{inc}", shim], out)
