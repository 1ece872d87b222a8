"""The native C++ host runtime: ctypes loader and numpy-facing wrappers
(the counterpart of ``gpu_mapreduce_tpu/native/__init__.py``).

``mrnative.cpp`` beside this file (a copy of the JAX package's source)
holds the reference's host hot paths in C++: lookup3 hashing
(``src/hash.cpp``), numeric table parsing (``oink/map_read_*.cpp``) and
the InvertedIndex href scan (``cpu/InvertedIndex.cpp``).  It is built at
first use with ``g++`` (or ``$CXX``) into the package's ``_build/``
directory, as ``ops/cuda`` builds the kernels: a temporary file renamed
into place, under a lock, rebuilt when older than its source.  Nothing
is built at import time, nothing is written into the source directory,
and the JAX package's library is never loaded.

:func:`available` builds and loads on its first call and says whether
the library is live (:func:`build_error` says why not); callers branch
on it (``oink/kernels._parse_cols``, ``InvertedIndex(engine="native")``),
and the wrappers raise ``RuntimeError`` when it is not.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import threading
from typing import List, Optional, Tuple

import numpy as np

_DIR = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.join(_DIR, "mrnative.cpp")
BUILD_DIR = os.path.join(os.path.dirname(_DIR), "_build")
LIB = os.path.join(BUILD_DIR,
                   f"libmrnative-{sys.implementation.cache_tag}.so")

_LOCK = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_build_error: Optional[str] = None
_tried = False


def _build() -> Optional[str]:
    """Compile ``mrnative.cpp`` → ``LIB`` through a temporary file;
    returns an error string or None."""
    cxx = os.environ.get("CXX", "g++")
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{LIB}.{os.getpid()}.tmp"
    cmd = [cxx, "-O3", "-shared", "-fPIC", "-std=c++17", SRC, "-o", tmp]
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=120)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"{cxx}: {e}"
    if proc.returncode != 0:
        try:
            os.remove(tmp)
        except OSError:
            pass
        return proc.stderr.strip() or f"{cxx} failed"
    os.replace(tmp, LIB)
    return None


def _bind(lib: ctypes.CDLL) -> None:
    i64, u32, u64 = ctypes.c_int64, ctypes.c_uint32, ctypes.c_uint64
    p = ctypes.POINTER
    u8p = p(ctypes.c_uint8)
    lib.mr_hashlittle.restype = u32
    lib.mr_hashlittle.argtypes = [u8p, i64, u32]
    lib.mr_hashlittle_batch.restype = None
    lib.mr_hashlittle_batch.argtypes = [u8p, p(i64), i64, u32, p(u32)]
    lib.mr_intern64_batch.restype = None
    lib.mr_intern64_batch.argtypes = [u8p, p(i64), i64, p(u64)]
    lib.mr_intern_ranges.argtypes = [u8p, p(i64), p(i64), i64, u32, u32,
                                     p(u64)]
    lib.mr_intern_ranges.restype = None
    lib.mr_intern_ranges2.argtypes = [u8p, p(i64), p(i64), i64, u32, u32,
                                      u32, u32, p(u64), p(u64)]
    lib.mr_intern_ranges2.restype = None
    lib.mr_parse_table.restype = i64
    lib.mr_parse_table.argtypes = [u8p, i64, i64, p(ctypes.c_int32),
                                   p(ctypes.c_void_p), i64]
    lib.mr_find_hrefs.restype = i64
    lib.mr_find_hrefs.argtypes = [u8p, i64, p(i64), p(i64), i64]
    lib.mr_tokenize.restype = i64
    lib.mr_tokenize.argtypes = [u8p, i64, p(i64), p(i64), i64]


def _load() -> Optional[ctypes.CDLL]:
    """Build (when missing or stale) and load the library, once a
    process; a failure is kept in :func:`build_error`."""
    global _lib, _build_error, _tried
    if _tried:
        return _lib
    with _LOCK:
        if _tried:
            return _lib
        if not os.path.exists(SRC):
            _build_error = f"{SRC} missing"
        elif (not os.path.exists(LIB)
              or os.path.getmtime(LIB) < os.path.getmtime(SRC)):
            _build_error = _build()
        if _build_error is None:
            try:
                lib = ctypes.CDLL(LIB)
                _bind(lib)
                _lib = lib
            except (OSError, AttributeError) as e:
                _build_error = str(e)
        _tried = True
    return _lib


def available() -> bool:
    """Whether the library built and loaded (builds it on first call)."""
    return _load() is not None


def build_error() -> Optional[str]:
    return _build_error


def library_path() -> Optional[str]:
    """The loaded library's path (None when it is not loaded)."""
    return LIB if _load() is not None else None


def _need() -> ctypes.CDLL:
    lib = _load()
    if lib is None:
        raise RuntimeError(f"native runtime unavailable: {_build_error}")
    return lib


def _u8(buf: bytes):
    return ctypes.cast(ctypes.c_char_p(buf), ctypes.POINTER(ctypes.c_uint8))


def _arr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _ptr(buf):
    """A uint8 pointer to ``buf`` (bytes, or a uint8 ndarray zero-copy),
    and the array it points into (kept alive by the caller)."""
    if isinstance(buf, np.ndarray):
        a = np.ascontiguousarray(buf, np.uint8)
        return _arr(a, ctypes.c_uint8), a
    return _u8(buf), buf


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------

def hashlittle(data: bytes, initval: int = 0) -> int:
    return int(_need().mr_hashlittle(_u8(data), len(data), initval))


def hashlittle_batch(buf: bytes, offsets: np.ndarray,
                     initval: int = 0) -> np.ndarray:
    """Hash n packed byte strings; ``offsets`` is int64[n+1]."""
    lib = _need()
    n = len(offsets) - 1
    offsets = np.ascontiguousarray(offsets, np.int64)
    out = np.empty(n, np.uint32)
    lib.mr_hashlittle_batch(_u8(buf), _arr(offsets, ctypes.c_int64), n,
                            initval, _arr(out, ctypes.c_uint32))
    return out


def intern_ranges(buf, starts: np.ndarray, lens: np.ndarray,
                  seed_hi: int = 0, seed_lo: int = 0xDEADBEEF) -> np.ndarray:
    """u64 ids over (start, len) ranges of ``buf``, hashed in place
    (default seeds: the intern family of ``ops/hash.hash_bytes64``;
    other seeds: an independent check family)."""
    lib = _need()
    n = len(starts)
    starts = np.ascontiguousarray(starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    out = np.empty(n, np.uint64)
    ptr, _keep = _ptr(buf)
    lib.mr_intern_ranges(ptr, _arr(starts, ctypes.c_int64),
                         _arr(lens, ctypes.c_int64), n, seed_hi, seed_lo,
                         _arr(out, ctypes.c_uint64))
    return out


def intern_ranges2(buf, starts: np.ndarray, lens: np.ndarray,
                   alt_hi: int, alt_lo: int) -> Tuple[np.ndarray, np.ndarray]:
    """Both u64 id families over (start, len) ranges in one pass over
    ``buf``: (intern ids, alternate-family check ids)."""
    lib = _need()
    n = len(starts)
    starts = np.ascontiguousarray(starts, np.int64)
    lens = np.ascontiguousarray(lens, np.int64)
    out0 = np.empty(n, np.uint64)
    out1 = np.empty(n, np.uint64)
    ptr, _keep = _ptr(buf)
    lib.mr_intern_ranges2(ptr, _arr(starts, ctypes.c_int64),
                          _arr(lens, ctypes.c_int64), n, 0, 0xDEADBEEF,
                          alt_hi, alt_lo, _arr(out0, ctypes.c_uint64),
                          _arr(out1, ctypes.c_uint64))
    return out0, out1


def intern64_batch(buf: bytes, offsets: np.ndarray) -> np.ndarray:
    """Byte strings → u64 intern ids (``ops/hash.hash_bytes64``)."""
    lib = _need()
    n = len(offsets) - 1
    offsets = np.ascontiguousarray(offsets, np.int64)
    out = np.empty(n, np.uint64)
    lib.mr_intern64_batch(_u8(buf), _arr(offsets, ctypes.c_int64), n,
                          _arr(out, ctypes.c_uint64))
    return out


def parse_table(buf: bytes, dtypes) -> List[np.ndarray]:
    """Parse a whitespace table of ``len(dtypes)`` columns, each
    ``np.uint64`` (exact) or ``np.float64``, into one array a column.
    A first guess of the row capacity is retried at the exact count the
    parser reports.  Accepts what the numpy route accepts (``+5``,
    zero padding, ``inf``, ``nan``, ``infinity``); raises ValueError on
    malformed input (a bad character, a partial token, u64 overflow, a
    token count not divisible by the columns)."""
    lib = _need()
    ncols = len(dtypes)
    spec = np.array([0 if dt == np.uint64 else 1 for dt in dtypes],
                    np.int32)
    cap = max(16, len(buf) // (2 * ncols))
    while True:
        cols = [np.empty(cap, dt) for dt in dtypes]
        ptrs = (ctypes.c_void_p * ncols)(
            *[c.ctypes.data_as(ctypes.c_void_p) for c in cols])
        n = lib.mr_parse_table(_u8(buf), len(buf), ncols,
                               _arr(spec, ctypes.c_int32), ptrs, cap)
        if n == -1:
            raise ValueError("malformed numeric table")
        if n >= 0:
            return [c[:n] for c in cols]
        cap = -n


def find_hrefs(buf) -> Tuple[np.ndarray, np.ndarray]:
    """URL (starts, lens) of every ``<a href="..."`` match, overlapping
    matches included, as the card's word mark finds them.  ``buf``:
    bytes or a uint8 ndarray (read in place)."""
    lib = _need()
    ptr, _keep = _ptr(buf)
    cap = max(16, len(buf) // 64)
    while True:
        starts = np.empty(cap, np.int64)
        lens = np.empty(cap, np.int64)
        n = lib.mr_find_hrefs(ptr, len(buf),
                              _arr(starts, ctypes.c_int64),
                              _arr(lens, ctypes.c_int64), cap)
        if n >= 0:
            return starts[:n], lens[:n]
        cap = -n


def tokenize(buf) -> Tuple[np.ndarray, np.ndarray]:
    """(starts, lens) of every whitespace-separated token (the
    whitespace of ``bytes.split``)."""
    lib = _need()
    ptr, _keep = _ptr(buf)
    cap = max(16, len(buf) // 4)
    while True:
        starts = np.empty(cap, np.int64)
        lens = np.empty(cap, np.int64)
        n = lib.mr_tokenize(ptr, len(buf),
                            _arr(starts, ctypes.c_int64),
                            _arr(lens, ctypes.c_int64), cap)
        if n >= 0:
            return starts[:n], lens[:n]
        cap = -n
