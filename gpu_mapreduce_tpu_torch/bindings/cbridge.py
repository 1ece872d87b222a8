"""Python side of the C ABI — handle table + C-callback trampolines (the
port's copy of ``gpu_mapreduce_tpu/bindings/cbridge.py``, over the port's
``MapReduce`` and ``OinkScript``).

The reference's C interface (``src/cmapreduce.{h,cpp}``) wraps the C++
MapReduce class in flat ``MR_*`` functions over ``void*`` handles, with
user callbacks as C function pointers.  Our engine is Python, so the
shim inverts: ``bindings/cmapreduce.c`` embeds CPython and forwards every
call here; C callback pointers arrive as integers and are invoked back
through ``ctypes.CFUNCTYPE`` with the reference's byte-oriented
signatures (map ``(itask, kv, ptr)`` / file map ``(itask, fname, kv,
ptr)`` / reduce ``(key, keybytes, multivalue, nvalues, valuebytes, kv,
ptr)`` / scan ``(key, keybytes, value, valuebytes, ptr)`` —
``src/cmapreduce.h:24-148``).

Keys/values cross the boundary as raw bytes, exactly like the
reference's byte-packed pages: C-added pairs become BytesColumn rows;
typed columns flatten to their little-endian bytes on the way out (a C
struct view, ``oink/typedefs.h`` style).

Devices: :func:`mr_create` and :func:`oink_open` take the device a C
caller named (``MR_create_device``/``OINK_open_device``); ``None`` is the
card, and without one they raise ``MRError``, which the shim turns into a
NULL handle and ``MR_last_error()``.  Nothing falls back to the CPU.
``MR_copy`` keeps its source's device (``MapReduce.copy``).
"""

from __future__ import annotations

import ctypes
import threading
from typing import Dict, List, Optional

import numpy as np

from ..core.mapreduce import MapReduce
from ..core.runtime import resolve_device
from ..oink.script import OinkScript

_handles: Dict[int, object] = {}
_next_id = [1]
# mr handle → active BlockedMultivalue during a nvalues==0 reduce call
_blockmeta: Dict[int, object] = {}
# mr handle → block_rows threshold for the C reduce tier (the ONEMAX
# stress hook, src/keymultivalue.cpp:43-45; set via
# MR_set(mr, "c_block_rows", ...))
_c_block_rows: Dict[int, int] = {}

MAPTASK_FN = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_void_p,
                              ctypes.c_void_p)
MAPFILE_FN = ctypes.CFUNCTYPE(None, ctypes.c_int, ctypes.c_char_p,
                              ctypes.c_void_p, ctypes.c_void_p)
REDUCE_FN = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_int,
                             ctypes.POINTER(ctypes.c_char), ctypes.c_int,
                             ctypes.POINTER(ctypes.c_int), ctypes.c_void_p,
                             ctypes.c_void_p)
SCAN_FN = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_int,
                           ctypes.POINTER(ctypes.c_char), ctypes.c_int,
                           ctypes.c_void_p)
MAPCHUNK_FN = ctypes.CFUNCTYPE(None, ctypes.c_int,
                               ctypes.POINTER(ctypes.c_char), ctypes.c_int,
                               ctypes.c_void_p, ctypes.c_void_p)
MAPMR_FN = ctypes.CFUNCTYPE(None, ctypes.c_uint64,
                            ctypes.POINTER(ctypes.c_char), ctypes.c_int,
                            ctypes.POINTER(ctypes.c_char), ctypes.c_int,
                            ctypes.c_void_p, ctypes.c_void_p)
HASH_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.c_char_p, ctypes.c_int)
CMP_FN = ctypes.CFUNCTYPE(ctypes.c_int, ctypes.POINTER(ctypes.c_char),
                          ctypes.c_int, ctypes.POINTER(ctypes.c_char),
                          ctypes.c_int)
SCANKMV_FN = ctypes.CFUNCTYPE(None, ctypes.c_char_p, ctypes.c_int,
                              ctypes.POINTER(ctypes.c_char), ctypes.c_int,
                              ctypes.POINTER(ctypes.c_int), ctypes.c_void_p)


# created at import: a lazy create would itself race — two mapstyle-2
# workers making the FIRST concurrent _register could each see None and
# build different Lock objects, un-serializing the very RMW the lock
# guards
_reg_lock = threading.Lock()


def _register(obj) -> int:
    # locked: mapstyle-2 worker threads register per-task accumulators
    # concurrently, and `_next_id[0] += 1` is a read-modify-write — two
    # tasks sharing one handle would cross-route their kv_adds
    with _reg_lock:
        h = _next_id[0]
        _next_id[0] += 1
        _handles[h] = obj
    return h


def _unregister(h: int):
    """Locked twin of :func:`_register`: every ``_handles`` mutation
    goes through ``_reg_lock`` (mapstyle-2 workers pop per-task
    accumulators concurrently with registrations — mrlint
    lock-discipline)."""
    with _reg_lock:
        return _handles.pop(h, None)


def _get(h: int):
    return _handles[h]


def _to_bytes(x) -> bytes:
    """Any key/value → its raw bytes (C struct view of typed rows)."""
    if isinstance(x, bytes):
        return x
    if isinstance(x, str):
        return x.encode()
    if isinstance(x, tuple):
        return b"".join(_to_bytes(e) for e in x)
    return np.asarray(x).tobytes()


class _KVAccum:
    """Batches per-pair C adds into one columnar add at flush (the
    reference appends to a page; we append to a BytesColumn batch)."""

    def __init__(self, kv):
        self.kv = kv
        self.keys: List[bytes] = []
        self.values: List[bytes] = []

    def add(self, key: bytes, value: bytes):
        self.keys.append(key)
        self.values.append(value)

    def flush(self):
        if self.keys:
            self.kv.add_batch(self.keys, self.values)
            self.keys, self.values = [], []


# ---------------------------------------------------------------------------
# entry points called from cmapreduce.c
# ---------------------------------------------------------------------------

def mr_create(device: Optional[str] = None) -> int:
    return _register(MapReduce(device=device))


def mr_destroy(h: int):
    _unregister(h)
    _blockmeta.pop(h, None)
    _c_block_rows.pop(h, None)


def mr_copy(h: int) -> int:
    h2 = _register(_get(h).copy())
    if h in _c_block_rows:      # MR_copy carries every setting over
        _c_block_rows[h2] = _c_block_rows[h]
    return h2


def mr_set(h: int, name: str, value: str) -> int:
    if name == "c_block_rows":
        _c_block_rows[h] = int(value)
        return 0
    mr = _get(h)
    mr.set(**{name: value if name == "fpath" else int(value)})
    return 0


def _cbytes(x: Optional[bytes]) -> bytes:
    """A C buffer as bytes: a NULL pointer (``None``, the shim's ``y#``
    of NULL) is the reference's zero-byte key or value.  The port's
    columns hold numbers or bytes, never ``None``."""
    return b"" if x is None else x


def kv_add(kvh: int, key: Optional[bytes], value: Optional[bytes]):
    _get(kvh).add(_cbytes(key), _cbytes(value))


def mr_map(h: int, nmap: int, fnptr: int, appptr: int, addflag: int) -> int:
    fn = MAPTASK_FN(fnptr)
    mr = _get(h)

    def wrapper(itask, kv, ptr):
        acc = _KVAccum(kv)
        kvh = _register(acc)
        try:
            fn(itask, kvh, appptr)
            acc.flush()
        finally:
            _unregister(kvh)

    return mr.map(nmap, wrapper, addflag=addflag)


def mr_map_file_list(h: int, paths: List[bytes], fnptr: int, appptr: int,
                     addflag: int) -> int:
    fn = MAPFILE_FN(fnptr)
    mr = _get(h)

    def wrapper(itask, fname, kv, ptr):
        acc = _KVAccum(kv)
        kvh = _register(acc)
        try:
            fn(itask, fname.encode() if isinstance(fname, str) else fname,
               kvh, appptr)
            acc.flush()
        finally:
            _unregister(kvh)

    return mr.map_files([p.decode() for p in paths], wrapper,
                        addflag=addflag)


def mr_map_file_chunks(h: int, which: str, nmap: int, paths: List[bytes],
                       sep: bytes, delta: int, fnptr: int,
                       appptr: int) -> int:
    """Chunked file maps (reference MR_map_file_char/str): the C callback
    receives each chunk's raw bytes."""
    fn = MAPCHUNK_FN(fnptr)
    mr = _get(h)

    def wrapper(itask, chunk, kv, ptr):
        acc = _KVAccum(kv)
        kvh = _register(acc)
        try:
            buf = ctypes.create_string_buffer(bytes(chunk), len(chunk))
            fn(itask, buf, len(chunk), kvh, appptr)
            acc.flush()
        finally:
            _unregister(kvh)

    files = [p.decode() for p in paths]
    if which == "char":
        return mr.map_file_char(nmap, files, 0, 0, sep, delta, wrapper)
    return mr.map_file_str(nmap, files, 0, 0, sep, delta, wrapper)


def mr_map_mr(h: int, h2: int, fnptr: int, appptr: int) -> int:
    """MR_map_mr: per-pair map over an existing MR's KV (reference
    map(mr,func,...) via C, src/cmapreduce.cpp; self-map h2 == h works
    through map_mr's snapshot).  The callback sees the raw key/value
    bytes exactly as the reference's byte-packed pages would.

    Unlike the task-scoped wrappers, this one registers the target kv
    ONCE and lets KeyValue.add's own 1M-row scalar buffer do the
    batching — a per-pair _KVAccum would build one single-row frame per
    pair."""
    fn = MAPMR_FN(fnptr)
    mr, src = _get(h), _get(h2)
    reg: dict = {}

    def wrapper(itask, k, v, kv, ptr):
        kvh = reg.get(id(kv))
        if kvh is None:
            kvh = _register(kv)
            reg[id(kv)] = kvh
        kb, vb = _to_bytes(k), _to_bytes(v)
        fn(itask,
           ctypes.create_string_buffer(kb, len(kb)), len(kb),
           ctypes.create_string_buffer(vb, len(vb)), len(vb),
           kvh, appptr)

    try:
        return mr.map_mr(src, wrapper)
    finally:
        for kvh in reg.values():
            _unregister(kvh)


def mr_aggregate_hash(h: int, fnptr: int) -> int:
    """MR_aggregate with a user C hash: proc = myhash(key, keybytes) %
    nprocs, evaluated on the host per key (the reference calls it per
    pair too, src/mapreduce.cpp:469-471)."""
    fn = HASH_FN(fnptr)

    def host_hash(key_bytes_list):
        return np.asarray([fn(b, len(b)) for b in key_bytes_list],
                          np.int64)

    host_hash.host_hash = True
    return _get(h).aggregate(host_hash)


def _bytes_cmp(fnptr: int):
    fn = CMP_FN(fnptr)

    def cmp(a, b):
        ab, bb = _to_bytes(a), _to_bytes(b)
        return fn(ctypes.create_string_buffer(ab, len(ab)), len(ab),
                  ctypes.create_string_buffer(bb, len(bb)), len(bb))

    return cmp


def mr_sort_cmp(h: int, which: str, fnptr: int) -> int:
    mr = _get(h)
    cmp = _bytes_cmp(fnptr)
    if which == "keys":
        return mr.sort_keys(cmp)
    if which == "values":
        return mr.sort_values(cmp)
    return mr.sort_multivalues(cmp)


def mr_scan_kmv(h: int, fnptr: int, appptr: int) -> int:
    fn = SCANKMV_FN(fnptr)

    def wrapper(k, vals, ptr):
        kb = _to_bytes(k)
        bvals = [_to_bytes(v) for v in vals]
        mv = b"".join(bvals)
        sizes = (ctypes.c_int * len(bvals))(*[len(b) for b in bvals])
        buf = ctypes.create_string_buffer(mv, len(mv))
        fn(kb, len(kb), buf, len(bvals), sizes, appptr)

    return _get(h).scan_kmv(wrapper)


def _call_reduce(fn, appptr, key, vals, kvh: int, mrh: int) -> None:
    from ..core.frame import BlockedMultivalue
    kb = _to_bytes(key)
    if isinstance(vals, BlockedMultivalue):
        # the reference's multi-page signal: NULL multivalue +
        # nvalues==0; the callback pulls blocks through
        # MR_multivalue_blocks/_block (src/mapreduce.cpp:1874-1925)
        _blockmeta[mrh] = vals
        try:
            fn(kb, len(kb), None, 0, None, kvh, appptr)
        finally:
            _blockmeta.pop(mrh, None)
    else:
        bvals = [_to_bytes(v) for v in vals]
        mv = b"".join(bvals)
        sizes = (ctypes.c_int * len(bvals))(*[len(b) for b in bvals])
        buf = ctypes.create_string_buffer(mv, len(mv))
        fn(kb, len(kb), buf, len(bvals), sizes, kvh, appptr)


def _reduce_groups(h: int, method: str, fnptr: int, appptr: int) -> int:
    """MR_reduce / MR_compress: one C callback a group.  The output kv is
    registered once for the whole call, as in :func:`mr_map_mr`, and
    ``KeyValue.add``'s own scalar buffer batches the adds: groups run one
    after another on this thread, and a frame a group would make the
    next op concatenate as many frames as there are groups."""
    fn = REDUCE_FN(fnptr)
    reg: dict = {}

    def wrapper(k, vals, kv, ptr):
        kvh = reg.get(id(kv))
        if kvh is None:
            kvh = reg[id(kv)] = _register(kv)
        _call_reduce(fn, appptr, k, vals, kvh, h)

    try:
        return getattr(_get(h), method)(wrapper,
                                        block_rows=_c_block_rows.get(h))
    finally:
        for kvh in reg.values():
            _unregister(kvh)


def mr_reduce(h: int, fnptr: int, appptr: int) -> int:
    return _reduce_groups(h, "reduce", fnptr, appptr)


def mr_compress(h: int, fnptr: int, appptr: int) -> int:
    return _reduce_groups(h, "compress", fnptr, appptr)


def mr_multivalue_blocks(h: int) -> int:
    """#blocks of the active nvalues==0 group (0 outside one)."""
    bmv = _blockmeta.get(h)
    if bmv is None:
        return 0
    return -(-bmv.nvalues_total // bmv.block_rows)


def mr_multivalue_block(h: int, iblock: int):
    """→ (nvalues, multivalue bytes, int32 LE valuesizes bytes) for block
    ``iblock`` of the active group; the C shim pins the buffers until the
    next block request (reference page-buffer lifetime)."""
    bmv = _blockmeta.get(h)
    if bmv is None:
        raise RuntimeError("MR_multivalue_block outside a blocked reduce")
    fr, i, br = bmv._frame, bmv._i, bmv.block_rows
    start = int(fr.offsets[i]) + iblock * br
    stop = min(start + br, int(fr.offsets[i + 1]))
    if iblock < 0 or start >= int(fr.offsets[i + 1]):
        raise IndexError(
            f"block {iblock} out of range "
            f"(group has {mr_multivalue_blocks(h)} blocks)")
    col = fr.values.slice(start, stop)
    bvals = [_to_bytes(v) for v in col.tolist()]
    sizes = np.asarray([len(b) for b in bvals], np.int32)
    return len(bvals), b"".join(bvals), sizes.tobytes()


def mr_scan_kv(h: int, fnptr: int, appptr: int) -> int:
    fn = SCAN_FN(fnptr)

    def wrapper(k, v, ptr):
        kb, vb = _to_bytes(k), _to_bytes(v)
        buf = ctypes.create_string_buffer(vb, len(vb))
        fn(kb, len(kb), buf, len(vb), appptr)

    return _get(h).scan_kv(wrapper)


def mr_method_u64(h: int, name: str, *args) -> int:
    """Run a no-callback MapReduce method returning a count: aggregate,
    convert, collate, clone, collapse, close, open, gather, broadcast,
    add, sort_keys, sort_values, sort_multivalues."""
    mr = _get(h)
    if name == "aggregate":
        return mr.aggregate(None)
    if name == "collate":
        return mr.collate(None)
    if name == "collapse":
        return mr.collapse(args[0])
    if name == "add":
        return mr.add(_get(args[0]))
    if name == "open":
        mr.open(*args)
        return 0
    return getattr(mr, name)(*args)


def mr_stats(h: int, which: str) -> int:
    mr = _get(h)
    if which == "kv":
        return mr.kv_stats(0)[0] if mr.kv is not None else 0
    return mr.kmv_stats(0)[0] if mr.kmv is not None else 0


def mr_print_file(h: int, path: str, kflag: int, vflag: int) -> int:
    return _get(h).print(kflag=kflag, vflag=vflag, file=path)


def mr_print(h: int, nstride: int, kflag: int, vflag: int) -> int:
    """Screen print (reference MR_print, src/cmapreduce.h)."""
    return _get(h).print(nstride=nstride, kflag=kflag, vflag=vflag)


def mr_cummulative_stats(h: int, level: int, reset: int) -> int:
    _get(h).cummulative_stats(level, reset)
    return 0


def kv_add_multi_static(kvh: int, n: int, keyblob: bytes, keybytes: int,
                        valblob: bytes, valuebytes: int):
    """n pairs of FIXED-width keys/values packed back to back (reference
    MR_kv_add_multi_static)."""
    acc = _get(kvh)
    keyblob, valblob = _cbytes(keyblob), _cbytes(valblob)
    for i in range(n):
        acc.add(keyblob[i * keybytes:(i + 1) * keybytes],
                valblob[i * valuebytes:(i + 1) * valuebytes])


def kv_add_multi_dynamic(kvh: int, n: int, keyblob: bytes,
                         keysizes: bytes, valblob: bytes,
                         valsizes: bytes):
    """n pairs of VARIABLE-width keys/values; per-pair byte counts arrive
    as int32 arrays (reference MR_kv_add_multi_dynamic)."""
    acc = _get(kvh)
    keyblob, valblob = _cbytes(keyblob), _cbytes(valblob)
    ks = np.frombuffer(keysizes, np.int32, n)
    vs = np.frombuffer(valsizes, np.int32, n)
    ko = np.concatenate([[0], np.cumsum(ks)])
    vo = np.concatenate([[0], np.cumsum(vs)])
    for i in range(n):
        acc.add(keyblob[ko[i]:ko[i + 1]], valblob[vo[i]:vo[i + 1]])


# -- OINK script driver (reference oink/library.h mrmpi_open/...) ----------

def oink_open(logfile: Optional[str], device: Optional[str] = None) -> int:
    # resolved before the log file is opened: no card, no file
    dev = resolve_device(device)
    return _register(OinkScript(device=dev, screen=None,
                                logfile=logfile or None))


def oink_file(h: int, path: str):
    _get(h).run_file(path)


def oink_command(h: int, line: str) -> Optional[str]:
    return _get(h).one(line)


def oink_close(h: int):
    interp = _unregister(h)
    if interp is not None:
        interp.close()
