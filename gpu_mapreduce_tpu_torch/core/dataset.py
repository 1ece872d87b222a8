"""KeyValue / KeyMultiValue datasets: frame lists with an add/complete
protocol, memsize pages and out-of-core spill.

The counterpart of ``gpu_mapreduce_tpu/core/dataset.py`` (the reference's
paged ``KeyValue``/``KeyMultiValue``, ``src/keyvalue.cpp``,
``src/keymultivalue.cpp``).  A dataset's frames are host
``KVFrame``/``KMVFrame``s, device-resident ``ShardedKV``/``ShardedKMV``
(``parallel/sharded.py``), or spill records.  ``complete()`` merges the
host batches and splits them into pages of at most ``memsize`` MB
(:func:`_split_to_budget`); device frames, and batches whose columns
already sit on a device, bypass the splitter.  Under
``outofcore=1`` a page that would take the resident host bytes past
``maxpage × memsize`` MB is written to ``fpath`` as
``mrtpu.<name>.<id>.<seq>.npz`` (the JAX package's names and npz fields)
and loads back lazily in :meth:`KeyValue.frames`.  Byte counts follow the
JAX package: a host frame counts its rows (text by its length, objects by
their pickles), a device frame its padded tensors.  ``msize`` tracks the
resident page bytes, ``wsize``/``rsize`` the spill bytes written and read.
"""

from __future__ import annotations

import os
import pickle
import threading
from typing import Iterator, List, Optional

import numpy as np
import torch

from .column import BytesColumn, DenseColumn, ObjectColumn, concat
from .frame import KMVFrame, KVFrame, empty_kv
from .runtime import Counters, Settings, global_counters

_FILE_ID = [0]
_FILE_ID_LOCK = threading.Lock()


def _next_file_id() -> int:
    with _FILE_ID_LOCK:
        _FILE_ID[0] += 1
        return _FILE_ID[0]


def rows_to_array(rows: list) -> np.ndarray:
    """np.asarray for scalar/tuple rows that refuses numpy's silent
    int→float64 fallback: a Python-int list straddling 2^63 (u64 ids next
    to small counts) becomes exact uint64 instead."""
    arr = np.asarray(rows)

    def _u64able(e):
        return isinstance(e, (int, np.integer)) and 0 <= int(e) < (1 << 64)

    if arr.dtype == np.float64 and all(
            _u64able(r) or (isinstance(r, tuple)
                            and all(_u64able(e) for e in r))
            for r in rows):
        arr = np.asarray(rows, dtype=np.uint64)
    return arr


def _coerce_rows(rows: list):
    """A Python add buffer → a column: bytes/str → BytesColumn; None →
    u8 zeros (the NULL value); numbers and uniform tuples → DenseColumn;
    anything else (mixed types, ragged tuples, dicts, ...) → ObjectColumn,
    the pickle tier (reference python/mrmpi.py:17-45)."""
    first = rows[0]
    if isinstance(first, (bytes, str, bytearray)):
        if all(isinstance(r, (bytes, str, bytearray, memoryview))
               for r in rows):
            return BytesColumn(rows)
        # mixed with non-string rows: arbitrary objects
        return ObjectColumn(rows)
    if first is None:
        return DenseColumn(np.zeros(len(rows), dtype=np.uint8))
    try:
        arr = rows_to_array(rows)
    except (ValueError, OverflowError):
        return ObjectColumn(rows)
    if arr.dtype == object or arr.dtype.kind in "USV":
        # numpy stringifies mixed tuples like ('a', 1): keep the rows
        return ObjectColumn(rows)
    return DenseColumn(arr)


def _merge_frames(frames: List[KVFrame]) -> KVFrame:
    if len(frames) == 1:
        return frames[0]
    return KVFrame(concat([f.key for f in frames]),
                   concat([f.value for f in frames]))


def one_frame_of(frames: list):
    """Frames as one frame: the sole frame itself; several host frames
    merge on the host; once any frame is on a device, the host frames
    move to that device (text columns interning there) and all
    concatenate there, intern tables merged.  Mesh frames of one mesh
    concatenate shard by shard; a mesh frame among other frames comes to
    the host first."""
    if not frames:
        return empty_kv()
    if len(frames) == 1:
        return frames[0]
    from ..parallel.sharded import MeshKV
    meshes = [f for f in frames if isinstance(f, MeshKV)]
    if meshes:
        if len(meshes) == len(frames) and \
                len({f.mesh for f in frames}) == 1:
            from ..parallel.backend import concat_mesh
            return concat_mesh(frames)
        # a mesh frame beside host or one-device frames: all on the host
        frames = [f.to_host() if isinstance(f, MeshKV) else f
                  for f in frames]
    device = next((f.device for f in frames
                   if not isinstance(f, KVFrame)), None)
    if device is None:
        return _merge_frames(frames)
    from ..parallel.sharded import concat_sharded, shard_frame
    return concat_sharded([shard_frame(f, device)
                           if isinstance(f, KVFrame) else f
                           for f in frames])


def _on_host(fr: KVFrame) -> bool:
    """Whether both columns of a host frame hold their rows on the host
    (a byte column split on the card does not)."""
    return all(getattr(c, "device", None) is None
               for c in (fr.key, fr.value))


# -- spill files ------------------------------------------------------------

def _col_to_npz(col, prefix: str, out: dict) -> None:
    """One host column as npz entries, in the JAX package's fields: a
    dense column as ``<p>_arr``; byte rows as their packed buffer
    ``<p>_obj`` and offsets ``<p>_obj_off``; objects as one pickle of
    the row list, ``<p>_pobj``."""
    if isinstance(col, ObjectColumn):
        blob = pickle.dumps(list(col.data), protocol=4)
        out[prefix + "_pobj"] = np.frombuffer(blob, np.uint8)
    elif isinstance(col, BytesColumn):
        host = col.to_host()
        out[prefix + "_obj"] = np.ascontiguousarray(host.buf, np.uint8)
        out[prefix + "_obj_off"] = np.asarray(host.offsets, np.int64)
    else:
        out[prefix + "_arr"] = np.asarray(col.data)


def _col_from_npz(z, prefix: str):
    if prefix + "_pobj" in z:
        return ObjectColumn(pickle.loads(z[prefix + "_pobj"].tobytes()))
    if prefix + "_obj" in z:
        off = np.asarray(z[prefix + "_obj_off"], np.int64)
        return BytesColumn.packed(np.asarray(z[prefix + "_obj"], np.uint8),
                                  off, int(off[-1]) if len(off) else 0)
    return DenseColumn(z[prefix + "_arr"])


def _write_spill(settings: Settings, counters: Counters, name: str,
                 fileid: int, seq: int, payload: dict, nbytes: int) -> str:
    """Write one spill page as ``fpath/mrtpu.<name>.<id>.<seq>.npz``
    (reference file naming, src/mapreduce.cpp:3187-3205)."""
    os.makedirs(settings.fpath, exist_ok=True)
    path = os.path.join(settings.fpath,
                        f"mrtpu.{name}.{fileid}.{seq}.npz")
    np.savez(path, **payload)
    counters.add(wsize=nbytes)
    return path


def _spill_budget(settings: Settings) -> int:
    return settings.maxpage * settings.memsize * (1 << 20)


class _Spilled:
    """A KV page parked in a spill file (reference write_page/read_page,
    src/keyvalue.cpp:688-756)."""

    __slots__ = ("path", "n", "bytes_")

    def __init__(self, path: str, n: int, bytes_: int):
        self.path = path
        self.n = n
        self.bytes_ = bytes_

    def load(self, counters: Counters) -> KVFrame:
        with np.load(self.path, allow_pickle=False) as z:
            key = _col_from_npz(z, "k")
            value = _col_from_npz(z, "v")
        counters.add(rsize=self.bytes_)
        return KVFrame(key, value)


class _SpilledKMV:
    """A KMV page parked in a spill file."""

    __slots__ = ("path", "n", "nvalues_total", "bytes_")

    def __init__(self, path: str, n: int, nvalues_total: int, bytes_: int):
        self.path = path
        self.n = n
        self.nvalues_total = nvalues_total
        self.bytes_ = bytes_

    def load(self, counters: Counters) -> KMVFrame:
        with np.load(self.path, allow_pickle=False) as z:
            key = _col_from_npz(z, "k")
            values = _col_from_npz(z, "v")
            nvalues, offsets = z["nv"], z["off"]
        counters.add(rsize=self.bytes_)
        return KMVFrame(key, nvalues, offsets, values)


def _remove(path: str) -> None:
    try:
        os.remove(path)
    except OSError:
        pass


# -- page splitting ---------------------------------------------------------

def _split_to_budget(fr: KVFrame, settings: Settings) -> List[KVFrame]:
    """A host frame cut into pages of at most ``memsize`` MB (a reference
    page boundary), rows in order."""
    limit = settings.memsize * (1 << 20)
    n = len(fr)
    if n == 0 or fr.nbytes() <= limit:
        return [fr]
    rows_per = max(1, int(n * limit / fr.nbytes()))
    return [fr.slice(s, min(s + rows_per, n)) for s in range(0, n, rows_per)]


def _split_kmv_to_budget(fr: KMVFrame, settings: Settings
                         ) -> List[KMVFrame]:
    """A KMV frame cut into pages of at most ``memsize`` MB on group
    boundaries; a single group larger than a page stays whole (the
    reference's "extended" KMV, src/keymultivalue.cpp:974-999)."""
    limit = settings.memsize * (1 << 20)
    if len(fr) == 0 or fr.nbytes() <= limit:
        return [fr]
    row_bytes = fr.nbytes() / max(1, fr.nvalues_total)
    rows_per = max(1, int(limit / row_bytes))
    offsets = np.asarray(fr.offsets)
    pieces: List[KMVFrame] = []
    g = 0
    while g < len(fr):
        start_row = int(offsets[g])
        # the furthest group whose end stays within rows_per of start_row
        h = int(np.searchsorted(offsets, start_row + rows_per,
                                side="right")) - 1
        h = min(max(h, g + 1), len(fr))
        sub_off = (offsets[g:h + 1] - start_row).astype(np.int64)
        pieces.append(KMVFrame(
            fr.key.slice(g, h), np.asarray(fr.nvalues[g:h]), sub_off,
            fr.values.slice(start_row, int(offsets[h]))))
        g = h
    return pieces


class KeyValue:
    """Append-only KV dataset.  ``device`` is where its MapReduce keeps
    data: a callback that is handed a host frame places it there."""

    def __init__(self, settings: Optional[Settings] = None,
                 counters: Optional[Counters] = None, name: str = "kv",
                 device=None):
        self.settings = settings if settings is not None else Settings()
        self.counters = counters if counters is not None \
            else global_counters()
        self.name = name
        self.device = device
        self.fileid = _next_file_id()
        self._buf_k: list = []
        self._buf_v: list = []
        self._batches: list = []
        self._frames: list = []        # KVFrame | ShardedKV | _Spilled
        self.nkv = 0
        self.complete_done = False

    # -- add protocol ------------------------------------------------------
    def add(self, key, value) -> None:
        """Add one pair (reference kv->add)."""
        self._buf_k.append(key)
        self._buf_v.append(value)
        if len(self._buf_k) >= 1 << 20:
            self._flush_scalars()

    def add_batch(self, keys, values, key_dtype=None,
                  value_dtype=None) -> None:
        """Add a batch of pairs as arrays.  Host arrays become a host
        frame; torch tensors stay on their device as a device frame,
        their logical dtypes given by ``key_dtype``/``value_dtype``
        (default: the tensor's own, so pass ``np.uint64`` for u64 bit
        patterns held in int64)."""
        self._flush_scalars()
        if isinstance(keys, torch.Tensor):
            from ..parallel.sharded import tensor_frame
            frame = tensor_frame(keys, values, key_dtype, value_dtype)
        else:
            frame = KVFrame(keys, values)
        if len(frame):
            self._batches.append(frame)

    def add_frame(self, frame) -> None:
        """Append a pre-built frame (a KVFrame or a ShardedKV)."""
        self._flush_scalars()
        self._batches.append(frame)

    def add_kv(self, other: "KeyValue") -> None:
        """Append another KV's frames (shared, not copied: no op changes
        a frame in place; spilled pages load here)."""
        self._flush_scalars()
        self._batches.extend(other.frames())

    def _flush_scalars(self) -> None:
        if self._buf_k:
            self._batches.append(KVFrame(_coerce_rows(self._buf_k),
                                         _coerce_rows(self._buf_v)))
            self._buf_k, self._buf_v = [], []

    # -- completion --------------------------------------------------------
    def complete(self) -> int:
        """Finalise: host batches merge and split into memsize pages
        (spilling past the budget under ``outofcore=1``); device frames,
        and batches whose rows already sit on a device (a byte column
        split on the card), are kept whole (reference
        KeyValue::complete, src/keyvalue.cpp:216-255)."""
        self._flush_scalars()
        plain = [b for b in self._batches if isinstance(b, KVFrame)]
        device = [b for b in self._batches if not isinstance(b, KVFrame)]
        self._batches = []
        if plain and all(_on_host(b) for b in plain):
            for fr in _split_to_budget(_merge_frames(plain), self.settings):
                self._push_frame(fr)
        elif plain:
            self._frames.append(_merge_frames(plain))
            self.counters.mem(self._frames[-1].nbytes())
        for f in device:
            self._frames.append(f)
            self.counters.mem(f.nbytes())
        self.nkv = sum(self._frame_n(f) for f in self._frames)
        self.complete_done = True
        return self.nkv

    def append(self) -> None:
        """Reopen a completed dataset for more adds (``addflag``)."""
        self.complete_done = False

    @staticmethod
    def _frame_n(f) -> int:
        return f.n if isinstance(f, _Spilled) else len(f)

    def _push_frame(self, fr: KVFrame) -> None:
        """Keep a host page resident, or spill it when it would take the
        resident bytes past the budget under ``outofcore=1``."""
        budget = _spill_budget(self.settings)
        if (self.settings.outofcore == 1 and budget
                and self._resident_bytes() + fr.nbytes() > budget):
            self._spill(fr)
        else:
            self._frames.append(fr)
            self.counters.mem(fr.nbytes())

    def _resident_bytes(self) -> int:
        return sum(f.nbytes() for f in self._frames
                   if isinstance(f, KVFrame))

    def _spill(self, fr: KVFrame) -> None:
        payload: dict = {}
        _col_to_npz(fr.key.to_host(), "k", payload)
        _col_to_npz(fr.value.to_host(), "v", payload)
        nb = fr.nbytes()
        path = _write_spill(self.settings, self.counters, self.name,
                            self.fileid, len(self._frames), payload, nb)
        self._frames.append(_Spilled(path, len(fr), nb))

    # -- read protocol -----------------------------------------------------
    @property
    def nframes(self) -> int:
        return len(self._frames)

    def is_host_dataset(self) -> bool:
        """Whether every frame is a host page or a spill file (what the
        external sort and group read)."""
        return all(isinstance(f, (KVFrame, _Spilled)) for f in self._frames)

    def frames(self) -> Iterator[object]:
        """The frames in order, spilled pages loaded one at a time
        (reference request_page, src/keyvalue.cpp:277-308)."""
        for f in self._frames:
            yield f.load(self.counters) if isinstance(f, _Spilled) else f

    def nbytes(self) -> int:
        """Bytes of the frames: a host frame's rows, a device frame's
        padded tensors, a spill file's page."""
        return sum(f.bytes_ if isinstance(f, _Spilled) else f.nbytes()
                   for f in self._frames)

    def one_frame(self):
        """The whole dataset as one frame (:func:`one_frame_of` its
        frames)."""
        return one_frame_of(list(self.frames()))

    def replace_frames(self, frame) -> None:
        """Swap the dataset's frames for one frame holding the same pairs."""
        self.free()
        self._frames = [frame]
        self.counters.mem(frame.nbytes())
        self.nkv = len(frame)
        self.complete_done = True

    def free(self) -> None:
        """Drop every frame; spill files are deleted."""
        for f in self._frames:
            if isinstance(f, _Spilled):
                _remove(f.path)
            else:
                self.counters.mem(-f.nbytes())
        self._frames = []
        self._batches = []
        self.nkv = 0


class KeyMultiValue:
    """Grouped dataset: a list of KMV frames, spilling to ``fpath`` past
    the budget under ``outofcore=1`` as the KeyValue does."""

    def __init__(self, settings: Optional[Settings] = None,
                 counters: Optional[Counters] = None):
        self.settings = settings if settings is not None else Settings()
        self.counters = counters if counters is not None \
            else global_counters()
        self.fileid = _next_file_id()
        self._frames: list = []       # KMVFrame | ShardedKMV | _SpilledKMV
        self.nkmv = 0

    def push(self, fr) -> None:
        """Add a frame; a host frame past the budget under
        ``outofcore=1`` is cut on group boundaries and spilled."""
        budget = _spill_budget(self.settings)
        if (self.settings.outofcore == 1 and budget
                and isinstance(fr, KMVFrame)
                and self._resident_bytes() + fr.nbytes() > budget):
            for piece in _split_kmv_to_budget(fr, self.settings):
                self._spill(piece)
        else:
            self._frames.append(fr)
            self.counters.mem(fr.nbytes())

    def _resident_bytes(self) -> int:
        return sum(f.nbytes() for f in self._frames
                   if isinstance(f, KMVFrame))

    def _spill(self, fr: KMVFrame) -> None:
        payload: dict = {"nv": np.asarray(fr.nvalues),
                         "off": np.asarray(fr.offsets)}
        _col_to_npz(fr.key.to_host(), "k", payload)
        _col_to_npz(fr.values.to_host(), "v", payload)
        nb = fr.nbytes()
        path = _write_spill(self.settings, self.counters, "kmv",
                            self.fileid, len(self._frames), payload, nb)
        self._frames.append(_SpilledKMV(path, len(fr), fr.nvalues_total,
                                        nb))

    def complete(self) -> int:
        self.nkmv = sum(f.n if isinstance(f, _SpilledKMV) else len(f)
                        for f in self._frames)
        return self.nkmv

    @property
    def nframes(self) -> int:
        return len(self._frames)

    def frames(self) -> Iterator[object]:
        for f in self._frames:
            yield f.load(self.counters) if isinstance(f, _SpilledKMV) \
                else f

    def nvalues(self) -> int:
        """Values over every group."""
        return sum(f.nvalues_total for f in self._frames)

    def nbytes(self) -> int:
        """Bytes of the frames: a host frame's groups (keys, int64 sizes
        and values), a device frame's padded tensors, a spill file's
        page."""
        return sum(f.bytes_ if isinstance(f, _SpilledKMV) else f.nbytes()
                   for f in self._frames)

    def free(self) -> None:
        for f in self._frames:
            if isinstance(f, _SpilledKMV):
                _remove(f.path)
            else:
                self.counters.mem(-f.nbytes())
        self._frames = []
        self.nkmv = 0
