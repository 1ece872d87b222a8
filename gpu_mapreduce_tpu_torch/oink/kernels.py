"""Shared OINK kernels: the map/reduce callbacks the ported commands use.

The counterpart of ``gpu_mapreduce_tpu/oink/kernels.py``.  Data
conventions (reference ``oink/typedefs.h:22-40``): a vertex is a u64, an
edge a ``[n, 2]`` u64 row, a weight a float64, a NULL value a u8 zero.

Readers are file-map callbacks that parse text on the host, except
``read_words``, which splits a file on the MR's device straight into a
packed byte column (no Python object per word).  Edge maps
are batch callbacks (``mr.map_mr(..., batch=True)``): a host ``KVFrame``
is mapped with numpy, a device ``ShardedKV`` by its body in
``parallel/devkernels.py`` on its device, so a graph that lives on the
card stays there.  Printers write one output
line per pair.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.frame import KMVFrame, KVFrame
from ..core.runtime import MRError
from ..ops.bits import M32
from ..ops.hash import hash_words32
from ..utils.io import split_words
from ..parallel import devkernels as dk
from ..parallel.devkernels import skv_map
from ..ops.reduces import (count, cull, max_values, min_values,  # noqa: F401
                           sum_values)

# ---------------------------------------------------------------------------
# file parsers (reference map_read_*.cpp)
# ---------------------------------------------------------------------------


def _null(n: int) -> np.ndarray:
    return np.zeros(n, np.uint8)


def _parse_cols(filename: str, dtypes) -> list:
    """Whitespace table → one exact-dtype array per column (u64 ids parse
    as integers, never through a float).  When every column is u64 or
    f64 and the native runtime is built, the table goes through its C++
    parser (``native.parse_table``, JAX :89-110); else through numpy."""
    with open(filename, "rb") as f:
        raw = f.read()
    from .. import native
    if all(dt in (np.uint64, np.float64) for dt in dtypes) \
            and native.available():
        try:
            return native.parse_table(raw, dtypes)
        except ValueError as e:
            raise ValueError(f"{filename}: {e}")
    toks = np.asarray(raw.split())
    ncols = len(dtypes)
    if len(toks) % ncols:
        raise ValueError(f"{filename}: token count not divisible by {ncols}")
    table = toks.reshape(-1, ncols)
    return [table[:, i].astype(dt) for i, dt in enumerate(dtypes)]


def read_edge(itask, filename, kv, ptr):
    """'vi vj' lines → key=[vi,vj], value=NULL (map_read_edge.cpp)."""
    vi, vj = _parse_cols(filename, (np.uint64, np.uint64))
    kv.add_batch(np.stack([vi, vj], 1), _null(len(vi)))


def read_edge_weight(itask, filename, kv, ptr):
    """'vi vj wt' lines → key=[vi,vj], value=weight
    (map_read_edge_weight.cpp)."""
    vi, vj, w = _parse_cols(filename, (np.uint64, np.uint64, np.float64))
    kv.add_batch(np.stack([vi, vj], 1), w)


def read_edge_label(itask, filename, kv, ptr):
    """'vi vj label' lines → key=[vi,vj], value=int label
    (map_read_edge_label.cpp)."""
    vi, vj, lab = _parse_cols(filename, (np.uint64, np.uint64, np.int64))
    kv.add_batch(np.stack([vi, vj], 1), lab)


def read_words(itask, filename, kv, ptr):
    """Whitespace words → key=word bytes, value=NULL
    (map_read_words.cpp); a list ``ptr`` collects the file names (the
    reference's nfiles counter).  The words split on the KV's device
    into a packed BytesColumn (``utils/io.split_words``)."""
    col = split_words(np.fromfile(filename, np.uint8), kv.device or "cpu")
    if isinstance(ptr, list):
        ptr.append(filename)
    kv.add_batch(col, _null(len(col)))


def read_vertex_value(itask, filename, kv, ptr):
    """'v u' lines → key=v, value=u, both u64 (cc_stats input)."""
    v, u = _parse_cols(filename, (np.uint64, np.uint64))
    kv.add_batch(v, u)


def read_vertex_weight(itask, filename, kv, ptr):
    """'v weight' lines → key=v, value=weight (map_read_vertex_weight.cpp)."""
    v, w = _parse_cols(filename, (np.uint64, np.float64))
    kv.add_batch(v, w)


# ---------------------------------------------------------------------------
# edge/vertex maps (batch: fn(frame, kv, ptr))
# ---------------------------------------------------------------------------

def host_kmv(fr) -> KMVFrame:
    """A batch-reduce input as a host KMVFrame."""
    return fr if isinstance(fr, KMVFrame) else fr.to_host()


def _map_device(fr, kv, body, **kw) -> None:
    """Map a device frame through a ``parallel/devkernels.py`` body; an
    empty result adds nothing, as ``add_batch`` of no rows does."""
    out = skv_map(fr, body, **kw)
    if len(out):
        kv.add_frame(out)


def edge_to_vertices(fr, kv, ptr):
    """Eij:NULL → Vi:NULL and Vj:NULL (map_edge_to_vertices.cpp)."""
    if isinstance(fr, KVFrame):
        e = fr.key.data
        both = np.concatenate([e[:, 0], e[:, 1]])
        kv.add_batch(both, _null(len(both)))
        return
    _map_device(fr, kv, dk.edge_to_vertices_dev, key_dtype=fr.key_dtype)


def edge_to_vertex(fr, kv, ptr):
    """Eij:NULL → Vi:NULL only (map_edge_to_vertex.cpp)."""
    if isinstance(fr, KVFrame):
        e = fr.key.data
        kv.add_batch(e[:, 0], _null(len(e)))
        return
    _map_device(fr, kv, dk.edge_to_vertex_dev, key_dtype=fr.key_dtype)


def edge_to_vertex_pair(fr, kv, ptr):
    """Eij:NULL → Vi:Vj (map_edge_to_vertex_pair.cpp)."""
    if isinstance(fr, KVFrame):
        e = fr.key.data
        kv.add_batch(e[:, 0], e[:, 1])
        return
    _map_device(fr, kv, dk.edge_to_vertex_pair_dev, key_dtype=fr.key_dtype,
                value_dtype=fr.key_dtype)


def edge_both_directions(fr, kv, ptr):
    """Eij:NULL → Vi:Vj and Vj:Vi (neighbor's adjacency expansion,
    oink/neighbor.cpp:84-116)."""
    if isinstance(fr, KVFrame):
        e = fr.key.data
        kv.add_batch(np.concatenate([e[:, 0], e[:, 1]]),
                     np.concatenate([e[:, 1], e[:, 0]]))
        return
    _map_device(fr, kv, dk.edge_both_directions_dev, key_dtype=fr.key_dtype,
                value_dtype=fr.key_dtype)


def edge_upper(fr, kv, ptr):
    """Canonicalise to Vi<Vj, drop self-loops (map_edge_upper.cpp:15-24)."""
    if isinstance(fr, KVFrame):
        e = fr.key.data
        e = e[e[:, 0] != e[:, 1]]
        lo = np.minimum(e[:, 0], e[:, 1])
        hi = np.maximum(e[:, 0], e[:, 1])
        kv.add_batch(np.stack([lo, hi], 1), _null(len(e)))
        return
    _map_device(fr, kv, dk.edge_upper_dev, extra=(fr.key_dtype,),
                key_dtype=fr.key_dtype)


def invert(fr, kv, ptr):
    """K:V → V:K (map_invert.cpp)."""
    if isinstance(fr, KVFrame):
        kv.add_batch(fr.value.data, fr.key.data)
        return
    _map_device(fr, kv, dk.invert_dev, key_dtype=fr.value_dtype,
                value_dtype=fr.key_dtype)


def add_weight(fr, kv, ptr):
    """Eij:NULL → Eij:1.0 (map_add_weight.cpp — unit edge weights)."""
    if isinstance(fr, KVFrame):
        kv.add_batch(fr.key.data, np.ones(len(fr), np.float64))
        return
    _map_device(fr, kv, dk.add_weight_dev, key_dtype=fr.key_dtype)


def value_histogram(mr) -> list:
    """The shared histogram tail of degree_stats and cc_stats
    (oink/degree_stats.cpp:52-61): invert to value:key, group, count,
    gather, sort descending.  Consumes mr's KV; returns [(value, count)]
    by value descending."""
    mr.map_mr(mr, invert, batch=True)
    mr.collate()
    mr.reduce(count, batch=True)
    mr.gather(1)
    mr.sort_keys(-1)
    stats = []
    mr.scan_kv(lambda k, v, p: stats.append((int(k), int(v))))
    return stats


# ---------------------------------------------------------------------------
# name → kernel registries (the reference's generated style_map.h /
# style_reduce.h): a script line like `mre map/mr mre add_weight` resolves
# its callback here (reference oink/mrmpi.cpp:354-466)
# ---------------------------------------------------------------------------

def hash_lookup3(keys: torch.Tensor) -> torch.Tensor:
    """lookup3 over a u64 key's little-endian bytes (a row of an [n, k]
    key in column order) → u32 hashes in int64 lanes.  One device never
    exchanges, so ``aggregate`` does not call it."""
    k = keys.reshape(keys.shape[0], -1).to(torch.int64)
    words = torch.stack([k & M32, (k >> 32) & M32], -1)
    return hash_words32(words.reshape(keys.shape[0], -1))


def hash_identity(keys: torch.Tensor) -> torch.Tensor:
    """The low 32 bits of the key (of column 0 for an [n, k] key)."""
    k = keys[:, 0] if keys.dim() > 1 else keys
    return k.to(torch.int64) & M32


MAP_FILE_KERNELS = {
    "read_edge": read_edge,
    "read_edge_label": read_edge_label,
    "read_edge_weight": read_edge_weight,
    "read_vertex_value": read_vertex_value,
    "read_vertex_weight": read_vertex_weight,
    "read_words": read_words,
}

MAP_MR_KERNELS = {
    "edge_to_vertices": edge_to_vertices,
    "edge_to_vertex": edge_to_vertex,
    "edge_both_directions": edge_both_directions,
    "edge_upper": edge_upper,
    "edge_to_vertex_pair": edge_to_vertex_pair,
    "invert": invert,
    "add_weight": add_weight,
}

REDUCE_KERNELS = {
    "count": count,
    "cull": cull,
    "sum": sum_values,
    "min": min_values,
    "max": max_values,
}

HASH_KERNELS = {
    "lookup3": hash_lookup3,
    "identity": hash_identity,
}

def lookup(table: dict, name: str, what: str):
    """The callback registered under ``name`` in ``table``."""
    if name not in table:
        raise MRError(f"unknown {what} kernel {name!r} (registered: "
                      f"{sorted(table)})")
    return table[name]


# ---------------------------------------------------------------------------
# printers (reference per-command print callbacks)
# ---------------------------------------------------------------------------

def print_edge(k, v, fp):
    fp.write(f"{k[0]} {k[1]}\n")


def print_vertex(k, v, fp):
    fp.write(f"{k}\n")


def print_vertex_value(k, v, fp):
    fp.write(f"{k} {v}\n")


def print_edge_value(k, v, fp):
    fp.write(f"{k[0]} {k[1]} {v}\n")
