"""Shared OINK kernels: the map/reduce callbacks the ported commands use.

The counterpart of ``gpu_mapreduce_tpu/oink/kernels.py``.  Data
conventions (reference ``oink/typedefs.h:22-40``): a vertex is a u64, an
edge a ``[n, 2]`` u64 row, a weight a float64, a NULL value a u8 zero.

Readers are file-map callbacks that parse text on the host.  Edge maps
are batch callbacks (``mr.map_mr(..., batch=True)``): a host ``KVFrame``
is mapped with numpy, a device ``ShardedKV`` with torch on its device, so
a graph that lives on the card stays there.  Printers write one output
line per pair.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core.frame import KMVFrame, KVFrame
from ..ops.bits import from_order_key, order_key
from ..ops.reduces import count, cull  # noqa: F401  (the commands' reduces)

# ---------------------------------------------------------------------------
# file parsers (reference map_read_*.cpp)
# ---------------------------------------------------------------------------


def _null(n: int) -> np.ndarray:
    return np.zeros(n, np.uint8)


def _parse_cols(filename: str, dtypes) -> list:
    """Whitespace table → one exact-dtype array per column (u64 ids parse
    as integers, never through a float)."""
    with open(filename, "rb") as f:
        toks = np.asarray(f.read().split())
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


def _device_rows(fr):
    """(key, value) valid rows of a device frame."""
    n = len(fr)
    return fr.key[:n], fr.value[:n]


def _device_null(k: torch.Tensor) -> torch.Tensor:
    return torch.zeros(k.shape[0], dtype=torch.uint8, device=k.device)


def edge_to_vertices(fr, kv, ptr):
    """Eij:NULL → Vi:NULL and Vj:NULL (map_edge_to_vertices.cpp)."""
    if isinstance(fr, KVFrame):
        e = fr.key.data
        both = np.concatenate([e[:, 0], e[:, 1]])
        kv.add_batch(both, _null(len(both)))
        return
    e, _ = _device_rows(fr)
    both = torch.cat([e[:, 0], e[:, 1]])
    kv.add_batch(both, _device_null(both), key_dtype=fr.key_dtype)


def edge_to_vertex(fr, kv, ptr):
    """Eij:NULL → Vi:NULL only (map_edge_to_vertex.cpp)."""
    if isinstance(fr, KVFrame):
        e = fr.key.data
        kv.add_batch(e[:, 0], _null(len(e)))
        return
    e, _ = _device_rows(fr)
    kv.add_batch(e[:, 0].contiguous(), _device_null(e),
                 key_dtype=fr.key_dtype)


def edge_both_directions(fr, kv, ptr):
    """Eij:NULL → Vi:Vj and Vj:Vi (neighbor's adjacency expansion,
    oink/neighbor.cpp:84-116)."""
    if isinstance(fr, KVFrame):
        e = fr.key.data
        kv.add_batch(np.concatenate([e[:, 0], e[:, 1]]),
                     np.concatenate([e[:, 1], e[:, 0]]))
        return
    e, _ = _device_rows(fr)
    kv.add_batch(torch.cat([e[:, 0], e[:, 1]]), torch.cat([e[:, 1], e[:, 0]]),
                 key_dtype=fr.key_dtype, value_dtype=fr.key_dtype)


def edge_upper(fr, kv, ptr):
    """Canonicalise to Vi<Vj, drop self-loops (map_edge_upper.cpp:15-24)."""
    if isinstance(fr, KVFrame):
        e = fr.key.data
        e = e[e[:, 0] != e[:, 1]]
        lo = np.minimum(e[:, 0], e[:, 1])
        hi = np.maximum(e[:, 0], e[:, 1])
        kv.add_batch(np.stack([lo, hi], 1), _null(len(e)))
        return
    e, _ = _device_rows(fr)
    e = e[e[:, 0] != e[:, 1]]
    dt = fr.key_dtype
    a, b = order_key(e[:, 0], dt), order_key(e[:, 1], dt)
    lo = from_order_key(torch.minimum(a, b), dt, e.dtype)
    hi = from_order_key(torch.maximum(a, b), dt, e.dtype)
    kv.add_batch(torch.stack([lo, hi], 1), _device_null(e), key_dtype=dt)


def invert(fr, kv, ptr):
    """K:V → V:K (map_invert.cpp)."""
    if isinstance(fr, KVFrame):
        kv.add_batch(fr.value.data, fr.key.data)
        return
    k, v = _device_rows(fr)
    kv.add_batch(v, k, key_dtype=fr.value_dtype, value_dtype=fr.key_dtype)


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
