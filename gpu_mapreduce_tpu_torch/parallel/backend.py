"""The backends a MapReduce dispatches its data plane to.

The counterpart of ``gpu_mapreduce_tpu/parallel/backend.py``:

* :class:`DeviceBackend` — datasets on one torch device.  Its
  ``aggregate`` is the reference's early-out for nprocs == 1
  (``parallel/shuffle.aggregate_kv``, src/mapreduce.cpp:403-406): no
  exchange, but a dense host frame moves onto the device so that convert
  and reduce run the device tier, and several frames concatenate into
  one.  ``gather`` keeps the rows where they are and cuts a lone device
  frame to the power of two of its rows (the JAX one-shard exchange's
  cap); ``broadcast`` is a no-op at P = 1.
* :class:`MeshBackend` — datasets over a :class:`~.mesh.Mesh` of P > 1
  shards (JAX parallel/backend.py:17-42): ``aggregate``, ``gather`` and
  ``broadcast`` run the exchange and the collectives; host datasets of a
  mesh MapReduce (a ``map``'s pages) group and sort on the first shard's
  device, as the JAX package groups them on its controller.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..core.column import DenseColumn
from ..core.dataset import one_frame_of
from ..core.frame import KVFrame
from .sharded import ShardedKV, round_cap, shard_frame, shard_frames


def _dense_page(fr, first) -> bool:
    """Whether ``fr`` is a host frame of dense columns shaped as
    ``first``'s."""
    if not isinstance(fr, KVFrame):
        return False
    for a, b in ((fr.key, first.key), (fr.value, first.value)):
        if not (isinstance(a, DenseColumn) and isinstance(b, DenseColumn)
                and a.data.dtype == b.data.dtype
                and a.data.shape[1:] == b.data.shape[1:]):
            return False
    return True


def _device_layout(fr):
    """A device frame's storage and logical dtypes and row shapes, or None
    when its keys or values are interned."""
    s = fr.shards[0] if hasattr(fr, "shards") else fr
    if s.key_decode is not None or s.value_decode is not None:
        return None
    return (s.key.dtype, s.value.dtype, str(s.key_dtype),
            str(s.value_dtype), s.key.shape[1:], s.value.shape[1:])


class DeviceBackend:
    nprocs = 1
    me = 0
    mesh = None

    def __init__(self, device: torch.device):
        self.device = device

    def place(self, frame):
        """A host KVFrame → the same pairs as a frame on this device."""
        return shard_frame(frame, self.device) \
            if isinstance(frame, KVFrame) else frame

    def place_kv(self, kv):
        """A dataset's pairs as one frame on this device (see
        :meth:`place_kv_frames`)."""
        return self.place_kv_frames(list(kv.frames()))

    def place_kv_frames(self, frames):
        """Frames as one frame on this device.  Host pages of dense
        columns (one dtype and row shape) copy straight into one padded
        device frame, with no concatenation on the host; anything else
        goes through ``one_frame_of``."""
        if len(frames) > 1 and all(_dense_page(f, frames[0])
                                   for f in frames):
            return shard_frames(frames, self.device)
        return self.place(one_frame_of(frames))

    def aggregate(self, mr, hash_fn=None) -> None:
        """No exchange at P = 1, so ``hash_fn`` is not called."""
        kv = mr.kv
        kv.replace_frames(self.place_kv(kv))

    def gather(self, mr, nprocs: int) -> None:
        """Every pair is on the one device already.  A lone device frame
        is cut to the power of two of its rows, as the JAX package's
        one-shard gather exchange re-caps it: a later plan keys on the
        cap, so frames of the same rows, from a cold or a warm group,
        key alike."""
        frames = list(mr.kv.frames())
        if len(frames) != 1 or not isinstance(frames[0], ShardedKV):
            return
        fr = frames[0]
        n = round_cap(len(fr))
        if n < fr.cap:
            mr.kv.replace_frames(dataclasses.replace(
                fr, key=fr.key[:n].clone(), value=fr.value[:n].clone()))

    def broadcast(self, mr, root: int) -> None:
        """One device holds the only replica."""


class MeshBackend:
    """Datasets over a mesh of P > 1 shards, driven by this process."""

    me = 0

    def __init__(self, mesh):
        self.mesh = mesh
        self.nprocs = mesh.size
        self._first = DeviceBackend(mesh.devices[0])

    @staticmethod
    def _split(kv):
        """(the dataset's mesh frames as one, or None; else its frames,
        mesh frames as their rows in shard order: joined on the first
        shard's device when every frame is a dense device frame of one
        dtype and row shape (an OINK cull loop's batches beside the
        rounds before), else brought to the host)."""
        from .sharded import MeshKV, ShardedKV
        frames = list(kv.frames())
        if frames and all(isinstance(f, MeshKV) for f in frames):
            return concat_mesh(frames), None
        if all(isinstance(f, (MeshKV, ShardedKV)) for f in frames):
            layouts = {_device_layout(f) for f in frames}
            if len(layouts) == 1 and None not in layouts:
                return None, [f.joined() if isinstance(f, MeshKV) else f
                              for f in frames]
        return None, [f.to_host() if isinstance(f, MeshKV) else f
                      for f in frames]

    def place_kv(self, kv):
        """The dataset as one device frame for convert and sort: its mesh
        frames (concatenated shard by shard when several), or else its
        pairs as one frame on the first shard's device."""
        mesh_frame, frames = self._split(kv)
        return mesh_frame if frames is None \
            else self._first.place_kv_frames(frames)

    def mesh_frame(self, kv, dense_only: bool = False):
        """The dataset as one mesh frame for the exchange: its mesh frames,
        or its pairs placed and split contiguously over the shards.  With
        ``dense_only`` a dataset of host text rows stays where it is
        (None), as the JAX package's gather and broadcast leave it."""
        from .sharded import split_to_mesh
        mesh_frame, frames = self._split(kv)
        if frames is None:
            return mesh_frame
        if dense_only and any(not f.is_dense() if isinstance(f, KVFrame)
                              else f.key_decode is not None
                              or f.value_decode is not None
                              for f in frames):
            return None
        return split_to_mesh(self._first.place_kv_frames(frames), self.mesh)

    def aggregate(self, mr, hash_fn=None) -> None:
        from .shuffle import aggregate_kv
        aggregate_kv(self, mr, hash_fn)

    def gather(self, mr, nprocs: int) -> None:
        from .collectives import gather_kv
        gather_kv(self, mr, nprocs)

    def broadcast(self, mr, root: int) -> None:
        from .collectives import broadcast_kv
        broadcast_kv(self, mr, root)


def _merge_mesh_tables(tables, what: str, P: int):
    """Union of mesh frames' decode tables as one ShardTables (None:
    plain ids; mixing plain with interned is refused)."""
    from .devkernels import _merge_decode
    from .sharded import mesh_tables
    if any(t is None for t in tables):
        return _merge_decode(tables, what)
    out = mesh_tables(tables[0], P)
    for t in tables[1:]:
        out = out.merge(mesh_tables(t, P))
    return out


def concat_mesh(frames):
    """Mesh frames on one mesh → one, shard by shard: shard p holds each
    frame's shard-p rows in frame order, in a block of the frames' caps
    summed (the JAX package's ``concat_sharded``).  Text columns of
    bytes and object kind meet in the pickle domain first, so equal
    logical rows carry one id."""
    from .devkernels import _reintern_pickle_domain
    from .sharded import MeshKV, ShardedKV
    if len(frames) == 1:
        return frames[0]
    mesh = frames[0].mesh
    P = mesh.size
    cols, tables = {}, {}
    for which in ("key", "value"):
        per = [[getattr(s, which) for s in f.shards] for f in frames]
        tabs = [getattr(f, f"{which}_decode") for f in frames]
        if {t.kind for t in tabs if t is not None} == {"bytes", "object"}:
            for i, t in enumerate(tabs):
                if t is not None and t.kind == "bytes":
                    moved = [_reintern_pickle_domain(c, t) for c in per[i]]
                    per[i] = [c for c, _ in moved]
                    tabs[i] = moved[0][1]
        cols[which] = per
        tables[which] = _merge_mesh_tables(tabs, which, P)
    cap = sum(f.cap for f in frames)
    first = frames[0]
    shards = []
    for p in range(P):
        k0, v0 = cols["key"][0][p], cols["value"][0][p]
        key = k0.new_zeros((cap,) + tuple(k0.shape[1:]))
        value = v0.new_zeros((cap,) + tuple(v0.shape[1:]))
        at = 0
        for i, f in enumerate(frames):
            m = int(f.shards[p].counts[0])
            key[at:at + m] = cols["key"][i][p][:m]
            value[at:at + m] = cols["value"][i][p][:m]
            at += m
        shards.append(ShardedKV(key, value, np.array([at], np.int32),
                                first.key_dtype, first.value_dtype,
                                tables["key"], tables["value"]))
    return MeshKV(mesh, shards)
