"""The one-device backend: datasets live on one torch device.

The counterpart of ``gpu_mapreduce_tpu/parallel/backend.MeshBackend`` at
one process.  Its ``aggregate`` is the reference's early-out for
nprocs == 1 (``parallel/shuffle.aggregate_kv``, src/mapreduce.cpp:403-406):
no exchange, but a dense host frame moves onto the device so that convert
and reduce run the device tier, and several frames concatenate into one.
``gather`` and ``broadcast`` are no-ops at P = 1, as the JAX package's
serial backend's are.
"""

from __future__ import annotations

import torch

from ..core.column import DenseColumn
from ..core.dataset import one_frame_of
from ..core.frame import KVFrame
from .sharded import shard_frame, shard_frames


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


class DeviceBackend:
    nprocs = 1
    me = 0

    def __init__(self, device: torch.device):
        self.device = device

    def place(self, frame):
        """A host KVFrame → the same pairs as a frame on this device."""
        return shard_frame(frame, self.device) \
            if isinstance(frame, KVFrame) else frame

    def place_kv(self, kv):
        """A dataset's pairs as one frame on this device.  Host pages of
        dense columns (one dtype and row shape) copy straight into one
        padded device frame, with no concatenation on the host; anything
        else goes through ``one_frame_of``."""
        frames = list(kv.frames())
        if len(frames) > 1 and all(_dense_page(f, frames[0])
                                   for f in frames):
            return shard_frames(frames, self.device)
        return self.place(one_frame_of(frames))

    def aggregate(self, mr) -> None:
        kv = mr.kv
        kv.replace_frames(self.place_kv(kv))

    def gather(self, mr, nprocs: int) -> None:
        """Every pair is on the one device already."""

    def broadcast(self, mr, root: int) -> None:
        """One device holds the only replica."""
