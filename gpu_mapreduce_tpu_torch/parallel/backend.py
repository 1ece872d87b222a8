"""The one-device backend: datasets live on one torch device.

The counterpart of ``gpu_mapreduce_tpu/parallel/backend.MeshBackend`` at
one process.  Its ``aggregate`` is the reference's early-out for
nprocs == 1 (``parallel/shuffle.aggregate_kv``, src/mapreduce.cpp:403-406):
no exchange, but a dense host frame moves onto the device so that convert
and reduce run the device tier, and several frames concatenate into one.
"""

from __future__ import annotations

import torch

from ..core.frame import KVFrame
from .sharded import shard_frame


class DeviceBackend:
    nprocs = 1
    me = 0

    def __init__(self, device: torch.device):
        self.device = device

    def place(self, frame):
        """A host KVFrame → the same pairs as a frame on this device."""
        return shard_frame(frame, self.device) \
            if isinstance(frame, KVFrame) else frame

    def aggregate(self, mr) -> None:
        kv = mr.kv
        kv.replace_frames(self.place(kv.one_frame()))
