"""The mesh: P shards on one axis ``"p"``, driven by one process.

The counterpart of ``gpu_mapreduce_tpu/parallel/mesh.py`` (its flat
form).  A :class:`Mesh` is an ordered tuple of torch devices; shard p's
rows live on ``mesh.devices[p]``.  Several shards may share one device
(four shards on one card, or eight on the CPU for the tests); the
exchange then runs every step of the data plane on that device, and
between distinct cards its bucket copies go device to device.  The
reference's rank/size (``MPI_Comm_rank``/``MPI_Comm_size``) are a shard's
index and :func:`mesh_axis_size`.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..core.runtime import MRError

AXIS = "p"


@dataclass(frozen=True)
class Mesh:
    """Shards on axis ``"p"``: shard p lives on ``devices[p]``."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (AXIS,)

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        return {AXIS: len(self.devices)}

    def __repr__(self):
        return f"Mesh(p={self.size}, devices={[str(d) for d in self.devices]})"


def make_mesh(ndev: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``ndev`` shards.  Without ``devices``: the first ``ndev``
    CUDA devices (all of them when ``ndev`` is None), and ``MRError``
    when fewer are present.  With ``devices`` (shards may repeat a
    device, as ``["cpu"] * 8`` or ``[cuda:0] * 4``): its first ``ndev``
    entries."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = have if ndev is None else int(ndev)
        if want < 1 or have < want:
            raise MRError(f"make_mesh({ndev}): {have} CUDA device(s) "
                          f"present; pass devices= to place shards on "
                          f"shared devices or on the CPU")
        devices = [torch.device("cuda", i) for i in range(want)]
    else:
        devices = [_normalize(torch.device(d)) for d in devices]
        if ndev is not None:
            if len(devices) < ndev:
                raise MRError(f"make_mesh({ndev}): only {len(devices)} "
                              f"devices given")
            devices = devices[:ndev]
        if not devices:
            raise MRError("make_mesh: no devices given")
    return Mesh(tuple(devices))


def _normalize(dev: torch.device) -> torch.device:
    """``cuda`` without an index names the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_axis_size(mesh: Mesh) -> int:
    """The shard count P."""
    return mesh.size
