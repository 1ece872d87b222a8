"""The mesh: P shards driven by one process, on one axis or two.

The counterpart of ``gpu_mapreduce_tpu/parallel/mesh.py``.  A
:class:`Mesh` is an ordered tuple of torch devices; shard p's rows live
on ``mesh.devices[p]``.  Several shards may share one device (four
shards on one card, or eight on the CPU for the tests); the exchange
then runs every step of the data plane on that device, and between
distinct cards its copies go device to device.  The reference's
rank/size (``MPI_Comm_rank``/``MPI_Comm_size``) are a shard's index and
:func:`mesh_axis_size`.

Flat form (:func:`make_mesh`): one axis ``"p"``.  Two-level form
(:func:`make_mesh2`): axes ``("s", "c")``, slice × chip, the flat shard
id ``s·C + c`` (row-major), so frames shard exactly as on the flat mesh
of ``S·C`` shards; the exchange routes hierarchically over it
(``shuffle._route``): first within a slice to the destination's chip
index, then one copy between same-chip-index peers across slices.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Sequence, Tuple

import torch

from ..core.runtime import MRError, resolve_device

AXIS = "p"


@dataclass(frozen=True)
class Mesh:
    """Shards on ``axis_names`` of sizes ``dims``: shard p lives on
    ``devices[p]``, p the row-major flat index over the axes."""

    devices: Tuple[torch.device, ...]
    axis_names: Tuple[str, ...] = (AXIS,)
    dims: Tuple[int, ...] = ()

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def shape(self) -> dict:
        if len(self.axis_names) == 1:
            return {self.axis_names[0]: len(self.devices)}
        return dict(zip(self.axis_names, self.dims))

    def __repr__(self):
        axes = ", ".join(f"{a}={n}" for a, n in self.shape.items())
        return f"Mesh({axes}, devices={[str(d) for d in self.devices]})"


def _devices(ndev: Optional[int], devices: Optional[Sequence],
             what: str) -> list:
    """``ndev`` devices: the first CUDA devices (all of them when ``ndev``
    is None; ``MRError`` when fewer are present), or the first ``ndev``
    entries of ``devices``."""
    if devices is None:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        want = have if ndev is None else int(ndev)
        if want < 1 or have < want:
            raise MRError(f"{what}: {have} CUDA device(s) present; pass "
                          f"devices= to place shards on shared devices or "
                          f"on the CPU")
        return [torch.device("cuda", i) for i in range(want)]
    devices = [_normalize(torch.device(d)) for d in devices]
    if ndev is not None:
        if len(devices) < ndev:
            raise MRError(f"{what}: only {len(devices)} devices given")
        devices = devices[:ndev]
    if not devices:
        raise MRError(f"{what}: no devices given")
    return devices


def make_mesh(ndev: Optional[int] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of ``ndev`` shards.  Without ``devices``: the first ``ndev``
    CUDA devices (all of them when ``ndev`` is None), and ``MRError``
    when fewer are present.  With ``devices`` (shards may repeat a
    device, as ``["cpu"] * 8`` or ``[cuda:0] * 4``): its first ``ndev``
    entries."""
    return Mesh(tuple(_devices(ndev, devices, f"make_mesh({ndev})")))


def mesh_on(ndev: int, device=None) -> Mesh:
    """A mesh of ``ndev`` shards for a caller that names one device: one
    shard a card where there are ``ndev`` cards, else every shard on
    ``device`` (the card unless ``"cpu"``; shards may share a card)."""
    dev = resolve_device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= ndev:
        return make_mesh(ndev)
    return make_mesh(ndev, devices=[dev] * ndev)


def make_mesh2(nslice: int, nchip: Optional[int] = None,
               devices: Optional[Sequence] = None) -> Mesh:
    """A two-level mesh of ``nslice`` slices × ``nchip`` chips on axes
    ``("s", "c")`` (JAX ``make_mesh2``): shard ``s·nchip + c`` on the
    ``s·nchip + c``-th device.  ``nchip`` defaults to the devices (the
    CUDA devices when ``devices`` is None) over ``nslice``."""
    what = f"make_mesh2({nslice}, {nchip})"
    if nchip is None:
        have = len(_devices(None, devices, what))
        nchip = have // nslice
    if nslice < 1 or nchip < 1:
        raise MRError(f"{what}: a slice and a chip at least")
    devs = _devices(nslice * nchip, devices, what)
    return Mesh(tuple(devs), ("s", "c"), (int(nslice), int(nchip)))


def _normalize(dev: torch.device) -> torch.device:
    """``cuda`` without an index names the current card."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def mesh_axes(mesh: Mesh) -> Tuple[str, ...]:
    return tuple(mesh.axis_names)


def mesh_axis_size(mesh: Mesh) -> int:
    """The shard count P (the product over the axes)."""
    return mesh.size


def flat_axis_index(mesh: Mesh, *index: int) -> int:
    """The flat shard id of an axis index (``(p,)`` or ``(s, c)``):
    row-major over the axes."""
    if len(index) != len(mesh.axis_names):
        raise MRError(f"flat_axis_index: {len(index)} indices for axes "
                      f"{mesh.axis_names}")
    flat = 0
    for i, n in zip(index, mesh.shape.values()):
        if not 0 <= i < n:
            raise MRError(f"flat_axis_index: {index} outside {mesh.shape}")
        flat = flat * n + i
    return flat
