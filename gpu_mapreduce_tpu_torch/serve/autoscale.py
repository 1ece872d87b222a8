"""Mesh autoscaling for serve/ sessions — width from profiled volume.

The daemon owns one full-width mesh, but most requests don't need it:
a tiny wordfreq pays mesh dispatch + exchange latency for nothing,
while a shuffle-heavy job wants every shard it can get.  The request
cost profiles measure the deciding quantity — per-request exchange
volume — and ``mr.reshard()`` makes width a live property of a
dataset.  This module picks each session's mesh width from its tenant's
profiled exchange EWMA (narrow for tiny jobs, wide for shuffle-heavy),
and PROMOTE a session live — ``mr.reshard(full_mesh)`` on every named
MR at the next command boundary — when its observed volume outgrows
the prediction.

``MRTPU_SERVE_MESH_AUTO=1`` arms it (default off: an opt-in scheduling
policy, not a correctness feature).  Disarmed, every session runs on
the daemon's full mesh exactly as before.  Sizing rule: the smallest
power-of-two width that keeps the tenant's per-shard exchange volume
under ``_TARGET_PER_SHARD`` (~4 MiB), clamped to [1, full].  A tenant
with NO history gets the full mesh — the autoscaler only narrows on
evidence, never on a guess (doc/serve.md#mesh-autoscaling).

The mesh is the port's ``parallel.mesh.make_mesh``: on a one-card
machine its P shards may all sit on the card (``[cuda:0] * P``), and a
narrow sub-mesh takes the first ``width`` of them.
"""

from __future__ import annotations

import threading
from typing import Dict, Optional

from ..utils.env import env_flag

_TARGET_PER_SHARD = 4 << 20      # exchange bytes per shard to aim for
_PROMOTE_FACTOR = 4              # observed > predicted×4 → go wide


class MeshAutoscaler:
    """Width chooser + live promoter for one daemon's mesh."""

    def __init__(self, comm, profiles, enabled: Optional[bool] = None):
        self.enabled = (enabled if enabled is not None
                        else env_flag("MRTPU_SERVE_MESH_AUTO", False))
        self.profiles = profiles
        self.full = comm
        self.full_width = 1
        self._meshes: Dict[int, object] = {}
        self._lock = threading.Lock()
        self.narrowed = 0
        self.promoted = 0
        self.dist_cap: Optional[int] = None
        if comm is None:
            self.enabled = False         # one device: nothing to size
            return
        from ..parallel.mesh import mesh_axis_size
        self.full_width = mesh_axis_size(comm)
        self._meshes[self.full_width] = comm
        # degraded data plane (parallel/dist.py): after a shrink the
        # fleet's surviving width caps every session mesh — "full" is
        # whatever actually survives, not what the hardware once was
        from ..parallel.dist import surviving_width
        cap = surviving_width()
        self.dist_cap = cap if cap and cap < self.full_width else None
        if self.dist_cap:
            self.full_width = self.dist_cap
            self.full = self.mesh_for(self.dist_cap)
        if self.full_width <= 1:
            self.enabled = False

    # -- sizing ------------------------------------------------------------
    def width_for(self, tenant: str) -> int:
        if not self.enabled:
            return self.full_width
        ewma = self.profiles.exchange_bytes(tenant)
        if ewma is None:
            return self.full_width       # no evidence → no narrowing
        width = 1
        while width < self.full_width and \
                ewma / width > _TARGET_PER_SHARD:
            width *= 2
        return min(width, self.full_width)

    def mesh_for(self, width: int):
        """A sub-mesh over the first ``width`` shards' devices of the
        full mesh (cached)."""
        width = max(1, min(int(width), self.full_width))
        with self._lock:
            mesh = self._meshes.get(width)
            if mesh is None:
                from ..parallel.mesh import make_mesh
                devices = list(self.full.devices)[:width]
                mesh = make_mesh(devices=devices)
                self._meshes[width] = mesh
            return mesh

    def comm_for(self, tenant: str):
        """(comm, width) for a new session of ``tenant``."""
        if not self.enabled:
            return self.full, self.full_width
        width = self.width_for(tenant)
        if width < self.full_width:
            self.narrowed += 1
        return self.mesh_for(width), width

    # -- live promotion ----------------------------------------------------
    def promote_hook(self, account, width: int, on_promote=None):
        """A ``script.post_cmd`` hook: when the session's OBSERVED
        exchange volume outgrows the narrow mesh's budget, reshard
        every named MR onto the full mesh at this (host-side, between-
        commands) boundary and widen the namespace for MRs the script
        creates later.  One-shot: the hook removes itself after
        promoting (or when the session already runs full-width)."""
        if not self.enabled or width >= self.full_width:
            return None
        budget = _PROMOTE_FACTOR * _TARGET_PER_SHARD * max(1, width)

        def hook(script) -> None:
            observed = account.exchange_sent + account.exchange_pad
            if observed <= budget:
                return
            full = self.mesh_for(self.full_width)
            # per-MR, continue on failure: backends are per-MR, so a
            # partially-promoted namespace is legal (cross-MR ops move
            # through host frames) — widening the REST beats leaving
            # everything narrow because one MR was mid-open.  A failed
            # MR stays on its old mesh; the next trigger retries it.
            failed = 0
            for name in list(script.obj.named):
                try:
                    script.obj.named[name].reshard(full)
                except Exception as e:
                    failed += 1
                    import sys
                    print(f"mesh autoscaler: reshard of {name!r} to "
                          f"width {self.full_width} failed ({e!r}); "
                          f"will retry next command", file=sys.stderr)
            script.obj.comm = full    # later MRs are born wide
            if failed:
                return                # keep the hook armed: retry
            self.promoted += 1
            if on_promote is not None:
                on_promote()
            script.post_cmd.remove(hook)

        return hook

    def snapshot(self) -> dict:
        return {"enabled": self.enabled, "full_width": self.full_width,
                "narrowed": self.narrowed, "promoted": self.promoted,
                "dist_cap": self.dist_cap}
