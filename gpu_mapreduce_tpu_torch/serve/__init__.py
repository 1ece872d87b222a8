"""serve/ — the multi-tenant MR-as-a-service daemon on the card.

A resident :class:`~.daemon.Server` keeps the expensive state warm (the
CUDA context and the loaded kernels, the mesh, the plan cache, the
interned dictionaries) and executes OINK scripts and JSON op batches
submitted over the obs/httpd loopback listener as isolated, journaled,
budget-scoped sessions.  ``python -m gpu_mapreduce_tpu_torch.serve``
runs it standalone.  The JAX package's ``serve/`` is the reference:
the same HTTP bodies and status codes, journal records, result and memo
records and metric names.  Fleet mode (``serve/fleet.py``) lets
several replicas share one directory and survive a replica's kill -9;
``serve/router.py`` fronts them.
"""

import importlib

# each public name and its module, imported at first use: the client
# (``serve.client``, ``ctl``) then starts without torch
_EXPORTS = {
    "AdmissionQueue": ".admission", "TokenAuth": ".auth",
    "TenantBudgets": ".budget", "ServeClient": ".client",
    "ServeError": ".client", "Server": ".daemon",
    "FleetMember": ".fleet", "owner_of": ".fleet", "ring_route": ".fleet",
    "BurnShedder": ".overload", "CostProfiles": ".overload",
    "DiskMonitor": ".overload", "Router": ".router",
    "Session": ".session", "normalize_payload": ".session",
    "run_session": ".session",
}

__all__ = ["AdmissionQueue", "TenantBudgets", "ServeClient",
           "ServeError", "Server", "Session", "normalize_payload",
           "run_session", "FleetMember", "Router", "owner_of",
           "ring_route", "TokenAuth", "BurnShedder", "CostProfiles",
           "DiskMonitor"]


def __getattr__(name):
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name], __name__),
                        name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
