"""serve/ — the multi-tenant MR-as-a-service daemon on the card.

A resident :class:`~.daemon.Server` keeps the expensive state warm (the
CUDA context and the loaded kernels, the mesh, the plan cache, the
interned dictionaries) and executes OINK scripts and JSON op batches
submitted over the obs/httpd loopback listener as isolated, journaled,
budget-scoped sessions.  ``python -m gpu_mapreduce_tpu_torch.serve``
runs it standalone.  The JAX package's ``serve/`` is the reference:
the same HTTP bodies and status codes, journal records, result and memo
records and metric names.  Fleet mode (``serve/fleet.py``,
``serve/router.py``) is not ported yet and refuses.
"""

from .admission import AdmissionQueue
from .auth import TokenAuth
from .budget import TenantBudgets
from .client import ServeClient, ServeError
from .daemon import Server
from .overload import BurnShedder, CostProfiles, DiskMonitor
from .session import Session, normalize_payload, run_session

__all__ = ["AdmissionQueue", "TenantBudgets", "ServeClient",
           "ServeError", "Server", "Session", "normalize_payload",
           "run_session", "TokenAuth", "BurnShedder", "CostProfiles",
           "DiskMonitor"]
