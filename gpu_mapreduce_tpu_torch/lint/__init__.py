"""mrlint over the port — the JAX package's ``lint/`` (domain-aware
static analysis for this repo's recurring fault classes), run over
``gpu_mapreduce_tpu_torch/`` and its docs under ``doc/torch/``.

Six checkers over a shared AST driver (``driver.py``) and best-effort
callgraph (``callgraph.py``):

* ``trace-purity`` — host effects in kernel launch wrappers and
  CUDA-graph bodies, and the stream, sync and error discipline of the
  ``.cu`` launchers (purity.py, retargeted from jit/shard_map bodies);
* ``lock-discipline`` — acquisition-order cycles + guarded/unguarded
  mutation splits (locks.py);
* ``cache-key`` — knob reads reachable from cached builders must key
  the cache (cachekey.py);
* ``knob-registry`` — MRTPU_*/SOAK_* knobs route through utils/env.py
  and match doc/torch/settings.md (knobs.py);
* ``metric-catalog`` — mrtpu_* metrics match doc/torch/observability.md
  (metrics_doc.py);
* ``net-timeout`` — outbound network calls in serve/, obs/httpd.py and
  ctl.py carry an explicit timeout (nettimeout.py).

CLI: ``python -m gpu_mapreduce_tpu_torch.lint`` (``__main__.py``).
Policy, rule catalog and pragma etiquette: doc/torch/lint.md.

IMPORTANT: nothing in this package may import from the parent package —
the analyzer runs with no side effects in seconds, without torch.
"""

from .driver import (Finding, Project, RULES, RULE_DOC, load_baseline,
                     run, summary, write_baseline)

# importing the checker modules registers their rules
from . import (cachekey, knobs, locks, metrics_doc,  # noqa: F401,E402
               nettimeout, purity)

__all__ = ["Finding", "Project", "RULES", "RULE_DOC", "run", "summary",
           "load_baseline", "write_baseline"]
