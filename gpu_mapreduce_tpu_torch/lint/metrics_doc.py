"""metric-catalog: code and the metric catalog must agree (the port's
copy of ``gpu_mapreduce_tpu/lint/metrics_doc.py``; the catalog is
``doc/torch/observability.md``).

Every metric name registered in the package (any lowercase ``mrtpu_*``
string literal — the reserved namespace for metric names) must appear
in doc/observability.md's catalog, and every name the catalog documents
must still exist in code.  Regex over source text on purpose: metric
specs ride tuples (the ft collector), so matching only
counter()/gauge()/histogram() call sites would miss them, and
non-metric identifiers use dashes or uppercase (thread names
"mrtpu-...", env vars "MRTPU_...") which the pattern excludes.

Rules: ``metric-undocumented``, ``metric-stale``.
"""

from __future__ import annotations

import re
from typing import Dict, List, Tuple

from .driver import Finding, Project, register

_REG_CALL = re.compile(r"[\"'](mrtpu_[a-z0-9_]+)[\"']")
_DOC_NAME = re.compile(r"mrtpu_[a-z0-9_]+")

# histogram exposition suffixes the doc may quote verbatim
_SUFFIXES = ("_bucket", "_sum", "_count")

DOC_NAME = "observability.md"


def code_metrics(project: Project) -> Dict[str, Tuple[str, int]]:
    """metric -> (relpath, line) of its first registration."""
    out: Dict[str, Tuple[str, int]] = {}
    for mod in project.all_modules():
        for i, text in enumerate(mod.lines, 1):
            for name in _REG_CALL.findall(text):
                out.setdefault(name, (mod.relpath, i))
    return out


def doc_metrics(doc: str) -> set:
    raw = set(_DOC_NAME.findall(doc))
    out = set()
    for name in raw:
        for suf in _SUFFIXES:
            if name.endswith(suf) and name[:-len(suf)] in raw:
                break
        else:
            out.add(name)
    return out


def check(project: Project) -> List[Finding]:
    out: List[Finding] = []
    in_code = code_metrics(project)
    doc = project.doc(DOC_NAME)
    if doc is None:
        return out
    doc_rel = project.doc_path(DOC_NAME)
    in_doc = doc_metrics(doc)
    doc_lines = doc.splitlines()
    for name in sorted(set(in_code) - in_doc):
        rel, line = in_code[name]
        out.append(Finding(
            "metric-undocumented", rel, line,
            f"metric {name} is registered here but missing from "
            f"{doc_rel}'s catalog — invisible to operators",
            symbol=name))
    for name in sorted(in_doc - set(in_code)):
        line = next((i for i, t in enumerate(doc_lines, 1)
                     if name in t), 1)
        out.append(Finding(
            "metric-stale", doc_rel, line,
            f"metric {name} is documented but registered nowhere — "
            f"operators will grep for a series that never appears",
            symbol=name))
    return out


register(
    "metric-catalog", check,
    "mrtpu_* metric names in code and doc/torch/observability.md must agree "
    "both ways",
    global_findings=("metric-undocumented", "metric-stale"))
