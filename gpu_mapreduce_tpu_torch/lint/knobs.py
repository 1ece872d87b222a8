"""knob-registry: every ``MRTPU_*``/``SOAK_*`` knob routes through
``utils/env.py`` and has a row in the knob catalog (the port's copy of
``gpu_mapreduce_tpu/lint/knobs.py``; the catalog is
``doc/torch/settings.md``).

``utils/env.py`` is the one place knob parsing is allowed to live: the
crash-proof warn-and-fall-back contract (a malformed observability
knob must degrade, never crash the run it was meant to observe) cannot
drift between sites when every read goes through ``env_knob`` /
``env_str`` / ``env_flag``.  A raw ``os.environ.get("MRTPU_...")``
bypasses that contract; an undocumented knob is invisible to operators;
a documented-but-removed knob sends them setting a variable nothing
reads.

Scope: the package plus the harness scripts (``chip_smoke.py`` and the
``profile_torch_*.py`` scripts — Project ``extra`` modules).  Only the
reserved ``MRTPU_``/``SOAK_`` namespaces are enforced; legacy ``MR_*``/
``GPUMR_*`` app knobs predate the registry and stay out of it.

The port's delta: the catalog may end with a section whose heading
starts ``## Not read by the port``.  The knobs named there (the JAX
package's, with the reason the port has no use for each) are neither
documented rows nor stale: a read of one in code is
``knob-undocumented``, and no ``knob-stale`` is reported for them.

Rules:

* ``knob-bypass`` — a reserved-namespace knob read via raw
  ``os.environ``/``os.getenv`` outside utils/env.py;
* ``knob-undocumented`` — a knob read anywhere but absent from the
  catalog;
* ``knob-stale`` — a knob documented in the catalog but read nowhere
  in code.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Tuple

from .callgraph import env_reads, is_env_helper_call
from .driver import Finding, Project, register

_KNOB = re.compile(r"^(MRTPU|SOAK)_[A-Z0-9_]+$")
_DOC_KNOB = re.compile(r"\b(?:MRTPU|SOAK)_[A-Z0-9_]+\b")
UNREAD_HEADING = "## Not read by the port"
DOC_NAME = "settings.md"


def split_catalog(doc: str) -> Tuple[str, str]:
    """(the catalog, the "not read by the port" section, or "")."""
    lines = doc.splitlines(keepends=True)
    for i, text in enumerate(lines):
        if text.startswith(UNREAD_HEADING):
            return "".join(lines[:i]), "".join(lines[i:])
    return doc, ""


def check(project: Project) -> List[Finding]:
    out: List[Finding] = []
    read_knobs: Dict[str, Tuple[str, int]] = {}

    for mod in project.all_modules(include_extra=True):
        in_registry = mod.relpath.endswith("utils/env.py")
        for knob, node in env_reads(mod.tree):
            if not _KNOB.match(knob):
                continue
            read_knobs.setdefault(knob, (mod.relpath, node.lineno))
            raw = not (isinstance(node, ast.Call)
                       and is_env_helper_call(node))
            if raw and not in_registry:
                out.append(Finding(
                    "knob-bypass", mod.relpath, node.lineno,
                    f"{knob} read via raw os.environ — route through "
                    f"utils/env.py (env_knob/env_str/env_flag) so the "
                    f"warn-and-fall-back contract can't drift"))

    doc_rel = project.doc_path(DOC_NAME)
    catalog, _unread = split_catalog(project.doc(DOC_NAME) or "")
    doc_knobs = set(_DOC_KNOB.findall(catalog))

    for knob, (rel, line) in sorted(read_knobs.items()):
        if knob not in doc_knobs:
            out.append(Finding(
                "knob-undocumented", rel, line,
                f"{knob} is read here but has no row in "
                f"{doc_rel} — operators can't discover it",
                symbol=knob))

    doc_lines = catalog.splitlines()
    for knob in sorted(doc_knobs - set(read_knobs)):
        line = next((i for i, t in enumerate(doc_lines, 1) if knob in t),
                    1)
        out.append(Finding(
            "knob-stale", doc_rel, line,
            f"{knob} is documented but read nowhere in code — setting "
            f"it does nothing", symbol=knob))
    return out


register(
    "knob-registry", check,
    "MRTPU_*/SOAK_* knobs must route through utils/env.py and have a "
    "doc/torch/settings.md row (and doc rows must match live knobs)",
    global_findings=("knob-undocumented", "knob-stale"))
