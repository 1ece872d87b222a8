"""net-timeout: every outbound network call must carry a timeout (the
port's copy of ``gpu_mapreduce_tpu/lint/nettimeout.py``).

The fleet tier grew a lot of plain-stdlib networking — router proxying,
client retries, replica probes, health checks.  ``urllib`` and
``socket`` default to NO timeout: one unresponsive peer (SYN-blackholed
port, half-dead NAT entry, a daemon wedged mid-accept) turns the
calling thread into a permanent hostage, and in the serve tier that
thread is a worker or the router's proxy path — a daemon-wide stall
with no error, the same failure shape the parallel/dist.py collective
watchdog exists to kill on the data plane.  The rule makes the control
plane hold the same line statically.

Flagged callables (kwarg or the known positional slot both count as
"has a timeout"):

* ``urllib.request.urlopen(url, data=None, timeout=...)`` — pos 3;
* ``socket.create_connection(addr, timeout=...)`` — pos 2;
* ``http.client.HTTPConnection/HTTPSConnection(host, port,
  timeout=...)`` — pos 3;
* ``socket.socket(...).connect`` is NOT flagged (no timeout param —
  the discipline there is ``settimeout`` first, which this rule cannot
  see soundly; ``create_connection`` is the preferred spelling and IS
  covered).

Scope: the serve tier (``serve/``), the obs HTTP daemon, the operator
tool ``ctl.py`` (the port's ``mrctl.py``, inside the package) and the
opted-in harness scripts — the modules whose threads are
daemon-critical.  Library
code elsewhere that grows a socket should move behind one of these or
get the rule extended.

Pragma: ``# mrlint: disable=net-timeout`` on the call line, for the
rare site where blocking forever is the intent (none today).
"""

from __future__ import annotations

import ast
from typing import List, Optional, Tuple

from .callgraph import name_chain
from .driver import Finding, Project, register

# (dotted-suffix chain, human name, 1-based positional slot of timeout)
_CALLS: Tuple[Tuple[Tuple[str, ...], str, int], ...] = (
    (("urllib", "request", "urlopen"), "urllib.request.urlopen", 3),
    (("request", "urlopen"), "urllib.request.urlopen", 3),
    (("urlopen",), "urlopen", 3),
    (("socket", "create_connection"), "socket.create_connection", 2),
    (("create_connection",), "socket.create_connection", 2),
    (("http", "client", "HTTPConnection"), "http.client.HTTPConnection",
     3),
    (("client", "HTTPConnection"), "http.client.HTTPConnection", 3),
    (("HTTPConnection",), "HTTPConnection", 3),
    (("http", "client", "HTTPSConnection"),
     "http.client.HTTPSConnection", 3),
    (("client", "HTTPSConnection"), "http.client.HTTPSConnection", 3),
    (("HTTPSConnection",), "HTTPSConnection", 3),
)


def _match(chain) -> Optional[Tuple[str, int]]:
    if not chain:
        return None
    for suffix, name, pos in _CALLS:
        if tuple(chain[-len(suffix):]) == suffix:
            return name, pos
    return None


def _in_scope(relpath: str) -> bool:
    return ("/serve/" in relpath
            or relpath.endswith("obs/httpd.py")
            # the package's own ctl.py (the operator tool)
            or (relpath.count("/") == 1 and relpath.endswith("/ctl.py")))


def check(project: Project) -> List[Finding]:
    out: List[Finding] = []
    mods = [m for m in project.all_modules() if _in_scope(m.relpath)]
    mods += list(project.extra.values())
    for mod in mods:
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            hit = _match(name_chain(node.func))
            if hit is None:
                continue
            name, pos = hit
            has_kw = any(kw.arg == "timeout" for kw in node.keywords)
            # a **kwargs splat may carry it — trust the splat (the
            # forwarding wrappers in router.py build their kw dicts
            # from sites this rule already checks)
            has_splat = any(kw.arg is None for kw in node.keywords)
            has_pos = len(node.args) >= pos
            if not (has_kw or has_pos or has_splat):
                out.append(Finding(
                    "net-timeout", mod.relpath, node.lineno,
                    f"{name} without an explicit timeout — one "
                    f"unresponsive peer stalls this thread forever "
                    f"(pass timeout=, doc/lint.md#net-timeout)"))
    return out


register(
    "net-timeout", check,
    "outbound network calls reachable from serve/router/client code "
    "must carry an explicit timeout")
