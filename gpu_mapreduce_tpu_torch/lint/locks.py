"""lock-discipline: acquisition-order cycles + guarded/unguarded
mutation splits (the port's copy of ``gpu_mapreduce_tpu/lint/locks.py``,
unchanged in behaviour).

Two recurring fault classes of threaded code:

* **order cycles** — thread A takes L1 then L2, thread B takes L2 then
  L1.  The static lock graph has an edge L1->L2 for every acquisition
  of L2 while L1 is (syntactically or via a resolved call, bounded
  depth) held; any cycle among strongly-identified locks is reported.
* **unguarded mutations** (a serve daemon's ``rejects`` counter) — a
  counter/dict that is mutated under a lock at >=1 site but bare at
  another is a torn-read/lost-update bug by construction.  Grouping is
  per (class, attribute) for ``self.X`` mutations and per (module,
  global) for module globals; ``__init__``/``__new__`` and module
  top-level are construction-time and exempt.

Lock identity:

* module-level ``NAME = threading.Lock()`` (Lock/RLock/Condition/
  Semaphore) -> strong id ``module::NAME``;
* ``self.NAME = threading.Lock()`` anywhere in a class -> strong id
  ``module::Class.NAME``;
* anything else lock-shaped (``with other._lock``) guards mutations in
  its block but does NOT enter the order graph — weak identities across
  classes would fabricate cycles.

Rules: ``lock-order-cycle``, ``lock-unguarded-mutation``.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import CallGraph, FuncInfo, get_graph, name_chain
from .driver import Finding, Project, register

_LOCK_CTORS = {"Lock", "RLock", "Condition", "Semaphore",
               "BoundedSemaphore"}
_MUTATORS = {"append", "extend", "add", "update", "pop", "popitem",
             "remove", "discard", "clear", "setdefault", "insert",
             "move_to_end", "appendleft"}


def _is_lock_ctor(node: ast.AST) -> bool:
    if not isinstance(node, ast.Call):
        return False
    chain = name_chain(node.func) or ()
    return bool(chain) and chain[-1] in _LOCK_CTORS


class _ModuleLocks:
    """Strong lock identities declared in one module."""

    def __init__(self, mod):
        self.mod = mod
        self.module_locks: Set[str] = set()
        self.class_locks: Dict[str, Set[str]] = {}
        for node in mod.tree.body:
            if isinstance(node, ast.Assign) and _is_lock_ctor(node.value):
                for t in node.targets:
                    if isinstance(t, ast.Name):
                        self.module_locks.add(t.id)
        for cls in ast.walk(mod.tree):
            if not isinstance(cls, ast.ClassDef):
                continue
            attrs = self.class_locks.setdefault(cls.name, set())
            for node in ast.walk(cls):
                if isinstance(node, ast.Assign) \
                        and _is_lock_ctor(node.value):
                    for t in node.targets:
                        if isinstance(t, ast.Attribute) \
                                and isinstance(t.value, ast.Name) \
                                and t.value.id == "self":
                            attrs.add(t.attr)

    def identify(self, expr: ast.AST,
                 scope: Optional[FuncInfo]) -> Optional[Tuple[str, bool]]:
        """(lock_id, strong) for a with-item expr, or None if not
        lock-shaped at all."""
        chain = name_chain(expr)
        if not chain:
            return None
        rel = self.mod.relpath
        if len(chain) == 1:
            if chain[0] in self.module_locks:
                return f"{rel}::{chain[0]}", True
        if chain[0] == "self" and len(chain) == 2 and scope is not None \
                and scope.class_name:
            if chain[1] in self.class_locks.get(scope.class_name, set()):
                return f"{rel}::{scope.class_name}.{chain[1]}", True
        last = chain[-1].lower()
        if "lock" in last or "cv" == last or "cond" in last \
                or "mutex" in last:
            return ".".join(chain), False
        return None


def _mutation_targets(node: ast.AST) -> List[Tuple[str, str, ast.AST]]:
    """(kind, name, node): kind "attr" for self.X, "global" for NAME.
    Covers Assign/AugAssign, subscript stores, and mutating method
    calls."""
    out = []
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) \
            else [node.target]
        for t in targets:
            base = t
            if isinstance(base, ast.Subscript):
                base = base.value
            if isinstance(base, ast.Attribute) \
                    and isinstance(base.value, ast.Name) \
                    and base.value.id == "self":
                out.append(("attr", base.attr, node))
            elif isinstance(base, ast.Name):
                out.append(("global", base.id, node))
    elif isinstance(node, ast.Call):
        chain = name_chain(node.func)
        if chain and chain[-1] in _MUTATORS:
            if len(chain) == 3 and chain[0] == "self":
                out.append(("attr", chain[1], node))
            elif len(chain) == 2:
                out.append(("global", chain[0], node))
    return out


class _FuncScan:
    """Per-function: direct acquisitions, nested (held -> acquired)
    pairs, calls made while holding locks, and mutation sites."""

    def __init__(self, locks: _ModuleLocks, info: FuncInfo):
        self.acquired: Set[str] = set()          # strong ids
        self.nested: List[Tuple[str, str, ast.AST]] = []
        self.calls_held: List[Tuple[str, Tuple[str, ...], ast.AST]] = []
        # (kind, name, guarded, node)
        self.mutations: List[Tuple[str, str, bool, ast.AST]] = []
        self._locks = locks
        self._info = info
        self._walk(info.node, [])

    def _walk(self, node: ast.AST, held: List[Tuple[str, bool]]) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef,
                                  ast.Lambda)) and child is not \
                    self._info.node:
                continue        # nested defs scanned as their own funcs
            if isinstance(child, (ast.With, ast.AsyncWith)):
                ids = []
                for item in child.items:
                    ident = self._locks.identify(item.context_expr,
                                                 self._info)
                    if ident is not None:
                        ids.append(ident)
                for lock_id, strong in ids:
                    if strong:
                        self.acquired.add(lock_id)
                        for held_id, held_strong in held:
                            if held_strong and held_id != lock_id:
                                self.nested.append(
                                    (held_id, lock_id, child))
                self._walk(child, held + ids)
                continue
            if isinstance(child, ast.Call):
                chain = name_chain(child.func)
                if chain and held:
                    for held_id, strong in held:
                        if strong:
                            self.calls_held.append(
                                (held_id, chain, child))
            for kind, nm, mnode in _mutation_targets(child):
                self.mutations.append((kind, nm, bool(held), mnode))
            self._walk(child, held)


def check(project: Project) -> List[Finding]:
    graph = get_graph(project)
    mod_locks = {m.relpath: _ModuleLocks(m)
                 for m in project.modules.values()}
    scans: Dict[str, _FuncScan] = {}
    for info in graph.funcs.values():
        if isinstance(info.node, ast.Lambda):
            continue
        scans[info.key] = _FuncScan(mod_locks[info.module.relpath], info)

    # transitive acquires, bounded: what may be taken inside a call
    trans: Dict[str, Set[str]] = {k: set(s.acquired)
                                  for k, s in scans.items()}
    for _ in range(4):
        changed = False
        for key, scan in scans.items():
            info = graph.funcs[key]
            for callee in graph.callees(info):
                extra = trans.get(callee.key, set()) - trans[key]
                if extra:
                    trans[key] |= extra
                    changed = True
        if not changed:
            break

    # lock graph edges
    edges: Dict[str, Dict[str, Tuple[str, int]]] = {}

    def add_edge(a: str, b: str, mod_rel: str, line: int) -> None:
        edges.setdefault(a, {}).setdefault(b, (mod_rel, line))

    for key, scan in scans.items():
        info = graph.funcs[key]
        for a, b, node in scan.nested:
            add_edge(a, b, info.module.relpath, node.lineno)
        for held_id, chain, node in scan.calls_held:
            callee = graph.resolve(info.module, info, chain)
            if callee is None:
                continue
            for b in trans.get(callee.key, ()):
                if b != held_id:
                    add_edge(held_id, b, info.module.relpath, node.lineno)

    out: List[Finding] = []

    # cycle detection (DFS with colors); report each cycle once
    seen_cycles: Set[frozenset] = set()
    color: Dict[str, int] = {}
    stack: List[str] = []

    def dfs(n: str) -> None:
        color[n] = 1
        stack.append(n)
        for m in edges.get(n, {}):
            if color.get(m, 0) == 0:
                dfs(m)
            elif color.get(m) == 1:
                cyc = stack[stack.index(m):] + [m]
                key = frozenset(cyc)
                if key not in seen_cycles:
                    seen_cycles.add(key)
                    mod_rel, line = edges[n][m]
                    out.append(Finding(
                        "lock-order-cycle", mod_rel, line,
                        "lock acquisition-order cycle: "
                        + " -> ".join(c.split("::")[-1] for c in cyc)
                        + " (full ids: " + " -> ".join(cyc) + ")"))
        stack.pop()
        color[n] = 2

    for n in list(edges):
        if color.get(n, 0) == 0:
            dfs(n)

    # guarded/unguarded mutation splits
    sites: Dict[Tuple, List[Tuple[bool, FuncInfo, ast.AST]]] = {}
    for key, scan in scans.items():
        info = graph.funcs[key]
        fname = info.qual.split(".")[-1]
        if fname in ("__init__", "__new__"):
            continue
        mlocks = mod_locks[info.module.relpath]
        for kind, nm, guarded, node in scan.mutations:
            if kind == "attr":
                if not info.class_name:
                    continue
                # only attributes of classes that own a lock matter
                gkey = ("attr", info.module.relpath, info.class_name, nm)
            else:
                # only module globals assigned at top level qualify
                # (a bare local assignment is not a global mutation)
                if not _is_module_global(info.module, nm):
                    continue
                gkey = ("global", info.module.relpath, nm)
            sites.setdefault(gkey, []).append((guarded, info, node))
    for gkey, entries in sites.items():
        guarded_n = sum(1 for g, _i, _n in entries if g)
        if guarded_n == 0:
            continue
        for g, info, node in entries:
            if g:
                continue
            nm = gkey[-1]
            scope = (f"{gkey[2]}.{nm}" if gkey[0] == "attr"
                     else nm)
            out.append(Finding(
                "lock-unguarded-mutation", info.module.relpath,
                node.lineno,
                f"{scope!r} is mutated under a lock at {guarded_n} "
                f"site(s) but bare here — torn reads / lost updates",
                symbol=info.qual))
    return out


def _is_module_global(mod, name: str) -> bool:
    for node in mod.tree.body:
        if isinstance(node, ast.Assign):
            for t in node.targets:
                if isinstance(t, ast.Name) and t.id == name:
                    return True
        elif isinstance(node, ast.AnnAssign):
            if isinstance(node.target, ast.Name) \
                    and node.target.id == name:
                return True
    return False


register(
    "lock-discipline", check,
    "lock acquisition-order cycles and mutations guarded at one site "
    "but bare at another")
