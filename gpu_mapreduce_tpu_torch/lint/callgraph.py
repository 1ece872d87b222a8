"""Scope and callgraph builder for mrlint (the port's copy of
``gpu_mapreduce_tpu/lint/callgraph.py``, unchanged in behaviour).

Best-effort static resolution, tuned for this repo's idioms rather
than full Python semantics:

* functions are indexed by qualname within their module (nested defs
  and lambdas included — callbacks are nested defs by construction);
* calls resolve through (a) enclosing-scope defs, (b) module-level
  defs/classes, (c) ``self.``/``cls.`` methods, (d) package-relative
  imports (module-level OR function-local — the repo late-imports
  heavily to keep import time down);
* reachability is a bounded BFS over resolved calls plus bare-``Name``
  references to project functions (so ``cache.get_or_build(key, build)``
  reaches ``build``).

Unresolvable calls (jnp.*, dict methods, externals) drop silently —
checkers built on this must treat reachability as an under-approximation
and say so in their rule docs.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Set, Tuple

from .driver import Module, Project


@dataclass
class FuncInfo:
    qual: str                    # "Class.method" / "outer.<locals>.inner"
    module: Module
    node: ast.AST                # FunctionDef | AsyncFunctionDef | Lambda
    class_name: str = ""
    params: Tuple[str, ...] = ()

    @property
    def key(self) -> str:
        return f"{self.module.relpath}::{self.qual}"

    @property
    def line(self) -> int:
        return self.node.lineno


def _params(node) -> Tuple[str, ...]:
    a = node.args
    names = [p.arg for p in a.posonlyargs + a.args]
    return tuple(names)


def name_chain(node) -> Optional[Tuple[str, ...]]:
    """``a.b.c`` -> ("a","b","c"); None for anything not a pure
    Name/Attribute chain."""
    parts: List[str] = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


class CallGraph:
    def __init__(self, project: Project):
        self.project = project
        self.funcs: Dict[str, FuncInfo] = {}
        # module relpath -> {alias: dotted target or (dotted, attr)}
        self.imports: Dict[str, Dict[str, object]] = {}
        # module relpath -> {name: FuncInfo} at module level
        self.top: Dict[str, Dict[str, FuncInfo]] = {}
        # module relpath -> {Class: {method: FuncInfo}}
        self.methods: Dict[str, Dict[str, Dict[str, FuncInfo]]] = {}
        for mod in project.modules.values():
            self._index_module(mod)

    # -- indexing ----------------------------------------------------------

    def _index_module(self, mod: Module) -> None:
        imports: Dict[str, object] = {}
        self.imports[mod.relpath] = imports
        self.top.setdefault(mod.relpath, {})
        self.methods.setdefault(mod.relpath, {})
        pkg_parts = mod.dotted.split(".")
        is_pkg = mod.relpath.endswith("__init__.py")

        def resolve_relative(level: int, target: str) -> str:
            # inside package __init__, "from . import x" is level-1 off
            # the package itself
            base = pkg_parts if is_pkg else pkg_parts[:-1]
            if level > 0:
                base = base[:len(base) - (level - 1)]
                return ".".join(base + ([target] if target else []))
            return target

        for node in ast.walk(mod.tree):
            if isinstance(node, ast.Import):
                for alias in node.names:
                    imports[alias.asname or alias.name.split(".")[0]] = \
                        alias.name
            elif isinstance(node, ast.ImportFrom):
                src = resolve_relative(node.level, node.module or "")
                for alias in node.names:
                    imports[alias.asname or alias.name] = (src, alias.name)

        stack: List[str] = []
        class_stack: List[str] = []
        graph = self

        class V(ast.NodeVisitor):
            def _add(self, node, name: str):
                qual = ".".join(stack + [name]) if stack else name
                info = FuncInfo(qual, mod, node,
                                class_stack[-1] if class_stack else "",
                                _params(node))
                graph.funcs[info.key] = info
                if not stack:
                    graph.top[mod.relpath][name] = info
                if class_stack and stack and stack[-1] == class_stack[-1]:
                    graph.methods[mod.relpath].setdefault(
                        class_stack[-1], {})[name] = info
                return info

            def visit_FunctionDef(self, node):
                self._add(node, node.name)
                stack.append(node.name)
                self.generic_visit(node)
                stack.pop()

            visit_AsyncFunctionDef = visit_FunctionDef

            def visit_Lambda(self, node):
                self._add(node, f"<lambda:{node.lineno}>")
                self.generic_visit(node)

            def visit_ClassDef(self, node):
                stack.append(node.name)
                class_stack.append(node.name)
                self.generic_visit(node)
                class_stack.pop()
                stack.pop()

        V().visit(mod.tree)

    # -- resolution --------------------------------------------------------

    def _module_by_dotted(self, dotted: str) -> Optional[Module]:
        return self.project.by_dotted.get(dotted)

    def resolve(self, mod: Module, scope: Optional[FuncInfo],
                chain: Tuple[str, ...]) -> Optional[FuncInfo]:
        """Resolve a name chain at a call/reference site to a project
        function, or None (external / unknown)."""
        if not chain:
            return None
        head = chain[0]
        # self.meth / cls.meth inside a class
        if head in ("self", "cls") and len(chain) == 2 and scope is not None \
                and scope.class_name:
            return self.methods.get(mod.relpath, {}).get(
                scope.class_name, {}).get(chain[1])
        if len(chain) == 1:
            # nested def in enclosing scopes, innermost first
            if scope is not None:
                parts = scope.qual.split(".")
                for i in range(len(parts), 0, -1):
                    key = f"{mod.relpath}::{'.'.join(parts[:i])}.{head}"
                    if key in self.funcs:
                        return self.funcs[key]
            hit = self.top.get(mod.relpath, {}).get(head)
            if hit is not None:
                return hit
            return self._resolve_import(mod, head, ())
        # Class.method in same module
        cls_methods = self.methods.get(mod.relpath, {}).get(head)
        if cls_methods is not None and len(chain) == 2:
            return cls_methods.get(chain[1])
        return self._resolve_import(mod, head, chain[1:])

    def _resolve_import(self, mod: Module, head: str,
                        rest: Tuple[str, ...]) -> Optional[FuncInfo]:
        target = self.imports.get(mod.relpath, {}).get(head)
        if target is None:
            return None
        if isinstance(target, tuple):              # from X import y
            src, attr = target
            child = self._module_by_dotted(f"{src}.{attr}")
            if child is not None and rest:
                # "from . import shuffle" then shuffle.f(...)
                return self.top.get(child.relpath, {}).get(rest[0])
            src_mod = self._module_by_dotted(src)
            if src_mod is None:
                return None
            if not rest:
                return self.top.get(src_mod.relpath, {}).get(attr)
            # from X import Class; Class.method(...)
            return self.methods.get(src_mod.relpath, {}).get(
                attr, {}).get(rest[0])
        src_mod = self._module_by_dotted(str(target))
        if src_mod is None or not rest:
            return None
        if len(rest) == 1:
            return self.top.get(src_mod.relpath, {}).get(rest[0])
        return self.methods.get(src_mod.relpath, {}).get(
            rest[0], {}).get(rest[1])

    def enclosing(self, mod: Module, node: ast.AST) -> Optional[FuncInfo]:
        """Innermost FuncInfo whose span contains node (by lineno)."""
        best = None
        for info in self.funcs.values():
            if info.module is not mod:
                continue
            n = info.node
            if n.lineno <= node.lineno <= (n.end_lineno or n.lineno):
                if best is None or n.lineno > best.node.lineno:
                    best = info
        return best

    # -- reachability ------------------------------------------------------

    def callees(self, info: FuncInfo) -> List[FuncInfo]:
        """Functions called OR referenced by bare name inside info's
        body (nested defs included — they execute under the same entry
        for our purposes).  Memoized per function: the checkers walk
        the graph O(rounds x functions) times over immutable bodies."""
        memo = getattr(self, "_callees_memo", None)
        if memo is None:
            memo = self._callees_memo = {}
        hit = memo.get(info.key)
        if hit is not None:
            return hit
        out: List[FuncInfo] = []
        seen: Set[str] = set()
        for node in ast.walk(info.node):
            chain = None
            if isinstance(node, ast.Call):
                chain = name_chain(node.func)
            elif isinstance(node, ast.Name) and isinstance(
                    getattr(node, "ctx", None), ast.Load):
                chain = (node.id,)
            if not chain:
                continue
            hit = self.resolve(info.module, info, chain)
            if hit is not None and hit.key != info.key \
                    and hit.key not in seen:
                seen.add(hit.key)
                out.append(hit)
        memo[info.key] = out
        return out

    def reachable(self, roots: List[FuncInfo],
                  max_depth: int = 8,
                  max_funcs: int = 400) -> List[FuncInfo]:
        seen: Dict[str, FuncInfo] = {}
        frontier = list(roots)
        for r in roots:
            seen[r.key] = r
        depth = 0
        while frontier and depth < max_depth and len(seen) < max_funcs:
            nxt: List[FuncInfo] = []
            for info in frontier:
                for callee in self.callees(info):
                    if callee.key not in seen:
                        seen[callee.key] = callee
                        nxt.append(callee)
            frontier = nxt
            depth += 1
        return list(seen.values())


def get_graph(project: Project) -> CallGraph:
    """The project's CallGraph, built once and cached on the Project —
    three checkers need it and indexing 100+ modules three times over
    would dominate the whole run."""
    graph = getattr(project, "_callgraph", None)
    if graph is None or graph.project is not project:
        graph = CallGraph(project)
        project._callgraph = graph
    return graph


# ---------------------------------------------------------------------------
# env-knob read detection (shared by purity / cache-key / knob checkers)
# ---------------------------------------------------------------------------

ENV_HELPERS = ("env_knob", "env_str", "env_flag")


def env_reads(root: ast.AST) -> List[Tuple[str, ast.AST]]:
    """(knob_name, node) for every env read under root: os.environ.get /
    os.environ[...] / os.getenv / the utils.env helpers.  Name "?" when
    the knob name is not a string literal."""
    out: List[Tuple[str, ast.AST]] = []

    def lit(node) -> str:
        if isinstance(node, ast.Constant) and isinstance(node.value, str):
            return node.value
        return "?"

    for node in ast.walk(root):
        if isinstance(node, ast.Call):
            chain = name_chain(node.func) or ()
            if chain[-2:] == ("environ", "get") or \
                    chain[-1:] == ("getenv",):
                if node.args:
                    out.append((lit(node.args[0]), node))
            elif chain and chain[-1] in ENV_HELPERS:
                if node.args:
                    out.append((lit(node.args[0]), node))
        elif isinstance(node, ast.Subscript) and isinstance(
                getattr(node, "ctx", None), ast.Load):
            # stores (os.environ["X"] = ...) are knob WRITES — the A/B
            # harness save/restore pattern, not consumption
            chain = name_chain(node.value) or ()
            if chain[-1:] == ("environ",):
                out.append((lit(node.slice), node))
    return out


def is_env_helper_call(node: ast.Call) -> bool:
    chain = name_chain(node.func) or ()
    return bool(chain) and chain[-1] in ENV_HELPERS
