"""cache-key-completeness: every knob a cached builder reads must key
its cache.

Key discipline (plan/cache.py docstring): every knob that changes what a
cached plan or content address stands for must be in its key.  A knob
read reachable from a builder that is NOT derivable from the key means
flipping that knob silently replays a stale entry.  (The port's copy of
``gpu_mapreduce_tpu/lint/cachekey.py``, unchanged in behaviour.)

Covered cache shapes (the repo's two idioms):

* ``SOMECACHE.get_or_build(KEY, BUILD)`` (plan/cache.LRUCache) — the
  knob set reachable from ``BUILD`` (lambda or function reference,
  project callgraph, bounded depth) must be a subset of the knob set
  derivable from ``KEY``: env reads syntactically inside the key
  expression, inside local assignments feeding it, or inside functions
  the key expression calls (``wire_enabled()`` in the plan key is the
  canonical example).
* ``@functools.lru_cache`` / ``@lru_cache(...)`` / ``@functools.cache``
  builders — the arguments ARE the key, so ANY env read reachable from
  the body is a finding (read the knob in the caller and pass it in,
  the ``apps/invertedindex._env_knobs`` pattern).
* content-address key builders (``*_key`` / ``*_digest`` functions
  that hash — ``serve/memo.memo_key``, ``plan/cache.
  stable_plan_digest``): their digests name entries in the SHARED
  on-disk store (utils/cas.py), so an env knob that can influence the
  bytes but is not derivable from a returned key expression poisons
  every replica's cache at once, across restarts.

Env reads that size a cache (``MRTPU_PLAN_CACHE`` in ``plan_cache()``)
never execute inside a builder and are not findings.

Rule: ``cache-key-missing-knob``.
"""

from __future__ import annotations

import ast
from typing import List, Optional, Set, Tuple

from .callgraph import (CallGraph, ENV_HELPERS, FuncInfo, env_reads,
                        get_graph, name_chain)
from .driver import Finding, Project, register


def _is_lru_decorator(dec: ast.AST) -> bool:
    chain = name_chain(dec)
    if isinstance(dec, ast.Call):
        chain = name_chain(dec.func)
    return bool(chain) and chain[-1] in ("lru_cache", "cache")


def _reachable_env_reads(graph: CallGraph, roots: List[FuncInfo]
                         ) -> List[Tuple[str, FuncInfo, ast.AST]]:
    out = []
    for info in graph.reachable(roots, max_depth=6):
        if info.qual in ENV_HELPERS:
            # the registry helpers' own os.environ.get(name) reads a
            # NON-LITERAL name ("?"): the actionable finding is at the
            # env_knob("MRTPU_X", ...) call site, which already reports
            continue
        for knob, node in env_reads(info.node):
            out.append((knob, info, node))
    return out


def _roots_of_expr(graph: CallGraph, mod, scope: Optional[FuncInfo],
                   expr: ast.AST) -> List[FuncInfo]:
    roots = []
    if isinstance(expr, ast.Lambda):
        qual = (f"{scope.qual}.<lambda:{expr.lineno}>" if scope
                else f"<lambda:{expr.lineno}>")
        hit = graph.funcs.get(f"{mod.relpath}::{qual}")
        if hit is not None:
            roots.append(hit)
        return roots
    for node in [expr] + list(ast.walk(expr)):
        chain = None
        if isinstance(node, ast.Call):
            chain = name_chain(node.func)
        elif isinstance(node, ast.Name):
            chain = (node.id,)
        if chain:
            hit = graph.resolve(mod, scope, chain)
            if hit is not None and hit not in roots:
                roots.append(hit)
    return roots


def _key_knobs(graph: CallGraph, mod, scope: Optional[FuncInfo],
               key_expr: ast.AST) -> Set[str]:
    """Knob names derivable from the key expression: read directly in
    it, read in local assignments that feed it (3 dataflow rounds), or
    read in functions it calls."""
    knobs: Set[str] = set()
    exprs: List[ast.AST] = [key_expr]
    seen_names: Set[str] = set()
    fn_node = scope.node if scope is not None else mod.tree
    for _ in range(3):
        new_names: Set[str] = set()
        for e in exprs:
            for knob, _node in env_reads(e):
                knobs.add(knob)
            for r in _roots_of_expr(graph, mod, scope, e):
                for knob, _i, _n in _reachable_env_reads(graph, [r]):
                    knobs.add(knob)
            for n in ast.walk(e):
                if isinstance(n, ast.Name) and n.id not in seen_names:
                    new_names.add(n.id)
        if not new_names:
            break
        seen_names |= new_names
        exprs = []
        for node in ast.walk(fn_node):
            if isinstance(node, ast.Assign):
                hits = any(isinstance(t, ast.Name) and t.id in new_names
                           for t in node.targets)
                if hits:
                    exprs.append(node.value)
        # function parameters named in the key are the CALLER's
        # responsibility — a knob passed in as an argument is keyed by
        # construction, nothing further to derive here
        if not exprs:
            break
    return knobs


def check(project: Project) -> List[Finding]:
    graph = get_graph(project)
    out: List[Finding] = []

    # idiom 1: CACHE.get_or_build(KEY, BUILD)
    for mod in project.modules.values():
        for node in ast.walk(mod.tree):
            if not isinstance(node, ast.Call):
                continue
            chain = name_chain(node.func)
            if not chain or chain[-1] != "get_or_build" \
                    or len(node.args) < 2:
                continue
            scope = graph.enclosing(mod, node)
            key_expr, build_expr = node.args[0], node.args[1]
            build_roots = _roots_of_expr(graph, mod, scope, build_expr)
            if not build_roots:
                continue
            keyed = _key_knobs(graph, mod, scope, key_expr)
            for knob, info, read in _reachable_env_reads(
                    graph, build_roots):
                if knob in keyed:
                    continue
                out.append(Finding(
                    "cache-key-missing-knob", info.module.relpath,
                    read.lineno,
                    f"env knob {knob!r} is read in code reachable from "
                    f"the builder cached at "
                    f"{mod.relpath}:{node.lineno} but does not appear "
                    f"in its cache key — flipping it replays a stale "
                    f"executable",
                    symbol=info.qual))

    # idiom 2: functools.lru_cache builders (the args ARE the key)
    for info in graph.funcs.values():
        node = info.node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not any(_is_lru_decorator(d) for d in node.decorator_list):
            continue
        for knob, rinfo, read in _reachable_env_reads(graph, [info]):
            out.append(Finding(
                "cache-key-missing-knob", rinfo.module.relpath,
                read.lineno,
                f"env knob {knob!r} is read inside (or reachable from) "
                f"lru_cache'd builder {info.qual!r} "
                f"({info.module.relpath}:{node.lineno}) whose arguments "
                f"are its cache key — read it in the caller and pass it "
                f"in",
                symbol=rinfo.qual))

    # idiom 3: content-address key builders.  A *_key / *_digest
    # function that hashes builds a CONTENT ADDRESS shared fleet-wide
    # through the CAS store — a knob it (or anything it calls) reads
    # must be derivable from a return expression, else flipping the
    # knob serves stale store entries on every replica at once.
    hashers = ("sha256", "sha256_bytes", "sha256_file", "md5",
               "blake2b", "crc32")
    for info in graph.funcs.values():
        node = info.node
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if not (node.name.endswith("_key")
                or node.name.endswith("_digest")):
            continue
        if not any(isinstance(n, ast.Call) and
                   (name_chain(n.func) or ("",))[-1] in hashers
                   for n in ast.walk(node)):
            continue
        keyed: Set[str] = set()
        for n in ast.walk(node):
            if isinstance(n, ast.Return) and n.value is not None:
                keyed |= _key_knobs(graph, info.module, info, n.value)
        for knob, rinfo, read in _reachable_env_reads(graph, [info]):
            if knob in keyed:
                continue
            out.append(Finding(
                "cache-key-missing-knob", rinfo.module.relpath,
                read.lineno,
                f"env knob {knob!r} is readable from content-address "
                f"key builder {info.qual!r} "
                f"({info.module.relpath}:{node.lineno}) but is not "
                f"derivable from its returned key expression — "
                f"replicas sharing the store would keep serving "
                f"entries the knob should have invalidated",
                symbol=rinfo.qual))
    return out


register(
    "cache-key", check,
    "env knobs readable from a cached builder must appear in (or be "
    "derivable from) its cache key")
