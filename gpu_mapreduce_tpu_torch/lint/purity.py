"""trace-purity, retargeted at the port's device code: no host effects
where the card's work is queued.

The port has no ``jit``, ``shard_map`` or ``pallas_call``: its device
code is queued on a CUDA stream and runs after the host moved on.  Host
work in that code is the class of fault the JAX rule caught in traced
bodies, in its CUDA form: a synchronise (``.item()``, ``.cpu()``,
``torch.cuda.synchronize``) stalls the host until the card drains and
serialises every session that shares the card's stream; an env read or
a ``print`` runs on every launch; a lock taken around a launch orders
nothing on the card.

Entry points (the device set's roots), three kinds:

1. **kernel launch wrappers** — every function in ``ops/cuda/`` that
   calls ``note_kernel_launch`` (``match.mark_words``, ``match.mark``,
   ``group.segment_table``);
2. **CUDA-graph bodies** — a ``with torch.cuda.graph(...)`` block, the
   statements between ``.capture_begin()`` and ``.capture_end()``, and a
   callable passed to ``torch.cuda.make_graphed_callables`` (a capture
   records launches; host work in it runs once, at capture time);
3. **host launchers in CUDA sources** — each ``extern "C"`` function of
   the package's ``.cu`` files, read as text (there is no C parser
   here), with the static host helpers it calls in the same file.

For kinds 1 and 2, everything reachable from an entry through the
project callgraph is device code, except the kernel loader
``ops/cuda/__init__.py``: its once-per-process build and load
(``library``, its lock, ``nvcc``, ``time``) and the launch counter
``note_kernel_launch`` are host bookkeeping outside any stream order,
so the walk does not enter that module (a rule, not a pragma).
Reachability is best-effort (unresolvable calls drop): the rule
under-approximates.

Rules emitted:

* ``purity-host-call`` — print/open/time/random/env reads;
* ``purity-lock`` — lock acquisition (``with <lock>`` / ``.acquire()``);
* ``purity-coerce`` — the device syncs of a tensor: ``.item()`` and
  ``.cpu()`` anywhere, ``.tolist()``/``.numpy()``/``float()``/
  ``int()``/``bool()``/``np.asarray()`` on a value data-flowed from a
  tensor parameter of an entry (one-level positional taint; a
  parameter annotated with a non-tensor type carries no taint, so
  numpy's ``.tolist()`` on a pattern's host tables is not a finding),
  and every ``.synchronize()`` (``torch.cuda``, a ``Stream``, an
  ``Event``);
* ``purity-cuda-launch`` — in a ``.cu`` launcher or the host helpers it
  calls: a ``<<<…>>>`` launch without four launch arguments whose
  fourth is the stream the launcher was handed; a synchronising or
  allocating runtime call (``cudaDeviceSynchronize``,
  ``cudaStreamSynchronize``, ``cudaEventSynchronize``, ``cudaMalloc*``,
  ``cudaFree*``, a ``cudaMemcpy``/``cudaMemset`` that is not
  ``Async``); a launch whose error is not read with
  ``cudaGetLastError()`` after it, or a success returned after the
  launch path; and a ``printf`` in any ``__global__``/``__device__``
  function of the file.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from .callgraph import ENV_HELPERS as _ENV_HELPERS
from .callgraph import (CallGraph, FuncInfo, env_reads, get_graph,
                        name_chain)
from .driver import Finding, Project, TextSource, register

_TIME_FNS = {"time", "perf_counter", "monotonic", "sleep",
             "process_time", "time_ns", "perf_counter_ns"}

# the kernel loader and launch counter: host bookkeeping, never walked
LOADER_SUFFIX = "ops/cuda/__init__.py"


def _is_kernel_module(relpath: str) -> bool:
    return "/ops/cuda/" in relpath and not relpath.endswith(LOADER_SUFFIX)


def _calls_named(node: ast.AST, name: str) -> bool:
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            chain = name_chain(n.func)
            if chain and chain[-1] == name:
                return True
    return False


def _synthetic(mod, scope: Optional[FuncInfo], tag: str,
               node: ast.AST) -> FuncInfo:
    """A code block (a graph capture) as a FuncInfo of its own: it
    resolves names in its enclosing function's scope."""
    qual = f"{scope.qual}.<{tag}:{node.lineno}>" if scope \
        else f"<{tag}:{node.lineno}>"
    return FuncInfo(qual, mod, node, scope.class_name if scope else "")


def _capture_regions(body: List[ast.stmt]):
    """(begin statement, statements) for each ``.capture_begin()`` …
    ``.capture_end()`` run inside one statement list."""
    def is_call(stmt, attr):
        return isinstance(stmt, ast.Expr) \
            and isinstance(stmt.value, ast.Call) \
            and isinstance(stmt.value.func, ast.Attribute) \
            and stmt.value.func.attr == attr
    i = 0
    while i < len(body):
        if is_call(body[i], "capture_begin"):
            for j in range(i + 1, len(body)):
                if is_call(body[j], "capture_end"):
                    yield body[i], body[i + 1:j]
                    i = j
                    break
        i += 1


def _entries(graph: CallGraph) -> List[FuncInfo]:
    roots: List[FuncInfo] = []
    seen: Set[str] = set()

    def add(info: Optional[FuncInfo]) -> None:
        if info is not None and info.key not in seen:
            seen.add(info.key)
            roots.append(info)

    # kind 1: the kernel launch wrappers
    for info in graph.funcs.values():
        if isinstance(info.node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                and _is_kernel_module(info.module.relpath) \
                and _calls_named(info.node, "note_kernel_launch"):
            add(info)
    # kind 2: CUDA-graph bodies
    for mod in graph.project.modules.values():
        for node in ast.walk(mod.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    expr = item.context_expr
                    chain = name_chain(expr.func) \
                        if isinstance(expr, ast.Call) else None
                    if chain and (chain[-2:] == ("cuda", "graph")
                                  or chain == ("graph",)):
                        scope = graph.enclosing(mod, node)
                        add(_synthetic(mod, scope, "graph", node))
            body = getattr(node, "body", None)
            if isinstance(body, list):
                for begin, stmts in _capture_regions(body):
                    if not stmts:
                        continue
                    block = ast.If(test=ast.Constant(True), body=stmts,
                                   orelse=[])
                    ast.copy_location(block, stmts[0])
                    block.end_lineno = stmts[-1].end_lineno
                    scope = graph.enclosing(mod, begin)
                    add(_synthetic(mod, scope, "capture", block))
            if isinstance(node, ast.Call):
                chain = name_chain(node.func)
                if chain and chain[-1] == "make_graphed_callables" \
                        and node.args:
                    arg = node.args[0]
                    elts = arg.elts if isinstance(arg, (ast.Tuple,
                                                        ast.List)) \
                        else [arg]
                    scope = graph.enclosing(mod, node)
                    for elt in elts:
                        achain = name_chain(elt)
                        if achain:
                            add(graph.resolve(mod, scope, achain))
    return roots


def _reachable(graph: CallGraph, roots: List[FuncInfo],
               max_depth: int = 8, max_funcs: int = 400) -> List[FuncInfo]:
    """``CallGraph.reachable`` that never enters the kernel loader."""
    seen: Dict[str, FuncInfo] = {r.key: r for r in roots}
    frontier = list(roots)
    depth = 0
    while frontier and depth < max_depth and len(seen) < max_funcs:
        nxt: List[FuncInfo] = []
        for info in frontier:
            for callee in graph.callees(info):
                if callee.key in seen \
                        or callee.module.relpath.endswith(LOADER_SUFFIX):
                    continue
                seen[callee.key] = callee
                nxt.append(callee)
        frontier = nxt
        depth += 1
    return list(seen.values())


def _tensor_params(info: FuncInfo) -> Set[str]:
    """An entry's parameters that may hold tensors: those annotated with
    a type naming ``Tensor``, or every parameter of an entry that
    annotates none."""
    node = info.node
    if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return set()
    args = node.args.posonlyargs + node.args.args
    if not any(a.annotation is not None for a in args):
        return {a.arg for a in args}
    return {a.arg for a in args if a.annotation is not None
            and "Tensor" in ast.unparse(a.annotation)}


def _taint(graph: CallGraph, traced: List[FuncInfo],
           entries: List[FuncInfo]) -> Dict[str, Set[str]]:
    """function key -> set of local names carrying tensor values."""
    traced_keys = {f.key for f in traced}
    taint: Dict[str, Set[str]] = {f.key: _tensor_params(f) for f in entries}
    by_key = {f.key: f for f in traced}
    for _round in range(5):
        changed = False
        for info in traced:
            names = taint.get(info.key, set())
            # closure flow: a nested def sees its ancestors' taints
            prefix = info.qual.rsplit(".", 1)[0] if "." in info.qual else ""
            while prefix:
                parent = taint.get(f"{info.module.relpath}::{prefix}")
                if parent:
                    names = names | parent
                prefix = prefix.rsplit(".", 1)[0] if "." in prefix else ""
            if names != taint.get(info.key, set()):
                taint[info.key] = set(names)
                changed = True
            if not names:
                continue
            for node in ast.walk(info.node):
                if not isinstance(node, ast.Call):
                    continue
                chain = name_chain(node.func)
                if not chain:
                    continue
                callee = graph.resolve(info.module, info, chain)
                if callee is None or callee.key not in traced_keys:
                    continue
                tgt = taint.setdefault(callee.key, set())
                for pos, arg in enumerate(node.args):
                    if isinstance(arg, ast.Name) and arg.id in names \
                            and pos < len(callee.params):
                        if callee.params[pos] not in tgt:
                            tgt.add(callee.params[pos])
                            changed = True
        if not changed:
            break
    for key in list(taint):
        if key in by_key:
            # assignments from tainted expressions taint their targets
            info = by_key[key]
            names = taint[key]
            for node in ast.walk(info.node):
                if isinstance(node, ast.Assign):
                    used = {n.id for n in ast.walk(node.value)
                            if isinstance(n, ast.Name)}
                    if used & names:
                        for t in node.targets:
                            for n in ast.walk(t):
                                if isinstance(n, ast.Name):
                                    names.add(n.id)
    return taint


def _lockish(expr: ast.AST) -> Optional[str]:
    chain = name_chain(expr)
    if isinstance(expr, ast.Call):
        chain = name_chain(expr.func)
    if not chain:
        return None
    last = chain[-1].lower()
    if "lock" in last or last in ("condition", "cv", "mutex"):
        return ".".join(chain)
    return None


def _root_name(expr: ast.AST) -> Optional[str]:
    """The name a receiver expression starts from (``x`` in
    ``x.view(-1)[0]``)."""
    while True:
        if isinstance(expr, ast.Name):
            return expr.id
        if isinstance(expr, (ast.Attribute, ast.Subscript)):
            expr = expr.value
        elif isinstance(expr, ast.Call):
            expr = expr.func
        else:
            return None


def device_set(project: Project) -> Tuple[List[FuncInfo], List[FuncInfo]]:
    """(the entries of kinds 1 and 2, everything reachable from them)."""
    graph = get_graph(project)
    entries = _entries(graph)
    return entries, _reachable(graph, entries)


def _check_python(project: Project) -> List[Finding]:
    graph = get_graph(project)
    entries, traced = device_set(project)
    taint = _taint(graph, traced, entries)
    out: List[Finding] = []
    where = "in device code (a kernel wrapper or CUDA-graph body)"

    for info in traced:
        mod = info.module
        names = taint.get(info.key, set())
        body = info.node
        nested_spans = [
            (f.node.lineno, f.node.end_lineno or f.node.lineno)
            for f in traced
            if f.module is mod and f.key != info.key
            and f.qual.startswith(info.qual + ".")]

        def owned(node) -> bool:
            # skip nodes belonging to a nested device def (they report
            # under their own FuncInfo, once)
            ln = getattr(node, "lineno", None)
            if ln is None:
                return False
            return not any(a <= ln <= b for a, b in nested_spans)

        def emit(rule, node, msg):
            out.append(Finding(rule, mod.relpath, node.lineno, msg,
                               symbol=info.qual))

        for knob, node in env_reads(body):
            # the registry helpers' own non-literal reads: the call site
            # reports with the real knob name
            if info.qual in _ENV_HELPERS:
                continue
            if owned(node):
                emit("purity-host-call", node,
                     f"env read {knob!r} {where} runs on every launch "
                     f"(read it once, outside, and pass it in)")
        for node in ast.walk(body):
            if not owned(node):
                continue
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lk = _lockish(item.context_expr)
                    if lk:
                        emit("purity-lock", node,
                             f"lock {lk!r} acquired {where} orders "
                             f"nothing on the card's stream")
            if not isinstance(node, ast.Call):
                continue
            chain = name_chain(node.func) or ()
            attr = node.func.attr \
                if isinstance(node.func, ast.Attribute) else None
            if chain == ("print",):
                emit("purity-host-call", node,
                     f"print() {where} is a host effect on every launch")
            elif chain == ("open",):
                emit("purity-host-call", node,
                     f"open() {where} is a host file effect")
            elif len(chain) == 2 and chain[0] == "time" \
                    and chain[1] in _TIME_FNS:
                emit("purity-host-call", node,
                     f"time.{chain[1]}() {where} reads the host clock, "
                     f"not the card's (use CUDA events)")
            elif chain[:1] == ("random",) and len(chain) == 2:
                emit("purity-host-call", node,
                     f"random.{chain[1]}() {where} — use a seeded "
                     f"torch.Generator passed in")
            elif len(chain) >= 3 and chain[0] in ("np", "numpy") \
                    and chain[1] == "random":
                emit("purity-host-call", node,
                     f"np.random {where} — use a seeded torch.Generator "
                     f"passed in")
            elif chain[-1:] == ("acquire",) and len(chain) >= 2 \
                    and "lock" in chain[-2].lower():
                emit("purity-lock", node,
                     f"{'.'.join(chain)} {where}")
            elif attr == "synchronize":
                emit("purity-coerce", node,
                     f"{ast.unparse(node.func)}() {where} blocks the "
                     f"host until the card drains")
            elif attr in ("item", "cpu") and not node.args:
                emit("purity-coerce", node,
                     f".{attr}() {where} copies to the host and waits "
                     f"for the card")
            elif attr in ("tolist", "numpy") and not node.args \
                    and _root_name(node.func.value) in names:
                emit("purity-coerce", node,
                     f".{attr}() on {_root_name(node.func.value)!r} "
                     f"{where} copies a tensor to the host and waits "
                     f"for the card")
            elif chain in (("float",), ("int",), ("bool",)) and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Name) and arg.id in names:
                    emit("purity-coerce", node,
                         f"{chain[0]}({arg.id}) {where} reads a tensor "
                         f"on the host and waits for the card")
            elif len(chain) == 2 and chain[0] in ("np", "numpy") \
                    and chain[1] in ("asarray", "array", "save", "load") \
                    and node.args:
                arg = node.args[0]
                if isinstance(arg, ast.Name) and arg.id in names:
                    emit("purity-coerce", node,
                         f"np.{chain[1]}({arg.id}) {where} pulls a "
                         f"tensor to the host")
    return out


# ---------------------------------------------------------------------------
# kind 3: host launchers in CUDA sources, read as text
# ---------------------------------------------------------------------------

_IDENT = re.compile(r"[A-Za-z_]\w*")
_FORBIDDEN = re.compile(
    r"\b(cudaDeviceSynchronize|cudaStreamSynchronize|cudaEventSynchronize"
    r"|cudaMalloc\w*|cudaFree\w*|cudaMemcpy(?:2D|3D|ToSymbol|FromSymbol)?"
    r"|cudaMemset(?:2D|3D)?)\s*\(")
_DEFAULT_STREAMS = {"0", "NULL", "nullptr", "cudaStreamLegacy",
                    "cudaStreamPerThread", "cudaStreamDefault"}
_SWALLOW = re.compile(r"\breturn\s*(?:\(\s*\w+\s*\)\s*)?"
                      r"(?:0|cudaSuccess)\s*;")


def _strip_comments(text: str) -> str:
    """Comments blanked to spaces (newlines kept, so offsets keep their
    lines); string and character literals left as they are."""
    out = list(text)
    i, n = 0, len(text)
    while i < n:
        c = text[i]
        if c in "\"'":
            j = i + 1
            while j < n and text[j] != c:
                j += 2 if text[j] == "\\" else 1
            i = j + 1
        elif text.startswith("//", i):
            j = text.find("\n", i)
            j = n if j < 0 else j
            for k in range(i, j):
                out[k] = " "
            i = j
        elif text.startswith("/*", i):
            j = text.find("*/", i + 2)
            j = n if j < 0 else j + 2
            for k in range(i, j):
                if out[k] != "\n":
                    out[k] = " "
            i = j
        else:
            i += 1
    return "".join(out)


def _match_close(text: str, i: int, open_c: str, close_c: str) -> int:
    """Index of the bracket closing the one at ``i``."""
    depth = 0
    for j in range(i, len(text)):
        if text[j] == open_c:
            depth += 1
        elif text[j] == close_c:
            depth -= 1
            if depth == 0:
                return j
    return len(text) - 1


def _split_args(text: str) -> List[str]:
    """Top-level comma split (parentheses, brackets and braces nest; an
    angle bracket is a comparison as often as a template)."""
    out, depth, cur = [], 0, []
    for c in text:
        if c in "([{":
            depth += 1
        elif c in ")]}":
            depth -= 1
        if c == "," and depth == 0:
            out.append("".join(cur).strip())
            cur = []
        else:
            cur.append(c)
    if "".join(cur).strip():
        out.append("".join(cur).strip())
    return out


class _CFunc:
    __slots__ = ("name", "header", "params", "at", "start", "end",
                 "launcher", "device")

    def __init__(self, name, header, params, at, start, end):
        self.name, self.header, self.params = name, header, params
        self.at = at                                 # the header's start
        self.start, self.end = start, end            # body's { and }
        self.launcher = 'extern "C"' in header
        self.device = "__global__" in header or "__device__" in header


_CONTROL = {"if", "for", "while", "switch", "return", "catch", "sizeof"}


def _c_functions(text: str) -> List[_CFunc]:
    """Every function definition of the file: at file scope or in a
    struct, namespace or ``extern "C" {}`` block, never inside another
    function's body."""
    out: List[_CFunc] = []
    stack: List[bool] = []             # True for a function's body
    head_start = 0
    for i, c in enumerate(text):
        if c == ";" or c == "}":
            if c == "}" and stack:
                stack.pop()
            head_start = i + 1
        elif c == "{":
            is_func = False
            if not any(stack):
                hdr = text[head_start:i].rstrip()
                tail = re.search(r"\)\s*(?:const|noexcept|override)?$", hdr)
                if tail:
                    at = head_start + len(text[head_start:i]) \
                        - len(text[head_start:i].lstrip())
                    close = tail.start()
                    depth, j = 0, close
                    while j >= 0:
                        if hdr[j] == ")":
                            depth += 1
                        elif hdr[j] == "(":
                            depth -= 1
                            if depth == 0:
                                break
                        j -= 1
                    m = re.search(r"([A-Za-z_]\w*)\s*(?:<[^<>]*>)?\s*$",
                                  hdr[:max(j, 0)])
                    if j > 0 and m and m.group(1) not in _CONTROL:
                        is_func = True
                        out.append(_CFunc(
                            m.group(1), hdr.strip(),
                            _split_args(hdr[j + 1:close]), at, i,
                            _match_close(text, i, "{", "}")))
            stack.append(is_func)
            head_start = i + 1
    return out


def _param_name(param: str) -> str:
    names = _IDENT.findall(param)
    return names[-1] if names else ""


def _strip_casts(expr: str) -> str:
    expr = expr.strip()
    while True:
        m = re.match(r"^\(\s*[A-Za-z_][\w\s\*]*\)\s*(.+)$", expr, re.S)
        if not m:
            return expr
        expr = m.group(1).strip()


def _stream_aliases(body: str, names: Set[str]) -> Set[str]:
    """``names`` and the locals assigned from one (through a cast)."""
    names = set(names)
    while True:
        grew = False
        for m in re.finditer(r"\b(\w+)\s*=\s*([^;=]+);", body):
            if m.group(1) not in names \
                    and _strip_casts(m.group(2)) in names:
                names.add(m.group(1))
                grew = True
        if not grew:
            return names


def cuda_launchers(project: Project) -> List[Tuple[str, str, int]]:
    """(relpath, launcher name, line) of every ``extern "C"`` function
    in the package's CUDA sources."""
    out = []
    for src in project.sources.values():
        text = _strip_comments(src.text)
        for f in _c_functions(text):
            if f.launcher:
                out.append((src.relpath, f.name,
                            text.count("\n", 0, f.at) + 1))
    return out


def _check_source(src: TextSource) -> List[Finding]:
    text = _strip_comments(src.text)
    funcs = _c_functions(text)
    host = {f.name: f for f in funcs if not f.device and not f.launcher}
    out: List[Finding] = []

    def line_of(pos: int) -> int:
        return text.count("\n", 0, pos) + 1

    def emit(pos: int, msg: str, symbol: str) -> None:
        out.append(Finding("purity-cuda-launch", src.relpath, line_of(pos),
                           msg, symbol=symbol))

    for f in funcs:
        if f.device:
            for m in re.finditer(r"\bprintf\s*\(", text[f.start:f.end]):
                emit(f.start + m.start(),
                     f"printf in device function {f.name!r} serialises "
                     f"the kernel on a host-read buffer", f.name)
    for launcher in (f for f in funcs if f.launcher):
        streams = {_param_name(p) for p in launcher.params
                   if "cudaStream_t" in p or _param_name(p) == "stream"}
        # the launcher and the host helpers it reaches, each with the
        # names that hold the launcher's stream there
        reach: Dict[str, Tuple[_CFunc, Set[str]]] = {
            launcher.name: (launcher, streams)}
        work = [launcher.name]
        while work:
            fn, names = reach[work.pop()]
            body = text[fn.start:fn.end]
            names = _stream_aliases(body, names)
            reach[fn.name] = (fn, names)
            for hname, helper in host.items():
                for m in re.finditer(rf"\b{hname}\s*(?:<[^;(){{}}]*>)?\s*\(",
                                     body):
                    open_at = fn.start + m.end() - 1
                    args = _split_args(
                        text[open_at + 1:_match_close(text, open_at, "(",
                                                      ")")])
                    passed = {_param_name(helper.params[k])
                              for k, a in enumerate(args)
                              if k < len(helper.params)
                              and _strip_casts(a) in names}
                    known = reach.get(hname, (helper, set()))[1]
                    if hname not in reach or not passed <= known:
                        reach[hname] = (helper, known | passed)
                        work.append(hname)
        for fn, names in reach.values():
            body = text[fn.start:fn.end]
            last = None
            for m in re.finditer(r"<<<(.*?)>>>", body, re.S):
                pos = fn.start + m.start()
                last = fn.start + m.end()
                args = _split_args(m.group(1))
                if len(args) < 4:
                    emit(pos, f"launch with {len(args)} launch arguments "
                              f"runs on the legacy default stream — pass "
                              f"the launcher's stream as the fourth",
                         launcher.name)
                    continue
                stream = _strip_casts(args[3])
                if stream in _DEFAULT_STREAMS or stream not in names:
                    emit(pos, f"launch on stream {args[3]!r}, not the "
                              f"stream the launcher was handed",
                         launcher.name)
            for m in _FORBIDDEN.finditer(body):
                call = m.group(1)
                emit(fn.start + m.start(),
                     f"{call}() in a kernel launcher blocks the host or "
                     f"the stream (launchers queue work and return; the "
                     f"caching allocator owns device memory)",
                     launcher.name)
            if last is not None \
                    and "cudaGetLastError" not in text[last:fn.end]:
                emit(last, f"{fn.name!r} launches but never reads "
                           f"cudaGetLastError() after its last launch",
                     launcher.name)
        # a success returned after the launch path drops its error
        body = text[launcher.start:launcher.end]
        calls = [m.start() for m in re.finditer(r"<<<", body)]
        calls += [m.start() for h in reach if h != launcher.name
                  for m in re.finditer(rf"\b{h}\s*(?:<[^;(){{}}]*>)?\s*\(",
                                       body)]
        if calls:
            for m in _SWALLOW.finditer(body, min(calls)):
                emit(launcher.start + m.start(),
                     f"{launcher.name!r} returns success after its launch "
                     f"path — return cudaGetLastError()", launcher.name)
    return out


def check(project: Project) -> List[Finding]:
    out = _check_python(project)
    for src in project.sources.values():
        out.extend(_check_source(src))
    return out


register(
    "trace-purity", check,
    "host effects (print/time/random/env/lock/syncs) in kernel launch "
    "wrappers and CUDA-graph bodies, and stream/sync/error discipline "
    "in the .cu launchers")
