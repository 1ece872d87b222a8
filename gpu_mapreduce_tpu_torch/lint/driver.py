"""mrlint driver: module loading, findings, pragmas, baselines, rule
registry (the port's copy of ``gpu_mapreduce_tpu/lint/driver.py``).

The analyzer is PURE AST — it must never import the package it lints
(importing pulls in torch and the import-time metrics/env hooks; a lint
gate has to run in seconds with no side effects).  For the same reason
this package never imports from its parent, whose ``__init__`` loads its
exports lazily: ``python -m gpu_mapreduce_tpu_torch.lint`` starts
without torch.

The port's deltas: the project is ``gpu_mapreduce_tpu_torch/`` and its
docs live under ``doc/torch/`` (``Project.doc_dir``; a fixture may point
it elsewhere), and the package's CUDA sources (``csrc/*.cu``) load as
:class:`TextSource` files for the rules that read them as text, with
``// mrlint: disable=...`` pragmas.

Vocabulary shared by every checker:

* :class:`Module` — one parsed source file (relpath, dotted name, AST,
  source lines).
* :class:`Project` — the loaded tree: package modules (analyzed by all
  checkers) plus ``extra`` modules (harness scripts such as soak.py
  that only opted-in checkers scan).
* :class:`Finding` — (rule, path, line, message, symbol), with a
  line-independent fingerprint so baselines survive unrelated edits.
* pragmas — ``# mrlint: disable=rule1,rule2`` (or bare ``disable`` for
  all rules) suppresses findings on its own line, on the whole function
  or class when placed on the ``def``/``class`` line, or on the whole
  file when it appears before the first statement.  Suppressed findings
  are still counted (``--json`` reports them) so a silently growing
  pragma pile stays visible.
"""

from __future__ import annotations

import ast
import hashlib
import json
import os
import re
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Tuple

_PRAGMA = re.compile(r"#\s*mrlint:\s*disable(?:=([A-Za-z0-9_,\-]+))?")
_C_PRAGMA = re.compile(r"//\s*mrlint:\s*disable(?:=([A-Za-z0-9_,\-]+))?")


@dataclass
class Finding:
    rule: str
    path: str          # project-relative, forward slashes
    line: int
    msg: str
    symbol: str = ""   # enclosing function/class qualname when known
    suppressed: bool = False
    # occurrence index among same-(rule,path,symbol,msg) findings, in
    # file order — assigned by run().  Line numbers would break the
    # baseline on every unrelated edit; with no discriminator at all,
    # one baselined raw read of a knob would suppress every FUTURE raw
    # read of that knob in the same file forever.
    seq: int = 0

    @property
    def fingerprint(self) -> str:
        digest = hashlib.sha1(self.msg.encode()).hexdigest()[:8]
        return f"{self.rule}:{self.path}:{self.symbol}:{digest}:{self.seq}"

    def to_dict(self) -> dict:
        return {"rule": self.rule, "path": self.path, "line": self.line,
                "msg": self.msg, "symbol": self.symbol,
                "suppressed": self.suppressed,
                "fingerprint": self.fingerprint}

    def __str__(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule}: {self.msg}{sym}"


@dataclass
class Module:
    relpath: str               # "gpu_mapreduce_tpu/parallel/shuffle.py"
    dotted: str                # "gpu_mapreduce_tpu.parallel.shuffle"
    tree: ast.Module
    lines: List[str]
    # lineno -> set of disabled rules ({"*"} = all)
    pragmas: Dict[int, set] = field(default_factory=dict)
    # all comment-only lines: a pragma on one covers the statement
    # below the comment block (the disable-next-line idiom for
    # statements too long to annotate inline)
    comment_only: set = field(default_factory=set)
    module_pragma: set = field(default_factory=set)
    # (first_line, end_line, def_line) spans of every function/class
    scopes: List[Tuple[int, int, int]] = field(default_factory=list)

    @property
    def source(self) -> str:
        return "\n".join(self.lines)


def _dotted_name(relpath: str) -> str:
    parts = relpath[:-3].split("/")          # strip .py
    if parts[-1] == "__init__":
        parts = parts[:-1]
    return ".".join(parts) or "<root>"


def _parse_pragmas(mod: Module) -> None:
    # the module-pragma header extends past a leading docstring: nearly
    # every module here opens with one, and a file-wide pragma reads
    # most naturally right under it
    body = mod.tree.body
    idx = 0
    if body and isinstance(body[0], ast.Expr) \
            and isinstance(body[0].value, ast.Constant) \
            and isinstance(body[0].value.value, str):
        idx = 1
    first_stmt_line = (body[idx].lineno if len(body) > idx
                       else len(mod.lines) + 1)
    for i, text in enumerate(mod.lines, start=1):
        if text.lstrip().startswith("#"):
            mod.comment_only.add(i)
        m = _PRAGMA.search(text)
        if not m:
            continue
        rules = set((m.group(1) or "*").split(","))
        mod.pragmas[i] = rules
        # a pragma above any code (header comment) covers the file; a
        # file-level docstring does not push it out of the header
        if i <= first_stmt_line and text.lstrip().startswith("#"):
            mod.module_pragma |= rules
    for node in ast.walk(mod.tree):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            first = min([node.lineno]
                        + [d.lineno for d in node.decorator_list])
            mod.scopes.append((first, node.end_lineno or node.lineno,
                               node.lineno))


def load_module(root: str, relpath: str) -> Optional[Module]:
    path = os.path.join(root, relpath)
    try:
        with open(path, encoding="utf-8") as f:
            src = f.read()
        tree = ast.parse(src, filename=relpath)
    except (OSError, SyntaxError):
        return None
    mod = Module(relpath.replace(os.sep, "/"), _dotted_name(relpath),
                 tree, src.splitlines())
    _parse_pragmas(mod)
    return mod


@dataclass
class TextSource:
    """A source file the Python parser cannot read (a ``.cu`` file):
    its lines and its ``// mrlint: disable=...`` pragmas, by line."""
    relpath: str
    lines: List[str]
    pragmas: Dict[int, set] = field(default_factory=dict)
    comment_only: set = field(default_factory=set)

    @property
    def text(self) -> str:
        return "\n".join(self.lines)


def load_text(root: str, relpath: str) -> Optional[TextSource]:
    try:
        with open(os.path.join(root, relpath), encoding="utf-8") as f:
            lines = f.read().splitlines()
    except OSError:
        return None
    src = TextSource(relpath.replace(os.sep, "/"), lines)
    for i, text in enumerate(lines, start=1):
        if text.lstrip().startswith("//"):
            src.comment_only.add(i)
        m = _C_PRAGMA.search(text)
        if m:
            src.pragmas[i] = set((m.group(1) or "*").split(","))
    return src


# text sources the package carries: CUDA C++ kernels and launchers
TEXT_SUFFIXES = (".cu", ".cuh")


class Project:
    """The loaded analysis universe: ``modules`` is the package every
    checker sees; ``extra`` holds harness scripts only opted-in checkers
    (knob registry, net-timeout) scan; ``sources`` the package's CUDA
    files; ``doc(name)`` reads a file of ``doc_dir`` for the code<->doc
    reconciliation rules."""

    def __init__(self, root: str, package: str = "gpu_mapreduce_tpu_torch",
                 extra_files: Tuple[str, ...] = (),
                 doc_dir: str = "doc/torch"):
        self.root = root
        self.package = package
        self.doc_dir = doc_dir.strip("/")
        self.modules: Dict[str, Module] = {}
        self.extra: Dict[str, Module] = {}
        self.sources: Dict[str, TextSource] = {}
        pkg_dir = os.path.join(root, package)
        for dirpath, dirnames, filenames in os.walk(pkg_dir):
            dirnames[:] = [d for d in dirnames
                           if d != "__pycache__" and not d.startswith(".")
                           and d != "_build"]
            for fname in sorted(filenames):
                rel = os.path.relpath(os.path.join(dirpath, fname), root)
                if fname.endswith(TEXT_SUFFIXES):
                    src = load_text(root, rel)
                    if src is not None:
                        self.sources[src.relpath] = src
                    continue
                if not fname.endswith(".py"):
                    continue
                mod = load_module(root, rel)
                if mod is not None:
                    self.modules[mod.relpath] = mod
        for rel in extra_files:
            if os.path.exists(os.path.join(root, rel)):
                mod = load_module(root, rel)
                if mod is not None:
                    self.extra[mod.relpath] = mod
        self.by_dotted: Dict[str, Module] = {
            m.dotted: m for m in self.modules.values()}

    def doc_path(self, name: str) -> str:
        """A doc file's project-relative path, as findings name it."""
        return f"{self.doc_dir}/{name}"

    def doc(self, name: str) -> Optional[str]:
        path = os.path.join(self.root, self.doc_dir, name)
        try:
            with open(path, encoding="utf-8") as f:
                return f.read()
        except OSError:
            return None

    def all_modules(self, include_extra: bool = False) -> List[Module]:
        out = list(self.modules.values())
        if include_extra:
            out += list(self.extra.values())
        return out


def _text_suppressed(src: TextSource, finding: Finding) -> bool:
    """A C pragma on the finding's line, or on the comment-only lines
    directly above it."""
    line = finding.line
    while True:
        rules = src.pragmas.get(line)
        if rules and ("*" in rules or finding.rule in rules):
            return True
        line -= 1
        if line not in src.comment_only:
            return False


def _suppressed(mod: Module, finding: Finding) -> bool:
    def covers(rules: set) -> bool:
        return "*" in rules or finding.rule in rules
    if covers(mod.module_pragma):
        return True
    rules = mod.pragmas.get(finding.line)
    if rules and covers(rules):
        return True
    # a comment-only pragma covers the line below it; chains of
    # comment-only lines extend upward (a two-line justification above
    # the flagged statement still counts)
    above = finding.line - 1
    while above in mod.comment_only:
        rules = mod.pragmas.get(above)
        if rules and covers(rules):
            return True
        above -= 1
    # a pragma on (or on a decorator line of, or in the comment block
    # directly above) an enclosing def/class suppresses the whole scope
    for first, end, def_line in mod.scopes:
        if first <= finding.line <= end:
            for line in range(first, def_line + 1):
                rules = mod.pragmas.get(line)
                if rules and covers(rules):
                    return True
            above = first - 1
            while above in mod.comment_only:
                rules = mod.pragmas.get(above)
                if rules and covers(rules):
                    return True
                above -= 1
    return False


# ---------------------------------------------------------------------------
# rule registry + run loop
# ---------------------------------------------------------------------------

# rule name -> checker callable(project) -> List[Finding]; populated by
# register() calls at the bottom of each checker module
RULES: Dict[str, Callable] = {}

# checker docstrings for --list-rules
RULE_DOC: Dict[str, str] = {}

# finding-rule names whose findings are whole-tree invariants (code<->
# doc reconciliation): they must survive the --changed
# report scope — the violation's ATTRIBUTED file is often an unchanged
# code file even when the doc edit caused it (and vice versa)
GLOBAL_FINDINGS: set = set()


def register(name: str, fn: Callable, doc: str = "",
             global_findings: Tuple[str, ...] = ()) -> None:
    RULES[name] = fn
    RULE_DOC[name] = doc
    GLOBAL_FINDINGS.update(global_findings)


def run(project: Project, rules: Optional[List[str]] = None,
        baseline: Optional[set] = None,
        only_paths: Optional[set] = None) -> List[Finding]:
    """Run the selected rules (default: all registered) and apply
    pragma + baseline suppression.  ``only_paths`` restricts REPORTING
    to those relpaths — analysis always sees the whole project, so
    cross-module rules (lock graph, doc reconciliation) stay sound
    under the CLI's ``--changed`` scope."""
    findings: List[Finding] = []
    for name in (rules if rules is not None else sorted(RULES)):
        if name not in RULES:
            raise KeyError(f"unknown rule {name!r} "
                           f"(known: {', '.join(sorted(RULES))})")
        findings.extend(RULES[name](project))
    findings.sort(key=lambda f: (f.path, f.line, f.rule))
    occurrence: Dict[Tuple, int] = {}
    for f in findings:
        key = (f.rule, f.path, f.symbol, f.msg)
        f.seq = occurrence.get(key, 0)
        occurrence[key] = f.seq + 1
    out = []
    for f in findings:
        mod = (project.modules.get(f.path) or project.extra.get(f.path))
        if mod is not None and _suppressed(mod, f):
            f.suppressed = True
        src = project.sources.get(f.path)
        if src is not None and _text_suppressed(src, f):
            f.suppressed = True
        if baseline and f.fingerprint in baseline:
            f.suppressed = True
        if only_paths is not None and f.path not in only_paths \
                and not f.path.startswith("doc/") \
                and f.rule not in GLOBAL_FINDINGS:
            continue
        out.append(f)
    out.sort(key=lambda f: (f.path, f.line, f.rule))
    return out


def load_baseline(path: str) -> set:
    with open(path) as f:
        data = json.load(f)
    return set(data.get("fingerprints", data) if isinstance(data, dict)
               else data)


def write_baseline(path: str, findings: List[Finding]) -> None:
    fps = sorted({f.fingerprint for f in findings if not f.suppressed})
    with open(path, "w") as f:
        json.dump({"fingerprints": fps}, f, indent=2)
        f.write("\n")


def summary(findings: List[Finding]) -> dict:
    """The --json payload: per-rule counts of live and suppressed
    findings, so a growing pragma pile stays visible."""
    by_rule: Dict[str, int] = {}
    nsupp = 0
    for f in findings:
        if f.suppressed:
            nsupp += 1
        else:
            by_rule[f.rule] = by_rule.get(f.rule, 0) + 1
    return {"findings": [f.to_dict() for f in findings],
            "counts": dict(sorted(by_rule.items())),
            "total": sum(by_rule.values()),
            "suppressed": nsupp}
