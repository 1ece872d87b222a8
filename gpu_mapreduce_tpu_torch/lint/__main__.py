"""mrlint CLI over the port (the counterpart of ``scripts/mrlint.py``).

Pure AST, no torch: neither this package nor the package's
``__init__`` imports torch, so the whole gate runs in seconds with no
side effects.

    python -m gpu_mapreduce_tpu_torch.lint                  # all rules
    python -m gpu_mapreduce_tpu_torch.lint -r knob-registry # one rule
    python -m gpu_mapreduce_tpu_torch.lint --changed        # changed files
    python -m gpu_mapreduce_tpu_torch.lint --json -         # findings JSON
    python -m gpu_mapreduce_tpu_torch.lint --list-rules

The project is ``gpu_mapreduce_tpu_torch/`` (its Python modules and its
``csrc/`` CUDA sources), its docs ``doc/torch/``, and the harness
scripts ``chip_smoke.py``, ``profile_torch_*.py`` and
``scripts/profile_torch_*.py``.

Exit codes: 0 clean, 1 unsuppressed findings, 2 usage/internal error.
Rule catalog + pragma policy: doc/torch/lint.md.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import subprocess
import sys
from typing import Tuple

PACKAGE = "gpu_mapreduce_tpu_torch"
REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

# harness scripts the knob-registry and net-timeout rules scan on top
# of the package
EXTRA_GLOBS = ("chip_smoke.py", "profile_torch_*.py",
               "scripts/profile_torch_*.py")


def extra_files(root: str) -> Tuple[str, ...]:
    out = []
    for pat in EXTRA_GLOBS:
        out += sorted(os.path.relpath(p, root)
                      for p in glob.glob(os.path.join(root, pat)))
    return tuple(out)


def _changed_paths(root: str) -> set:
    """Working-tree + last-commit changes, repo-relative.  Untracked
    files count too — a brand-new module with a finding must not slip
    through the changed-file scope."""
    out = set()
    for args in (["git", "diff", "--name-only", "HEAD"],
                 ["git", "diff", "--name-only", "HEAD~1..HEAD"],
                 ["git", "ls-files", "--others", "--exclude-standard"]):
        try:
            res = subprocess.run(args, cwd=root, capture_output=True,
                                 text=True, timeout=30)
            out.update(p for p in res.stdout.splitlines() if p)
        except (OSError, subprocess.SubprocessError):
            pass
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m gpu_mapreduce_tpu_torch.lint", description=__doc__,
        formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("--rules", "-r",
                    help="comma-separated checker names (default: all)")
    ap.add_argument("--list-rules", action="store_true")
    ap.add_argument("--json", metavar="FILE",
                    help="write findings JSON to FILE ('-' = stdout)")
    ap.add_argument("--changed", action="store_true",
                    help="report findings only in files changed vs git "
                         "HEAD/HEAD~1 (analysis still sees everything)")
    ap.add_argument("--baseline", metavar="FILE",
                    help="suppress fingerprints listed in FILE")
    ap.add_argument("--write-baseline", metavar="FILE",
                    help="write current unsuppressed fingerprints to "
                         "FILE and exit 0")
    ap.add_argument("--root", default=REPO, help=argparse.SUPPRESS)
    args = ap.parse_args(argv)

    try:
        from gpu_mapreduce_tpu_torch import lint
    except Exception as e:                      # broken analyzer ≠ clean
        print(f"mrlint: failed to load analyzer: {e!r}", file=sys.stderr)
        return 2

    if args.list_rules:
        for name in sorted(lint.RULES):
            print(f"{name:18s} {lint.RULE_DOC.get(name, '')}")
        return 0

    rules = args.rules.split(",") if args.rules else None
    baseline = None
    if args.baseline:
        try:
            baseline = lint.load_baseline(args.baseline)
        except (OSError, ValueError) as e:
            print(f"mrlint: bad baseline {args.baseline}: {e!r}",
                  file=sys.stderr)
            return 2
    only = _changed_paths(args.root) if args.changed else None

    try:
        project = lint.Project(args.root, package=PACKAGE,
                               extra_files=extra_files(args.root))
        findings = lint.run(project, rules=rules, baseline=baseline,
                            only_paths=only)
    except KeyError as e:
        print(f"mrlint: {e.args[0]}", file=sys.stderr)
        return 2

    if args.write_baseline:
        lint.write_baseline(args.write_baseline, findings)
        print(f"mrlint: baseline written to {args.write_baseline}")
        return 0

    payload = lint.summary(findings)
    payload["files_scanned"] = (len(project.modules) + len(project.extra)
                                + len(project.sources))
    payload["rules"] = rules or sorted(lint.RULES)
    if args.json == "-":
        json.dump(payload, sys.stdout, indent=2)
        print()
    elif args.json:
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=2)
            f.write("\n")

    live = [f for f in findings if not f.suppressed]
    if args.json != "-":
        for f in live:
            print(f)
    nsupp = payload["suppressed"]
    scope = "changed files" if args.changed else "project"
    if live:
        print(f"mrlint: {len(live)} finding(s) in {scope} "
              f"({nsupp} suppressed by pragma/baseline)",
              file=sys.stderr)
        return 1
    print(f"mrlint OK: 0 findings in {scope} "
          f"({payload['files_scanned']} files, {nsupp} suppressed)",
          file=sys.stderr if args.json == "-" else sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
