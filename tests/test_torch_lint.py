"""mrlint over the port (``gpu_mapreduce_tpu_torch/lint/``) against the JAX
package's lint on the same fixtures, the retargeted trace-purity rule,
the self-check over the port's tree and the CLI.

The JAX lint is loaded by file path, as ``scripts/mrlint.py`` loads it,
so its package ``__init__`` (and JAX behind it) stays cold.  Every rule
the port keeps unchanged gives the JAX rule's findings (rule, path,
line, message, symbol, suppression) on the fixtures of
``tests/test_lint.py``; the port's fixtures point its ``doc_dir`` at
``doc/``, where the JAX rules read their catalogs.
"""

import functools
import importlib.util
import json
import re
import os
import subprocess
import sys
import textwrap

import pytest

from gpu_mapreduce_tpu_torch import lint
from gpu_mapreduce_tpu_torch.lint import purity
from gpu_mapreduce_tpu_torch.lint.__main__ import extra_files
from gpu_mapreduce_tpu_torch.lint.callgraph import get_graph

import test_lint as J

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_lint():
    name = "jax_mrlint_by_path"
    if name in sys.modules:
        return sys.modules[name]
    lint_dir = os.path.join(REPO, "gpu_mapreduce_tpu", "lint")
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(lint_dir, "__init__.py"),
        submodule_search_locations=[lint_dir])
    mod = importlib.util.module_from_spec(spec)
    sys.modules[name] = mod
    spec.loader.exec_module(mod)
    return mod


def _write(root, files, docs=None, pkg="pkg"):
    for rel, src in files.items():
        path = os.path.join(root, pkg, rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(textwrap.dedent(src))
    for rel, src in (docs or {}).items():
        path = os.path.join(root, "doc", rel)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        with open(path, "w") as f:
            f.write(textwrap.dedent(src))


def _rows(findings):
    return [(f.rule, f.path, f.line, f.msg, f.symbol, f.suppressed)
            for f in findings]


def port_fixture(root, files, rules, docs=None, **run_kw):
    _write(root, files, docs)
    project = lint.Project(root, package="pkg", doc_dir="doc")
    findings = lint.run(project, rules=rules, **run_kw)
    return findings, [f for f in findings if not f.suppressed]


# ---------------------------------------------------------------------------
# the unchanged rules: the JAX rule's findings on the same fixture
# ---------------------------------------------------------------------------

SHARED = {
    "lock-unguarded": ({"mod.py": J.LOCK_BAD_MUTATION}, None,
                       ["lock-discipline"], 1),
    "lock-clean": ({"mod.py": J.LOCK_CLEAN}, None, ["lock-discipline"], 0),
    "lock-cycle": ({"mod.py": J.LOCK_CYCLE}, None, ["lock-discipline"], 1),
    "cachekey-bad": ({"mod.py": J.CACHEKEY_BAD, "cache.py": J.CACHE_STUB},
                     None, ["cache-key"], 1),
    "cachekey-clean": ({"mod.py": J.CACHEKEY_CLEAN,
                        "cache.py": J.CACHE_STUB}, None, ["cache-key"], 0),
    "cachekey-lru": ({"mod.py": J.CACHEKEY_LRU}, None, ["cache-key"], 1),
    "cachekey-cas-bad": ({"mod.py": J.CACHEKEY_CAS_BAD}, None,
                         ["cache-key"], 1),
    "cachekey-cas-clean": ({"mod.py": J.CACHEKEY_CAS_CLEAN}, None,
                           ["cache-key"], 0),
    "knobs-bad": ({"mod.py": J.KNOBS_BAD, "utils/env.py": J.ENV_STUB},
                  {"settings.md": J.SETTINGS_DOC}, ["knob-registry"], 3),
    "knobs-clean": ({"mod.py": """
        from .utils.env import env_knob
        def a():
            return env_knob("MRTPU_RAW_READ", int, 1)
    """, "utils/env.py": J.ENV_STUB},
        {"settings.md": "| `MRTPU_RAW_READ` | 1 | all good |\n"},
        ["knob-registry"], 0),
    "knobs-module-pragma": ({"mod.py": '''
        """Module docstring."""
        # mrlint: disable=knob-bypass
        import os

        def a():
            return os.environ.get("MRTPU_HEADER_TEST", "1")
    '''}, {"settings.md": "| `MRTPU_HEADER_TEST` | 1 | x |"},
        ["knob-registry"], 0),
    "metrics": ({"mod.py": 'NAME = "mrtpu_seeded_total"\n'},
                {"observability.md": "catalog: `mrtpu_ghost_total` only\n"},
                ["metric-catalog"], 2),
    "net-bad": ({"serve/mod.py": J.NET_BAD}, None, ["net-timeout"], 3),
    "net-clean": ({"serve/mod.py": J.NET_CLEAN}, None, ["net-timeout"], 0),
    "net-out-of-scope": ({"parallel/mod.py": J.NET_BAD}, None,
                         ["net-timeout"], 0),
    "pragma-scopes": ({"mod.py": """
        import threading

        class S:
            def __init__(self):
                self._lock = threading.Lock()
                self.n = 0

            def locked(self):
                with self._lock:
                    self.n += 1

            def inline(self):
                self.n += 1  # mrlint: disable=lock-unguarded-mutation

            def next_line(self):
                # mrlint: disable=lock-unguarded-mutation — justified
                self.n += 1

            # mrlint: disable=lock-unguarded-mutation — whole scope
            def scoped(self):
                self.n += 1
                self.n += 2

            def still_flagged(self):
                self.n += 1

            def wrong_rule(self):
                self.n += 1  # mrlint: disable=trace-purity
    """}, None, ["lock-discipline"], 2),
}


@pytest.mark.parametrize("case", sorted(SHARED))
def test_unchanged_rule_equals_jax(case, tmp_path):
    files, docs, rules, nlive = SHARED[case]
    jl = _jax_lint()
    jroot, proot = str(tmp_path / "jax"), str(tmp_path / "port")
    _write(jroot, files, docs)
    jfind = jl.run(jl.Project(jroot, package="pkg"), rules=rules)
    pfind, live = port_fixture(proot, files, rules, docs)
    assert _rows(pfind) == _rows(jfind)
    assert len(live) == nlive, [str(f) for f in live]


def test_changed_scope_and_baseline_equal_jax(tmp_path):
    """The report scope keeps whole-tree reconciliation findings, and a
    baseline suppresses by fingerprint, as in the JAX lint."""
    jl = _jax_lint()
    files = {"mod.py": 'NAME = "mrtpu_orphan_total"\n'}
    docs = {"observability.md": "no catalog entry here\n"}
    got = {}
    for side in ("jax", "port"):
        root = str(tmp_path / side)
        _write(root, files, docs)
        project = jl.Project(root, package="pkg") if side == "jax" else \
            lint.Project(root, package="pkg", doc_dir="doc")
        run = jl.run if side == "jax" else lint.run
        scoped = run(project, rules=["metric-catalog"],
                     only_paths={"doc/observability.md"})
        baseline = {f.fingerprint for f in scoped}
        again = run(project, rules=["metric-catalog"], baseline=baseline)
        got[side] = (_rows(scoped), [f.fingerprint for f in scoped],
                     _rows(again))
    assert got["port"] == got["jax"]
    assert got["port"][0] and all(row[5] for row in got["port"][2])


def test_knob_catalog_unread_section_is_skipped(tmp_path):
    """The port's delta: knobs under "## Not read by the port" are not
    stale, and a read of one is undocumented."""
    files = {"mod.py": """
        from .utils.env import env_knob
        def a():
            return env_knob("MRTPU_LIVE", int, 1)
        def b():
            return env_knob("MRTPU_DROPPED_BUT_READ", int, 1)
    """, "utils/env.py": J.ENV_STUB}
    doc = ("| `MRTPU_LIVE` | 1 | read |\n"
           "| `MRTPU_GHOST` | - | read nowhere |\n\n"
           "## Not read by the port\n\n"
           "| `MRTPU_JIT_CACHE` | XLA's executable caches |\n"
           "| `MRTPU_DROPPED_BUT_READ` | dropped |\n")
    _, live = port_fixture(str(tmp_path), files, ["knob-registry"],
                           {"settings.md": doc})
    got = sorted((f.rule, f.symbol) for f in live)
    assert got == [("knob-stale", "MRTPU_GHOST"),
                   ("knob-undocumented", "MRTPU_DROPPED_BUT_READ")]


def test_net_timeout_covers_the_packages_ctl(tmp_path):
    _, live = port_fixture(str(tmp_path), {"ctl.py": J.NET_BAD},
                           ["net-timeout"])
    assert len(live) == 3


# ---------------------------------------------------------------------------
# trace-purity, retargeted: kernel wrappers, CUDA-graph bodies, launchers
# ---------------------------------------------------------------------------

LOADER = """
    import threading
    import time
    _LOCK = threading.Lock()
    _LIBS = {}

    def note_kernel_launch(wrapper):
        wrapper.launches += 1

    def library(name):
        with _LOCK:                      # the once-per-process build
            t0 = time.perf_counter()
            _LIBS[name] = t0
        return _LIBS[name]
"""

WRAPPER = """
    import os
    import numpy as np
    import torch
    from . import library, note_kernel_launch

    def _tables(pattern):
        return np.frombuffer(pattern, np.uint8)

    def kern(x: torch.Tensor, pattern: bytes) -> torch.Tensor:
        lib = library("kern")
        cm = _tables(pattern).tolist()   # host tables: not a finding
        {body}
        note_kernel_launch(kern)
        return x
"""

PURITY_CASES = {
    # name: (the wrapper body's line, finding rule and a word of its msg)
    "item": ("n = x.sum().item()", "purity-coerce", ".item()"),
    "synchronize": ("torch.cuda.synchronize()", "purity-coerce",
                    "synchronize"),
    "print": ("print('launching')", "purity-host-call", "print()"),
    "env": ("mode = os.environ.get('MRTPU_KERN_MODE', '0')",
            "purity-host-call", "MRTPU_KERN_MODE"),
    "tolist": ("rows = x.tolist()", "purity-coerce", ".tolist()"),
    "stream-sync": ("torch.cuda.current_stream().synchronize()",
                    "purity-coerce", "synchronize"),
}


@pytest.mark.parametrize("case", sorted(PURITY_CASES))
def test_purity_wrapper_true_positive_and_clean_twin(case, tmp_path):
    body, rule, word = PURITY_CASES[case]
    files = {"ops/cuda/__init__.py": LOADER,
             "ops/cuda/mod.py": WRAPPER.replace("{body}", body)}
    _, live = port_fixture(str(tmp_path / "bad"), files, ["trace-purity"])
    assert [f.rule for f in live] == [rule], [str(f) for f in live]
    assert word in live[0].msg and live[0].symbol == "kern"
    files["ops/cuda/mod.py"] = WRAPPER.replace("{body}", "y = x * 2")
    _, live = port_fixture(str(tmp_path / "clean"), files, ["trace-purity"])
    assert live == [], [str(f) for f in live]


GRAPH_CASES = {
    "with": """
        import torch

        def capture(static_in):
            g = torch.cuda.CUDAGraph()
            with torch.cuda.graph(g):
                out = static_in * 2
                {line}
            return g, out
    """,
    "capture-region": """
        import torch

        def capture(static_in):
            g = torch.cuda.CUDAGraph()
            g.capture_begin()
            out = static_in * 2
            {line}
            g.capture_end()
            return g, out
    """,
    "graphed-callable": """
        import torch

        def step(static_in):
            out = static_in * 2
            {line}
            return out

        def make(sample):
            return torch.cuda.make_graphed_callables(step, (sample,))
    """,
}


@pytest.mark.parametrize("case", sorted(GRAPH_CASES))
def test_purity_cuda_graph_body(case, tmp_path):
    src = GRAPH_CASES[case]
    _, live = port_fixture(str(tmp_path / "bad"), {
        "graphs.py": src.replace("{line}", "host = out.cpu()")},
        ["trace-purity"])
    assert [f.rule for f in live] == ["purity-coerce"], \
        [str(f) for f in live]
    assert ".cpu()" in live[0].msg
    _, live = port_fixture(str(tmp_path / "clean"), {
        "graphs.py": src.replace("{line}", "out = out + 1")},
        ["trace-purity"])
    assert live == []


def test_purity_does_not_enter_the_loader(tmp_path):
    """The wrapper calls the loader (a lock, ``time``) and the launch
    counter: by rule, no finding there."""
    files = {"ops/cuda/__init__.py": LOADER,
             "ops/cuda/mod.py": WRAPPER.replace("{body}", "y = x")}
    _write(str(tmp_path), files)
    project = lint.Project(str(tmp_path), package="pkg")
    entries, traced = purity.device_set(project)
    assert [e.qual for e in entries] == ["kern"]
    assert all(not t.module.relpath.endswith("ops/cuda/__init__.py")
               for t in traced)
    assert lint.run(project, rules=["trace-purity"]) == []


LAUNCHER = """
#include <cuda_runtime.h>
#include <stdint.h>

__global__ void k(const int* x, int* y, int64_t n) {
    int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x;
    if (i < n) y[i] = x[i] + 1;
    PRINTF_LINE
}

template <int W>
static cudaError_t launch(const int* x, int* y, int64_t n,
                          cudaStream_t stream) {
    const int blocks = (int)((n + 255) / 256 < 1 ? 1 : (n + 255) / 256);
    k<<<blocks, 256, 0, stream>>>(x, y, n);
    return cudaGetLastError();
}

// Launches on `stream` and returns cudaGetLastError(); does not
// synchronise.
extern "C" int k_launch(const void* x, void* y, int64_t n, int dev,
                        void* stream) {
    if (n == 0) return (int)cudaSuccess;
    cudaError_t err = cudaSetDevice(dev);
    if (err != cudaSuccess) return (int)err;
    cudaStream_t st = (cudaStream_t)stream;
    k<<<(int)(n < 1024 ? 1 : n / 1024), 1024, 0, st>>>(
        (const int*)x, (int*)y, n);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    EXTRA_LINE
    return (int)launch<1>((const int*)x, (int*)y, n, st);
}
"""

CU_CASES = {
    "device-sync": ("EXTRA_LINE", "cudaDeviceSynchronize();",
                    "cudaDeviceSynchronize"),
    "default-stream": ("EXTRA_LINE", "k<<<1, 32>>>((const int*)x, (int*)y, "
                       "n); err = cudaGetLastError();", "default stream"),
    "stream-zero": ("EXTRA_LINE", "k<<<1, 32, 0, 0>>>((const int*)x, "
                    "(int*)y, n); err = cudaGetLastError();",
                    "not the stream"),
    "malloc": ("EXTRA_LINE", "void* tmp; cudaMalloc(&tmp, 64);",
               "cudaMalloc"),
    "sync-memcpy": ("EXTRA_LINE", "cudaMemcpy(y, x, 4, "
                    "cudaMemcpyDeviceToDevice);", "cudaMemcpy"),
    "device-printf": ("PRINTF_LINE", 'printf("%d", (int)i);', "printf"),
    "swallowed": ("    return (int)launch<1>((const int*)x, (int*)y, n, "
                  "st);", "launch<1>((const int*)x, (int*)y, n, st); "
                  "return 0;", "returns success"),
    "no-error-read": ("    err = cudaGetLastError();\n    if (err != "
                      "cudaSuccess) return (int)err;\n", "",
                      "never reads cudaGetLastError"),
}


def _cu(root, text):
    path = os.path.join(root, "pkg", "csrc", "k.cu")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)
    return lint.Project(root, package="pkg")


@pytest.mark.parametrize("case", sorted(CU_CASES))
def test_purity_cuda_launch_true_positive(case, tmp_path):
    marker, line, word = CU_CASES[case]
    text = LAUNCHER.replace(marker, line).replace("EXTRA_LINE", "") \
        .replace("PRINTF_LINE", "")
    project = _cu(str(tmp_path), text)
    live = [f for f in lint.run(project, rules=["trace-purity"])
            if not f.suppressed]
    assert {f.rule for f in live} == {"purity-cuda-launch"}, \
        [str(f) for f in live]
    assert any(word in f.msg for f in live), [str(f) for f in live]
    # a launcher's findings name it; a device printf its kernel
    symbol = "k" if case == "device-printf" else "k_launch"
    assert all(f.path == "pkg/csrc/k.cu" and f.symbol == symbol
               for f in live)


def test_purity_cuda_launch_clean_and_pragma(tmp_path):
    text = LAUNCHER.replace("EXTRA_LINE", "").replace("PRINTF_LINE", "")
    project = _cu(str(tmp_path / "clean"), text)
    assert lint.run(project, rules=["trace-purity"]) == []
    assert purity.cuda_launchers(project) == [
        ("pkg/csrc/k.cu", "k_launch", text[:text.index('extern "C"')]
         .count("\n") + 1)]
    text = LAUNCHER.replace("EXTRA_LINE", "cudaDeviceSynchronize();  "
                            "// mrlint: disable=purity-cuda-launch (why)") \
        .replace("PRINTF_LINE", "")
    project = _cu(str(tmp_path / "pragma"), text)
    found = lint.run(project, rules=["trace-purity"])
    assert len(found) == 1 and found[0].suppressed


# ---------------------------------------------------------------------------
# the port's own tree: clean, with real coverage, and its catalogs
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _repo_project():
    """The port's tree, loaded once (its callgraph is cached on it)."""
    return lint.Project(REPO, extra_files=extra_files(REPO))


def test_selfcheck_port_tree_runs_clean():
    findings = lint.run(_repo_project())
    live = [f for f in findings if not f.suppressed]
    assert live == [], "\n" + "\n".join(str(f) for f in live)
    # every suppression is a pragma with its reason on its lines
    assert sum(1 for f in findings if f.suppressed) < 20


def test_selfcheck_coverage_floor():
    project = _repo_project()
    assert {"chip_smoke.py"} <= set(project.extra)
    assert len(get_graph(project).funcs) > 1500
    entries, traced = purity.device_set(project)
    assert sorted(e.key for e in entries) == [
        "gpu_mapreduce_tpu_torch/ops/cuda/group.py::segment_table",
        "gpu_mapreduce_tpu_torch/ops/cuda/match.py::mark",
        "gpu_mapreduce_tpu_torch/ops/cuda/match.py::mark_words"]
    mods = {t.module.relpath for t in traced}
    for must in ("gpu_mapreduce_tpu_torch/ops/cuda/match.py",
                 "gpu_mapreduce_tpu_torch/ops/cuda/group.py"):
        assert must in mods, f"{must} fell out of the device set"
    assert {(p, n) for p, n, _ in purity.cuda_launchers(project)} == {
        ("gpu_mapreduce_tpu_torch/csrc/mark_bytes.cu", "mark_bytes_launch"),
        ("gpu_mapreduce_tpu_torch/csrc/mark_words.cu", "mark_words_launch"),
        ("gpu_mapreduce_tpu_torch/csrc/seg_table.cu", "seg_table_launch")}


def test_catalogs_agree_with_the_tree():
    """doc/torch/settings.md names every knob the port reads and only
    those (its unread section the five the port dropped);
    doc/torch/observability.md names every metric, today the JAX
    package's set literal for literal."""
    from gpu_mapreduce_tpu_torch.lint.knobs import split_catalog
    from gpu_mapreduce_tpu_torch.lint.metrics_doc import (code_metrics,
                                                          doc_metrics)
    project = _repo_project()
    live = [f for f in lint.run(project, rules=["knob-registry",
                                                "metric-catalog"])
            if not f.suppressed]
    assert live == [], [str(f) for f in live]
    _, unread = split_catalog(project.doc("settings.md"))
    assert set(re.findall(r"MRTPU_[A-Z0-9_]+", unread)) == {
        "MRTPU_DEFER_SYNC", "MRTPU_DONATE", "MRTPU_JIT_CACHE",
        "MRTPU_JIT_PERSIST", "MRTPU_MEGAFUSE"}
    jl = _jax_lint()
    jmetrics = set(jl.metrics_doc.code_metrics(jl.Project(
        REPO, package="gpu_mapreduce_tpu")))
    assert set(code_metrics(project)) == jmetrics
    assert doc_metrics(project.doc("observability.md")) == jmetrics


def _cli(*args, cwd=REPO):
    return subprocess.run(
        [sys.executable, "-m", "gpu_mapreduce_tpu_torch.lint", *args],
        capture_output=True, text=True, timeout=120, cwd=cwd,
        env=dict(os.environ, PYTHONPATH=REPO))


def test_cli_json_and_exit_codes(tmp_path):
    res = _cli("--json", "-")
    assert res.returncode == 0, res.stderr
    payload = json.loads(res.stdout)
    assert payload["total"] == 0 and payload["suppressed"] < 20
    assert payload["files_scanned"] > 100
    assert "trace-purity" in payload["rules"]
    res = _cli("-r", "no-such-rule")
    assert res.returncode == 2 and "unknown rule" in res.stderr
    res = _cli("--list-rules")
    assert res.returncode == 0 and "purity" in res.stdout
    # a tree with a finding: exit 1, and --write-baseline then silences it
    _write(str(tmp_path), {"serve/mod.py": J.NET_BAD},
           pkg="gpu_mapreduce_tpu_torch")
    res = _cli("--root", str(tmp_path), "-r", "net-timeout")
    assert res.returncode == 1 and "net-timeout" in res.stdout
    base = str(tmp_path / "base.json")
    assert _cli("--root", str(tmp_path), "--write-baseline",
                base).returncode == 0
    res = _cli("--root", str(tmp_path), "-r", "net-timeout", "--baseline",
               base)
    assert res.returncode == 0, res.stdout + res.stderr
