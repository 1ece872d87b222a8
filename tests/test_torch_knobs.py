"""The port's knobs as the JAX package reads them: ``MRTPU_PLAN_CACHE``
sizes the plan cache in both packages, and ``MRTPU_TORCH_PTXAS_VERBOSE``
goes through ``utils/env.env_flag`` (warn and fall back on a malformed
value)."""

import json
import os
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

PROBE = """
import json, sys
from {pkg}.plan.cache import cache_stats
print(json.dumps(cache_stats()["plan"]))
"""


@pytest.mark.parametrize("size", ["5", "not-a-number"])
def test_plan_cache_knob_sizes_both_packages(size):
    """One fresh process a package: the cache is process-wide and sized
    when first made."""
    env = dict(os.environ, PYTHONPATH=ROOT, JAX_PLATFORMS="cpu",
               MRTPU_PLAN_CACHE=size)
    got = {}
    for pkg in ("gpu_mapreduce_tpu", "gpu_mapreduce_tpu_torch"):
        r = subprocess.run([sys.executable, "-c", PROBE.format(pkg=pkg)],
                           cwd=ROOT, env=env, capture_output=True,
                           text=True, timeout=120)
        assert r.returncode == 0, r.stderr
        got[pkg] = (json.loads(r.stdout.strip().splitlines()[-1])["maxsize"],
                    "MRTPU_PLAN_CACHE ignored" in r.stderr)
    want = (5, False) if size == "5" else (32, True)
    assert got["gpu_mapreduce_tpu_torch"] == got["gpu_mapreduce_tpu"] \
        == want


@pytest.mark.parametrize("raw,verbose", [("1", True), ("yes", True),
                                         ("0", False), ("", False),
                                         ("sometimes", False)])
def test_ptxas_verbose_reads_through_env_flag(raw, verbose, monkeypatch,
                                              capsys):
    from gpu_mapreduce_tpu_torch.ops import cuda as kcuda
    seen = {}

    class FakePopen:
        def __init__(self, cmd, **kw):
            seen["cmd"] = cmd

    monkeypatch.setenv("MRTPU_TORCH_PTXAS_VERBOSE", raw)
    monkeypatch.setattr(kcuda, "_nvcc", lambda: "nvcc")
    monkeypatch.setattr(kcuda.subprocess, "Popen", FakePopen)
    monkeypatch.setattr(kcuda, "BUILD_DIR", "/nonexistent-build-dir")
    monkeypatch.setattr(kcuda.os, "makedirs", lambda *a, **k: None)
    kcuda._start_build("mark_words")
    assert ("-Xptxas" in seen["cmd"]) == verbose
    warned = "MRTPU_TORCH_PTXAS_VERBOSE ignored" in capsys.readouterr().err
    assert warned == (raw == "sometimes")
