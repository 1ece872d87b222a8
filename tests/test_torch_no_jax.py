"""The port imports neither JAX nor the JAX package, and its entry points
default to the card.

A subprocess poisons ``sys.modules`` so that importing ``jax`` or
``gpu_mapreduce_tpu`` raises, then imports every module of the port and
``chip_smoke``."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in ("jax", "jaxlib", "gpu_mapreduce_tpu"):
        sys.modules[name] = None          # any import of them now raises
    import gpu_mapreduce_tpu_torch as pkg
    names = [m.name for m in pkgutil.walk_packages(pkg.__path__,
                                                   pkg.__name__ + ".")]
    for name in names:
        importlib.import_module(name)
    import chip_smoke
    leaked = [m for m in sys.modules if m.split(".")[0] in
              ("jax", "jaxlib", "gpu_mapreduce_tpu")
              and sys.modules[m] is not None]
    assert not leaked, leaked
    import torch
    from gpu_mapreduce_tpu_torch.parallel.dist import topology
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    if not torch.cuda.is_available():
        for entry in (pkg.InvertedIndex, pkg.MapReduce, pkg.OinkScript,
                      lambda: pkg.intcount([]), lambda: pkg.wordfreq([]),
                      lambda: pkg.wordfreq_interned([]),
                      lambda: make_mesh(), lambda: make_mesh(2),
                      lambda: topology(0, 2)):
            try:
                entry()
            except pkg.MRError:
                pass
            else:
                raise SystemExit(f"{entry}() ran without a card")
    print("OK", len(names), *names)
""")

NEW_SUBPACKAGES = ("oink.script", "oink.commands.rmat", "oink.commands.cc",
                   "oink.commands.pagerank", "oink.commands.degree",
                   "oink.commands.edges", "models.rmat", "models.pagerank",
                   "models.cc", "ops.prng", "parallel.staging",
                   "oink.mrscript", "models.luby", "models.tri",
                   "models.sssp", "oink.commands.histo",
                   "oink.commands.luby", "oink.commands.tri",
                   "oink.commands.sssp", "parallel.devkernels",
                   "core.column", "utils.io", "apps.wordfreq",
                   "oink.commands.wordfreq", "core.external",
                   "core.checkpoint", "exec", "exec.spill",
                   "exec.prefetch", "utils.fsio", "utils.integrity",
                   "parallel.mesh", "parallel.shuffle",
                   "parallel.collectives", "parallel.ingest",
                   "parallel.group", "parallel.sharded", "plan.fuser",
                   "plan.ir", "plan.cache", "core.mapreduce",
                   "oink.commands.invertedindex", "oink.objects",
                   "parallel.backend", "parallel.dist", "parallel.reshard",
                   "ft", "ft.inject", "launch", "ft.retry",
                   "ft.journal", "oink.universe")


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("OK")
    words = r.stdout.split()
    assert int(words[1]) >= 60                 # every module was imported
    for name in NEW_SUBPACKAGES:
        assert "gpu_mapreduce_tpu_torch." + name in words[2:], name
