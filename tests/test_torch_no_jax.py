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
    if not torch.cuda.is_available():
        for entry in (pkg.InvertedIndex, pkg.MapReduce,
                      lambda: pkg.intcount([])):
            try:
                entry()
            except pkg.MRError:
                pass
            else:
                raise SystemExit(f"{entry}() ran without a card")
    print("OK", len(names))
""")


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", SCRIPT], cwd=ROOT, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stdout + r.stderr
    assert r.stdout.startswith("OK")
    assert int(r.stdout.split()[1]) >= 33      # every module was imported
