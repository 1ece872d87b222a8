"""The port imports neither JAX nor the JAX package, and its entry points
default to the card.

A subprocess poisons ``sys.modules`` so that importing ``jax`` or
``gpu_mapreduce_tpu`` raises, then imports every module of the port and
``chip_smoke``.  Under an audit hook it also runs the native engine, a
stream and a serve session on the CPU: no file under ``gpu_mapreduce_tpu/``
is opened or loaded (the native loader builds and loads the port's own
library)."""

import os
import subprocess
import sys
import textwrap

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = textwrap.dedent("""
    import importlib, pkgutil, sys
    for name in ("jax", "jaxlib", "gpu_mapreduce_tpu"):
        sys.modules[name] = None          # any import of them now raises
    import os
    jax_pkg = os.path.join(os.getcwd(), "gpu_mapreduce_tpu") + os.sep
    touched = []
    def audit(event, args):
        if event in ("open", "ctypes.dlopen", "os.listdir") and args \
                and isinstance(args[0], (str, bytes, os.PathLike)):
            path = os.path.abspath(os.fsdecode(args[0]))
            if path.startswith(jax_pkg) or path + os.sep == jax_pkg:
                touched.append((event, path))
    sys.addaudithook(audit)
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
    import tempfile
    from gpu_mapreduce_tpu_torch import native
    from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
    with tempfile.TemporaryDirectory() as tmp:
        assert native.available(), native.build_error()
        paths, nrefs, _ = make_corpus(tmp, 1, 2)
        ii = pkg.InvertedIndex(device="cpu", engine="native")
        assert ii.run(paths, outdir=os.path.join(tmp, "o"))[0] == nrefs
        os.environ["MRTPU_CAS_DIR"] = os.path.join(tmp, "cas")
        src = os.path.join(tmp, "s.txt")
        with open(src, "w") as f:
            f.write("a b a\\n")
        s = pkg.Stream(os.path.join(tmp, "st"), [src], device="cpu",
                       settings={"fuse": 1})
        s.drain()
        assert s.snapshot() == "a 2\\nb 1\\n"
        s.close()
        # a session through the daemon on the CPU
        from gpu_mapreduce_tpu_torch.serve import ServeClient, Server
        srv = Server(port=0, workers=1, device="cpu",
                     state_dir=os.path.join(tmp, "serve"))
        srv.start()
        try:
            c = ServeClient.local(srv.port)
            res = c.wait(c.submit(script=f"variable files index {src}\\n"
                                  "wordfreq 2 -i v_files\\n")["id"])
            assert res["status"] == "done", res
        finally:
            srv.shutdown()
    assert not touched, touched
    if not torch.cuda.is_available():
        for entry in (pkg.InvertedIndex, pkg.MapReduce, pkg.OinkScript,
                      lambda: pkg.intcount([]), lambda: pkg.wordfreq([]),
                      lambda: pkg.wordfreq_interned([]),
                      lambda: make_mesh(), lambda: make_mesh(2),
                      lambda: topology(0, 2),
                      lambda: pkg.Stream(tempfile.mkdtemp(), []),
                      lambda: pkg.InvertedIndex(engine="native"),
                      lambda: sys.modules["gpu_mapreduce_tpu_torch.serve"]
                      .Server(port=0, state_dir=tempfile.mkdtemp())):
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
                   "ft.journal", "oink.universe", "obs", "obs.context",
                   "obs.tracer", "obs.sinks", "obs.report", "obs.metrics",
                   "obs.flight", "obs.httpd", "obs.fleetobs",
                   "oink.commands.dump_trace", "oink.commands.dump_metrics",
                   "oink.commands.dump_plan", "utils.cas", "native",
                   "stream", "stream.engine", "stream.scheduler",
                   "stream.tailer", "oink.commands.stream", "obs.slo",
                   "serve", "serve.budget", "serve.auth", "serve.admission",
                   "serve.overload", "serve.memo", "serve.session",
                   "serve.autoscale", "serve.streams", "serve.daemon",
                   "serve.client", "serve.__main__")


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
