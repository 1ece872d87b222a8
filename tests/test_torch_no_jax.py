"""The port imports neither JAX nor the JAX package, and its entry points
(the example drivers among them) default to the card.

A subprocess poisons ``sys.modules`` so that importing ``jax`` or
``gpu_mapreduce_tpu`` raises, then imports every module of the port and
``chip_smoke``.  Under an audit hook it also runs the native engine, a
stream and a serve session on the CPU: no file under ``gpu_mapreduce_tpu/``
is opened or loaded (the native loader builds and loads the port's own
library).  Then a fleet replica behind the router answers the operator
client (``ctl``), and the trace viewer runs, JAX still poisoned."""

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
                      .Server(port=0, state_dir=tempfile.mkdtemp()),
                      *[lambda ex=ex, a=a: sys.modules[
                          "gpu_mapreduce_tpu_torch.examples." + ex].main(a)
                        for ex, a in (
                            ("intcount", ["f"]), ("wordfreq", ["f"]),
                            ("wordfreq2", ["f"]),
                            ("rmat", ["4", "2", "0.25", "0.25", "0.25",
                                      "0.25", "0.0", "7"]),
                            ("invertedindex", ["o", "f"]),
                            ("invertedindex", ["o", "f", "--mesh", "2"]))]):
            try:
                entry()
            except pkg.MRError:
                pass
            else:
                raise SystemExit(f"{entry}() ran without a card")
    # a fleet replica behind the router, driven by the operator tools,
    # with JAX poisoned
    import contextlib, io
    from gpu_mapreduce_tpu_torch import ctl
    from gpu_mapreduce_tpu_torch.obs import trace_view
    from gpu_mapreduce_tpu_torch.serve import Router
    with tempfile.TemporaryDirectory() as tmp:
        fleet = os.path.join(tmp, "fleet")
        rep = Server(port=0, workers=1, device="cpu", fleet_dir=fleet,
                     replica_id="r0")
        rep.start()
        rt = Router(fleet)
        rt.start()
        out = io.StringIO()
        try:
            with contextlib.redirect_stdout(out):
                assert ctl.main(["--state", fleet, "top", "--json"]) == 0
                assert ctl.main(["--state", fleet, "stats"]) == 0
                assert trace_view.main(["--help"]) == 0
        finally:
            rt.stop()
            rep.shutdown()
        assert '"replica": "r0"' in out.getvalue()
    leaked = [m for m in sys.modules if m.split(".")[0] in
              ("jax", "jaxlib", "gpu_mapreduce_tpu")
              and sys.modules[m] is not None]
    assert not leaked, leaked
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
                   "serve.client", "serve.__main__", "serve.fleet",
                   "serve.router", "ctl", "obs.trace_view",
                   "bindings", "bindings.cbridge", "lint", "lint.driver",
                   "lint.callgraph", "lint.locks", "lint.cachekey",
                   "lint.knobs", "lint.metrics_doc", "lint.nettimeout",
                   "lint.purity", "lint.__main__", "examples",
                   "examples.intcount", "examples.invertedindex",
                   "examples.rmat", "examples.wordfreq",
                   "examples.wordfreq2", "plan.__main__", "utils.publish")


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


TOOL = textwrap.dedent("""
    import runpy, sys
    for name in ("torch", "jax", "jaxlib", "gpu_mapreduce_tpu"):
        sys.modules[name] = None          # any import of them now raises
    mod = sys.argv[1]
    sys.argv = [mod] + sys.argv[2:]
    runpy.run_module(mod, run_name="__main__")
""")


def test_operator_tools_start_without_torch(tmp_path):
    """``ctl`` and ``obs.trace_view`` are a urllib client and a JSONL
    reader: with torch (and JAX) poisoned they still drive a daemon and
    read its trace (the daemon itself runs in a process of its own)."""
    import json
    state, trace = tmp_path / "state", tmp_path / "t.jsonl"
    corpus = tmp_path / "w.txt"
    corpus.write_text("to be or not to be\n" * 20)
    job = tmp_path / "job.oink"
    job.write_text(f"variable files index {corpus}\nwordfreq 3 -i v_files\n")
    env = dict(os.environ, PYTHONPATH=ROOT, MRTPU_TRACE=str(trace))
    daemon = subprocess.Popen(
        [sys.executable, "-m", "gpu_mapreduce_tpu_torch.serve", "--device",
         "cpu", "--port", "0", "--state", str(state)], cwd=ROOT, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    try:
        port = int(json.loads(daemon.stdout.readline())["serving"])
        env.pop("MRTPU_TRACE")

        def tool(*argv):
            return subprocess.run([sys.executable, "-c", TOOL, *argv],
                                  cwd=ROOT, env=env, capture_output=True,
                                  text=True, timeout=120)
        r = tool("gpu_mapreduce_tpu_torch.ctl", "--port", str(port),
                 "submit", str(job), "--wait")
        assert r.returncode == 0, r.stderr
        res = json.loads(r.stdout)
        assert res["status"] == "done" and "WordFreq" in res["output"]
        r = tool("gpu_mapreduce_tpu_torch.ctl", "--state", str(state),
                 "stats")
        assert r.returncode == 0, r.stderr
        assert json.loads(r.stdout)["sessions"]["total"] == 1
        r = tool("gpu_mapreduce_tpu_torch.ctl", "--port", str(port),
                 "shutdown")
        assert r.returncode == 0, r.stderr
        daemon.wait(timeout=120)
    finally:
        if daemon.poll() is None:
            daemon.kill()
        daemon.communicate(timeout=60)
    r = tool("gpu_mapreduce_tpu_torch.obs.trace_view", str(trace))
    assert r.returncode == 0, r.stderr
    assert "oink.wordfreq" in r.stdout


def test_lint_starts_without_torch():
    """mrlint over the port is pure AST: with torch and JAX poisoned it
    runs over the whole tree and exits 0 with no live finding."""
    import json
    env = dict(os.environ, PYTHONPATH=ROOT)
    r = subprocess.run([sys.executable, "-c", TOOL,
                        "gpu_mapreduce_tpu_torch.lint", "--json", "-"],
                       cwd=ROOT, env=env, capture_output=True, text=True,
                       timeout=120)
    assert r.returncode == 0, r.stderr
    payload = json.loads(r.stdout)
    assert payload["total"] == 0 and payload["files_scanned"] > 100
