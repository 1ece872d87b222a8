"""The port's C ABI (``gpu_mapreduce_tpu_torch/bindings/``) against the JAX
package's: the four C examples built with the system compiler and run
as processes on the JAX tests' seeded inputs, the port's with
``-device cpu``, each held byte for byte against the JAX example's
stdout, log and output files.

Two differences are by design and named where they are compared:

* ``cblocked``'s ``Cummulative hi-water mem`` line counts each package's
  own frame bytes (the rest of its output is equal);
* ``crmat``'s edge file holds the same lines in another order: its
  order follows each package's collate, the JAX bridge's ``MapReduce()``
  on the serial host path, the port's on its one device.

Every process of a module run starts together (each imports its
package: ≈ 4 s apiece on the CPU), so the file stays short.
"""

import collections
import concurrent.futures
import ctypes
import io
import os
import random
import shutil
import subprocess
import sys

import pytest

from gpu_mapreduce_tpu_torch.bindings import build_example, build_shared

pytestmark = pytest.mark.skipif(shutil.which("gcc") is None,
                                reason="no C compiler")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ("cwordfreq", "coink", "crmat", "cblocked")
CRMAT = ("6", "4", "0.25", "0.25", "0.25", "0.25", "0.0", "7")
NO_CARD = "no CUDA device is available"


def _jax_build(name, out):
    # loaded here, not at import: the JAX bindings module imports no JAX,
    # but its package's __init__ does
    from gpu_mapreduce_tpu.bindings import build_example as jax_build
    return jax_build(name, out=out)


def _inputs(d):
    """The JAX tests' inputs: the 3000-word Counter case, the coink
    wordfreq script and its error case."""
    os.makedirs(d, exist_ok=True)
    random.seed(9)
    vocab = ["ant", "bee", "cat", "dog", "eel", "fox", "gnu"]
    words = random.choices(vocab, [30, 25, 18, 11, 8, 5, 3], k=3000)
    with open(os.path.join(d, "a.txt"), "w") as f:
        f.write(" ".join(words[:1500]))
    with open(os.path.join(d, "b.txt"), "w") as f:
        f.write(" ".join(words[1500:]))
    with open(os.path.join(d, "w.txt"), "w") as f:
        f.write("red blue red green red blue " * 10)
    with open(os.path.join(d, "in.c_oink"), "w") as f:
        f.write("variable files index w.txt\nwordfreq 2 -i v_files\n"
                'print "driven from C"\n')
    with open(os.path.join(d, "bad.oink"), "w") as f:
        f.write("frobnicate 1\n")
    return words


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Build both packages' examples, then run every case at once:
    ``{(side, case): (CompletedProcess, cwd)}`` for side "jax", "port",
    "refuse" (the port without -device) and "poisoned" (the port with
    jax and gpu_mapreduce_tpu shadowed on PYTHONPATH)."""
    root = tmp_path_factory.mktemp("cabi")
    bins = {}
    with concurrent.futures.ThreadPoolExecutor(8) as pool:
        futs = {(side, n): pool.submit(
            build_example if side == "port" else _jax_build, n,
            str(root / "bin" / f"{side}-{n}"))
            for side in ("port", "jax") for n in EXAMPLES}
        for key, fut in futs.items():
            bins[key] = fut.result()
    poison = root / "poison"
    for name in ("jax", "gpu_mapreduce_tpu"):
        (poison / name).mkdir(parents=True)
        (poison / name / "__init__.py").write_text(
            f"raise ImportError('{name} is poisoned here')\n")
    words = None
    cases = {}
    for side in ("jax", "port", "refuse", "poisoned"):
        d = str(root / side)
        words = _inputs(d)
        exe = side if side == "jax" else "port"
        dev = ["-device", "cpu"] if side in ("port", "poisoned") else []
        path = REPO if side != "poisoned" else f"{poison}{os.pathsep}{REPO}"
        env = dict(os.environ, PYTHONPATH=path, JAX_PLATFORMS="cpu")
        todo = {"cwordfreq": ["a.txt", "b.txt"]}
        if side != "poisoned":
            todo.update({"coink": ["in.c_oink", "log.oink"],
                         "crmat": [*CRMAT, "mat"], "cblocked": []})
        if side in ("jax", "port"):
            todo["coink-bad"] = ["bad.oink"]
        for case, args in todo.items():
            cmd = [bins[(exe, case.split("-")[0])], *dev, *args]
            cases[(side, case)] = (cmd, d, env)

    def run(item):
        cmd, d, env = item
        return subprocess.run(cmd, capture_output=True, text=True, cwd=d,
                              env=env, timeout=300), d
    with concurrent.futures.ThreadPoolExecutor(6) as pool:
        done = dict(zip(cases, pool.map(run, cases.values())))
    done["words"] = words
    return done


def _ok(runs, side, case):
    r, d = runs[(side, case)]
    assert r.returncode == 0, r.stderr[-2000:]
    return r, d


def test_cwordfreq_equals_jax_and_counter(runs):
    jr, _ = _ok(runs, "jax", "cwordfreq")
    pr, _ = _ok(runs, "port", "cwordfreq")
    assert pr.stdout == jr.stdout
    lines = pr.stdout.strip().splitlines()
    oracle = collections.Counter(runs["words"])
    assert lines[0] == f"3000 total words, {len(oracle)} unique words"
    top = [(ln.split()[1], int(ln.split()[0])) for ln in lines[1:6]]
    assert top == oracle.most_common(5)


def test_coink_script_equals_jax(runs):
    jr, jd = _ok(runs, "jax", "coink")
    pr, pd = _ok(runs, "port", "coink")
    assert pr.stdout == jr.stdout
    assert "1 files, 60 words, 3 unique" in pr.stdout
    with open(os.path.join(jd, "log.oink")) as f:
        jlog = f.read()
    with open(os.path.join(pd, "log.oink")) as f:
        assert f.read() == jlog
    assert "driven from C" in jlog


def test_coink_script_error_equals_jax(runs):
    jr, _ = runs[("jax", "coink-bad")]
    pr, _ = runs[("port", "coink-bad")]
    assert pr.returncode == jr.returncode == 1
    assert pr.stdout == jr.stdout
    err = [ln for ln in pr.stderr.splitlines() if "script error" in ln]
    assert err == [ln for ln in jr.stderr.splitlines()
                   if "script error" in ln]
    assert "Unknown command" in err[0]


def test_crmat_equals_jax(runs):
    jr, jd = _ok(runs, "jax", "crmat")
    pr, pd = _ok(runs, "port", "crmat")
    assert pr.stdout == jr.stdout
    lines = pr.stdout.splitlines()
    assert lines[:2] == ["64 rows in matrix", "256 nonzeroes in matrix"]
    with open(os.path.join(jd, "mat.0")) as f:
        jedges = f.read().splitlines()
    with open(os.path.join(pd, "mat.0")) as f:
        pedges = f.read().splitlines()
    # the same edges; the order follows each package's collate
    assert sorted(pedges) == sorted(jedges)
    assert len(pedges) == 256 and len(set(pedges)) == 256
    hist = [tuple(map(int, ln.split())) for ln in lines[2:-2]]
    assert sum(d * c for d, c in hist) == 256
    assert lines[-2] == f"{64 - sum(c for _, c in hist)} rows with 0 " \
                        f"nonzeroes"


def test_cblocked_equals_jax(runs):
    jr, _ = _ok(runs, "jax", "cblocked")
    pr, _ = _ok(runs, "port", "cblocked")

    def rest(text):
        # each package counts its own frame bytes in this line
        return [ln for ln in text.splitlines()
                if not ln.startswith("Cummulative hi-water mem")]
    assert rest(pr.stdout) == rest(jr.stdout)
    lines = pr.stdout.splitlines()
    assert lines[:3] == ["pairs 36", "scrunch groups 1",
                         "groups 6 blocked 3 values 36"]
    assert any(ln.startswith("Cummulative hi-water mem") for ln in lines)


def test_no_card_no_device_is_refused(runs):
    """Without -device every example runs on the card: with none, it
    exits 1 with the port's MRError text and writes nothing."""
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present: the refusal needs a machine "
                    "without one")
    for case in ("cwordfreq", "coink", "crmat", "cblocked"):
        r, d = runs[("refuse", case)]
        assert r.returncode == 1, (case, r.stdout, r.stderr)
        assert NO_CARD in r.stderr, (case, r.stderr)
        assert r.stdout == "", (case, r.stdout)
    _, d = runs[("refuse", "crmat")]
    assert not os.path.exists(os.path.join(d, "mat.0"))
    assert not os.path.exists(os.path.join(d, "log.oink"))


def test_example_runs_with_jax_poisoned(runs):
    pr, _ = _ok(runs, "port", "cwordfreq")
    qr, _ = _ok(runs, "poisoned", "cwordfreq")
    assert qr.stdout == pr.stdout


def test_shared_shim_in_a_running_interpreter(tmp_path, monkeypatch):
    """``ctypes.PyDLL`` loads the shim into this interpreter: ``MR_init``
    imports the bridge, an OINK wordfreq line runs on the CPU and writes
    what the port's own interpreter writes, and ``MR_finalize`` leaves
    this interpreter running (a later call sees the bridge gone)."""
    from gpu_mapreduce_tpu_torch import OinkScript
    _inputs(str(tmp_path))
    monkeypatch.chdir(tmp_path)
    lib = ctypes.PyDLL(build_shared(out=str(tmp_path / "libcmr.so")))
    lib.MR_last_error.restype = ctypes.c_char_p
    lib.OINK_open_device.restype = ctypes.c_void_p
    lib.OINK_open_device.argtypes = [ctypes.c_char_p, ctypes.c_char_p]
    lib.OINK_command.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    lib.OINK_close.argtypes = [ctypes.c_void_p]
    lines = ["variable files index a.txt b.txt",
             "wordfreq 5 -i v_files -o c.out NULL"]
    assert lib.MR_init() == 0, lib.MR_last_error()
    h = lib.OINK_open_device(None, b"cpu")
    assert h, lib.MR_last_error()
    for line in lines:
        assert lib.OINK_command(h, line.encode()) == 0, lib.MR_last_error()
    assert lib.MR_last_error() is None
    lib.OINK_close(h)
    lib.MR_finalize()
    assert sys.version_info[:2] >= (3, 12)          # still running here
    assert lib.OINK_open_device(None, b"cpu") is None
    assert lib.MR_last_error() == b"MR_init() not called"
    script = OinkScript(device="cpu", screen=io.StringIO())
    for line in lines:
        script.one(line.replace("c.out", "py.out"))
    with open("c.out") as f, open("py.out") as g:
        assert f.read() == g.read()
    # the interpreter is intact: the bridge imports again
    assert lib.MR_init() == 0
    lib.MR_finalize()
