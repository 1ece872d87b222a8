"""The port's example drivers (``gpu_mapreduce_tpu_torch/examples/``)
against the JAX package's (``examples/*.py``), both called in process
through ``main`` on the inputs of ``tests/test_examples.py``, the port's
with ``-device cpu``: the summary lines equal, the top-N lines equal
where the counts differ and as a set among tied counts, rmat's edge file
as a set of lines, ``invertedindex --mesh 3``'s part files equal to JAX
``make_mesh(3)``'s."""

import collections
import importlib.util
import os
import random
import re

import numpy as np
import pytest

from gpu_mapreduce_tpu_torch import MRError
from gpu_mapreduce_tpu_torch.examples import (intcount, invertedindex, rmat,
                                              split_device, wordfreq,
                                              wordfreq2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_driver(name):
    spec = importlib.util.spec_from_file_location(
        f"_jax_example_{name}", os.path.join(ROOT, "examples", f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run(capsys, fn, *args):
    capsys.readouterr()
    fn(*args)
    return capsys.readouterr().out.splitlines()


def _top_groups(lines):
    """Top-N lines ``count word`` as their count runs: a list of (count,
    set of lines), so tied counts compare as a set."""
    groups = []
    for ln in lines:
        n = int(ln.split()[0])
        if groups and groups[-1][0] == n:
            groups[-1][1].add(ln)
        else:
            groups.append((n, {ln}))
    return groups


@pytest.fixture(scope="module")
def word_files(tmp_path_factory):
    d = tmp_path_factory.mktemp("words")
    random.seed(3)
    vocab = ["alpha", "beta", "gamma", "delta", "epsilon"]
    oracle = collections.Counter()
    files = []
    for i in range(3):
        ws = random.choices(vocab, [9, 7, 5, 3, 1], k=1200)
        oracle.update(ws)
        p = d / f"w{i}.txt"
        p.write_text(" ".join(ws))
        files.append(str(p))
    return files, oracle


def test_split_device():
    assert split_device(["a", "-device", "cpu", "b"]) == ("cpu", ["a", "b"])
    assert split_device(["-d", "cuda:0", "x"]) == ("cuda:0", ["x"])
    assert split_device(["x"]) == (None, ["x"])


def test_wordfreq_driver_matches_jax(word_files, capsys):
    files, oracle = word_files
    got = _run(capsys, wordfreq.main, files + ["-device", "cpu"])
    want = _run(capsys, _jax_driver("wordfreq").main, ["wordfreq.py"] + files)
    summary = f"{sum(oracle.values())} total words, {len(oracle)} unique words"
    # wordfreq(quiet=False) prints the summary and top first, the driver
    # again: two blocks of 1 + 5 lines
    assert len(got) == len(want) == 12
    for at in (0, 6):
        assert got[at] == want[at] == summary
        assert _top_groups(got[at + 1:at + 6]) == \
            _top_groups(want[at + 1:at + 6])
    assert got[1] == f"{oracle.most_common(1)[0][1]} alpha"


def test_wordfreq2_driver_matches_jax(word_files, capsys):
    files, oracle = word_files
    got = _run(capsys, wordfreq2.main, ["-device", "cpu"] + files)
    want = _run(capsys, _jax_driver("wordfreq2").main, files)
    assert got[0] == want[0] == "top 10 (local sort):"
    assert got[6] == want[6] == "top 10 (global, after gather):"
    for lo, hi in ((1, 6), (7, 12)):
        assert _top_groups(got[lo:hi]) == _top_groups(want[lo:hi])
    assert got[-1] == want[-1] == (f"{sum(oracle.values())} total words, "
                                   f"{len(oracle)} unique words (3 files)")
    assert len(got) == len(want) == 13


def test_intcount_driver_matches_jax(tmp_path, capsys):
    rng = np.random.default_rng(6)
    vals = rng.integers(0, 50, 4096).astype("<u4")
    p = tmp_path / "ints.bin"
    p.write_bytes(vals.tobytes())
    got = _run(capsys, intcount.main, [str(p), "-device", "cpu"])
    want = _run(capsys, _jax_driver("intcount").main, ["intcount.py", str(p)])
    assert got[0] == want[0] == f"{len(vals)} ints, {len(np.unique(vals))} " \
                                "unique"
    assert len(got) == len(want) == 11
    assert _top_groups(got[1:]) == _top_groups(want[1:])
    # the top line is the oracle's most common count
    assert int(got[1].split()[0]) == np.bincount(vals).max()


def test_rmat_driver_matches_jax(tmp_path, capsys):
    args = ["8", "4", "0.25", "0.25", "0.25", "0.25", "0.0", "7"]
    got = _run(capsys, rmat.main, ["-device", "cpu"] + args
               + [str(tmp_path / "mat")])
    want = _run(capsys, _jax_driver("rmat").main, ["rmat.py"] + args
                + [str(tmp_path / "jmat")])
    assert got == want and any(ln.startswith("RMAT:") for ln in got)
    edges = (tmp_path / "mat").read_text().splitlines()
    assert len(edges) == 256 * 4 and len(set(edges)) == len(edges)
    assert set(edges) == set((tmp_path / "jmat").read_text().splitlines())


def _html_files(tmp_path):
    files = []
    for i in range(4):
        p = tmp_path / f"d{i}.html"
        p.write_bytes((b'<a href="http://e.org/p%d">x</a> pad ' % (i % 3))
                      * 5)
        files.append(str(p))
    return files


@pytest.mark.parametrize("mesh", [0, 3])
def test_invertedindex_driver_matches_jax(mesh, tmp_path, capsys):
    """One device against JAX ``make_mesh(1)``'s files (the JAX driver
    without ``--mesh`` is its serial host path, whose order is first
    appearance), and ``--mesh 3`` against JAX ``make_mesh(3)``: the same
    summary and part files, byte for byte."""
    files = _html_files(tmp_path)
    out, jout = tmp_path / "out", tmp_path / "jout"
    extra = ["--mesh", str(mesh)] if mesh else []
    got = _run(capsys, invertedindex.main,
               [str(out)] + files + extra + ["-device", "cpu"])
    want = _run(capsys, _jax_driver("invertedindex").main,
                [str(jout)] + files + ["--engine", "xla",
                                       "--mesh", str(mesh or 1)])
    assert got[0] == "20 (url, doc) pairs, 3 unique urls " \
                     f"-> {out}/part-*"
    assert want[0] == got[0].replace(str(out), str(jout))
    assert all(re.fullmatch(r"  \w+: \d+\.\d{3}s", ln) for ln in got[1:])
    parts = sorted(os.listdir(out))
    assert parts == sorted(os.listdir(jout)) == \
        [f"part-{i:05d}" for i in range(max(mesh, 1))]
    for part in parts:
        assert (out / part).read_bytes() == (jout / part).read_bytes(), part


def test_drivers_refuse_without_arguments():
    for mod in (intcount, wordfreq, wordfreq2, rmat):
        with pytest.raises(SystemExit, match="usage"):
            mod.main(["-device", "cpu"])
    with pytest.raises(SystemExit):
        invertedindex.main(["-device", "cpu"])


def test_native_engine_and_bad_device(tmp_path, capsys):
    """``--engine native`` gives the default engine's files; an unknown
    device is refused by the entry point, not run elsewhere."""
    from gpu_mapreduce_tpu_torch import native
    files = _html_files(tmp_path)
    _run(capsys, invertedindex.main, [str(tmp_path / "a")] + files
         + ["-device", "cpu"])
    if native.available():
        _run(capsys, invertedindex.main, [str(tmp_path / "b")] + files
             + ["--engine", "native", "-device", "cpu"])
        assert (tmp_path / "a" / "part-00000").read_bytes() == \
            (tmp_path / "b" / "part-00000").read_bytes()
    with pytest.raises((MRError, RuntimeError)):
        intcount.main([files[0], "-device", "nodevice"])
