"""wordfreq in the port against the JAX package on the same seeded files
(all six ASCII whitespace separators, runs of them, and the bytes
0x1c-0x1f, 0x85 and 0xa0 inside words): ``wordfreq``,
``wordfreq_interned`` and the OINK ``wordfreq`` command (``fuse 0``, then
``fuse 1`` cold and warm) against JAX ``make_mesh(1)`` runs, message
lines and ``-o`` files byte-identical; ``read_words``' KV (pairs and
``kv_stats``); and the host pulls of one run."""

import io
import os

import numpy as np
import pytest

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu.apps import wordfreq as jwf
from gpu_mapreduce_tpu.oink import kernels as jkernels
from gpu_mapreduce_tpu.oink.script import OinkScript as JOinkScript
from gpu_mapreduce_tpu.parallel.mesh import make_mesh
from gpu_mapreduce_tpu.plan import plan_cache as j_plan_cache
from gpu_mapreduce_tpu_torch import MapReduce, OinkScript
from gpu_mapreduce_tpu_torch.apps import wordfreq as twf
from gpu_mapreduce_tpu_torch.oink import kernels as tkernels
from gpu_mapreduce_tpu_torch.parallel.sharded import ShardedKMV, ShardedKV
from gpu_mapreduce_tpu_torch.plan import plan_cache, plan_history

SEPARATORS = [b" ", b"\t", b"\n", b"\r", b"\x0b", b"\x0c"]


def write_corpus(d, nwords=(4000, 2500), vocab=600, seed=9):
    """Files of Zipf-drawn words over a seeded vocabulary (lengths 1-30,
    a few of 40-200 bytes), each followed by one separator or a run of
    2-3; returns their paths."""
    rng = np.random.default_rng(seed)
    alphabet = np.frombuffer(b"abcdefghijklmnopqrstuvwxyz"
                             b"\x1c\x1d\x1e\x1f\x85\xa0\xc3\xa9", np.uint8)
    lens = rng.integers(1, 31, vocab)
    lens[rng.integers(0, vocab, 6)] = rng.integers(40, 201, 6)
    words = [alphabet[rng.integers(0, len(alphabet), n)].tobytes()
             for n in lens]
    paths = []
    for i, n in enumerate(nwords):
        ranks = np.minimum(rng.zipf(1.2, n), vocab) - 1
        pieces = [b"\n\t " if i else b""]
        for r in ranks:
            pieces.append(words[r])
            k = 1 if rng.random() < 0.97 else int(rng.integers(2, 4))
            pieces.extend(SEPARATORS[j] for j in rng.integers(0, 6, k))
        p = os.path.join(d, f"words-{i}.txt")
        with open(p, "wb") as f:
            f.write(b"".join(pieces))
        paths.append(p)
    return paths


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return write_corpus(str(tmp_path_factory.mktemp("wf")))


def test_wordfreq_apps_match_jax(corpus):
    mesh = make_mesh(1)
    want = jwf.wordfreq(corpus, 7, comm=mesh)
    assert jwf.wordfreq_interned(corpus, 7, comm=mesh) == want
    assert twf.wordfreq(corpus, 7, device="cpu") == want
    assert twf.wordfreq_interned(corpus, 7, device="cpu") == want
    words = [w for p in corpus for w in open(p, "rb").read().split()]
    assert want[:2] == (len(words), len(set(words)))


def test_read_words_kv_matches_jax(corpus):
    files_t, files_j = [], []
    t, j = MapReduce(device="cpu"), JMapReduce(make_mesh(1))
    n_t = t.map_files(corpus, tkernels.read_words, files_t)
    n_j = j.map_files(corpus, jkernels.read_words, files_j)
    assert n_t == n_j and files_t == files_j == corpus
    assert t.kv_stats() == j.kv_stats()
    got, want = [], []
    t.scan_kv(lambda k, v, p: got.append((k, v)))
    j.scan_kv(lambda k, v, p: want.append((k, int(v))))
    assert got == want and got[0][1] == 0


def _run_script(cls, kw, d, files, fuse_runs):
    """The wordfreq line of examples/in.wordfreq, with an -o file, once
    per entry of ``fuse_runs``: (screen text, -o file bytes) each."""
    out = []
    cwd = os.getcwd()
    os.chdir(d)
    try:
        for i, fuse in enumerate(fuse_runs):
            screen = io.StringIO()
            s = cls(screen=screen, **kw)
            s.one(f"set fuse {fuse}")
            s.one(f"variable files index {' '.join(files)}")
            s.one(f"wordfreq 10 -i v_files -o wf.{i} NULL")
            with open(f"wf.{i}", "rb") as f:
                out.append((screen.getvalue(), f.read()))
    finally:
        os.chdir(cwd)
    return out


def test_oink_wordfreq_matches_jax(corpus, tmp_path, monkeypatch):
    """fuse 0, fuse 1 cold, fuse 1 warm: the same WordFreq lines and the
    same -o file, run for run; the warm port run takes the group
    table's plain version."""
    plan_cache().clear()
    j_plan_cache().clear()
    runs = (0, 1, 1)
    for side in ("t", "j"):
        os.makedirs(tmp_path / side)
    monkeypatch.setenv("MRTPU_PALLAS_GROUP", "1")
    got = _run_script(OinkScript, {"device": "cpu"}, tmp_path / "t",
                      corpus, runs)
    group = next(g for e in reversed(plan_history()) for g in e["groups"]
                 if g["fused"])
    monkeypatch.delenv("MRTPU_PALLAS_GROUP")
    want = _run_script(JOinkScript, {"comm": make_mesh(1)}, tmp_path / "j",
                       corpus, runs)
    assert got == want
    assert (group["mode"], group["table"]) == ("local1", True)
    assert "WordFreq: 2 files, 6500 words" in got[0][0]
    assert got[0][1].count(b"\n") == int(
        got[0][0].split(" unique")[0].split()[-1])


def test_wordfreq_pulls_only_head_and_output(corpus, tmp_path,
                                             monkeypatch):
    """One OINK wordfreq run pulls a whole frame to the host once (the
    -o file); the top-N reads only its head."""
    pulls = []
    for cls in (ShardedKV, ShardedKMV):
        real = cls.to_host

        def counted(self, _real=real, _name=cls.__name__):
            pulls.append(_name)
            return _real(self)
        monkeypatch.setattr(cls, "to_host", counted)
    heads = []
    real_head = ShardedKV.head
    monkeypatch.setattr(ShardedKV, "head", lambda self, n: (
        heads.append(n), real_head(self, n))[1])
    _run_script(OinkScript, {"device": "cpu"}, tmp_path, corpus, (0,))
    assert pulls == ["ShardedKV"] and heads == [10]
