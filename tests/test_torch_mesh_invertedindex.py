"""InvertedIndex on the port's mesh vs the JAX package's mesh path.

Each shard maps its byte-balanced slice of the files on its own device;
the run's pairs, unique URLs, stats, per-shard URL dictionaries, the
aggregated frame shard by shard and the ``part-<shard>`` files equal the
JAX ``InvertedIndex(comm=make_mesh(P))``'s byte for byte, for P in {1, 3,
8}, with one batch round and with several."""

import collections
import os
import re

import pytest

from gpu_mapreduce_tpu.apps import invertedindex as J
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu_torch import InvertedIndex
from gpu_mapreduce_tpu_torch.apps import invertedindex as T
from gpu_mapreduce_tpu_torch.apps.corpus import make_corpus
from gpu_mapreduce_tpu_torch.parallel.ingest import balance_by_bytes
from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
from gpu_mapreduce_tpu_torch.parallel.sharded import MeshKV

from test_torch_parallel import same_kv


def tmesh(P):
    return make_mesh(P, devices=["cpu"] * P)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """12 files of the skewed generator (hot URLs and a long tail)."""
    d = tmp_path_factory.mktemp("mesh_ii")
    return make_corpus(str(d), 1, nfiles=12, skew=True)


def _parts(d):
    return {f: open(os.path.join(d, f), "rb").read()
            for f in sorted(os.listdir(d))}


@pytest.mark.parametrize("P,batch_bytes", [(1, None), (3, None), (8, None),
                                           (3, 100_000), (8, 100_000)])
def test_pipeline_on_mesh_matches_jax(corpus, tmp_path, P, batch_bytes,
                                      monkeypatch):
    """The whole run, one round a shard or several (``_BATCH_BYTES``
    cut), against the JAX mesh path with its jnp extract."""
    paths, nref, nuniq = corpus
    calls = []
    mark = T.mark_words
    monkeypatch.setattr(T, "mark_words",
                        lambda w, p: calls.append(w.device) or mark(w, p))
    ti = InvertedIndex(comm=tmesh(P))
    ji = J.InvertedIndex(comm=j_make_mesh(P), engine="xla")
    if batch_bytes:
        ti._BATCH_BYTES = ji._BATCH_BYTES = batch_bytes
    got = ti.run(paths, outdir=str(tmp_path / "t"))
    assert got == ji.run(paths, outdir=str(tmp_path / "j")) == (nref, nuniq)
    assert ti.stats == ji.stats
    if P > 1:
        # one mark a shard a batch round; rounds are the most batches a
        # shard has, every shard runs each round
        rounds = max(len(ti._file_batches(files, sizes))
                     for _, files, sizes in balance_by_bytes(paths, P)
                     if files)
        assert len(calls) == P * rounds
        assert ti.stats["nbatches"] <= P * rounds
        if batch_bytes:
            assert rounds > 1
    parts = _parts(tmp_path / "t")
    assert parts == _parts(tmp_path / "j")
    assert list(parts) == [f"part-{p:05d}" for p in range(P)]
    assert ti.urls == ji.urls
    if P > 1:
        assert [dict(d) for d in ti.shard_urls] == \
            [dict(d) for d in ji.shard_urls]
        assert ti._urls == {}
    same_kv(ji.mr, ti.mr)


def test_mesh_parts_union_is_the_one_device_file(corpus, tmp_path):
    """The P = 8 part files hold each URL once, on the shard the
    aggregate routes it to; their union is the one-device part-00000 and
    a regex oracle."""
    paths, _, nuniq = corpus
    oracle = collections.defaultdict(set)
    for f in paths:
        for u in re.findall(rb'<a href="([^"]*)"', open(f, "rb").read()):
            oracle[u].add(f)
    InvertedIndex(device="cpu").run(paths, outdir=str(tmp_path / "one"))
    ii = InvertedIndex(comm=tmesh(8))
    assert ii.run(paths, outdir=str(tmp_path / "mesh"))[1] == nuniq
    lines = []
    got = {}
    for body in _parts(tmp_path / "mesh").values():
        for line in body.decode().splitlines():
            url, names = line.split("\t")
            assert url.encode() not in got
            got[url.encode()] = set(names.split(" "))
            lines.append(line)
    assert got == dict(oracle)
    one = (tmp_path / "one" / "part-00000").read_text().splitlines()
    assert sorted(lines) == sorted(one)


def test_mesh_frames_and_timer(corpus):
    paths, nref, nuniq = corpus
    ii = InvertedIndex(comm=tmesh(3))
    assert ii.run(paths) == (nref, nuniq)
    assert set(ii.timer.times) >= {"read", "h2d", "map_device",
                                   "aggregate", "convert", "reduce"}
    frames = list(ii.mr.kv.frames())
    assert len(frames) == 1 and isinstance(frames[0], MeshKV)
    assert frames[0].nprocs == 3 and len(frames[0]) == nuniq


def test_mesh_dense_corpus_retries_on_every_shard(tmp_path, monkeypatch):
    """A long-URL-dense corpus: the cap retry and the wide fallback are
    mesh-wide, so every shard runs every pass (one mark a shard a pass)
    and the pairs equal the generator's."""
    paths, nref, nuniq = make_corpus(str(tmp_path), 1, nfiles=6,
                                     dense=True)
    calls = []
    mark = T.mark_words
    monkeypatch.setattr(T, "mark_words",
                        lambda w, p: calls.append(w.device) or mark(w, p))
    ti = InvertedIndex(comm=tmesh(3))
    assert ti.run(paths) == (nref, nuniq)
    st = ti.stats
    assert st["wide_fallbacks"] >= 1 and st["cap_retries"] >= 1
    assert len(calls) == 3 * (1 + st["cap_retries"] + st["wide_fallbacks"])
