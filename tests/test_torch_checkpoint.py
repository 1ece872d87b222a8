"""Checkpoints across the two packages, on the CPU: a checkpoint written
by the JAX package loads in the port and one written by the port loads in
the JAX package, for KV and KMV datasets with dense, byte, object and
interned columns; the manifests are equal with the digest fields masked,
each package's digests verify in the other, a flipped byte raises, the
double-fault swap keeps the old checkpoint, an MR with open adds refuses
to save, a load streams into an out-of-core budget, v1 manifests load,
and ``examples/in.checkpoint`` gives the same degree files in both."""

import json
import os
import shutil

import numpy as np
import pytest

from gpu_mapreduce_tpu import MapReduce as JMapReduce
from gpu_mapreduce_tpu.core.runtime import MRError as JMRError
from gpu_mapreduce_tpu.parallel.mesh import make_mesh
from gpu_mapreduce_tpu.utils import integrity as jintegrity
from gpu_mapreduce_tpu_torch import MapReduce, MRError
from gpu_mapreduce_tpu_torch.core import checkpoint
from gpu_mapreduce_tpu_torch.utils import integrity

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _mr(side, mesh=False, **kw):
    if side == "port":
        return MapReduce(device="cpu", **kw)
    return JMapReduce(make_mesh(1), **kw) if mesh else JMapReduce(**kw)


def _col(col):
    dtype = str(col.data.dtype) if hasattr(col, "data") and \
        isinstance(col.data, np.ndarray) and col.data.dtype != object \
        else None
    return type(col).__name__, dtype, col.tolist()


def view(mr):
    if mr.kv is not None:
        return ("kv", [(_col(f.key), _col(f.value))
                       for f in (fr.to_host() for fr in mr.kv.frames())])
    return ("kmv", [(_col(f.key), np.asarray(f.nvalues).tolist(),
                     _col(f.values))
                    for f in (fr.to_host() for fr in mr.kmv.frames())])


def _dataset(kind, rng):
    n = 500
    if kind == "dense":
        k = rng.integers(0, 1 << 64, n, dtype=np.uint64)
        k[:2] = [(1 << 64) - 1, 1 << 63]
        return k, rng.integers(0, 9, n).astype(np.int32)
    if kind == "pairs":
        return (rng.integers(0, 30, (n, 2)).astype(np.uint64),
                np.ones(n, np.uint8))
    if kind in ("bytes", "interned"):
        return ([b"w%d" % i for i in rng.integers(0, 60, n)],
                [b"v" * int(i) for i in rng.integers(0, 5, n)])
    if kind == "objects":
        return ([("t", int(i)) for i in rng.integers(0, 20, n)],
                [{"d": int(i)} for i in rng.integers(0, 3, n)])
    raise ValueError(kind)


def _build(side, kind, grouped, **kw):
    keys, vals = _dataset(kind, np.random.default_rng(len(kind)))
    # a grouped dataset is the device tier's (the port groups on its
    # device, the JAX package on its one-device mesh)
    mr = _mr(side, mesh=(kind == "interned" or grouped), **kw)
    if kind == "objects":
        mr.map(1, lambda i, kv, p: [kv.add(k, v) for k, v in
                                    zip(keys, vals)])
    else:
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, vals))
    if kind == "interned":
        mr.aggregate()            # device frame, interned columns
    if grouped:
        mr.collate()
    return mr


def _masked_manifest(path):
    with open(os.path.join(path, "manifest.json")) as f:
        man = json.load(f)
    for fm in man.get("frames", []):
        fm.pop("digest", None)
        fm.pop("shard_digests", None)
    return man


def _npz(path):
    out = {}
    for name in sorted(os.listdir(path)):
        if name.endswith(".npz"):
            with np.load(os.path.join(path, name)) as z:
                out[name] = {k: z[k].tolist() for k in sorted(z.files)}
    return out


KINDS = ["dense", "pairs", "bytes", "objects", "interned"]


@pytest.mark.parametrize("grouped", [False, True], ids=["kv", "kmv"])
@pytest.mark.parametrize("kind", KINDS)
def test_checkpoints_cross_between_packages(tmp_path, kind, grouped):
    srcs = {side: _build(side, kind, grouped) for side in ("port", "jax")}
    want = view(srcs["port"])
    assert want == view(srcs["jax"])
    for side, mr in srcs.items():
        assert mr.save(str(tmp_path / side)) >= 1
    # the same manifest and the same arrays, digests aside
    assert _masked_manifest(tmp_path / "port") == \
        _masked_manifest(tmp_path / "jax")
    assert _npz(tmp_path / "port") == _npz(tmp_path / "jax")
    # each package's stamps verify in the other (MRTPU_VERIFY is on)
    assert checkpoint.validate(str(tmp_path / "jax"))
    from gpu_mapreduce_tpu.core import checkpoint as jcheckpoint
    assert jcheckpoint.validate(str(tmp_path / "port"))
    for reader, writer in (("port", "jax"), ("jax", "port")):
        dst = _mr(reader)
        dst.load(str(tmp_path / writer))
        assert view(dst) == want, (reader, writer)
    # a text KV loaded back re-interns when it is placed again
    if kind == "interned" and not grouped:
        dst = _mr("port")
        dst.load(str(tmp_path / "jax"))
        dst.aggregate()
        assert dst.kv.one_frame().key_decode is not None
        assert view(dst) == want


def test_array_digest_and_file_digest_equal_jax(tmp_path):
    rng = np.random.default_rng(0)
    arrays = [rng.integers(0, 1 << 64, 100, dtype=np.uint64),
              rng.standard_normal((7, 3)), np.zeros(0, np.int8)]
    assert integrity.array_digest(*arrays) == \
        jintegrity.array_digest(*arrays)
    assert integrity.digest_bytes(b"abc") == jintegrity.digest_bytes(b"abc")
    p = tmp_path / "f"
    p.write_bytes(rng.bytes(3 << 20))
    assert integrity.file_digest(str(p)) == jintegrity.file_digest(str(p))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_flipped_byte_raises_integrity_error(tmp_path, writer):
    mr = _build(writer, "dense", False)
    mr.save(str(tmp_path / "ck"))
    frame = tmp_path / "ck" / "frame-00000.npz"
    data = bytearray(frame.read_bytes())
    data[len(data) // 2] ^= 0x01
    frame.write_bytes(bytes(data))
    before = integrity.integrity_failures().get("checkpoint", 0)
    with pytest.raises(integrity.IntegrityError, match="checksum"):
        _mr("port").load(str(tmp_path / "ck"))
    assert integrity.integrity_failures()["checkpoint"] == before + 1
    assert not checkpoint.validate(str(tmp_path / "ck"))


def test_shard_digest_mismatch_names_the_writer_shard(tmp_path):
    mr = _build("port", "dense", False)
    mr.aggregate()                       # a device frame: shards [n]
    mr.save(str(tmp_path / "ck"))
    man_path = tmp_path / "ck" / "manifest.json"
    man = json.loads(man_path.read_text())
    assert man["frames"][0]["shards"] == [500]
    man["frames"][0]["shard_digests"] = ["crc32:00000000"]
    man_path.write_text(json.dumps(man))
    with pytest.raises(integrity.IntegrityError, match="writer shard 0"):
        _mr("port").load(str(tmp_path / "ck"))


def test_save_double_fault_preserves_old_checkpoint(tmp_path, monkeypatch):
    path = str(tmp_path / "ck")
    mr = _mr("port")
    mr.map(1, lambda i, kv, p: kv.add_batch(
        np.arange(8, dtype=np.uint64), np.ones(8, np.uint64)))
    mr.save(path)
    mr2 = _mr("port")
    mr2.map(1, lambda i, kv, p: kv.add_batch(
        np.arange(4, dtype=np.uint64), np.zeros(4, np.uint64)))
    real_rename = os.rename

    def failing_rename(src, dst):
        if dst == path:            # both the swap and its undo
            raise OSError("injected rename failure")
        return real_rename(src, dst)

    monkeypatch.setattr(checkpoint.os, "rename", failing_rename)
    with pytest.raises(MRError, match="survives"):
        mr2.save(path)
    monkeypatch.undo()
    old = [d for d in os.listdir(tmp_path) if d.startswith("ck.old.")]
    assert old
    mr3 = _mr("port")
    mr3.load(str(tmp_path / old[0]))
    got = []
    mr3.scan_kv(lambda k, v, p: got.append(int(k)))
    assert sorted(got) == list(range(8))


def test_save_swap_and_refusals(tmp_path):
    mr = _mr("port")
    kvh = mr.open()
    kvh.add(1, 2)
    with pytest.raises(MRError, match="uncompleted"):
        mr.save(str(tmp_path / "x"))
    mr.close()
    assert mr.save(str(tmp_path / "x")) == 1
    assert mr.save(str(tmp_path / "x")) == 1        # replaces in place
    (tmp_path / "y").mkdir()
    (tmp_path / "y" / "notes.txt").write_text("keep")
    with pytest.raises(MRError, match="non-checkpoint"):
        mr.save(str(tmp_path / "y"))
    assert (tmp_path / "y" / "notes.txt").read_text() == "keep"
    with pytest.raises(MRError, match="manifest"):
        _mr("port").load(str(tmp_path / "nope"))
    assert not [d for d in os.listdir(tmp_path) if ".tmp." in d]


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_load_streams_into_outofcore_budget(tmp_path, writer):
    src = _mr(writer)
    keys = np.arange(400_000, dtype=np.uint64)
    src.map(1, lambda i, kv, p: kv.add_batch(keys, keys))
    src.save(str(tmp_path / "big"))
    got = {}
    for side in ("port", "jax"):
        dst = _mr(side, outofcore=1, memsize=1, maxpage=1,
                  fpath=str(tmp_path / f"sp-{side}"))
        assert dst.load(str(tmp_path / "big")) == 400_000
        assert dst.kv._resident_bytes() <= 2 * (1 << 20)
        got[side] = (dst.kv.nframes, view(dst),
                     sorted(os.listdir(tmp_path / f"sp-{side}")) != [])
    assert got["port"] == got["jax"]


def test_spilled_multiframe_kv_saves_frame_by_frame(tmp_path):
    got = {}
    for side in ("port", "jax"):
        mr = _mr(side, outofcore=1, memsize=1, maxpage=1,
                 fpath=str(tmp_path / f"sp-{side}"))
        keys = np.arange(300_000, dtype=np.uint64)
        mr.map(1, lambda i, kv, p: kv.add_batch(keys, keys))
        nf = mr.save(str(tmp_path / side))
        got[side] = (nf, _masked_manifest(tmp_path / side),
                     _npz(tmp_path / side))
    assert got["port"] == got["jax"] and got["port"][0] > 1


def test_v1_manifest_loads(tmp_path):
    mr = _build("port", "dense", False)
    mr.save(str(tmp_path / "ck"))
    man_path = tmp_path / "ck" / "manifest.json"
    man = json.loads(man_path.read_text())
    man_path.write_text(json.dumps({"version": 1, "kind": man["kind"],
                                    "nframes": man["nframes"],
                                    "counts": man["counts"]}))
    for side in ("port", "jax"):
        dst = _mr(side)
        assert dst.load(str(tmp_path / "ck")) == 500
        assert view(dst) == view(mr)
    man_path.write_text(json.dumps({"version": 9, "kind": "kv"}))
    with pytest.raises(MRError, match="unsupported checkpoint version"):
        _mr("port").load(str(tmp_path / "ck"))


def test_example_in_checkpoint_matches_jax(tmp_path, monkeypatch):
    from gpu_mapreduce_tpu.oink.script import OinkScript as JOinkScript
    from gpu_mapreduce_tpu_torch import OinkScript
    outs = {}
    for side, s in (("port", OinkScript(device="cpu", screen=False,
                                        logfile=None)),
                    ("jax", JOinkScript(screen=False, logfile=None))):
        d = tmp_path / side
        d.mkdir()
        monkeypatch.chdir(d)
        s.run_file(os.path.join(ROOT, "examples", "in.checkpoint"))
        outs[side] = {name: (d / name).read_bytes()
                      for name in ("deg.original", "deg.restored")}
        assert sorted(outs[side]["deg.original"].split()) == \
            sorted(outs[side]["deg.restored"].split())
        shutil.rmtree(d / "ckpt.rmat")
    assert outs["port"] == outs["jax"]
    assert outs["port"]["deg.original"]


def test_script_save_load_lines(tmp_path, monkeypatch):
    from gpu_mapreduce_tpu_torch import OinkScript
    monkeypatch.chdir(tmp_path)
    s = OinkScript(device="cpu", screen=False, logfile=None)
    s.run_string("mr a\n")
    s.obj.get_mr("a").map(1, lambda i, kv, p: kv.add(1, 2))
    s.run_string(f"a save {tmp_path}/ck\nmr b\nb load {tmp_path}/ck\n")
    got = []
    s.obj.get_mr("b").scan_kv(lambda k, v, p: got.append((k, v)))
    assert got == [(1, 2)]
    with pytest.raises(MRError, match="Illegal MR object save"):
        s.one("a save")
    assert JMRError is not MRError
