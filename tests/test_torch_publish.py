"""``gpu_mapreduce_tpu_torch/utils/publish.py`` against the JAX package's
``utils/publish.py`` on the same files: the merge under a key, the
tmp + rename write, the ``.corrupt`` move, the reads; and the port's
default file is its own, never ``BASELINE.json``."""

import json
import os

import pytest

from gpu_mapreduce_tpu.utils import publish as jpub
from gpu_mapreduce_tpu_torch.utils import publish as tpub

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _both(tmp_path, name):
    return str(tmp_path / f"port-{name}.json"), str(tmp_path / f"jax-{name}"
                                                     ".json")


def test_merge_matches_jax(tmp_path):
    p, j = _both(tmp_path, "merge")
    for path, mod in ((p, tpub), (j, jpub)):
        mod.publish("cuda_bench", {"value": 1.5, "unit": "pairs/s"}, path)
        mod.publish("soak", {"seconds": [1, 2]}, path)
        mod.publish("cuda_bench", {"value": 2.5}, path)   # replaces its key
    with open(p) as f, open(j) as g:
        assert f.read() == g.read()
    for path, mod in ((p, tpub), (j, jpub)):
        assert mod.read_published("cuda_bench", path) == {"value": 2.5}
        assert mod.read_published("soak", path) == {"seconds": [1, 2]}
        assert mod.read_published("absent", path) == {}
        assert not os.path.exists(path + ".tmp")


def test_keeps_other_top_level_keys(tmp_path):
    p, j = _both(tmp_path, "other")
    for path in (p, j):
        with open(path, "w") as f:
            json.dump({"note": "kept", "published": {"a": 1}}, f)
    tpub.publish("b", 2, p)
    jpub.publish("b", 2, j)
    with open(p) as f, open(j) as g:
        got, want = json.load(f), json.load(g)
    assert got == want == {"note": "kept", "published": {"a": 1, "b": 2}}


@pytest.mark.parametrize("text", ["{not json", "", "[1, 2"])
def test_corrupt_file_moves_aside_as_jax(tmp_path, text):
    p, j = _both(tmp_path, "bad")
    for path, mod in ((p, tpub), (j, jpub)):
        with open(path, "w") as f:
            f.write(text)
        assert mod.read_published("k", path) == {}
        mod.publish("k", {"x": 1}, path)
        with open(path + ".corrupt") as f:
            assert f.read() == text        # kept for repair
        with open(path) as f:
            assert json.load(f) == {"published": {"k": {"x": 1}}}


def test_missing_file_starts_fresh(tmp_path):
    p, j = _both(tmp_path, "new")
    assert tpub.read_published("k", p) == jpub.read_published("k", j) == {}
    tpub.publish("k", [1], p)
    jpub.publish("k", [1], j)
    with open(p) as f, open(j) as g:
        assert f.read() == g.read()
    assert not os.path.exists(p + ".corrupt")


def test_tmp_then_rename(tmp_path, monkeypatch):
    """The write lands in ``<path>.tmp`` and is renamed over the file: a
    write that fails leaves the old file whole."""
    p = str(tmp_path / "t.json")
    tpub.publish("k", 1, p)
    before = open(p).read()

    def boom(*a, **k):
        raise OSError("disk full")
    monkeypatch.setattr(tpub.json, "dump", boom)
    with pytest.raises(OSError):
        tpub.publish("k", 2, p)
    assert open(p).read() == before


def test_default_path_is_the_ports_own():
    assert tpub.DEFAULT_PATH == os.path.join(ROOT, "PUBLISHED_TORCH.json")
    assert os.path.basename(tpub.DEFAULT_PATH) != "BASELINE.json"
