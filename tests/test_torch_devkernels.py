"""``parallel/devkernels.py`` of the port against the JAX package's on the
same seeded numpy inputs, exactly: the row state and segment helpers,
``clone_sharded``, ``skv_map`` with the edge bodies and ``skmv_map`` with
the composed graph engines' KMV bodies (cc, luby_find, sssp, tri_find).
The inputs hold u64 ids at and above 2^63 and 2^64-1, empty groups,
garbage rows past the valid counts and padded group slots past the group
count."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_mapreduce_tpu.oink.commands import cc as jcc
from gpu_mapreduce_tpu.oink.commands import luby as jluby
from gpu_mapreduce_tpu.oink.commands import sssp as jsssp
from gpu_mapreduce_tpu.oink.commands import tri as jtri
from gpu_mapreduce_tpu.parallel import devkernels as jdk
from gpu_mapreduce_tpu.parallel.mesh import make_mesh
from gpu_mapreduce_tpu.parallel.sharded import ShardedKMV as JShardedKMV
from gpu_mapreduce_tpu.parallel.sharded import ShardedKV as JShardedKV
from gpu_mapreduce_tpu_torch.core.frame import KMVFrame
from gpu_mapreduce_tpu_torch.interop import kmv_from_numpy, kv_from_numpy
from gpu_mapreduce_tpu_torch.oink.commands import cc as tcc
from gpu_mapreduce_tpu_torch.oink.commands import luby as tluby
from gpu_mapreduce_tpu_torch.oink.commands import sssp as tsssp
from gpu_mapreduce_tpu_torch.oink.commands import tri as ttri
from gpu_mapreduce_tpu_torch.parallel import devkernels as tdk

U64MAX = (1 << 64) - 1
GCAP, VCAP = 32, 128
MESH = make_mesh(1)


def _ids(rng, shape, big=True):
    """u64 ids: small ones (so groups share them), ids at and above 2^63
    and 2^64-1 (only small ones with ``big=False``)."""
    x = rng.integers(0, 40, shape, dtype=np.uint64)
    if big:
        pool = np.array([1 << 63, (1 << 63) + 1, U64MAX - 1, U64MAX,
                         (1 << 63) - 1], np.uint64)
        hit = rng.random(shape) < 0.3
        x[hit] = rng.choice(pool, int(hit.sum()))
    return x


def _layout(rng, g=20, empty=(3, 4, 11)):
    """Group sizes (some empty) and offsets: group slots past ``g`` are
    padding with size 0 and offset VCAP, as a convert lays them out."""
    sizes = rng.integers(1, 7, g)
    sizes[list(empty)] = 0
    nv = np.zeros(GCAP, np.int32)
    vo = np.full(GCAP, VCAP, np.int32)
    nv[:g] = sizes
    vo[:g] = np.concatenate([[0], np.cumsum(sizes)[:-1]])
    return nv, vo, g, int(sizes.sum())


def _pair(ukey, nv, vo, values, g, vc):
    """The same KMV as a JAX frame and a port frame."""
    j = JShardedKMV(MESH, jnp.asarray(ukey), jnp.asarray(nv), jnp.asarray(vo),
                    jnp.asarray(values), np.array([g], np.int32),
                    np.array([vc], np.int32))
    t = kmv_from_numpy(ukey, nv, vo, values, [g], [vc], "cpu")
    return j, t


def _np(x):
    """A JAX array or a torch tensor as numpy (int64 bits as u64 where
    the JAX side is u64)."""
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _same(t, j):
    a, b = _np(t), _np(j)
    if b.dtype == np.uint64 and a.dtype == np.int64:
        a = a.view(np.uint64)
    assert a.shape == b.shape and np.array_equal(a, b), (a, b)


def _same_frame(t, j):
    """Equal counts, then equal valid rows in order, in equal dtypes."""
    th, jh = t.to_host(), j.to_host()
    assert int(t.counts[0]) == int(j.counts[0])
    for a, b in ((th.key.data, jh.key.data), (th.value.data, jh.value.data)):
        assert a.dtype == b.dtype and np.array_equal(a, b), (a, b)


def test_kmv_row_state_matches_jax():
    rng = np.random.default_rng(1)
    nv, vo, g, vc = _layout(rng)
    vals = _ids(rng, VCAP)
    jseg, jrows, jgroups = jdk.kmv_row_state(
        jnp.asarray(nv), jnp.asarray(vo), jnp.asarray(vals), g, vc)
    seg, rows, groups = tdk.kmv_row_state(
        torch.from_numpy(nv), torch.from_numpy(vo),
        torch.from_numpy(vals.view(np.int64)), g, vc)
    _same(rows, jrows)
    _same(groups, jgroups)
    assert np.array_equal(seg.numpy()[rows.numpy()],
                          _np(jseg)[_np(jrows)])


@pytest.mark.parametrize("seed", [2, 3, 4])
@pytest.mark.parametrize("op", ["min", "max", "any"])
def test_u64_segment_reductions_match_jax(op, seed):
    """Unsigned min / max (U64MAX and 0 where a segment has no valid
    row) and any, over ids at and above 2^63."""
    rng = np.random.default_rng(seed)
    nv, vo, g, vc = _layout(rng)
    x = _ids(rng, VCAP)
    seg, rows, _ = tdk.kmv_row_state(torch.from_numpy(nv),
                                     torch.from_numpy(vo),
                                     torch.zeros(VCAP), g, vc)
    valid = rows & torch.from_numpy(rng.random(VCAP) < 0.6)
    jseg = jnp.asarray(seg.numpy().astype(np.int32))
    jvalid = jnp.asarray(valid.numpy())
    tx = torch.from_numpy(x.view(np.int64))
    if op == "any":
        cond = x > np.uint64(1 << 63)
        got = tdk.seg_any(torch.from_numpy(cond), seg, valid, GCAP)
        want = jluby._seg_any(jnp.asarray(cond), jseg, jvalid, GCAP)
    else:
        tfn = tdk.seg_min_u64 if op == "min" else tdk.seg_max_u64
        jfn = jdk.seg_min_u64 if op == "min" else jdk.seg_max_u64
        got, want = tfn(tx, seg, valid, GCAP), jfn(jnp.asarray(x), jseg,
                                                   jvalid, GCAP)
    _same(got, want)
    if op == "min":
        assert (got == tdk.U64MAX).any()            # empty segments


@pytest.mark.parametrize("seed", [5, 6])
def test_float64_segment_reductions_match_jax(seed):
    """seg_min_with (identity +inf) and seg_lex_min2's exact attainment
    compare, over ties and infinities."""
    rng = np.random.default_rng(seed)
    nv, vo, g, vc = _layout(rng)
    a = rng.choice([0.5, 1.0, 1.0 + 2 ** -52, 3.0, np.inf], VCAP)
    b = rng.choice([-1.0, 2.0, 7.0, 1e300], VCAP)
    seg, rows, _ = tdk.kmv_row_state(torch.from_numpy(nv),
                                     torch.from_numpy(vo),
                                     torch.zeros(VCAP), g, vc)
    valid = rows & torch.from_numpy(rng.random(VCAP) < 0.7)
    jseg = jnp.asarray(seg.numpy().astype(np.int32))
    jvalid = jnp.asarray(valid.numpy())
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    _same(tdk.seg_min_with(ta, seg, valid, GCAP, np.inf),
          jdk.seg_min_with(jnp.asarray(a), jseg, jvalid, GCAP, np.inf))
    got = tdk.seg_lex_min2(ta, tb, seg, valid, GCAP, np.inf, np.inf)
    want = jdk.seg_lex_min2(jnp.asarray(a), jnp.asarray(b), jseg, jvalid,
                            GCAP, jnp.inf, jnp.inf)
    for x, y in zip(got, want):
        _same(x, y)


def test_clone_sharded_matches_jax():
    rng = np.random.default_rng(7)
    key, value = _ids(rng, (64, 2)), _ids(rng, 64)
    j = jdk.clone_sharded(JShardedKV(MESH, jnp.asarray(key),
                                     jnp.asarray(value),
                                     np.array([41], np.int32)))
    t = tdk.clone_sharded(kv_from_numpy(key, value, [41], "cpu"))
    assert (len(t), t.nvalues_total) == (len(j), j.nvalues_total) == (41, 41)
    for a, b in ((t.ukey, j.ukey), (t.nvalues, j.nvalues),
                 (t.voffsets, j.voffsets), (t.values, j.values)):
        _same(a, b)
    th, jh = t.to_host(), j.to_host()
    assert np.array_equal(th.offsets, jh.offsets)


EDGE_BODIES = ["edge_to_vertices_dev", "edge_to_vertex_dev",
               "edge_to_vertex_pair_dev", "edge_both_directions_dev",
               "edge_upper_dev", "invert_dev", "add_weight_dev"]


@pytest.mark.parametrize("name", EDGE_BODIES)
def test_skv_map_edge_bodies_match_jax(name):
    """Rows past the count hold garbage; self-loops and ids at and above
    2^63 included; the valid rows come out packed in order."""
    rng = np.random.default_rng(8)
    key = _ids(rng, (64, 2))
    key[5, 1] = key[5, 0]                              # a self-loop
    value = _ids(rng, 64)
    counts = np.array([45], np.int32)
    j = jdk.skv_map(JShardedKV(MESH, jnp.asarray(key), jnp.asarray(value),
                               counts), getattr(jdk, name))
    t = tdk.skv_map(kv_from_numpy(key, value, counts, "cpu"),
                    getattr(tdk, name))
    _same_frame(t, j)


def test_skv_map_places_a_host_frame():
    from gpu_mapreduce_tpu_torch.core.frame import KVFrame
    rng = np.random.default_rng(9)
    key, value = _ids(rng, (30, 2)), _ids(rng, 30)
    host = tdk.skv_map(KVFrame(key, value), tdk.edge_upper_dev,
                       device="cpu")
    dev = tdk.skv_map(kv_from_numpy(key, value, [30], "cpu"),
                      tdk.edge_upper_dev)
    assert isinstance(host, tdk.ShardedKV)
    assert np.array_equal(host.to_host().key.data, dev.to_host().key.data)


def _tagged(rng, n, width, tags=(0, 1)):
    """[n, width] u64 rows: a tag in column 0, ids after it."""
    v = _ids(rng, (n, width))
    v[:, 0] = rng.choice(np.array(tags, np.uint64), n)
    return v


def _sssp_rows(rng, n):
    """[n, 4] float64 [tag, pred, dist, current] rows with tied and
    infinite distances and preds above 2^63 and up to 2^64 - 2^11."""
    rows = np.stack([rng.choice([0.0, 1.0], n),
                     rng.choice([-1.0, 3.0, 5.0, 9.0, float(1 << 63),
                                 float(U64MAX - 2047)], n),
                     rng.choice([0.0, 1.0, 2.5, np.inf], n),
                     rng.choice([0.0, 1.0], n)], 1)
    return rows


def _kmv_case(name, rng):
    """(ukey [GCAP(, 2)], values [VCAP(, w)], extra for JAX, extra for the
    port) for a body's input shape."""
    edge_keys = _ids(rng, (GCAP, 2))
    if name == "cc_zone_winner":
        return _ids(rng, GCAP), _ids(rng, VCAP), (), ()
    if name in ("cc_edge_zone", "cc_zone_reassign"):
        return _ids(rng, GCAP), _tagged(rng, VCAP, 3), (), ()
    if name == "luby_edge_winner_null":
        return (edge_keys, rng.choice(np.array([0, 0, 0, 1], np.uint8), VCAP),
                (jnp.uint64(6789),), (6789,))
    if name == "luby_edge_winner":
        seed = U64MAX - 5                              # wraps mod 2^64
        return (edge_keys, rng.choice(np.array([0, 0, 1], np.uint64), VCAP),
                (jnp.uint64(seed),), (seed,))
    if name.startswith("luby_"):
        return _ids(rng, GCAP), _tagged(rng, VCAP, 2)[:, ::-1].copy(), (), ()
    if name == "tri_first_degree":
        return _ids(rng, GCAP), _ids(rng, VCAP), (), ()
    if name == "tri_emit_triangles":
        return edge_keys, _tagged(rng, VCAP, 3), (), ()
    if name.startswith("sssp_"):
        return _ids(rng, GCAP, big=False), _sssp_rows(rng, VCAP), (), ()
    raise KeyError(name)


KMV_BODIES = {
    "cc_edge_zone": (jcc._edge_zone_dev, tcc._edge_zone_dev),
    "cc_zone_winner": (jcc._zone_winner_dev, tcc._zone_winner_dev),
    "cc_zone_reassign": (jcc._zone_reassign_dev, tcc._zone_reassign_dev),
    "luby_edge_winner_null": (jluby._edge_winner_dev,
                              tluby._edge_winner_dev),
    "luby_edge_winner": (jluby._edge_winner_dev, tluby._edge_winner_dev),
    "luby_vert_winner": (jluby._vert_winner_dev, tluby._vert_winner_dev),
    "luby_vert_loser": (jluby._vert_loser_dev, tluby._vert_loser_dev),
    "luby_vert_emit_mis": (jluby._vert_emit_mis_dev,
                           tluby._vert_emit_mis_dev),
    "luby_vert_emit_edges": (jluby._vert_emit_edges_dev,
                             tluby._vert_emit_edges_dev),
    "tri_first_degree": (jtri._first_degree_dev, ttri._first_degree_dev),
    "tri_emit_triangles": (jtri._emit_triangles_dev,
                           ttri._emit_triangles_dev),
    "sssp_pick_shortest_state": (jsssp._pick_shortest_state,
                                 tsssp._pick_shortest_state),
    "sssp_pick_shortest_changed": (jsssp._pick_shortest_changed,
                                   tsssp._pick_shortest_changed),
    "sssp_update_adjacent_edges": (jsssp._update_adjacent_edges,
                                   tsssp._update_adjacent_edges),
    "sssp_update_adjacent_relax": (jsssp._update_adjacent_relax,
                                   tsssp._update_adjacent_relax),
}


@pytest.mark.parametrize("seed", [10, 11])
@pytest.mark.parametrize("name", sorted(KMV_BODIES))
def test_skmv_map_bodies_match_jax(name, seed):
    """Each composed engine's KMV body through skmv_map, against the JAX
    body through the JAX skmv_map: equal counts and equal valid rows."""
    rng = np.random.default_rng(seed)
    nv, vo, g, vc = _layout(rng)
    ukey, values, jextra, textra = _kmv_case(name, rng)
    j, t = _pair(ukey, nv, vo, values, g, vc)
    jbody, tbody = KMV_BODIES[name]
    _same_frame(tdk.skmv_map(t, tbody, extra=textra),
                jdk.skmv_map(j, jbody, extra=jextra))


def test_nsq_angles_matches_jax():
    """The angle expansion sized by one host read of the pair count,
    against the JAX body under its static cap: every pair j < k of each
    group, in the same order."""
    rng = np.random.default_rng(12)
    nv, vo, g, vc = _layout(rng, empty=())
    ukey, values = _ids(rng, GCAP), _ids(rng, VCAP)
    j, t = _pair(ukey, nv, vo, values, g, vc)
    jkv, tkv = _Sink(), _Sink()
    jtri.nsq_angles(j, jkv, None)
    ttri.nsq_angles(t, tkv, None)
    sizes = nv[:g].astype(np.int64)
    assert len(tkv.frames[0]) == int((sizes * (sizes - 1) // 2).sum()) > 0
    _same_frame(tkv.frames[0], jkv.frames[0])


def test_skmv_map_places_a_host_kmv_frame():
    rng = np.random.default_rng(13)
    nv, vo, g, vc = _layout(rng, empty=())
    ukey, values = _ids(rng, GCAP), _tagged(rng, VCAP, 3)
    _, t = _pair(ukey, nv, vo, values, g, vc)
    offsets = np.concatenate([[0], np.cumsum(nv[:g])])
    host = KMVFrame(ukey[:g], nv[:g], offsets, values[:vc])
    got = tdk.skmv_map(host, tcc._zone_reassign_dev, device="cpu")
    want = tdk.skmv_map(t, tcc._zone_reassign_dev)
    for a, b in ((got.to_host().key.data, want.to_host().key.data),
                 (got.to_host().value.data, want.to_host().value.data)):
        assert np.array_equal(a, b)


class _Sink:
    """The add_frame half of a KeyValue, for one callback call."""
    device = "cpu"

    def __init__(self):
        self.frames = []

    def add_frame(self, fr):
        self.frames.append(fr)


def test_f64_to_u64_converts_like_jax():
    x = np.array([0.0, 1.0, 2.0 ** 53, 2.0 ** 63 - 1024, 2.0 ** 63,
                  2.0 ** 63 + 2048, 2.0 ** 64 - 2048, 7.9, -1.0, -0.5,
                  np.nan, np.inf, -np.inf, 2.0 ** 64, 1e300], np.float64)
    _same(tdk.f64_to_u64(torch.from_numpy(x)),
          jnp.asarray(x).astype(jnp.uint64))


def test_u64_compares_are_unsigned():
    a = np.array([0, 5, 1 << 63, U64MAX, 7], np.uint64)
    b = np.array([1 << 63, 4, U64MAX, 0, 7], np.uint64)
    ta, tb = (torch.from_numpy(x.view(np.int64)) for x in (a, b))
    assert np.array_equal(tdk.u64_lt(ta, tb).numpy(), a < b)
    assert np.array_equal(tdk.u64_min(ta, tb).numpy().view(np.uint64),
                          np.minimum(a, b))
    assert np.array_equal(tdk.u64_max(ta, tb).numpy().view(np.uint64),
                          np.maximum(a, b))
