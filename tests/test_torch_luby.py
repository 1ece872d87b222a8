"""luby_find's layer in the port against the JAX package on the same
inputs, exactly: ``vertex_rand`` bit for bit (ids near 0, 2^63 and
2^64-1, seeds that wrap), the staging's ``drop_self``, the fused model's
state and round count, and the command's set and message."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpu_mapreduce_tpu.models import luby as jluby
from gpu_mapreduce_tpu.models import rmat as jrmat
from gpu_mapreduce_tpu.oink.command import run_command as j_run
from gpu_mapreduce_tpu.oink.commands.luby import vertex_rand as j_rand
from gpu_mapreduce_tpu.oink.objects import ObjectManager as JObjects
from gpu_mapreduce_tpu.parallel.mesh import make_mesh
from gpu_mapreduce_tpu.parallel.staging import stage_graph as j_stage
from gpu_mapreduce_tpu_torch.interop import (mapreduce_from_numpy,
                                             mapreduce_to_numpy)
from gpu_mapreduce_tpu_torch.models import luby as tluby
from gpu_mapreduce_tpu_torch.oink.command import run_command as t_run
from gpu_mapreduce_tpu_torch.oink.commands.luby import vertex_rand
from gpu_mapreduce_tpu_torch.oink.objects import ObjectManager
from gpu_mapreduce_tpu_torch.parallel.staging import stage_graph

U64MAX = (1 << 64) - 1


def _ids_near_edges():
    return np.array([0, 1, 2, 3, 255, (1 << 53) + 1, (1 << 63) - 2,
                     (1 << 63) - 1, 1 << 63, (1 << 63) + 1, U64MAX - 2,
                     U64MAX - 1, U64MAX], np.uint64)


@pytest.mark.parametrize("seed", [0, 6789, 12345, U64MAX, U64MAX - 6788,
                                  1 << 63, -1, -(1 << 62)])
def test_vertex_rand_bit_equal(seed):
    rng = np.random.default_rng(abs(seed) % 1000)
    v = np.concatenate([_ids_near_edges(),
                        rng.integers(0, U64MAX, 2000, dtype=np.uint64,
                                     endpoint=True)])
    want = j_rand(v, seed)
    got = vertex_rand(torch.from_numpy(v.view(np.int64)), seed).numpy()
    assert got.dtype == np.float64
    assert np.array_equal(got.view(np.int64), want.view(np.int64))
    assert got.min() >= 0.0 and got.max() < 1.0


def _edges(seed, nlevels=9, nnz=4, self_loops=0):
    e, _ = jrmat.generate_unique(seed, nlevels, nnz,
                                 (0.45, 0.15, 0.15, 0.25))
    rng = np.random.default_rng(seed)
    e = e.copy()
    e[rng.integers(0, len(e), 30)] |= np.uint64(1 << 63)   # ids past 2^63
    if self_loops:
        loops = rng.choice(e.reshape(-1), self_loops)
        lone = 0xFEDCBA9876543210                 # a self-loop-only id
        e = np.concatenate([e, np.stack([loops, loops], 1),
                            np.array([[lone, lone]], np.uint64)])
    return e[rng.permutation(len(e))]


def _port_mr(e):
    return mapreduce_from_numpy(e, np.zeros(len(e), np.uint8), device="cpu")


def _jax_mr(e):
    from gpu_mapreduce_tpu import MapReduce as JMapReduce
    mr = JMapReduce(make_mesh(1))
    mr.map(1, lambda i, kv, p: kv.add_batch(e, np.zeros(len(e), np.uint8)))
    return mr


@pytest.mark.parametrize("seed", [3, 4])
def test_staging_drop_self_exact(seed):
    e = _edges(seed, self_loops=25)
    jsg = j_stage(_jax_mr(e), make_mesh(1), drop_self=True)
    tsg = stage_graph(_port_mr(e), drop_self=True)
    valid = np.asarray(jsg.valid)
    assert tsg.n == jsg.n < len(np.unique(e))
    assert np.array_equal(tsg.verts.numpy().view(np.uint64), jsg.verts)
    assert np.array_equal(np.asarray(jsg.src)[valid], tsg.src.numpy())
    assert np.array_equal(np.asarray(jsg.dst)[valid], tsg.dst.numpy())
    assert len(tsg.src) == int((e[:, 0] != e[:, 1]).sum())


def test_staging_of_self_loops_only():
    e = np.array([[5, 5], [U64MAX, U64MAX]], np.uint64)
    sg = stage_graph(_port_mr(e), drop_self=True)
    assert sg.n == 0 and sg.src.numel() == 0


@pytest.mark.parametrize("seed, nlevels, nnz", [(11, 9, 4), (12, 10, 2),
                                                (13, 8, 8), (14, 6, 1)])
def test_luby_model_exact(seed, nlevels, nnz):
    sg = stage_graph(_port_mr(_edges(seed, nlevels, nnz, self_loops=10)),
                     drop_self=True)
    prio = vertex_rand(sg.verts, seed)
    jstate, jit = jluby.luby_mis(sg.src.numpy().astype(np.int32),
                                 sg.dst.numpy().astype(np.int32),
                                 jnp.asarray(prio.numpy()), sg.n)
    state, it = tluby.luby_mis(sg.src, sg.dst, prio, sg.n)
    assert it == int(jit) and it > 1
    assert state.dtype == torch.int8
    assert np.array_equal(state.numpy(), np.asarray(jstate))
    # a maximal independent set
    s, d = sg.src.numpy(), sg.dst.numpy()
    inset = state.numpy() == 1
    assert not np.any(inset[s] & inset[d])
    covered = inset.copy()
    covered[s[inset[d]]] = True
    covered[d[inset[s]]] = True
    assert covered.all()


def test_luby_maxiter_matches():
    src = torch.arange(0, 99, dtype=torch.int64)
    dst = src + 1
    prio = torch.linspace(1.0, 0.0, 100, dtype=torch.float64)
    state, it = tluby.luby_mis(src, dst, prio, 100, maxiter=3)
    jstate, jit = jluby.luby_mis(src.numpy().astype(np.int32),
                                 dst.numpy().astype(np.int32),
                                 jnp.asarray(prio.numpy()), 100, maxiter=3)
    assert it == int(jit) == 3
    assert np.array_equal(state.numpy(), np.asarray(jstate))
    assert (state == 0).any()            # cut before it finished


@pytest.mark.parametrize("seed", [21, 22])
def test_luby_command_matches_jax(seed):
    e = _edges(seed, self_loops=5)
    jobj = JObjects(comm=make_mesh(1))
    jobj.name_mr("mre", _jax_mr(e))
    tobj = ObjectManager(device="cpu")
    tobj.name_mr("mre", _port_mr(e))
    jcmd = j_run("luby_find", [str(seed)], obj=jobj, inputs=["mre"],
                 outputs=[(None, "mis")], screen=False)
    tcmd = t_run("luby_find", [str(seed)], obj=tobj, inputs=["mre"],
                 outputs=[(None, "mis")], screen=False)
    assert (tcmd.nset, tcmd.niterate) == (jcmd.nset, jcmd.niterate)
    jmis = []
    jobj.named["mis"].scan_kv(lambda k, v, p: jmis.append(k))
    tk, tv = mapreduce_to_numpy(tobj.named["mis"])
    assert np.array_equal(tk, np.asarray(jmis, np.uint64))
    assert tv.dtype == np.uint8 and not tv.any()
