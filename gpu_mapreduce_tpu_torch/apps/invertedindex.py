"""InvertedIndex on one device or a mesh: the port's main path.

The counterpart of ``gpu_mapreduce_tpu/apps/invertedindex.py``: its
one-device mesh (the path ``bench.py`` drives) and, with ``comm=mesh``,
its mesh path (``_map_corpus_mesh``, JAX :747-866).  Find every
``<a href="..."`` URL in an HTML corpus, emit (url id, doc id) pairs,
group them by URL and count each group; with ``outdir`` also write
``url \\t files`` lines to ``part-00000``.

The map stage runs over the corpus held on the device as u32 words:

    mark (hand-written CUDA kernel, csrc/mark_words.cu)
    → compaction of the word mask (ascending byte starts)
    → URL windows as unaligned u32 loads (64 bytes, then 256 bytes for
      the long tail)
    → closing-quote scan + two seeded masked lookup3 passes → u64 URL id
      and an independent alt id (a u64 intern collision shows as one id
      with two alt ids)
    → doc ids by searchsorted over the file offsets
    → valid rows packed first, in order, and the collision count.

Around it, a cap-retry / wide-window loop: a hit count past the capacity
retries with the exact power-of-two capacity, and a long-URL-dense corpus
(more than cap/4 rows past the 64-byte window) retries with 256-byte
windows for every row.

On a mesh of P > 1 every shard takes its contiguous, byte-balanced slice
of the files (doc ids stay global file indices) and runs the same map
stage on its own device, one launch of the mark kernel per shard per
batch round; the hit cap is shared and grows by the mesh-wide maximum,
and the wide windows come on when any shard is long-URL-dense.  URL
bytes go into the dictionary of the shard the aggregate will route the
id to, and ``outdir`` gets one ``part-<shard>`` per shard.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.mapreduce import MapReduce
from ..core.runtime import resolve_device, synchronize
from ..ops.bits import to_numpy, to_torch, unsigned_order_key
from ..ops.cuda.match import (bytes_view_u32, compact_word_matches,
                              first_byte_pos, mark_words,
                              mask_words_to_length, unaligned_words)
from ..ops.hash import ALT_SEEDS, hash_bytes64_masked
from ..ops.sort import lexsort
from ..parallel.group import reduce_sharded
from ..parallel.sharded import ShardedKV
from ..utils.io import findfiles

PATTERN = b'<a href="'
QUOTE = ord('"')
MAX_URL = 256               # longest URL matched (window width in bytes)
URL_DICT_MAX = 64 << 20     # keep URL bytes below this corpus size

_GAP = MAX_URL + len(PATTERN)  # zero gap between files: no cross-file
                               # matches, and a URL window never bleeds
                               # into the next file
_W_SHORT = 16                  # 64-byte first-tier URL window
_ALT_HI, _ALT_LO = ALT_SEEDS      # alt-id seed family


def _build_corpus(files: Sequence[str]):
    """Concatenate files with zero gaps → (bytes, file data starts int32).
    Byte offsets are int32 on the device, so one corpus stays < 2 GiB."""
    pieces: List[np.ndarray] = []
    starts = np.zeros(len(files), np.int64)
    gap = np.zeros(_GAP, np.uint8)
    off = 0
    for i, f in enumerate(files):
        with open(f, "rb") as fh:
            data = np.frombuffer(fh.read(), np.uint8)
        starts[i] = off
        pieces.append(data)
        pieces.append(gap)
        off += len(data) + _GAP
    if off >= (1 << 31):
        raise ValueError(
            f"corpus is {off} bytes; the device path indexes bytes with "
            f"int32 — split the file list into < 2 GiB batches")
    corpus = np.concatenate(pieces) if pieces else np.zeros(0, np.uint8)
    return corpus, starts.astype(np.int32)


def _bucket_words(nwords: int) -> int:
    """Round a corpus word count up to a size bucket: next power of two
    below 1 Mi words, else the next 1 Mi-word multiple."""
    n = max(nwords, 64)
    if n <= (1 << 20):
        return 1 << (n - 1).bit_length()
    g = 1 << 20
    return -(-n // g) * g


def _hash2(win: torch.Tensor, length: torch.Tensor):
    """(u64 id, alt id) of each row's first ``length`` window bytes."""
    l0 = length.clamp(min=0)
    wm = mask_words_to_length(win, l0)
    return (hash_bytes64_masked(wm, l0),
            hash_bytes64_masked(wm, l0, _ALT_HI, _ALT_LO))


def _window_hash(words: torch.Tensor, ustarts: torch.Tensor, nwords: int):
    win = unaligned_words(words, ustarts, nwords)
    length = first_byte_pos(win, QUOTE)
    ids, alts = _hash2(win, length)
    return ids, alts, length


def _count_collisions(ids: torch.Tensor, alts: torch.Tensor,
                      valid: torch.Tensor) -> int:
    """#ids carrying two different alt ids among valid rows — a real
    64-bit intern collision."""
    masked = torch.where(valid, ids, torch.zeros_like(ids))
    order = lexsort((unsigned_order_key(alts), unsigned_order_key(masked),
                     ~valid))
    a, b, v = ids[order], alts[order], valid[order]
    return int(((a[1:] == a[:-1]) & (b[1:] != b[:-1])
                & v[1:] & v[:-1]).sum())


def _extract_core(words: torch.Tensor, file_starts: torch.Tensor, *,
                  cap: int, wide: bool):
    """The map stage over one corpus of int32 words [m] with file data
    starts [F] (int32, ascending).  Returns the packed columns [cap] —
    ids and alts (u64 as int64), docs (int32), URL byte starts and
    lengths (int32), valid rows first — and the host counts nhits,
    npairs, ncoll and nlong (the raw long-tail count)."""
    nw = MAX_URL // 4
    w1 = nw if wide else _W_SHORT
    cap_long = max(8, cap // 4)
    dev = words.device
    m = words.shape[0]
    nbytes = 4 * m
    wmask = mark_words(words, PATTERN)
    starts, nhits = compact_word_matches(wmask, nbytes, cap)
    ustarts = starts + len(PATTERN)
    ids, alts, lengths = _window_hash(words, ustarts, w1)

    nlong = 0
    if not wide:
        # long tail: no quote in the 64-byte window → regather 256 bytes
        # for the first cap/4 such rows (the JAX path's lax.cond branch,
        # whose fixed-size slot array drops its unused slots; here the
        # rows are indexed directly, so no slot is ever out of range)
        is_long = (lengths < 0) & (starts < nbytes)
        nlong = int(is_long.sum())
        if nlong > 0:
            rows = torch.nonzero(is_long, as_tuple=True)[0][:cap_long]
            lwin = unaligned_words(words, ustarts[rows], nw)
            lln = first_byte_pos(lwin, QUOTE)
            lln = torch.where(lln >= _W_SHORT * 4, lln,
                              torch.full_like(lln, -1))
            ids[rows], alts[rows] = _hash2(lwin, lln)
            lengths[rows] = lln

    docs = torch.searchsorted(file_starts, starts, right=True) - 1
    valid = (starts < nbytes) & (lengths >= 0)
    npairs = int(valid.sum())
    # valid rows first, each part in row order (a stable partition)
    order = torch.cat([torch.nonzero(valid, as_tuple=True)[0],
                       torch.nonzero(~valid, as_tuple=True)[0]])
    pids, palts = ids[order], alts[order]
    ncoll = _count_collisions(pids, palts,
                              torch.arange(cap, device=dev) < npairs)
    return (pids, palts, docs[order].to(torch.int32), ustarts[order],
            lengths[order], nhits, npairs, ncoll, nlong)


def _pack_words(corpus: np.ndarray, W: int) -> np.ndarray:
    """The corpus bytes as ``W`` little-endian u32 words, zero-padded
    (the ``pack`` stage)."""
    wp = np.zeros(W, np.uint32)
    w = bytes_view_u32(corpus)
    wp[:len(w)] = w
    return wp


def _url_dict_wanted(files, want_urls: bool) -> bool:
    """Keep URL bytes when output needs them or the corpus is small."""
    return want_urls or sum(os.path.getsize(f) for f in files) \
        <= URL_DICT_MAX


def _host_collision_count(ids: np.ndarray, alts: np.ndarray) -> int:
    """Host version of :func:`_count_collisions` over valid rows."""
    order = np.lexsort((alts, ids))
    a, b = ids[order], alts[order]
    return int(((a[1:] == a[:-1]) & (b[1:] != b[:-1])).sum())


class StageTimer:
    """Cumulative wall-clock seconds per pipeline stage.  Each stage ends
    with a synchronise of every device it may use, so its time includes
    their work.  Each stage is also a ``stage.<name>`` span (``obs/``,
    JAX :449-454) that closes after that synchronise, so the span's
    duration is the stage's seconds."""

    def __init__(self, device: torch.device, devices=()):
        self.devices = tuple(dict.fromkeys(devices or (device,)))
        self.times: Dict[str, float] = {}
        self._lock = threading.Lock()    # native map tasks time in threads

    @contextlib.contextmanager
    def stage(self, name: str, **attrs):
        """Time the body as stage ``name``; ``attrs`` go on its span."""
        from ..obs import get_tracer
        with get_tracer().span("stage." + name, cat="app", **attrs):
            t0 = time.perf_counter()
            try:
                yield
            finally:
                for dev in self.devices:
                    synchronize(dev)
                dt = time.perf_counter() - t0
                with self._lock:
                    self.times[name] = self.times.get(name, 0.0) + dt


class InvertedIndex:
    """Builds an inverted URL→documents index over the MapReduce ops."""

    _BATCH_BYTES = 1 << 30   # per-corpus cap: byte offsets are int32
    # compaction floor of the native engine's id check: below this many
    # accumulated pairs a compaction costs more than it saves
    _CHK_MIN_COMPACT = 1 << 16

    def __init__(self, device=None, comm=None, engine: Optional[str] = None):
        """``engine``: ``None`` or ``"cuda"`` (the card's kernels) or
        ``"native"`` (the host C++ scanner under mapstyle 2, a thread
        pool; ``MRError`` when the native runtime does not build)."""
        from ..core.runtime import MRError
        from ..parallel.mesh import Mesh
        engine = engine or "cuda"
        if engine not in ("cuda", "native"):
            raise MRError(f"unknown InvertedIndex engine {engine!r}")
        self.comm = comm
        if isinstance(comm, Mesh):
            self.device = comm.devices[0]
            self.timer = StageTimer(self.device, comm.devices)
        else:
            self.device = resolve_device(device)
            self.timer = StageTimer(self.device)
        if engine == "native":
            from .. import native
            if not native.available():
                raise MRError(f"native engine unavailable: "
                              f"{native.build_error()}")
        self.engine = engine
        self.mapstyle = 2 if engine == "native" else 0
        self._urls: Dict[int, bytes] = {}
        self.shard_urls: Optional[List[Dict[int, bytes]]] = None
        self.docs: List[str] = []
        self.npairs = 0
        self._intern_lock = threading.Lock()
        self._compact_lock = threading.Lock()
        self._keep_bytes = True
        self._reset_chk(counters=True)
        self._reset_stats()

    def _reset_stats(self):
        # map-stage machinery: batches, hit-capacity retries, wide-window
        # fallbacks, largest raw long-tail count
        self.stats = {"nbatches": 0, "cap_retries": 0,
                      "wide_fallbacks": 0, "nlong_max": 0}

    @property
    def urls(self) -> Dict[int, bytes]:
        """id → URL bytes, over every dictionary the run kept."""
        merged: Dict[int, bytes] = {}
        for d in self.shard_urls or []:
            merged.update(d)
        merged.update(self._urls)
        return merged

    @staticmethod
    def _intern(table: Dict[int, bytes], ids, urls) -> None:
        for h, url in zip(ids.tolist(), urls):
            prev = table.get(h)
            if prev is not None and prev != url:
                raise ValueError(
                    f"64-bit URL intern collision: {prev!r} vs {url!r}")
            table[h] = url

    def _file_batches(self, files, sizes):
        """Greedy contiguous file batches under the int32 corpus cap."""
        batches, cur, size = [], [], 0
        for f, fbytes in zip(files, sizes):
            fsz = int(fbytes) + _GAP
            if fsz > self._BATCH_BYTES:
                raise ValueError(
                    f"{f}: single file of {fsz} bytes exceeds the device "
                    f"corpus cap ({self._BATCH_BYTES})")
            if cur and size + fsz > self._BATCH_BYTES:
                batches.append(cur)
                cur, size = [], 0
            cur.append(f)
            size += fsz
        if cur:
            batches.append(cur)
        return batches

    def _map_corpus(self, files, kv, want_urls: bool) -> None:
        """The map stage: each batch of files becomes one corpus on the
        device and one ShardedKV frame of (url id, doc id) pairs."""
        self.docs = list(files)
        keep_bytes = _url_dict_wanted(files, want_urls)
        if keep_bytes:
            self.shard_urls = [{}]
        batches = self._file_batches(
            files, [os.path.getsize(f) for f in files])
        checks = []     # per-batch (ids, alts) for the cross-batch check
        base = 0
        for batch in batches:
            doc_base, base = base, base + len(batch)
            with self.timer.stage("read"):
                corpus, fstarts = _build_corpus(batch)
            self.stats["nbatches"] += 1
            if len(corpus) == 0:
                continue
            W = _bucket_words(-(-len(corpus) // 4))
            fst = np.full(max(len(fstarts), 1), 4 * W, np.int32)
            fst[:len(fstarts)] = fstarts
            with self.timer.stage("pack", bytes=len(corpus),
                                  pad=-len(corpus) % 4):
                wp = _pack_words(corpus, W)
            with self.timer.stage("h2d"):
                words = to_torch(wp, self.device)
                fstarts_d = to_torch(fst, self.device)

            # ~1 href/KB is the PUMA-style density; an overflow retries
            # with the exact power-of-two capacity
            cap = max(8, 1 << (max(1, len(corpus) // 1024) - 1).bit_length())
            wide = False
            with self.timer.stage("map_device"):
                while True:
                    (ids, alts, docs, ustarts, lengths, nhits, npairs,
                     ncoll, nlong) = _extract_core(words, fstarts_d,
                                                   cap=cap, wide=wide)
                    self.stats["nlong_max"] = max(self.stats["nlong_max"],
                                                  nlong)
                    if nhits > cap:
                        cap = max(8, 1 << (nhits - 1).bit_length())
                        self.stats["cap_retries"] += 1
                    elif nlong > max(8, cap // 4):
                        wide = True   # long-URL-dense corpus
                        self.stats["wide_fallbacks"] += 1
                    else:
                        break
                if ncoll:
                    raise ValueError(
                        f"{ncoll} 64-bit URL intern collision(s) detected")
                docs = docs + doc_base
            kv.add_frame(ShardedKV(ids, docs, np.array([npairs], np.int32),
                                   np.dtype(np.uint64), np.dtype(np.uint32)))
            if len(batches) > 1:
                checks.append((ids[:npairs], alts[:npairs]))

            if keep_bytes and npairs:
                with self.timer.stage("url_dict"):
                    us = ustarts[:npairs].cpu().numpy()
                    ln = lengths[:npairs].cpu().numpy()
                    urls = [corpus[s:s + l].tobytes()
                            for s, l in zip(us.tolist(), ln.tolist())]
                    self._intern(self.shard_urls[0],
                                 to_numpy(ids[:npairs], np.uint64), urls)

        if checks:
            with self.timer.stage("map_device"):
                ids = torch.cat([c[0] for c in checks])
                alts = torch.cat([c[1] for c in checks])
                ncoll = _count_collisions(
                    ids, alts, torch.ones_like(ids, dtype=torch.bool))
                if ncoll:
                    raise ValueError(
                        f"{ncoll} 64-bit URL intern collision(s) detected "
                        f"(distinct URLs share a u64 id)")

    def _intern_dest(self, ids: np.ndarray, urls) -> None:
        """URL bytes into the dictionary of the shard the aggregate
        routes each id to (``default_hash(id) % P``), so shard d's part
        file decodes from ``shard_urls[d]`` alone."""
        from ..core.column import dest_of_ids
        dest = dest_of_ids(ids, len(self.shard_urls))
        for d in np.unique(dest).tolist():
            at = np.nonzero(dest == d)[0]
            self._intern(self.shard_urls[d], ids[at],
                         [urls[i] for i in at.tolist()])

    def _map_corpus_mesh(self, files, kv, want_urls: bool) -> None:
        """The map stage on a mesh (JAX ``_map_corpus_mesh``): shard p
        maps its contiguous, byte-balanced slice of the files on its own
        device, in rounds of batches under the int32 corpus cap; each
        round adds one mesh frame of (url id, doc id) pairs.  Every
        shard's corpus pads to the round's largest, and every shard runs
        each round's extract (one mark launch a shard), with one shared
        cap."""
        from ..parallel.ingest import balance_by_bytes
        from ..parallel.sharded import MeshKV
        mesh = self.comm
        P = mesh.size
        self.docs = list(files)
        keep_bytes = _url_dict_wanted(files, want_urls)
        if keep_bytes:
            self.shard_urls = [{} for _ in range(P)]
        batch_lists = []
        for start, chunk, sizes in balance_by_bytes(files, P):
            bl, base = [], start
            for b in (self._file_batches(chunk, sizes) if chunk else []):
                bl.append((base, b))
                base += len(b)
            batch_lists.append(bl)
        nrounds = max((len(b) for b in batch_lists), default=0)
        checks = []     # per round, per shard: (ids, alts) of valid rows
        for r in range(nrounds):
            per = []    # (doc base, corpus, file starts) per shard
            for p in range(P):
                if r < len(batch_lists[p]):
                    base, batch = batch_lists[p][r]
                    with self.timer.stage("read"):
                        corpus, fstarts = _build_corpus(batch)
                    self.stats["nbatches"] += 1
                    per.append((base, corpus, fstarts))
                else:
                    per.append((0, np.zeros(0, np.uint8),
                                np.zeros(0, np.int32)))
            max_bytes = max(len(c[1]) for c in per)
            if max_bytes == 0:
                continue
            W = _bucket_words(-(-max_bytes // 4))
            F = max(max(len(c[2]) for c in per), 1)
            hosts = []
            with self.timer.stage("pack",
                                  bytes=sum(len(c[1]) for c in per),
                                  pad=sum(-len(c[1]) % 4 for c in per)):
                for _, corpus, fstarts in per:
                    fst = np.full(F, 4 * W, np.int32)
                    fst[:len(fstarts)] = fstarts
                    hosts.append((_pack_words(corpus, W), fst))
            with self.timer.stage("h2d"):
                words = [to_torch(wp, dev)
                         for (wp, _), dev in zip(hosts, mesh.devices)]
                fst_d = [to_torch(fst, dev)
                         for (_, fst), dev in zip(hosts, mesh.devices)]
            del hosts
            cap = max(8, 1 << (max(1, max_bytes // 1024) - 1).bit_length())
            wide = False
            with self.timer.stage("map_device"):
                while True:
                    outs = [_extract_core(w, f, cap=cap, wide=wide)
                            for w, f in zip(words, fst_d)]
                    nhits = max(o[5] for o in outs)
                    nlong = max(o[8] for o in outs)
                    self.stats["nlong_max"] = max(self.stats["nlong_max"],
                                                  nlong)
                    if nhits > cap:
                        cap = max(8, 1 << (nhits - 1).bit_length())
                        self.stats["cap_retries"] += 1
                    elif nlong > max(8, cap // 4):
                        wide = True   # a shard is long-URL-dense
                        self.stats["wide_fallbacks"] += 1
                    else:
                        break
                ncoll = sum(o[7] for o in outs)
                if ncoll:
                    raise ValueError(
                        f"{ncoll} 64-bit URL intern collision(s) detected")
            shards = []
            for (base, _, _), o in zip(per, outs):
                ids, alts, docs, _, _, _, npairs = o[:7]
                shards.append(ShardedKV(ids, docs + base,
                                        np.array([npairs], np.int32),
                                        np.dtype(np.uint64),
                                        np.dtype(np.uint32)))
                checks.append((ids[:npairs], alts[:npairs]))
            kv.add_frame(MeshKV(mesh, shards))

            if keep_bytes:
                with self.timer.stage("url_dict"):
                    for (base, corpus, _), o in zip(per, outs):
                        ids, _, _, ustarts, lengths, _, n = o[:7]
                        if not n:
                            continue
                        us = ustarts[:n].cpu().numpy()
                        ln = lengths[:n].cpu().numpy()
                        urls = [corpus[s:s + l].tobytes()
                                for s, l in zip(us.tolist(), ln.tolist())]
                        self._intern_dest(to_numpy(ids[:n], np.uint64),
                                          urls)

        if checks:
            # one collision check over every shard and round (JAX
            # _mesh_collision_count, :369-388)
            with self.timer.stage("map_device"):
                dev0 = mesh.devices[0]
                ids = torch.cat([c[0].to(dev0) for c in checks])
                alts = torch.cat([c[1].to(dev0) for c in checks])
                ncoll = _count_collisions(
                    ids, alts, torch.ones_like(ids, dtype=torch.bool))
                if ncoll:
                    raise ValueError(
                        f"{ncoll} 64-bit URL intern collision(s) detected "
                        f"(distinct URLs share a u64 id)")

    # -- map stage: the native (host C++) engine ----------------------

    def _map_file_native(self, itask, filename, kv, ptr):
        """One file's pairs (JAX :556-596), thread-safe under mapstyle 2:
        the document id is the task id, the URL dictionary and the check
        runs are lock-guarded, and the read, the scan and the hashing
        release the GIL."""
        from .. import native
        with open(filename, "rb") as f:
            data = np.frombuffer(f.read(), dtype=np.uint8)
        if len(data) == 0:
            return
        with self.timer.stage("native_scan"):
            starts, lengths = native.find_hrefs(data)
        # the card drops a URL whose quote is not inside its MAX_URL-byte
        # window (longest URL MAX_URL - 1); so does this engine
        lengths = np.where(lengths >= MAX_URL, -1, lengths)
        with self.timer.stage("host_add"):
            keep = lengths >= 0
            kst, kln = starts[keep], lengths[keep]
            if self._keep_bytes:
                ids = native.intern_ranges(data, kst, kln)
                urls = [data[s:s + n].tobytes()
                        for s, n in zip(kst.tolist(), kln.tolist())]
                with self._intern_lock:
                    self._intern(self._urls, ids, urls)
            else:
                ids, alts = native.intern_ranges2(data, kst, kln,
                                                  _ALT_HI, _ALT_LO)
                self._fold_id_check(ids, alts)
            docs = np.full(len(ids), itask, dtype=np.uint32)
            kv.add_batch(to_torch(ids, kv.device), to_torch(docs, kv.device),
                         key_dtype=np.uint64, value_dtype=np.uint32)

    def _fold_id_check(self, ids, alts):
        """Record a batch of (id, alt) pairs for the collision check (a
        collision is one id with two alt values): one locked append; the
        sort and check run in :meth:`_compact_chk_runs` once the raw
        pairs pass the last compacted size, and once at the map's end
        (JAX :598-627)."""
        if not len(ids):
            return
        with self._intern_lock:
            self._chk_tails.append((ids, alts))
            self._chk_raw += len(ids)
            trigger = self._chk_raw > max(self._chk_base,
                                          self._CHK_MIN_COMPACT)
        if trigger:
            self._compact_chk_runs()

    # mrlint: disable=lock-unguarded-mutation — only called from run()'s
    # single-threaded phases: before map_files spawns the mapper pool
    # and after it joins; the locked sites are the pool's
    def _reset_chk(self, counters: bool) -> None:
        """Drop the check's accumulators (``counters`` also zeroes the
        raw and base counts); called outside the map's threads."""
        self._chk_tails = []
        self._chk_sorted = None
        if counters:
            self._chk_raw = self._chk_base = 0

    def _compact_chk_runs(self):
        """Fold the recorded tails into the standing sorted, deduplicated
        run by rank (the tail sorted, then two searchsorteds), raising
        if any id carries two alt values (JAX :640-685).  The tails are
        swapped out under the intern lock, the merge runs outside it,
        and compactions are serial."""
        with self._compact_lock:
            with self._intern_lock:
                tails, self._chk_tails = self._chk_tails, []
            if not tails:
                return
            ti = np.concatenate([t[0] for t in tails])
            ta = np.concatenate([t[1] for t in tails])
            taken = len(ti)
            o = np.argsort(ti)
            ti, ta = ti[o], ta[o]
            if self._chk_sorted is not None:
                ri, ra = self._chk_sorted
                n, t = len(ri), len(ti)
                # run elements first on ties: the two position families
                # are disjoint and cover [0, n + t)
                pos_r = np.searchsorted(ti, ri, side="left") \
                    + np.arange(n, dtype=np.int64)
                pos_t = np.searchsorted(ri, ti, side="right") \
                    + np.arange(t, dtype=np.int64)
                mi = np.empty(n + t, ri.dtype)
                ma = np.empty(n + t, ra.dtype)
                mi[pos_r], ma[pos_r] = ri, ra
                mi[pos_t], ma[pos_t] = ti, ta
            else:
                mi, ma = ti, ta
            same = mi[1:] == mi[:-1]
            if (same & (ma[1:] != ma[:-1])).any():
                raise ValueError("64-bit URL intern collision(s) detected")
            keep = np.ones(len(mi), bool)
            keep[1:] = ~same
            mi, ma = mi[keep], ma[keep]
            with self._intern_lock:
                self._chk_sorted = (mi, ma)
                self._chk_raw -= taken
                self._chk_base = len(mi)

    def _map_native(self, mr, files, want_urls: bool) -> int:
        """The native engine's map stage: one task a file (JAX
        :971-987); a collision surfaces while files map or in the
        closing compaction, which stays in the ``host_add`` stage."""
        self.docs = list(files)
        self._keep_bytes = _url_dict_wanted(files, want_urls)
        self._reset_chk(counters=True)
        self.stats["nbatches"] = len(files)
        npairs = mr.map_files(files, self._map_file_native)
        if self._chk_tails:
            with self.timer.stage("host_add"):
                self._compact_chk_runs()
        self._reset_chk(counters=False)
        return npairs

    def run(self, paths: Sequence[str],
            outdir: Optional[str] = None) -> Tuple[int, int]:
        """Returns (total hits, unique urls).  Writes ``url \\t files``
        lines to ``outdir/part-<shard>`` (``part-00000`` on one device)
        when outdir is given (reference myreduce,
        cuda/InvertedIndex.cu:463-513)."""
        mr = MapReduce(self.device, comm=self.comm, mapstyle=self.mapstyle)
        self._reset_stats()
        self._urls, self.shard_urls = {}, None
        files = findfiles(list(paths))
        mapper = self._map_corpus_mesh if mr.nprocs > 1 \
            else self._map_corpus
        with self.timer.stage("map"):
            if self.engine == "native":
                self.npairs = self._map_native(mr, files,
                                               outdir is not None)
            else:
                self.npairs = mr.map(1, lambda itask, kv, ptr: mapper(
                    files, kv, want_urls=outdir is not None))
        with self.timer.stage("aggregate"):
            mr.aggregate()
        with self.timer.stage("convert"):
            mr.convert()

        nurl = [0]

        def emit_batch(fr, kv, ptr):
            counted = reduce_sharded(fr, "count")
            nurl[0] += len(counted)
            kv.add_frame(counted)

        with self.timer.stage("reduce"):
            if outdir:
                os.makedirs(outdir, exist_ok=True)
                for fr in mr.kmv.frames():
                    self._write_parts_sharded(outdir, fr)
            mr.reduce(emit_batch, batch=True)
        self.mr = mr
        return self.npairs, nurl[0]

    def _write_parts_sharded(self, outdir: str, fr) -> None:
        """Write ``part-<shard>`` from each shard's groups in ascending
        unsigned URL id, decoding URL bytes from the run's dictionary."""
        for p in range(fr.nprocs):
            lookup = (self.shard_urls[p] if self.shard_urls is not None
                      else self._urls)
            hf = fr.shard_to_host(p)
            with open(os.path.join(outdir, f"part-{p:05d}"), "w") as out:
                for k, vals in hf.groups():
                    url = lookup[int(k)].decode(errors="replace")
                    names = " ".join(self.docs[int(v)]
                                     for v in sorted(set(vals)))
                    out.write(f"{url}\t{names}\n")
