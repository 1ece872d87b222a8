"""The process group: one rank a process over ``torch.distributed``.

The counterpart of ``gpu_mapreduce_tpu/parallel/dist.py``.  MR-MPI runs
as N OS processes that form one data plane; so does this module, and it
survives a dead peer.  :func:`init_from_env` joins the launcher's
process group (``launch.py`` sets ``MRTPU_DIST_*``) and picks the
transport from the topology, never from a caught error:

* every rank owns a card (world ≤ ``torch.cuda.device_count()``): rank r
  on ``cuda:r``, the data group on ``nccl``;
* ranks share a card (more ranks than cards): rank r on
  ``cuda:(r % cards)``, the data group on ``gloo`` with the tensors on
  the card;
* ``MRTPU_DIST_DEVICE=cpu`` (the launcher's ``--device cpu``): ranks on
  the CPU, ``gloo``.  With no card and no such request it raises.

Beside the data group every topology has one ``gloo`` group for host
metadata (the count matrix, sizes, the barrier).  A world of 1 needs no
process group.

A dead peer turns every collective into an unbounded stall.  Three
mechanisms bound it:

* **heartbeats** — each rank's :class:`Heartbeat` thread renews an
  fsync'd lease file under ``<rundir>/hb-g<gen>/``; a lease past expiry
  + ``MRTPU_DIST_SKEW`` is a dead rank;
* **collective watchdog** — :meth:`DistRuntime.guard` runs each sync
  point (``count_sync``, ``exchange``, ``reshard``, ``ckpt_barrier``) on
  a worker thread while it polls the peers' leases, its own fence and a
  deadline (``MRTPU_DIST_SYNC_TIMEOUT``, the only catch for a peer hung
  but still beating): a dead peer becomes :class:`PeerLostError` within
  lease + skew + poll seconds;
* **fencing** — the launcher creates ``rank<k>.fence.json`` with
  ``O_CREAT|O_EXCL`` before a shrunk generation resumes; a fenced rank
  that wakes up meets :class:`RankFencedError` and writes nothing.

A survivor leaves with ``os._exit(EXIT_PEER_LOST)``, never through
``destroy_process_group`` on a wedged communicator.  Torch's own
timeout is set past the watchdog's, so the watchdog always fires first.

The rank frame (:class:`RankKV`, :func:`shard_local_rows`) holds this
rank's block of a frame over the group; ``parallel/shuffle.exchange``
moves its rows across ranks.
"""

from __future__ import annotations

import datetime
import json
import os
import threading
import time
from dataclasses import dataclass, field
from typing import Callable, List, Optional

import numpy as np
import torch

from ..core.frame import KVFrame
from ..core.runtime import MRError
from ..ops.bits import to_torch
from ..utils.env import env_knob, env_str
from ..utils.fsio import atomic_write_json, fsync_dir, read_json
from .sharded import ShardedKV, pad_rows, round_cap

# the launcher/worker exit protocol: a survivor that saw a dead peer
# exits PEER_LOST (the launcher shrinks); a fenced zombie exits FENCED
EXIT_PEER_LOST = 75
EXIT_FENCED = 76

_HB_DIR = "hb-g"       # per GENERATION: a fence of generation g's rank 2
#                        must never fence the next generation's rank 2
_HB_SUF = ".hb.json"
_FENCE_SUF = ".fence.json"
_EXIT_SUF = ".exit.json"


class PeerLostError(MRError):
    """A sync point saw dead or hung peer rank(s): the bounded-time
    replacement for an endless collective."""

    def __init__(self, site: str, dead: List[int], reason: str = ""):
        self.site = site
        self.dead = list(dead)
        super().__init__(
            f"peer rank(s) {self.dead or '?'} lost at sync point "
            f"{site!r}{': ' + reason if reason else ''}")


class RankFencedError(MRError):
    """THIS rank was fenced (a shrunk generation took over its work): it
    must stop without writing output."""

    def __init__(self, rank: int, site: str = ""):
        self.rank = rank
        super().__init__(
            f"rank {rank} is fenced (superseded by a shrunk generation)"
            + (f" at {site!r}" if site else ""))


def shrink_width(survivors: int) -> int:
    """The next generation's width: the largest power of two ≤
    ``survivors`` (0 when none is left)."""
    if survivors < 1:
        return 0
    w = 1
    while w * 2 <= survivors:
        w *= 2
    return w


# ---------------------------------------------------------------------------
# heartbeat, fence and exit-report files
# ---------------------------------------------------------------------------

def hb_dir(rundir: str, gen: int = 0) -> str:
    return os.path.join(rundir, f"{_HB_DIR}{gen}")


def hb_path(rundir: str, rank: int, gen: int = 0) -> str:
    return os.path.join(hb_dir(rundir, gen), f"rank{rank}{_HB_SUF}")


def fence_path(rundir: str, rank: int, gen: int = 0) -> str:
    return os.path.join(hb_dir(rundir, gen), f"rank{rank}{_FENCE_SUF}")


def exit_path(rundir: str, rank: int, gen: int = 0) -> str:
    return os.path.join(hb_dir(rundir, gen), f"rank{rank}{_EXIT_SUF}")


def write_beat(rundir: str, rank: int, lease_s: float, gen: int = 0,
               state: str = "ready", seq: int = 0) -> None:
    """One durable heartbeat: the lease every peer's verdict reads."""
    os.makedirs(hb_dir(rundir, gen), exist_ok=True)
    now = time.time()
    atomic_write_json(hb_path(rundir, rank, gen), {
        "rank": rank, "pid": os.getpid(), "gen": gen, "state": state,
        "seq": seq, "ts": now, "ttl": lease_s, "expires": now + lease_s})


def read_beat(rundir: str, rank: int, gen: int = 0) -> Optional[dict]:
    return read_json(hb_path(rundir, rank, gen))


def write_exit_report(rundir: str, rank: int, gen: int, code: str,
                      dead: Optional[List[int]] = None,
                      site: str = "") -> None:
    """A rank's last word: which peers it saw dead at which sync point
    (the launcher joins these reports with the exit codes)."""
    try:
        atomic_write_json(exit_path(rundir, rank, gen), {
            "rank": rank, "gen": gen, "code": code,
            "dead": list(dead or []), "site": site, "ts": time.time()})
    except OSError:
        pass                 # best effort: the exit code still speaks


def beat_expired(beat: Optional[dict], skew_s: float,
                 now: Optional[float] = None) -> bool:
    """Dead once past ``expires + skew``; a missing or unreadable beat
    counts as expired."""
    if beat is None:
        return True
    now = time.time() if now is None else now
    try:
        return now > float(beat["expires"]) + skew_s
    except (KeyError, TypeError, ValueError):
        return True


def fence_rank(rundir: str, rank: int, by: str, gen: int = 0) -> bool:
    """Fence ``rank`` (O_CREAT|O_EXCL, then a directory fsync); returns
    whether this call created the fence (False: already fenced)."""
    os.makedirs(hb_dir(rundir, gen), exist_ok=True)
    path = fence_path(rundir, rank, gen)
    try:
        fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
    except FileExistsError:
        return False
    try:
        os.write(fd, json.dumps(
            {"rank": rank, "by": by, "gen": gen,
             "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                  time.gmtime())}).encode())
        os.fsync(fd)
    finally:
        os.close(fd)
    fsync_dir(hb_dir(rundir, gen))
    return True


def is_fenced(rundir: str, rank: int, gen: int = 0) -> bool:
    return os.path.exists(fence_path(rundir, rank, gen))


class Heartbeat:
    """One rank's lease writer thread: a beat every ``heartbeat_s``; each
    beat also reads the rank's own fence and latches ``fenced``."""

    def __init__(self, rundir: str, rank: int, *, heartbeat_s: float,
                 lease_s: float, gen: int = 0):
        self.rundir = rundir
        self.rank = rank
        self.heartbeat_s = heartbeat_s
        self.lease_s = lease_s
        self.gen = gen
        self.seq = 0
        self.fenced = False
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None

    def start(self) -> None:
        os.makedirs(hb_dir(self.rundir, self.gen), exist_ok=True)
        self.beat_once()              # beat 0 lands before any collective
        self._thread = threading.Thread(
            target=self._run, daemon=True,
            name=f"mrtpu-dist-hb-r{self.rank}")
        self._thread.start()

    def beat_once(self) -> None:
        self.seq += 1
        write_beat(self.rundir, self.rank, self.lease_s, gen=self.gen,
                   seq=self.seq)
        if is_fenced(self.rundir, self.rank, self.gen):
            self.fenced = True

    def _run(self) -> None:
        while not self._stop.wait(self.heartbeat_s):
            try:
                self.beat_once()
            except OSError:
                # peers judge this rank by its last durable lease; a disk
                # that stays broken expires it honestly
                pass

    def stop(self, leave: bool = True) -> None:
        """Stop beating; ``leave`` removes the lease (a clean exit is not
        a death)."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.heartbeat_s + 1.0)
        if leave:
            try:
                os.remove(hb_path(self.rundir, self.rank, self.gen))
            except OSError:
                pass


# ---------------------------------------------------------------------------
# the runtime
# ---------------------------------------------------------------------------

class DistRuntime:
    """This process's membership in the process group: its rank, world,
    generation, device, backend and transport, and the watchdog."""

    def __init__(self, rank: int, world: int, rundir: str, *,
                 heartbeat_s: Optional[float] = None,
                 lease_s: Optional[float] = None,
                 skew_s: Optional[float] = None,
                 sync_timeout_s: Optional[float] = None,
                 gen: int = 0, device=None, backend: str = "none",
                 transport: str = "none"):
        self.rank = rank
        self.world = world
        self.rundir = rundir
        self.gen = gen
        self.device = torch.device(device) if device is not None \
            else torch.device("cpu")
        self.backend = backend          # the data group's: nccl | gloo
        self.transport = transport      # how tensors travel: nccl | gloo
        self.meta = None                # the gloo group for host metadata
        self.heartbeat_s = heartbeat_s if heartbeat_s is not None else \
            env_knob("MRTPU_DIST_HEARTBEAT", float, 0.25)
        self.lease_s = lease_s if lease_s is not None else \
            env_knob("MRTPU_DIST_LEASE", float, 1.5)
        self.skew_s = skew_s if skew_s is not None else \
            env_knob("MRTPU_DIST_SKEW", float, 0.25)
        self.sync_timeout_s = sync_timeout_s if sync_timeout_s is not None \
            else env_knob("MRTPU_DIST_SYNC_TIMEOUT", float, 60.0)
        self.heartbeat = Heartbeat(rundir, rank,
                                   heartbeat_s=self.heartbeat_s,
                                   lease_s=self.lease_s, gen=gen)
        self.peer_lost: Optional[PeerLostError] = None

    def torch_timeout(self) -> datetime.timedelta:
        """Torch's collective timeout: twice the watchdog's worst case
        plus a minute, so the watchdog trips first."""
        worst = self.sync_timeout_s + self.lease_s + self.skew_s
        return datetime.timedelta(seconds=2 * worst + 60)

    # -- observation -------------------------------------------------------
    def peer_ranks(self) -> List[int]:
        return [r for r in range(self.world) if r != self.rank]

    def dead_peers(self, now: Optional[float] = None) -> List[int]:
        now = time.time() if now is None else now
        return [r for r in self.peer_ranks()
                if beat_expired(read_beat(self.rundir, r, self.gen),
                                self.skew_s, now)]

    def fenced(self) -> bool:
        return self.heartbeat.fenced or \
            is_fenced(self.rundir, self.rank, self.gen)

    # -- the watchdog ------------------------------------------------------
    def guard(self, site: str, fn: Callable, *args, **kwargs):
        """Run the sync point ``fn`` under the collective watchdog; return
        its result or raise :class:`RankFencedError` (this rank is
        fenced) or :class:`PeerLostError` (a peer's lease expired, the
        deadline passed, or ``fn`` failed while a peer was dying — the
        transport saw the death first, confirmed against the leases
        within one expiry window).  ``fn`` runs on a daemon thread, with
        this rank's card current there (CUDA's current device is per
        thread); on a trip that thread is abandoned mid-collective."""
        from ..ft.inject import fault_point
        fault_point(f"dist.{site}")
        if self.fenced():
            raise RankFencedError(self.rank, site)

        done = threading.Event()
        box: list = [None, None]     # [result, exception]
        device = self.device

        def _work():
            try:
                if device.type == "cuda":
                    torch.cuda.set_device(device)
                box[0] = fn(*args, **kwargs)
            except BaseException as e:        # noqa: BLE001 — re-raised
                box[1] = e
            finally:
                done.set()

        t = threading.Thread(target=_work, daemon=True,
                             name=f"mrtpu-dist-sync-{site}")
        t0 = time.monotonic()
        t.start()
        poll = max(0.05, self.heartbeat_s / 2.0)
        while not done.wait(poll):
            if self.fenced():
                raise RankFencedError(self.rank, site)
            dead = self.dead_peers()
            if dead:
                self._trip(site, dead, "lease expired")
            if time.monotonic() - t0 > self.sync_timeout_s:
                self._trip(site, self.dead_peers(),
                           f"sync deadline {self.sync_timeout_s:g}s "
                           f"passed (hung peer?)")
        if box[1] is not None:
            # the transport may see a dying peer before its lease expires:
            # give the leases one expiry window (and a poll) to confirm,
            # looking once more after it ends, else the original error
            # propagates; with no peer nothing can confirm
            if self.peer_ranks():
                deadline = time.time() + self.lease_s + self.skew_s + poll
                while True:
                    dead = self.dead_peers()
                    if dead:
                        self._trip(site, dead,
                                   f"transport error {box[1]!r}")
                    if time.time() > deadline:
                        break
                    time.sleep(poll)
            raise box[1]
        return box[0]

    def _trip(self, site: str, dead: List[int], reason: str):
        err = PeerLostError(site, dead, reason)
        self.peer_lost = err
        raise err

    def stop(self, leave: bool = True) -> None:
        self.heartbeat.stop(leave=leave)


def lease_table(rt: DistRuntime) -> dict:
    """A snapshot of the generation's lease and fence state: who is
    alive, expired, fenced or missing, and since when."""
    now = time.time()
    peers = {}
    for r in range(rt.world):
        beat = read_beat(rt.rundir, r, rt.gen)
        row = {"fenced": is_fenced(rt.rundir, r, rt.gen),
               "expired": beat_expired(beat, rt.skew_s, now)}
        if beat is None:
            row["missing"] = True
        else:
            try:
                row["age_s"] = round(now - float(beat["ts"]), 3)
                row["expires_in_s"] = round(float(beat["expires"]) - now,
                                            3)
                row["seq"] = int(beat.get("seq", 0))
                row["state"] = str(beat.get("state", ""))
                row["pid"] = beat.get("pid")
            except (KeyError, TypeError, ValueError):
                row["unreadable"] = True
        peers[str(r)] = row
    return {"rank": rt.rank, "world": rt.world, "gen": rt.gen,
            "rundir": rt.rundir, "fenced": rt.fenced(),
            "lease_s": rt.lease_s, "skew_s": rt.skew_s,
            "dead": [r for r, row in peers.items() if row["expired"]],
            "peers": peers}


_ACTIVE: Optional[DistRuntime] = None
_LOCK = threading.Lock()


def active() -> Optional[DistRuntime]:
    return _ACTIVE


def activate(rt: Optional[DistRuntime]) -> Optional[DistRuntime]:
    global _ACTIVE
    with _LOCK:
        prev, _ACTIVE = _ACTIVE, rt
    return prev


def topology(rank: int, world: int, want: str = ""):
    """(device, backend, transport) of rank ``rank`` of ``world``: see
    the module docstring.  ``want`` is ``"cpu"`` or empty."""
    if want == "cpu":
        return torch.device("cpu"), "gloo", "gloo"
    if want:
        raise MRError(f"MRTPU_DIST_DEVICE={want!r}: only 'cpu' (or unset, "
                      f"for the cards) is known")
    if not torch.cuda.is_available():
        raise MRError("no CUDA device for the process group; pass "
                      "--device cpu to run the ranks on the CPU")
    cards = torch.cuda.device_count()
    if world <= cards:
        return torch.device("cuda", rank), "nccl", "nccl"
    # NCCL refuses two ranks on one card: ranks sharing a card use gloo
    return torch.device("cuda", rank % cards), "gloo", "gloo"


def init_from_env() -> Optional[DistRuntime]:
    """Join the process group the launcher describes in ``MRTPU_DIST_*``
    (WORLD, RANK, COORD ``host:port``, RUNDIR, GEN, DEVICE), arm
    ``MRTPU_FAULTS``, start heartbeating and install the runtime.
    Returns None (and touches nothing) outside a launched job."""
    world = env_knob("MRTPU_DIST_WORLD", int, 0)
    rundir = env_str("MRTPU_DIST_RUNDIR", "")
    if world < 1 or (world == 1 and not rundir):
        return None
    rank = env_knob("MRTPU_DIST_RANK", int, 0)
    coord = env_str("MRTPU_DIST_COORD", "")
    gen = env_knob("MRTPU_DIST_GEN", int, 0)
    if world > 1 and (not coord or not rundir):
        raise MRError("MRTPU_DIST_WORLD is set but MRTPU_DIST_COORD / "
                      "MRTPU_DIST_RUNDIR are not — use python -m "
                      "gpu_mapreduce_tpu_torch.launch")
    ndev = env_knob("MRTPU_DIST_LOCAL_DEVICES", int, 1)
    if ndev != 1:
        raise MRError(f"a rank holding {ndev} shards "
                      f"(MRTPU_DIST_LOCAL_DEVICES) is not ported yet")
    device, backend, transport = topology(
        rank, world, env_str("MRTPU_DIST_DEVICE", ""))
    rt = DistRuntime(rank, world, rundir, gen=gen, device=device,
                     backend=backend, transport=transport)
    if world > 1:
        # a shrunk-to-1 generation needs no process group
        import torch.distributed as dist
        if device.type == "cuda":
            torch.cuda.set_device(device)
        dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                world_size=world, rank=rank,
                                timeout=rt.torch_timeout())
        rt.meta = dist.new_group(backend="gloo",
                                 timeout=rt.torch_timeout())
    # arm MRTPU_FAULTS here: workers drive the collectives directly
    from ..ft.inject import configure_from_env
    configure_from_env()
    rt.heartbeat.start()
    activate(rt)
    return rt


def guard_call(site: str, fn: Callable, *args, **kwargs):
    """``fn`` under the watchdog when a process group is active, a direct
    call otherwise."""
    rt = _ACTIVE
    if rt is None:
        return fn(*args, **kwargs)
    return rt.guard(site, fn, *args, **kwargs)


def surviving_width() -> Optional[int]:
    """The width after a shrink: the active runtime's world; None when
    no process group is active."""
    rt = _ACTIVE
    return rt.world if rt is not None else None


def _require_active() -> DistRuntime:
    rt = _ACTIVE
    if rt is None:
        raise MRError("no process group is active: start the ranks with "
                      "python -m gpu_mapreduce_tpu_torch.launch")
    return rt


# ---------------------------------------------------------------------------
# collectives of host metadata (the gloo group) and of rows (the data group)
# ---------------------------------------------------------------------------

def all_gather_host(row: np.ndarray) -> np.ndarray:
    """Every rank's int64 vector ``row`` → ``[world, len(row)]``, rank
    order, over the metadata group (one collective)."""
    rt = _require_active()
    t = torch.as_tensor(np.asarray(row, np.int64).reshape(-1))
    if rt.world == 1:
        return t.numpy()[None, :].copy()
    import torch.distributed as dist
    out = [torch.empty_like(t) for _ in range(rt.world)]
    dist.all_gather(out, t, group=rt.meta)
    return torch.stack(out).numpy()


def barrier_count() -> int:
    """The all-ranks sync point: the sum of one per rank over the
    metadata group (equal to the world when every rank entered)."""
    rt = _require_active()
    if rt.world == 1:
        return 1
    import torch.distributed as dist
    t = torch.ones(1, dtype=torch.int64)
    dist.all_reduce(t, group=rt.meta)
    return int(t.item())


def all_to_all_rows(tensors, counts_mat: np.ndarray, cap_out: int) -> list:
    """Each of ``tensors`` (this rank's rows sorted by destination, on
    its device) to the other ranks: ``counts_mat[rank, d]`` rows to rank
    d, ``counts_mat[s, rank]`` rows from rank s, laid out by source rank
    in ``cap_out`` rows padded with zeros.  One ``all_to_all_single`` a
    tensor; the call returns once the rows have arrived."""
    rt = _require_active()
    send = counts_mat[rt.rank, :].astype(np.int64).tolist()
    recv = counts_mat[:, rt.rank].astype(np.int64).tolist()
    n = int(sum(recv))
    outs = []
    for t in tensors:
        out = t.new_zeros((cap_out,) + tuple(t.shape[1:]))
        if rt.world == 1:
            out[:n] = t[:n]
        else:
            import torch.distributed as dist
            dist.all_to_all_single(out[:n], t.contiguous(), recv, send)
        outs.append(out)
    if rt.device.type == "cuda":
        torch.cuda.synchronize(rt.device)
    return outs


# ---------------------------------------------------------------------------
# the rank frame
# ---------------------------------------------------------------------------

@dataclass
class RankKV:
    """This rank's block of a KV frame over the process group: ``shard``
    holds the rank's rows at the global cap (``round_cap`` of the largest
    count) on its device, and ``counts[P]`` every rank's valid count,
    agreed by all.  It is the one-controller mesh frame's shard
    ``rank``, held by the process that owns it."""

    rank: int
    shard: ShardedKV
    counts: np.ndarray
    exchange_stats: object = field(default=None, compare=False)
    sync_seconds: dict = field(default=None, compare=False)

    @property
    def nprocs(self) -> int:
        return int(self.counts.shape[0])

    @property
    def cap(self) -> int:
        return self.shard.cap

    @property
    def device(self) -> torch.device:
        return self.shard.device

    @property
    def key_dtype(self):
        return self.shard.key_dtype

    @property
    def value_dtype(self):
        return self.shard.value_dtype

    @property
    def key_decode(self):
        return self.shard.key_decode

    @property
    def value_decode(self):
        return self.shard.value_decode

    def __len__(self) -> int:
        return int(self.counts.sum())

    def shard_to_host(self, p: int) -> KVFrame:
        """Host KVFrame of this rank's valid rows; another rank's shard
        lives in another process."""
        if p != self.rank:
            raise MRError(f"shard {p} of a rank frame lives on rank {p}; "
                          f"this is rank {self.rank}")
        return self.shard.to_host()

    def valid_rows(self):
        """This rank's valid (key, value) rows on its device."""
        return self.shard.valid_rows()

    def __repr__(self):
        return (f"RankKV(rank={self.rank}, cap={self.cap}, "
                f"counts={self.counts.tolist()}, device={self.device})")


def _place_rows(rows, device, dtype):
    """Host rows (numpy) or a tensor → (tensor on ``device``, logical
    dtype); only dense ``[n]`` or ``[n, k]`` columns travel."""
    if isinstance(rows, torch.Tensor):
        dt = np.dtype(dtype) if dtype is not None else \
            torch.empty(0, dtype=rows.dtype).numpy().dtype
        t = rows.to(device)
    else:
        arr = np.asarray(rows)
        if arr.dtype.kind not in "biuf":
            raise MRError("interned columns across ranks are not ported "
                          "yet (intern tables are per process)")
        dt, t = arr.dtype, to_torch(arr, device)
    if t.dim() not in (1, 2):
        raise MRError(f"a rank frame's column is [n] or [n, k], not "
                      f"{tuple(t.shape)}")
    return t, dt


def shard_local_rows(local_rows, counts, key_dtype=None,
                     value_dtype=None) -> RankKV:
    """This rank's ``(keys, values)`` as its block of a frame over the
    process group (JAX ``shard_local_rows``): ``counts[P]`` is every
    rank's valid count, agreed by all; the block is padded with zeros to
    the common cap, on the rank's device.  Tensors may carry u64 as
    int64 bits: ``key_dtype``/``value_dtype`` name the logical dtype."""
    rt = _require_active()
    counts = np.asarray(counts, np.int64).reshape(-1)
    if counts.shape[0] != rt.world:
        raise MRError(f"shard_local_rows: {counts.shape[0]} counts for a "
                      f"world of {rt.world}")
    keys, values = local_rows
    k, kd = _place_rows(keys, rt.device, key_dtype)
    v, vd = _place_rows(values, rt.device, value_dtype)
    n = int(counts[rt.rank])
    if k.shape[0] != n or v.shape[0] != n:
        raise MRError(f"shard_local_rows: rank {rt.rank} holds "
                      f"{k.shape[0]} keys and {v.shape[0]} values, its "
                      f"count says {n}")
    cap = round_cap(int(counts.max()) if counts.size else 0)
    shard = ShardedKV(pad_rows(k, cap), pad_rows(v, cap),
                      np.array([n], np.int32), kd, vd)
    return RankKV(rt.rank, shard, counts.astype(np.int32))

