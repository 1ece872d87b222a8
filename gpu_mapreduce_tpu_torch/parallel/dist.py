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

``MRTPU_DIST_LOCAL_DEVICES = L`` gives each rank L shards: rank r holds
the shards ``r·L … r·L + L − 1`` of a ``(W, L)`` mesh, on the cards
``r·L + c`` when ``W·L`` cards are present (NCCL, one data group a
chip index), else on the shared cards ``(r·L + c) % cards`` (gloo).

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

Each rank also observes itself (:func:`_arm_observability`, the JAX
package's fleet observability): the launch's one trace id on every span,
a trace shard ``trace-r<rank>.jsonl`` and the flight recorder in the run
dir, the sync observer's arrival stamps at every guarded site and a
metrics dump ``metrics-r<rank>.json`` (``obs/fleetobs.py``), and the
``mrtpu_dist_*`` metrics.

A survivor leaves with ``os._exit(EXIT_PEER_LOST)``, never through
``destroy_process_group`` on a wedged communicator.  Torch's own
timeout is set past the watchdog's, so the watchdog always fires first.

The rank frame (:class:`RankKV`, :func:`shard_local_rows`) holds this
rank's blocks of a frame over the group, one a local shard;
``parallel/shuffle.exchange`` moves its rows across ranks
(:func:`all_to_all_rows`).
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
from ..utils.env import env_flag, env_knob, env_str
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
        try:
            from ..obs.metrics import get_registry
            get_registry().counter(
                "mrtpu_dist_heartbeats_total",
                "data-plane heartbeats written by this rank").inc()
        except Exception:
            pass

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
                 transport: str = "none", devices=None):
        self.rank = rank
        self.world = world
        self.rundir = rundir
        self.gen = gen
        if devices is None:
            devices = [device if device is not None else "cpu"]
        # this rank's shards' devices, one a local shard
        self.devices = [torch.device(d) for d in devices]
        self.device = self.devices[0]
        self.backend = backend          # the data group's: nccl | gloo
        self.transport = transport      # how tensors travel: nccl | gloo
        self.meta = None                # the gloo group for host metadata
        self.chip_groups = None         # L > 1: a data group a chip index
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
        # obs/fleetobs, armed by _arm_observability
        self.sync_obs = None
        self.metrics_dumper = None

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
        thread); on a trip that thread is abandoned mid-collective.

        The sync observer (``obs/fleetobs.SyncObserver``) stamps this
        rank's arrival before the collective and reads every peer's
        after it; observing a sync never fails it."""
        from ..ft.inject import fault_point
        fault_point(f"dist.{site}")
        if self.fenced():
            self._note_fenced(site)
            raise RankFencedError(self.rank, site)
        # the arrival stamp lands after fault_point (an injected delay is
        # in it) and before the collective
        obs, arec = self.sync_obs, None
        if obs is not None:
            try:
                arec = obs.arrive(site)
            except Exception:
                arec = None

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
                self._note_fenced(site)
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
        if arec is not None:
            try:
                obs.complete(site, arec)
            except Exception:
                pass
        return box[0]

    def _trip(self, site: str, dead: List[int], reason: str):
        err = PeerLostError(site, dead, reason)
        self.peer_lost = err
        try:
            from ..obs import get_tracer
            from ..obs.metrics import get_registry
            reg = get_registry()
            reg.counter(
                "mrtpu_dist_watchdog_trips_total",
                "collective watchdog trips (a sync point detected a "
                "dead/hung peer instead of stalling)", ("site",)
            ).inc(site=site)
            reg.counter(
                "mrtpu_dist_peer_lost_total",
                "peer ranks lost (as observed by this rank)"
            ).inc(max(1, len(dead)))
            with get_tracer().span("dist.peer_lost", cat="dist",
                                   site=site, rank=self.rank,
                                   dead=list(dead)):
                pass
        except Exception:
            pass
        raise err

    def _note_fenced(self, site: str):
        try:
            from ..obs.metrics import get_registry
            get_registry().counter(
                "mrtpu_dist_fenced_total",
                "sync points this rank declined because it was fenced "
                "(zombie double-execution guard)", ("site",)
            ).inc(site=site)
        except Exception:
            pass

    def stop(self, leave: bool = True) -> None:
        if self.metrics_dumper is not None:
            try:
                self.metrics_dumper.stop("exit")
            except Exception:
                pass
        if self.sync_obs is not None:
            try:
                self.sync_obs.close()
            except Exception:
                pass
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


def note_sync_rows(counts_mat) -> None:
    """Hand the sync observer the count matrix's per-destination row
    totals (its column sums): the data-skew half of the straggler
    verdict.  Under ``MRTPU_DIST_LOCAL_DEVICES`` the P = world × L shards
    fold onto their ranks (rank r holds shards r·L … r·L + L − 1).  A
    no-op outside the process group; never raises."""
    rt = _ACTIVE
    if rt is None or rt.sync_obs is None:
        return
    try:
        rows = [int(x) for x in counts_mat.sum(axis=0)]
        P = len(rows)
        if P != rt.world and rt.world > 0 and P % rt.world == 0:
            per = P // rt.world
            rows = [sum(rows[r * per:(r + 1) * per])
                    for r in range(rt.world)]
        rt.sync_obs.note_rows(rows)
    except Exception:
        pass


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
    """(device, backend, transport) of rank ``rank`` of ``world``, one
    shard a rank: see the module docstring.  ``want`` is ``"cpu"`` or
    empty."""
    devices, backend, transport = local_topology(rank, world, want, 1)
    return devices[0], backend, transport


def local_topology(rank: int, world: int, want: str = "",
                   nlocal: int = 1):
    """(devices, backend, transport) of rank ``rank`` of ``world`` when
    each rank holds ``nlocal`` shards: local shard c on card
    ``rank·nlocal + c`` (NCCL) when every shard owns a card, else on
    card ``(rank·nlocal + c) % cards`` (gloo); all on the CPU (gloo)
    for ``want == "cpu"``."""
    if want == "cpu":
        return [torch.device("cpu")] * nlocal, "gloo", "gloo"
    if want:
        raise MRError(f"MRTPU_DIST_DEVICE={want!r}: only 'cpu' (or unset, "
                      f"for the cards) is known")
    if not torch.cuda.is_available():
        raise MRError("no CUDA device for the process group; pass "
                      "--device cpu to run the ranks on the CPU")
    cards = torch.cuda.device_count()
    ids = [rank * nlocal + c for c in range(nlocal)]
    if world * nlocal <= cards:
        return [torch.device("cuda", i) for i in ids], "nccl", "nccl"
    # NCCL refuses two ranks on one card: ranks sharing a card use gloo
    return [torch.device("cuda", i % cards) for i in ids], "gloo", "gloo"


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
    nlocal = env_knob("MRTPU_DIST_LOCAL_DEVICES", int, 1)
    if nlocal < 1:
        raise MRError(f"MRTPU_DIST_LOCAL_DEVICES={nlocal}: a rank holds "
                      f"one shard at least")
    devices, backend, transport = local_topology(
        rank, world, env_str("MRTPU_DIST_DEVICE", ""), nlocal)
    rt = DistRuntime(rank, world, rundir, gen=gen, devices=devices,
                     backend=backend, transport=transport)
    if world > 1:
        # a shrunk-to-1 generation needs no process group
        import torch.distributed as dist
        if devices[0].type == "cuda":
            torch.cuda.set_device(devices[0])
        dist.init_process_group(backend, init_method=f"tcp://{coord}",
                                world_size=world, rank=rank,
                                timeout=rt.torch_timeout())
        rt.meta = dist.new_group(backend="gloo",
                                 timeout=rt.torch_timeout())
        if nlocal > 1:
            # chip index c's all-to-all runs between same-index peers,
            # each on its own card: one data group a chip index
            rt.chip_groups = [dist.new_group(backend=backend,
                                             timeout=rt.torch_timeout())
                              for _ in range(nlocal)]
    # arm MRTPU_FAULTS here: workers drive the collectives directly
    from ..ft.inject import configure_from_env
    configure_from_env()
    rt.heartbeat.start()
    activate(rt)
    try:
        from ..obs import get_tracer
        from ..obs.metrics import get_registry
        get_tracer().set_proc_attrs(rank=rank)
        reg = get_registry()
        reg.gauge("mrtpu_dist_world",
                  "process count of the active data plane").set(world)
        reg.gauge("mrtpu_dist_rank",
                  "this process's rank in the data plane").set(rank)
        reg.gauge("mrtpu_dist_gen",
                  "shrink generation of the active data plane (0 = "
                  "first launch)").set(gen)
    except Exception:
        pass
    _arm_observability(rt)
    return rt


def _arm_observability(rt: DistRuntime) -> None:
    """A rank's fleet observability (JAX :595-641): the launch's trace id
    (``MRTPU_DIST_TRACE_ID``) on every span, journal record and flight
    dump; this rank's trace shard ``<rundir>/trace-r<rank>.jsonl``
    (``MRTPU_DIST_TRACE``, default on); the flight recorder at the run
    dir unless ``MRTPU_FLIGHT`` says otherwise; the sync observer
    (``MRTPU_DIST_SYNC_OBS``) and the metrics dumps
    (``MRTPU_DIST_METRICS``).  Each piece is crash-proof on its own."""
    tid = env_str("MRTPU_DIST_TRACE_ID", "")
    if tid:
        try:
            from ..obs.context import set_process_trace_id
            set_process_trace_id(tid)
        except Exception:
            pass
    if env_flag("MRTPU_DIST_TRACE", True):
        try:
            from ..obs import get_tracer
            get_tracer().enable(jsonl=os.path.join(
                rt.rundir, f"trace-r{rt.rank}.jsonl"))
        except Exception:
            pass
    if env_str("MRTPU_FLIGHT", "") == "":
        # no explicit flight config: the recorder dumps into the run dir
        # (MRTPU_FLIGHT=0 still disables it)
        try:
            from ..obs import flight as _flight
            _flight.enable(dir=rt.rundir)
        except Exception:
            pass
    if env_flag("MRTPU_DIST_SYNC_OBS", True):
        try:
            from ..obs.fleetobs import SyncObserver
            rt.sync_obs = SyncObserver(rt.rundir, rt.rank, rt.world,
                                       gen=rt.gen)
        except Exception:
            rt.sync_obs = None
    if env_flag("MRTPU_DIST_METRICS", True):
        try:
            from ..obs.fleetobs import RankMetricsDumper
            rt.metrics_dumper = RankMetricsDumper(rt.rundir, rt.rank,
                                                  gen=rt.gen)
            rt.metrics_dumper.start()
        except Exception:
            rt.metrics_dumper = None


def guard_call(site: str, fn: Callable, *args, **kwargs):
    """``fn`` under the watchdog when a process group is active, a direct
    call otherwise."""
    rt = _ACTIVE
    if rt is None:
        return fn(*args, **kwargs)
    return rt.guard(site, fn, *args, **kwargs)


def surviving_width() -> Optional[int]:
    """The width after a shrink: the active runtime's world, or the
    operator-set ``MRTPU_DIST_WIDTH_CAP`` (how a serve daemon that is
    not itself a rank learns of a shrink).  None = uncapped."""
    rt = _ACTIVE
    if rt is not None:
        return rt.world
    cap = env_knob("MRTPU_DIST_WIDTH_CAP", int, 0)
    return cap if cap > 0 else None


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


def all_to_all_rows(blocks, counts_mat: np.ndarray, cap_out: int) -> list:
    """This rank's local blocks ``[(keys, values), ...]`` (each local
    shard's rows sorted by destination, on its device) to their
    destination shards over a ``(world, L)`` mesh of ``P = world·L``
    shards (``counts_mat`` ``[P, P]``): for each chip index c, local
    copies first gather every local block's rows for the shards
    ``(r', c)`` on local shard c, then one ``all_to_all_single`` a
    column moves them between the ranks' shards of index c.  Each
    destination's rows are laid out by source rank, then by the
    source's local index (the flat source order), in ``cap_out`` rows
    padded with zeros.  Returns the L ``(keys, values)`` blocks once the
    rows have arrived."""
    rt = _require_active()
    W, L, r = rt.world, len(blocks), rt.rank
    src_off = np.concatenate([np.zeros((W * L, 1), np.int64),
                              np.cumsum(counts_mat, axis=1)], axis=1)
    srcs = [r * L + l for l in range(L)]
    outs = []
    for c in range(L):
        dests = [rr * L + c for rr in range(W)]
        send = [int(counts_mat[srcs, dd].sum()) for dd in dests]
        recv = [int(counts_mat[rr * L:(rr + 1) * L, r * L + c].sum())
                for rr in range(W)]
        n = int(sum(recv))
        dev = rt.devices[c]
        out = []
        for j in range(2):
            if L == 1:
                stage = blocks[0][j].contiguous()
            else:       # the hop inside the rank, to local shard c
                stage = _gather_rows(
                    [(blocks[l][j], int(src_off[s, dd]),
                      int(counts_mat[s, dd]))
                     for dd in dests for l, s in enumerate(srcs)], dev)
            t = stage.new_zeros((cap_out,) + tuple(stage.shape[1:]))
            if W == 1:
                t[:n] = stage[:n]
            else:
                import torch.distributed as dist
                group = rt.chip_groups[c] if rt.chip_groups else None
                # rows travel as their bytes: gloo has no int16 (a
                # uint16 wire pack)
                dist.all_to_all_single(_row_bytes(t)[:n],
                                       _row_bytes(stage), recv, send,
                                       group=group)
            out.append(t)
        outs.append(tuple(out))
    for dev in set(rt.devices):
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    return outs


def _row_bytes(t: torch.Tensor) -> torch.Tensor:
    """A contiguous ``[n, ...]`` tensor's rows as ``[n, rowbytes]`` uint8,
    sharing its memory."""
    rowbytes = t.element_size() * int(np.prod(t.shape[1:], dtype=np.int64))
    return t.view(torch.uint8).reshape(t.shape[0], rowbytes)


def _gather_rows(parts, device) -> torch.Tensor:
    """``(tensor, start, n)`` slices joined in order on ``device``."""
    t0 = parts[0][0]
    total = sum(n for _, _, n in parts)
    out = torch.empty((total,) + tuple(t0.shape[1:]), dtype=t0.dtype,
                      device=device)
    at = 0
    for t, lo, n in parts:
        if n:
            out[at:at + n].copy_(t[lo:lo + n], non_blocking=True)
            at += n
    return out


# ---------------------------------------------------------------------------
# the rank frame
# ---------------------------------------------------------------------------

@dataclass
class RankKV:
    """This rank's blocks of a KV frame over the process group: ``shards``
    holds the rank's L local shards (flat ids ``rank·L … rank·L + L −
    1``), each at the global cap (``round_cap`` of the largest count) on
    its device, and ``counts[P]`` every shard's valid count, agreed by
    all.  Local shard l is the one-controller mesh frame's shard
    ``rank·L + l``, held by the process that owns it."""

    rank: int
    shards: List[ShardedKV]
    counts: np.ndarray
    exchange_stats: object = field(default=None, compare=False)
    sync_seconds: dict = field(default=None, compare=False)

    @property
    def nprocs(self) -> int:
        return int(self.counts.shape[0])

    @property
    def nlocal(self) -> int:
        return len(self.shards)

    @property
    def shard_ids(self) -> range:
        L = self.nlocal
        return range(self.rank * L, (self.rank + 1) * L)

    @property
    def shard(self) -> ShardedKV:
        """The rank's one block (a rank holding one shard)."""
        if self.nlocal != 1:
            raise MRError(f"rank {self.rank} holds {self.nlocal} shards; "
                          f"read them from .shards")
        return self.shards[0]

    @property
    def cap(self) -> int:
        return self.shards[0].cap

    @property
    def device(self) -> torch.device:
        return self.shards[0].device

    @property
    def key_dtype(self):
        return self.shards[0].key_dtype

    @property
    def value_dtype(self):
        return self.shards[0].value_dtype

    @property
    def key_decode(self):
        return self.shards[0].key_decode

    @property
    def value_decode(self):
        return self.shards[0].value_decode

    def __len__(self) -> int:
        return int(self.counts.sum())

    def shard_to_host(self, p: int) -> KVFrame:
        """Host KVFrame of local shard p's valid rows; another rank's
        shard lives in another process."""
        if p not in self.shard_ids:
            owner = p // self.nlocal
            raise MRError(f"shard {p} of a rank frame lives on rank "
                          f"{owner}; this is rank {self.rank}")
        return self.shards[p - self.shard_ids.start].to_host()

    def valid_rows(self):
        """This rank's valid (key, value) rows on its first device, local
        shards in order."""
        if self.nlocal == 1:
            return self.shards[0].valid_rows()
        rows = [s.valid_rows() for s in self.shards]
        return tuple(torch.cat([r[c].to(self.device) for r in rows])
                     for c in (0, 1))

    def __repr__(self):
        if self.nlocal == 1:
            return (f"RankKV(rank={self.rank}, cap={self.cap}, "
                    f"counts={self.counts.tolist()}, device={self.device})")
        return (f"RankKV(rank={self.rank}, shards={list(self.shard_ids)}, "
                f"cap={self.cap}, counts={self.counts.tolist()}, "
                f"devices={[str(s.device) for s in self.shards]})")


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
    """This rank's rows as its blocks of a frame over the process group
    (JAX ``shard_local_rows``): ``local_rows`` is a list of ``(keys,
    values)`` blocks, one a local shard in shard order (a rank holding
    one shard may pass the pair itself); ``counts[P]`` is every shard's
    valid count, agreed by all.  Each block is padded with zeros to the
    common cap, on its shard's device.  Tensors may carry u64 as int64
    bits: ``key_dtype``/``value_dtype`` name the logical dtype."""
    rt = _require_active()
    L = len(rt.devices)
    blocks = local_rows if isinstance(local_rows, list) else [local_rows]
    counts = np.asarray(counts, np.int64).reshape(-1)
    if counts.shape[0] != rt.world * L:
        raise MRError(f"shard_local_rows: {counts.shape[0]} counts for "
                      f"{rt.world} rank(s) of {L} shard(s)")
    if len(blocks) != L:
        raise MRError(f"shard_local_rows: {len(blocks)} local blocks for "
                      f"{L} local shard(s)")
    cap = round_cap(int(counts.max()) if counts.size else 0)
    shards = []
    for l, ((keys, values), dev) in enumerate(zip(blocks, rt.devices)):
        k, kd = _place_rows(keys, dev, key_dtype)
        v, vd = _place_rows(values, dev, value_dtype)
        p = rt.rank * L + l
        n = int(counts[p])
        if k.shape[0] != n or v.shape[0] != n:
            raise MRError(f"shard_local_rows: shard {p} of rank {rt.rank} "
                          f"holds {k.shape[0]} keys and {v.shape[0]} "
                          f"values, its count says {n}")
        shards.append(ShardedKV(pad_rows(k, cap), pad_rows(v, cap),
                                np.array([n], np.int32), kd, vd))
    return RankKV(rt.rank, shards, counts.astype(np.int32))
