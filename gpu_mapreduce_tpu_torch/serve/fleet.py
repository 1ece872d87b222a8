"""Fleet membership: heartbeat leases, epoch fencing, journal claims
(the port of ``gpu_mapreduce_tpu/serve/fleet.py``).

N replicas serve one fleet with nothing shared but a directory:

* **leases** — every replica heartbeats an fsync'd lease file under
  ``<fleet>/fleet/`` (``<rid>.lease.json``: epoch, port, state dir,
  readiness state, expiry, pid).  A replica whose lease passes its
  expiry (plus a clock-skew margin, ``MRTPU_FLEET_SKEW``) is presumed
  dead; writes are tmp + fsync + rename so a reader never sees a torn
  lease.
* **epochs** — a replica joins at ``max(every epoch in the fleet
  dir) + 1``.  Epochs totally order membership events, which makes
  fencing a comparison instead of a guess.
* **claims** — a survivor that observes an expired lease takes over the
  dead peer's journal by creating ``<rid>.claim-<gen>.json`` with
  ``O_CREAT|O_EXCL``: the filesystem arbitrates the race, exactly one
  survivor wins, every loser's replay is a no-op.  The claim carries
  the claimant's (strictly newer) epoch; a paused-then-revived replica
  sees a claim with ``epoch > its own`` and must not execute any
  session it accepted before the claim (``fenced()``).  A claimant that
  itself dies mid-takeover leaves a claim without its ``done`` flag;
  once the CLAIMANT's lease expires too, another survivor may supersede
  with the next generation (again ``O_EXCL``).
* **ring** — session routing hashes over the healthy replicas with a
  vnode consistent-hash ring, so one replica's death remaps only its
  own arc (serve/router.py).

The files are the JAX package's byte for byte, so either package's
``FleetMember`` reads the other's leases and claims.  Nothing here
touches the card: the router (an observer member) holds no CUDA
context.
"""

from __future__ import annotations

import hashlib
import json
import os
import threading
import time
from typing import Dict, List, Optional, Tuple

from ..core.errors import MRError
from ..utils.env import env_knob

_LEASE_SUF = ".lease.json"
_CLAIM_MID = ".claim-"


def _atomic_write(path: str, obj: dict) -> None:
    """tmp + fsync + rename + parent-dir fsync (utils/fsio) — a crash
    mid-heartbeat can tear only the ``.tmp``, never the lease a peer's
    expiry decision reads, and a crash after the rename cannot lose the
    directory entry either."""
    from ..utils.fsio import atomic_write_json
    atomic_write_json(path, obj)


def _read_json(path: str) -> Optional[dict]:
    from ..utils.fsio import read_json
    return read_json(path)


def ring_hash(key: str) -> int:
    """Stable cross-process hash (Python's ``hash`` is salted)."""
    return int(hashlib.sha1(key.encode()).hexdigest()[:15], 16)


# the sorted vnode point lists, keyed by (rids, vnodes): membership
# changes only on join/leave/expiry, so the per-submission hot path is
# one SHA1 + a bisect instead of rebuilding N×vnodes hashes per request
_RING_CACHE: Dict[Tuple, List[Tuple[int, str]]] = {}
_RING_LOCK = threading.Lock()


def ring_route(key: str, rids: List[str],
               vnodes: Optional[int] = None) -> Optional[str]:
    """Consistent-hash ``key`` onto one of ``rids``: each replica owns
    ``vnodes`` points on a circle, the key lands on the first point at
    or past its own hash.  A replica leaving remaps only the arcs it
    owned — warm sessions and result affinity on the survivors stay
    put."""
    if not rids:
        return None
    v = max(1, vnodes if vnodes is not None
            else env_knob("MRTPU_FLEET_VNODES", int, 64))
    ck = (tuple(rids), v)
    with _RING_LOCK:
        points = _RING_CACHE.get(ck)
    if points is None:
        points = sorted((ring_hash(f"{rid}#{i}"), rid)
                        for rid in rids for i in range(v))
        with _RING_LOCK:
            if len(_RING_CACHE) >= 64:      # churny fleets stay bounded
                _RING_CACHE.clear()
            _RING_CACHE[ck] = points
    h = ring_hash(key)
    import bisect
    i = bisect.bisect_left(points, (h, ""))
    return points[i % len(points)][1]


def owner_of(sid: str) -> Optional[str]:
    """The replica a fleet session id names (``<rid>.s<seq>``), or
    None for a single-daemon sid (``s<seq>``)."""
    if "." not in sid:
        return None
    return sid.rsplit(".", 1)[0]


class FleetMember:
    """One replica's membership handle: join/heartbeat/leave its own
    lease, observe peers, claim the dead.  All methods are safe to call
    from the daemon's fleet thread plus its workers (reads are lock-free
    file reads; the only mutation races — claim creation — are settled
    by ``O_EXCL``)."""

    def __init__(self, root: str, rid: str, *,
                 heartbeat_s: Optional[float] = None,
                 lease_s: Optional[float] = None,
                 skew_s: Optional[float] = None):
        if not rid or any(c in rid for c in "./\\ \t\n"):
            raise MRError(f"fleet replica id {rid!r} must be a plain "
                          f"name (no '.', path separators or spaces — "
                          f"it prefixes session ids and names files)")
        self.root = root
        self.dir = os.path.join(root, "fleet")
        os.makedirs(self.dir, exist_ok=True)
        self.rid = rid
        self.heartbeat_s = heartbeat_s if heartbeat_s is not None \
            else env_knob("MRTPU_FLEET_HEARTBEAT", float, 1.0)
        self.lease_s = lease_s if lease_s is not None \
            else env_knob("MRTPU_FLEET_LEASE", float, 5.0)
        self.skew_s = skew_s if skew_s is not None \
            else env_knob("MRTPU_FLEET_SKEW", float, 1.0)
        self.epoch = 0
        self._meta: dict = {}
        self._last_renew = 0.0

    # -- paths -------------------------------------------------------------
    def lease_path(self, rid: str) -> str:
        return os.path.join(self.dir, rid + _LEASE_SUF)

    def claim_path(self, rid: str, gen: int) -> str:
        return os.path.join(self.dir, f"{rid}{_CLAIM_MID}{gen:04d}.json")

    # -- membership --------------------------------------------------------
    def _next_epoch(self) -> int:
        """Strictly newer than every epoch any lease or claim in the
        fleet dir has ever recorded."""
        top = 0
        for name in self._listdir():
            if name.endswith(".json"):
                rec = _read_json(os.path.join(self.dir, name))
                if rec:
                    try:
                        top = max(top, int(rec.get("epoch", 0)))
                    except (TypeError, ValueError):
                        pass
        return max(top, self.epoch) + 1

    def _listdir(self) -> List[str]:
        try:
            return os.listdir(self.dir)
        except OSError:
            return []

    def join(self, port: int, state_dir: str, state: str = "ready") -> int:
        """Write our first lease; returns the epoch we joined at."""
        self.epoch = self._next_epoch()
        self._meta = {"port": int(port), "pid": os.getpid(),
                      "state_dir": os.path.abspath(state_dir)}
        self.renew(state=state)
        return self.epoch

    def renew(self, state: str = "ready") -> bool:
        """Heartbeat: extend our lease ``lease_s`` into the future.
        Returns False when we are fenced (the lease is still written —
        a fenced replica stays observable — but the caller must stop
        executing claimed work)."""
        now = time.time()
        _atomic_write(self.lease_path(self.rid), {
            "rid": self.rid, "epoch": self.epoch, "state": state,
            "ts": now, "ttl": self.lease_s, "expires": now + self.lease_s,
            **self._meta})
        self._last_renew = now
        return not self.fenced()

    def self_expired(self, now: Optional[float] = None) -> bool:
        """Our OWN lease judged by our OWN clock, with NO skew
        allowance: the executing side of the lease discipline.  Peers
        wait ``skew_s`` past our published expiry before claiming; we
        stop starting work the moment we can no longer prove the lease
        is ours — the two margins can't both be wrong at once."""
        now = time.time() if now is None else now
        return now > self._last_renew + self.lease_s

    def leave(self) -> None:
        """Graceful exit: drop the lease so peers never see an expiry
        (a clean shutdown is not a failure — nothing to claim)."""
        try:
            os.remove(self.lease_path(self.rid))
        except OSError:
            pass

    # -- observation -------------------------------------------------------
    def lease(self, rid: str) -> Optional[dict]:
        return _read_json(self.lease_path(rid))

    def peers(self) -> Dict[str, dict]:
        """Every lease in the fleet dir (including our own)."""
        out: Dict[str, dict] = {}
        for name in self._listdir():
            if name.endswith(_LEASE_SUF):
                rec = _read_json(os.path.join(self.dir, name))
                if rec and rec.get("rid"):
                    out[rec["rid"]] = rec
        return out

    def expired(self, lease: dict, now: Optional[float] = None) -> bool:
        """Expiry with skew tolerance: a lease is only DEAD once past
        ``expires + skew_s`` — two hosts' clocks disagreeing by less
        than the margin can never fail over a live replica."""
        now = time.time() if now is None else now
        try:
            return now > float(lease["expires"]) + self.skew_s
        except (KeyError, TypeError, ValueError):
            return True        # an unreadable lease protects nobody

    def replica_state(self, rid: str, lease: Optional[dict] = None,
                      now: Optional[float] = None) -> str:
        """ready | draining | expired | fenced — the router's (and the
        ``mrtpu_fleet_replicas`` gauge's) view of one replica."""
        lease = self.lease(rid) if lease is None else lease
        if lease is None:
            return "expired"
        cur = self.current_claim(rid)
        if cur is not None and self._claim_fences(cur[1], lease):
            return "fenced"
        if self.expired(lease, now):
            return "expired"
        return str(lease.get("state", "ready"))

    def healthy(self, now: Optional[float] = None) -> List[str]:
        """Replica ids routable right now: live lease, ``ready`` state,
        not fenced — sorted for a deterministic ring."""
        return sorted(rid for rid, lease in self.peers().items()
                      if self.replica_state(rid, lease, now) == "ready")

    # -- claims (journal takeover) -----------------------------------------
    def claims(self, rid: str) -> List[Tuple[int, dict]]:
        out = []
        prefix = rid + _CLAIM_MID
        for name in self._listdir():
            if name.startswith(prefix) and name.endswith(".json"):
                try:
                    gen = int(name[len(prefix):-len(".json")])
                except ValueError:
                    continue
                rec = _read_json(os.path.join(self.dir, name))
                # an existing-but-unreadable claim still FENCES (it
                # was mid-write a moment ago; treat as pending)
                out.append((gen, rec if rec is not None else {}))
        return sorted(out)

    def current_claim(self, rid: str) -> Optional[Tuple[int, dict]]:
        cs = self.claims(rid)
        return cs[-1] if cs else None

    def _claim_fences(self, claim: dict, lease: dict) -> bool:
        """A claim fences the lease it names when its epoch is strictly
        newer — a replica that REJOINED after being claimed (new epoch)
        carries newer work the old claim does not cover."""
        try:
            return int(claim.get("epoch", 1 << 62)) > \
                int(lease.get("epoch", 0))
        except (TypeError, ValueError):
            return True

    def fenced(self) -> bool:
        """Whether a peer has claimed OUR journal at a newer epoch: if
        so, every session we accepted before the claim belongs to the
        claimant and we must not execute it (the revived-replica
        double-execution guard)."""
        cur = self.current_claim(self.rid)
        if cur is None:
            return False
        lease = self.lease(self.rid) or {"epoch": self.epoch}
        return self._claim_fences(cur[1], lease)

    def claim(self, dead_rid: str) -> Optional[dict]:
        """Try to take over ``dead_rid``'s journal.  Returns the claim
        record when WE hold the claim (fresh win, or resuming our own
        unfinished takeover after a restart), None when a peer does —
        the loser of the race treats None as "someone else's replay".

        Supersede: a claim whose ``done`` flag never landed and whose
        claimant's own lease has since expired is a takeover that died
        mid-flight — the next generation is up for grabs (``O_EXCL``
        again, so every transition has exactly one winner)."""
        cur = self.current_claim(dead_rid)
        gen = 0
        if cur is not None:
            cgen, crec = cur
            if crec.get("by") == self.rid and not crec.get("done"):
                return {**crec, "gen": cgen}      # finish our own
            if crec.get("done"):
                # the previous takeover COMPLETED; a new claim means
                # the replica rejoined (newer epoch) and died again —
                # its post-rejoin work needs the next generation
                gen = cgen + 1
            else:
                claimant = crec.get("by")
                lease = self.lease(claimant) if claimant else None
                if lease is not None and not self.expired(lease):
                    return None                   # takeover in flight
                gen = cgen + 1
        rec = {"claimed": dead_rid, "by": self.rid,
               "epoch": self._next_epoch(), "gen": gen,
               "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime())}
        path = self.claim_path(dead_rid, gen)
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return None                           # lost the race
        try:
            os.write(fd, json.dumps(rec).encode())
            os.fsync(fd)
        finally:
            os.close(fd)
        # the claim's EXISTENCE is the fence — make the directory entry
        # durable before acting on the takeover (utils/fsio discipline)
        from ..utils.fsio import fsync_dir
        fsync_dir(self.dir)
        return rec

    def claim_done(self, dead_rid: str, gen: int) -> None:
        """Mark a takeover complete: the claimed sessions are durably
        re-journaled under the claimant, so the claim can never be
        superseded again."""
        rec = _read_json(self.claim_path(dead_rid, gen)) or {}
        _atomic_write(self.claim_path(dead_rid, gen),
                      {**rec, "done": True})
        # retire the dead lease: the replica is no longer a member, so
        # the monitor stops seeing an eternally-expired peer.  Only the
        # OLD lease goes — a replica that already REJOINED (epoch newer
        # than the claim) keeps its fresh lease untouched
        lease = self.lease(dead_rid)
        try:
            if lease is not None and \
                    int(lease.get("epoch", 0)) <= int(rec.get(
                        "epoch", 0)):
                os.remove(self.lease_path(dead_rid))
        except (OSError, TypeError, ValueError):
            pass

# ---------------------------------------------------------------------------
# fleet metrics: one collector per process, scanning every enabled root
# ---------------------------------------------------------------------------

_ROOTS: Dict[str, FleetMember] = {}
_ROOTS_LOCK = threading.Lock()


def enable_fleet_metrics(member: FleetMember) -> None:
    """Register (once) the scrape-time collector refreshing
    ``mrtpu_fleet_replicas{state}`` from the fleet dir — the router and
    every replica call this, so whichever process an operator scrapes
    reports the same membership truth."""
    from ..obs.metrics import get_registry
    with _ROOTS_LOCK:
        _ROOTS[os.path.abspath(member.root)] = member
    get_registry().register_collector(_collect_fleet)


def _collect_fleet(reg) -> None:
    with _ROOTS_LOCK:
        members = list(_ROOTS.values())
    g = reg.gauge("mrtpu_fleet_replicas",
                  "fleet replicas by membership state "
                  "(ready/draining/expired/fenced)", ("state",))
    counts = {"ready": 0, "draining": 0, "expired": 0, "fenced": 0}
    for m in members:
        for rid, lease in m.peers().items():
            st = m.replica_state(rid, lease)
            counts[st] = counts.get(st, 0) + 1
    for state, n in counts.items():
        g.set(n, state=state)


def note_failover(seconds: float) -> None:
    """One completed journal takeover: count + duration histogram (the
    adopted-session count rides the ``fleet.failover`` span)."""
    try:
        from ..obs.metrics import get_registry
        reg = get_registry()
        reg.counter("mrtpu_fleet_failovers_total",
                    "journal takeovers completed (a survivor claimed "
                    "and replayed a dead replica's sessions)").inc()
        reg.histogram("mrtpu_fleet_failover_seconds",
                      "expired-lease observation to takeover complete"
                      ).observe(float(seconds))
    except Exception:
        pass


def note_fenced_drop(rid: str) -> None:
    """A fenced replica declined to execute a claimed session — the
    no-op that proves double execution cannot happen."""
    try:
        from ..obs.metrics import get_registry
        get_registry().counter(
            "mrtpu_fleet_fenced_total",
            "sessions a fenced (claimed) replica declined to execute",
            ("rid",)).inc(rid=rid)
    except Exception:
        pass
