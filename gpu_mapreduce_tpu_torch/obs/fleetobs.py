"""Fleet-wide observability (the port's copy of
``gpu_mapreduce_tpu/obs/fleetobs.py``, with ``scripts/trace_view.py``'s
``read_trace_dir``): sync-point straggler attribution, the per-rank
metrics dump channel, and the ``{replica,rank}`` federation renderer.

* :class:`SyncObserver` — each rank appends ``{"site","seq","rank",
  "ts","rows"}`` to ``<rundir>/hb-g<gen>/rank<k>.sync.jsonl`` before
  entering a guarded collective; when the collective returns every
  peer's stamp is on disk, so each rank computes the sync's arrival
  spread, slowest rank and cause (``data_skew`` when the slowest rank's
  routed rows pass ``MRTPU_DIST_SKEW_RATIO`` × the mean, else
  ``host_slow``) with no extra collective.
* :class:`RankMetricsDumper` — ``<rundir>/metrics-r<rank>.json``
  rewritten every ``MRTPU_DIST_METRICS_SECS`` and at exit.
* :func:`federate_text`, :func:`read_rank_dumps`, :func:`member_row`,
  :func:`rank_dump_stale` — the fleet table's pieces.
* :func:`read_trace_dir` — a run dir's ``trace-r<k>.jsonl`` shards as
  one stream on one clock.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Dict, List, Optional

from ..utils.env import env_knob

# mirror of parallel/dist.py's per-generation heartbeat dir layout
# (obs/ must not import parallel/ at module level); the sync shards
# live beside the lease files they are judged with
_HB_DIR = "hb-g"
_SYNC_SUF = ".sync.jsonl"
_METRICS_PAT = "metrics-r{rank}.json"


def sync_path(rundir: str, rank: int, gen: int = 0) -> str:
    return os.path.join(rundir, f"{_HB_DIR}{gen}",
                        f"rank{rank}{_SYNC_SUF}")


def rank_metrics_path(rundir: str, rank: int) -> str:
    return os.path.join(rundir, _METRICS_PAT.format(rank=rank))


def classify_straggler(slowest: int, rows_by_rank
                       ) -> str:
    """``data_skew`` when the slowest rank's routed rows exceed
    ``MRTPU_DIST_SKEW_RATIO`` x the mean per-rank rows (the count
    matrix says the imbalance was the DATA's fault), else
    ``host_slow`` (same rows, late anyway: CPU steal, page cache,
    a sick host — the half the autoscaler cannot fix by resharding)."""
    if not rows_by_rank or slowest >= len(rows_by_rank):
        return "host_slow"
    mean = sum(rows_by_rank) / len(rows_by_rank)
    if mean <= 0:
        return "host_slow"
    ratio = env_knob("MRTPU_DIST_SKEW_RATIO", float, 2.0)
    return "data_skew" if rows_by_rank[slowest] >= ratio * mean \
        else "host_slow"


class SyncObserver:
    """One rank's sync-site instrumentation (armed from
    ``parallel/dist.DistRuntime`` when ``MRTPU_DIST_SYNC_OBS`` is on).
    Every method is crash-proof at the call site (dist.guard wraps in
    try/except): observing a sync must never fail it."""

    def __init__(self, rundir: str, rank: int, world: int, gen: int = 0):
        self.rundir = rundir
        self.rank = rank
        self.world = world
        self.gen = gen
        self.path = sync_path(rundir, rank, gen)
        self.spread_flight_s = env_knob("MRTPU_DIST_SPREAD_FLIGHT",
                                        float, 0.0)
        self._lock = threading.Lock()
        self._f = None
        self._seq: Dict[str, int] = {}
        self._rows: Optional[List[int]] = None
        # incremental peer tails: byte offset + (rank, site, seq) → ts
        self._offsets: Dict[int, int] = {}
        self._peer_index: Dict[tuple, float] = {}
        self._flight_dumped: set = set()

    # -- feed --------------------------------------------------------------
    def note_rows(self, rows_by_rank) -> None:
        """Last known per-rank routed row counts (the shuffle count
        matrix's destination sums) — the data-skew evidence."""
        with self._lock:
            self._rows = [int(x) for x in rows_by_rank]

    # -- the two guard hooks ----------------------------------------------
    def arrive(self, site: str) -> dict:
        """Stamp this rank's arrival at ``site`` (durable BEFORE the
        collective blocks) and return the record ``complete`` needs."""
        with self._lock:
            seq = self._seq.get(site, 0)
            self._seq[site] = seq + 1
            rec = {"site": site, "seq": seq, "rank": self.rank,
                   "ts": time.time()}
            if self._rows is not None and self.rank < len(self._rows):
                rec["rows"] = self._rows[self.rank]
            self._append(rec)
        return rec

    def complete(self, site: str, rec: dict) -> Optional[dict]:
        """The sync returned on this rank: read every peer's arrival
        stamp for (site, seq) — all durable, since the collective could
        not have completed otherwise — and report spread / slowest /
        cause.  Returns the spread record (None when no peer stamp was
        found, e.g. a site that is not a true all-ranks collective)."""
        now = time.time()
        seq = int(rec["seq"])
        with self._lock:
            arrivals = {self.rank: float(rec["ts"])}
            for r in range(self.world):
                if r == self.rank:
                    continue
                ts = self._lookup(r, site, seq)
                if ts is not None:
                    arrivals[r] = ts
            rows = list(self._rows) if self._rows else []
        if len(arrivals) < 2:
            return None
        first = min(arrivals.values())
        slowest = max(arrivals, key=lambda r: arrivals[r])
        spread = arrivals[slowest] - first
        cause = classify_straggler(slowest, rows)
        out = {"kind": "spread", "site": site, "seq": seq,
               "spread_s": round(spread, 6), "slowest": slowest,
               "cause": cause, "ranks_seen": len(arrivals),
               "wall_s": round(now - float(rec["ts"]), 6),
               "arrivals": {str(r): round(ts - first, 6)
                            for r, ts in sorted(arrivals.items())}}
        with self._lock:
            self._append(out)
        self._report(site, spread, slowest, cause, len(arrivals))
        return out

    # -- reporting ---------------------------------------------------------
    def _report(self, site: str, spread: float, slowest: int,
                cause: str, seen: int) -> None:
        try:
            from .metrics import get_registry
            reg = get_registry()
            reg.histogram(
                "mrtpu_dist_sync_spread_seconds",
                "per-sync arrival spread across ranks (last arrival "
                "minus first) at each guarded collective site",
                ("site",)).observe(spread, site=site)
            reg.counter(
                "mrtpu_dist_sync_total",
                "guarded collective syncs observed with full per-rank "
                "arrival evidence", ("site",)).inc(site=site)
            reg.gauge(
                "mrtpu_dist_sync_slowest_rank",
                "last rank to arrive at the most recent sync of each "
                "site", ("site",)).set(slowest, site=site)
            if spread >= env_knob("MRTPU_DIST_SPREAD_WARN",
                                  float, 0.25):
                reg.counter(
                    "mrtpu_dist_sync_straggler_total",
                    "syncs whose arrival spread crossed "
                    "MRTPU_DIST_SPREAD_WARN, by attributed cause "
                    "(data_skew vs host_slow)", ("site", "cause")
                ).inc(site=site, cause=cause)
        except Exception:
            pass
        try:
            from .context import note_sync
            note_sync(site, spread, slowest, cause, seen)
        except Exception:
            pass
        if self.spread_flight_s > 0 and spread >= self.spread_flight_s \
                and site not in self._flight_dumped:
            self._flight_dumped.add(site)
            try:
                from . import flight as _flight
                rec = _flight.get()
                if rec is not None:
                    rec.dump(f"sync_spread:{site}")
            except Exception:
                pass

    # -- internals ---------------------------------------------------------
    def _append(self, rec: dict) -> None:
        if self._f is None:
            os.makedirs(os.path.dirname(self.path), exist_ok=True)
            # every caller (arrive/complete) already holds self._lock;
            # the Lock is non-reentrant so this helper cannot take it
            self._f = open(self.path, "ab")
        self._f.write(json.dumps(rec).encode() + b"\n")
        self._f.flush()          # same-host visibility; no fsync — the
        #                          record matters for attribution, not
        #                          durability across power loss

    def _lookup(self, r: int, site: str, seq: int) -> Optional[float]:
        key = (r, site, seq)
        ts = self._peer_index.get(key)
        if ts is None:
            self._ingest_peer(r)
            ts = self._peer_index.get(key)
        return ts

    def _ingest_peer(self, r: int) -> None:
        """Tail-read peer ``r``'s sync shard from the last offset; only
        complete lines are consumed (a peer may be mid-append)."""
        path = sync_path(self.rundir, r, self.gen)
        try:
            with open(path, "rb") as f:
                f.seek(self._offsets.get(r, 0))
                data = f.read()
        except OSError:
            return
        end = data.rfind(b"\n") + 1
        if not end:
            return
        self._offsets[r] = self._offsets.get(r, 0) + end
        for line in data[:end].splitlines():
            try:
                rec = json.loads(line)
            except ValueError:
                continue
            if rec.get("kind") == "spread":
                continue
            try:
                self._peer_index[(int(rec["rank"]), str(rec["site"]),
                                  int(rec["seq"]))] = float(rec["ts"])
            except (KeyError, TypeError, ValueError):
                continue

    def close(self) -> None:
        with self._lock:
            if self._f is not None:
                try:
                    self._f.close()
                except OSError:
                    pass
                self._f = None


def read_sync_records(rundir: str) -> List[dict]:
    """Every rank's sync records across all generations of a run dir —
    the offline merge of a run's sync points."""
    out: List[dict] = []
    try:
        gens = sorted(d for d in os.listdir(rundir)
                      if d.startswith(_HB_DIR))
    except OSError:
        return out
    for g in gens:
        gdir = os.path.join(rundir, g)
        try:
            shards = sorted(f for f in os.listdir(gdir)
                            if f.endswith(_SYNC_SUF))
        except OSError:
            continue
        for shard in shards:
            try:
                with open(os.path.join(gdir, shard), "rb") as f:
                    for line in f:
                        try:
                            rec = json.loads(line)
                        except ValueError:
                            continue
                        rec["gen"] = g
                        out.append(rec)
            except OSError:
                continue
    return out


# ---------------------------------------------------------------------------
# the per-rank metrics dump channel
# ---------------------------------------------------------------------------

class RankMetricsDumper(threading.Thread):
    """Daemon thread atomically rewriting
    ``<rundir>/metrics-r<rank>.json`` with the full registry snapshot
    every ``every_s`` — plus :meth:`dump_once` at exit/PeerLost.  The
    file (not a socket) is the channel on purpose: a SIGKILLed rank's
    last cadence dump survives it, which is what lets the federation
    route mark the rank stale instead of losing it."""

    def __init__(self, rundir: str, rank: int, gen: int = 0,
                 every_s: Optional[float] = None):
        super().__init__(daemon=True,
                         name=f"mrtpu-dist-metrics-r{rank}")
        self.rundir = rundir
        self.rank = rank
        self.gen = gen
        self.every_s = every_s if every_s is not None else \
            env_knob("MRTPU_DIST_METRICS_SECS", float, 5.0)
        self.every_s = max(0.25, float(self.every_s))
        self._stop = threading.Event()

    def run(self) -> None:
        self.dump_once("start")   # a dump exists before the first sync
        while not self._stop.wait(self.every_s):
            self.dump_once("cadence")

    def dump_once(self, reason: str = "cadence") -> Optional[str]:
        """One atomic dump; never raises (a full disk must not fail the
        rank it observes).  Returns the path (None on failure)."""
        try:
            from ..utils.fsio import atomic_write_json
            from .context import current_trace_id
            from .metrics import snapshot
            path = rank_metrics_path(self.rundir, self.rank)
            atomic_write_json(path, {
                "rank": self.rank, "gen": self.gen, "pid": os.getpid(),
                "ts": time.time(),
                "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                     time.gmtime()),
                "every_s": self.every_s, "reason": reason,
                "trace_id": current_trace_id(),
                "metrics": snapshot()})
            return path
        except Exception:
            return None

    def stop(self, reason: str = "exit") -> None:
        """Final dump; idempotent, FIRST reason wins — the exit path
        stops with its specific story ("done", "peer_lost:<site>") and
        the generic runtime-teardown "exit" must not rewrite it."""
        if self._stop.is_set():
            return
        self._stop.set()
        self.dump_once(reason)


def read_rank_dumps(rundir: str) -> Dict[int, dict]:
    """{rank: dump doc} over ``<rundir>/metrics-r*.json``."""
    out: Dict[int, dict] = {}
    try:
        names = sorted(os.listdir(rundir))
    except OSError:
        return out
    for name in names:
        if not (name.startswith("metrics-r")
                and name.endswith(".json")):
            continue
        try:
            rank = int(name[len("metrics-r"):-len(".json")])
        except ValueError:
            continue
        try:
            with open(os.path.join(rundir, name)) as f:
                out[rank] = json.load(f)
        except (OSError, ValueError):
            continue
    return out


def rank_dump_stale(doc: dict, now: Optional[float] = None) -> float:
    """Age of a rank dump in seconds; compare against
    ``3 x every_s + 1`` for the staleness verdict (one missed cadence
    is scheduling noise; three is a dead or wedged rank)."""
    now = time.time() if now is None else now
    try:
        return max(0.0, now - float(doc["ts"]))
    except (KeyError, TypeError, ValueError):
        return float("inf")


# ---------------------------------------------------------------------------
# federation rendering (the router's /metrics/fleet)
# ---------------------------------------------------------------------------

def member_row(replica: str = "", rank: str = "", *, up: bool,
               stale: bool, age_s: float,
               metrics: Optional[dict] = None,
               state: str = "") -> dict:
    """One federation member (exactly one of ``replica``/``rank`` set)."""
    return {"replica": str(replica), "rank": str(rank), "up": bool(up),
            "stale": bool(stale), "age_s": round(float(age_s), 3),
            "state": state, "metrics": metrics}


# liveness/staleness series every member gets, dead ones included
_MEMBER_GAUGES = (
    ("mrtpu_fleet_member_up",
     "federation member currently serving/reporting "
     "(0 = dead or unreachable)",
     lambda m: 1 if m["up"] else 0),
    ("mrtpu_fleet_member_stale",
     "member's metrics are a last-known image, not a live scrape",
     lambda m: 1 if m["stale"] else 0),
    ("mrtpu_fleet_member_age_seconds",
     "seconds since the member's lease/dump was last renewed",
     lambda m: m["age_s"]),
)


def federate_text(members: List[dict]) -> str:
    """Merge member registry snapshots into ONE Prometheus exposition:
    every sample gains ``{replica,rank}`` labels (its member's), and
    liveness/staleness series cover every member — the dead ones
    emphatically included (stale, not absent)."""
    lines: List[str] = []
    for gname, ghelp, gval in _MEMBER_GAUGES:
        lines.append(f"# HELP {gname} {ghelp}")
        lines.append(f"# TYPE {gname} gauge")
        for m in members:
            lines.append(f"{gname}{_mlab(m)} {gval(m)}")
    # merged member series, grouped per metric so HELP/TYPE render once
    order: List[str] = []
    families: Dict[str, dict] = {}
    for m in members:
        snap = m.get("metrics") or {}
        for name, fam in snap.items():
            if name not in families:
                families[name] = {"type": fam.get("type", "untyped"),
                                  "help": fam.get("help", ""),
                                  "rows": []}
                order.append(name)
            families[name]["rows"].append((m, fam.get("samples") or []))
    for name in order:
        fam = families[name]
        if fam["help"]:
            lines.append(f"# HELP {name} {fam['help']}")
        lines.append(f"# TYPE {name} {fam['type']}")
        for m, samples in fam["rows"]:
            extra = [("replica", m["replica"]), ("rank", m["rank"])]
            for s in samples:
                labels = list((s.get("labels") or {}).items()) + extra
                if fam["type"] == "histogram":
                    for ub, cum in (s.get("buckets") or {}).items():
                        lines.append(
                            f"{name}_bucket"
                            f"{_plab(labels + [('le', ub)])} {cum}")
                    lines.append(f"{name}_sum{_plab(labels)} "
                                 f"{_fmt(s.get('sum', 0))}")
                    lines.append(f"{name}_count{_plab(labels)} "
                                 f"{s.get('count', 0)}")
                else:
                    lines.append(f"{name}{_plab(labels)} "
                                 f"{_fmt(s.get('value', 0))}")
    return "\n".join(lines) + "\n"


def _esc(v) -> str:
    return str(v).replace("\\", "\\\\").replace('"', '\\"') \
                 .replace("\n", "\\n")


def _plab(items) -> str:
    if not items:
        return ""
    return "{" + ",".join(f'{k}="{_esc(v)}"' for k, v in items) + "}"


def _mlab(m: dict) -> str:
    return _plab([("replica", m["replica"]), ("rank", m["rank"])])


def _fmt(v) -> str:
    try:
        f = float(v)
    except (TypeError, ValueError):
        return "0"
    if f == float("inf"):
        return "+Inf"
    if f.is_integer() and abs(f) < 1e15:
        return str(int(f))
    return repr(f)


# ---------------------------------------------------------------------------
# the trace shards of a launched run
# ---------------------------------------------------------------------------

def read_trace_dir(path: str):
    """Merge a run dir's per-rank shards (``trace-r<k>.jsonl``) into one
    event stream: ``(events, n_shards)``.  Each process's ``ts`` counts
    from its own epoch; every event's ``wall`` (the span's start on the
    wall clock) gives each shard one offset onto the run's shared clock.
    Span ids are namespaced per rank (``(rank + 1) << 32``), so two
    ranks' span #7 never merge, and every event gains ``rank``."""
    import glob
    from .sinks import read_jsonl
    per_rank = []
    for sp in sorted(glob.glob(os.path.join(path, "trace-r*.jsonl"))):
        base = os.path.basename(sp)
        try:
            rank = int(base[len("trace-r"):-len(".jsonl")])
        except ValueError:
            continue
        per_rank.append((rank, read_jsonl(sp)))
    # the run's zero: the earliest shard epoch (wall minus its own ts)
    t0 = None
    for _r, evs in per_rank:
        for ev in evs:
            w = ev.get("wall")
            if w is not None:
                w0 = float(w) - float(ev.get("ts", 0.0)) / 1e6
                t0 = w0 if t0 is None else min(t0, w0)
    out = []
    for rank, evs in per_rank:
        off = None
        if t0 is not None:
            for ev in evs:
                w = ev.get("wall")
                if w is not None:
                    off = (float(w) - t0) * 1e6 \
                        - float(ev.get("ts", 0.0))
                    break
        ns = (rank + 1) << 32
        for ev in evs:
            ev = dict(ev)
            ev["rank"] = rank
            if off is not None:
                ev["ts"] = round(float(ev.get("ts", 0.0)) + off, 1)
            if ev.get("id"):
                ev["id"] = int(ev["id"]) + ns
            if ev.get("parent"):
                ev["parent"] = int(ev["parent"]) + ns
            out.append(ev)
    out.sort(key=lambda e: float(e.get("ts", 0.0)))
    return out, len(per_rank)
