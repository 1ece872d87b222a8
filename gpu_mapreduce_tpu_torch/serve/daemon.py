"""The MR-as-a-service daemon.

One resident process holds what a cold script run pays for on every
invocation: the initialised card (its CUDA context and the loaded
kernels), the mesh when one is configured, the process-global plan
cache (a second identical request records no new plan), and the
interned-dictionary state of the bytes domain.  Requests arrive over the obs/httpd loopback listener as
sessions (serve/session.py) through a bounded admission queue
(serve/admission.py) into a small worker pool.

Durability: every ACCEPTED session lands in an fsync'd ft/ journal
(``<state>/journal.jsonl``) before the client sees its 202, and its
completion is recorded after the result file is durably on disk — so a
``kill -9`` at any point leaves a state directory from which a
restarted daemon replays exactly the accepted-but-unfinished sessions,
in admission order, resuming any that were mid-run from their last
auto-checkpoint (doc/serve.md#recovery).

HTTP API (all JSON; see doc/serve.md):

* ``POST /v1/jobs``               — submit ``{"script"| "ops", "tenant"
  [, "priority", "deadline_ms"]}`` → 202 ``{"id", "state"}``; 429 +
  ``Retry-After`` when the queue is full, the tenant is rate-limited,
  or the tenant is being SLO-burn shed; 503 when draining or degraded.
* ``GET  /v1/jobs``               — session summaries.
* ``GET  /v1/jobs/<id>``          — one session's status.
* ``GET  /v1/jobs/<id>/result``   — the result record (202 while
  pending/running).
* ``DELETE /v1/jobs/<id>``        — cancel: queued sessions finalize
  ``cancelled`` immediately, running ones stop at their next op
  barrier; 409 once terminal.
* ``GET  /v1/stats``              — queue/sessions/tenants/plan-cache.
* ``POST /v1/drain``              — stop admitting, keep executing.
* ``POST /v1/shutdown``           — drain, finish the queue, stop.
* ``GET  /v1/jobs/<id>/events``   — the session's NDJSON event stream;
  ``/v1/streams`` is the standing-query surface (serve/streams.py).

With ``MRTPU_SERVE_TOKENS`` armed every route needs ``Authorization:
Bearer <token>`` — 401/403 are decided BEFORE any journal write;
drain/shutdown need the admin (``*``) token (serve/auth.py).

Serve-journal record kinds: ``serve_submit`` (before the 202),
``serve_done`` (after the durable result), ``serve_cancel``
(acknowledged cancels), ``cache_hit`` (the session was served from
the memo store — replay re-serves, never recomputes), ``serve_gc`` /
``memo_gc`` / ``cas_gc`` (sweep intents, written BEFORE deletion so a
kill -9 mid-GC finishes on restart), ``serve_shed``, ``stream_open`` /
``stream_close`` and ``fleet_claimed``.  The file formats are the JAX
package's, so either package's daemon replays the other's state
directory.  Unknown kinds are ignored by recovery, so journals roll
forward.

The port runs on the card: ``Server()`` resolves its device with
``core.runtime.resolve_device`` (the card, or ``MRError`` where there
is none — it never falls back to the CPU); ``Server(device="cpu")`` is
the only way onto the host.  ``start`` builds and loads the CUDA kernels
and initialises CUDA on the main thread before the listener answers, so
the first request pays for neither.  Sessions share the card's default
stream; a session that meets a CUDA error fails loudly, and after a
sticky CUDA error the daemon must be restarted (the journal then
replays its unfinished sessions).  Pools are threads, never forked
processes: a process that has touched CUDA must not fork.

Fleet mode (``fleet_dir`` / ``MRTPU_FLEET_DIR`` — doc/serve.md#the-
serve-fleet): N replicas share one directory tree.  Each replica
heartbeats a lease (serve/fleet.py), mints globally-unique session ids
(``<rid>.s<seq>``), writes results into the SHARED ``<fleet>/results/``
store, and watches its peers: an expired lease triggers a journal
claim — fenced record into the dead journal, then the dead's
accepted-but-unfinished sessions replay here (mid-run ones resume from
their copied auto-checkpoints), flagged ``meta.failed_over``.  Fencing
discipline: a worker executes a session only while this replica's OWN
lease is current and unclaimed — a paused-then-revived replica finds
the claim and drops its stale queue instead of double-executing.  Each
replica is its own process with its own CUDA context; a replica after a
sticky CUDA error keeps renewing its lease as the JAX package's does
and fails every session until it is restarted.
"""

from __future__ import annotations

import os
import queue as _queue
import threading
import time
from typing import Dict, List, Optional

from ..core.runtime import MRError, resolve_device
from ..utils.env import env_flag, env_knob, env_str
from .admission import AdmissionQueue
from .auth import TokenAuth
from .budget import TenantBudgets
from .overload import BurnShedder, CostProfiles, DiskMonitor
from .session import (CANCELLED, DONE, FAILED, QUEUED, RUNNING, TERMINAL,
                      Session, atomic_write_json, cancelled_record,
                      normalize_payload, run_session)

_CURRENT: Optional["Server"] = None     # the metrics collector's target


def _collect_serve(reg) -> None:
    """obs/metrics collector: refresh the serve gauges at scrape time."""
    srv = _CURRENT
    if srv is None:
        return
    reg.gauge("mrtpu_sessions_active",
              "sessions currently executing on serve/ workers"
              ).set(srv.active_count())
    reg.gauge("mrtpu_serve_queue_depth",
              "sessions admitted but not yet running"
              ).set(srv.queue.depth())
    g = reg.gauge("mrtpu_tenant_pages",
                  "per-tenant dataset pages currently resident "
                  "(bytes_in_use / memsize)", ("tenant",))
    for tenant, snap in srv.budgets.snapshot().items():
        g.set(snap["pages_in_use"], tenant=tenant)
    reg.gauge("mrtpu_serve_degraded",
              "1 while the daemon sheds admissions under resource "
              "pressure (low disk / ENOSPC), else 0"
              ).set(1 if srv.disk.check() else 0)
    # caching-tier shape (utils/cas.py): scrape-time store census
    try:
        from ..utils.cas import cas_store
        store = cas_store()
        if store is not None:
            st = store.stats()
            reg.gauge("mrtpu_cas_chunks",
                      "objects resident in the content-addressed store"
                      ).set(st["chunks"])
            reg.gauge("mrtpu_cas_bytes",
                      "bytes resident in the content-addressed store"
                      ).set(st["bytes"])
    except Exception:
        pass


class Server:
    """The daemon object.  ``start()`` recovers the state directory,
    mounts the HTTP routes, and spins up the worker pool; it is safe to
    embed in-process or drive via ``python -m
    gpu_mapreduce_tpu_torch.serve``.  ``device`` defaults to the card
    (``MRError`` without one); a ``comm`` mesh names its own devices."""

    def __init__(self, port: Optional[int] = None,
                 workers: Optional[int] = None,
                 queue_cap: Optional[int] = None,
                 state_dir: Optional[str] = None,
                 comm=None, paused: Optional[bool] = None,
                 budgets: Optional[TenantBudgets] = None,
                 device=None,
                 fleet_dir: Optional[str] = None,
                 replica_id: Optional[str] = None,
                 heartbeat_s: Optional[float] = None,
                 lease_s: Optional[float] = None):
        # the device first: a replica with no card (and not asked onto
        # the CPU) raises before it writes any state
        self.device = comm.devices[0] if comm is not None \
            else resolve_device(device)
        self.port = port if port is not None \
            else env_knob("MRTPU_SERVE_PORT", int, 0)
        self.nworkers = workers if workers is not None \
            else env_knob("MRTPU_SERVE_WORKERS", int, 2)
        cap = queue_cap if queue_cap is not None \
            else env_knob("MRTPU_SERVE_QUEUE", int, 16)
        # fleet membership (serve/fleet.py): replicas of one fleet
        # share a directory; each keeps its own state dir under
        # <fleet>/replicas/<rid> (unless overridden) and its results in
        # the SHARED <fleet>/results/ store
        self.fleet_dir = fleet_dir or env_str("MRTPU_FLEET_DIR", "") \
            or None
        self.rid = replica_id or env_str("MRTPU_FLEET_ID", "") \
            or f"r{os.getpid()}"
        self._fleet = None
        if self.fleet_dir is not None:
            from .fleet import FleetMember
            self._fleet = FleetMember(self.fleet_dir, self.rid,
                                      heartbeat_s=heartbeat_s,
                                      lease_s=lease_s)
        self._fenced = False
        self.fenced_drops = 0           # claimed sessions we declined
        self._fleet_suspended = False   # test hook: a stalled replica
        self._fleet_thread: Optional[threading.Thread] = None
        if self.fleet_dir is not None and state_dir is None:
            state_dir = os.path.join(self.fleet_dir, "replicas",
                                     self.rid)
        self.state_dir = state_dir \
            or env_str("MRTPU_SERVE_STATE", "mrtpu-serve")
        # paused = admit + journal but do not execute (maintenance /
        # pre-drain staging; also what makes the kill-mid-queue replay
        # test deterministic)
        self.paused = paused if paused is not None \
            else env_flag("MRTPU_SERVE_PAUSED", False)
        self.comm = comm
        self.queue = AdmissionQueue(cap)
        # per-tenant request-rate quota: 0 = off
        from .admission import TenantRateLimiter
        self.ratelimit = TenantRateLimiter(
            env_knob("MRTPU_SERVE_RATE", float, 0.0),
            env_knob("MRTPU_SERVE_BURST", float, None))
        # session TTL/GC: terminal session state past this age is
        # swept by a background thread (0 = keep forever)
        self.ttl_s = max(0.0, env_knob("MRTPU_SERVE_TTL", float, 0.0))
        self.gc_count = 0
        # caching-tier GC (doc/perf.md#the-caching-tier), folded into
        # the same TTL sweep: memoized results age out after
        # MRTPU_MEMO_TTL (0 = keep forever) and unreferenced CAS chunks
        # are collected after MRTPU_CAS_GRACE seconds unlinked
        self.memo_ttl_s = max(0.0,
                              env_knob("MRTPU_MEMO_TTL", float, 0.0))
        self.cas_grace_s = max(0.0,
                               env_knob("MRTPU_CAS_GRACE", float, 3600.0))
        self.cache_gc_count = 0         # entries removed (memo + chunks)
        self.budgets = budgets or TenantBudgets()
        # -- the self-protection plane -----------------------------------
        # tenant bearer tokens on /v1/ (serve/auth.py; disarmed when
        # MRTPU_SERVE_TOKENS is unset)
        self.auth = TokenAuth()
        # per-tenant session-cost evidence + the SLO-burn admission
        # shedder it feeds (serve/overload.py)
        self.profiles = CostProfiles()
        self.shedder = BurnShedder(self.profiles)
        # "tenant|reason" → monotonic ts of the latest shed: the
        # rising-edge / episode tracker behind _note_shed's journaling
        # (own lock: mutated by concurrent HTTP handler threads)
        self._shed_edges: Dict[str, float] = {}
        self._shed_lock = threading.Lock()
        # resource-pressure degradation: state dir + shared result
        # store are the paths whose filesystems must keep room
        self.disk = DiskMonitor([self.state_dir,
                                 os.path.dirname(self.result_path("x"))])
        # hung-session watchdog: no barrier progress for MRTPU_SERVE_
        # STALL seconds flags the session (and cancels it under
        # MRTPU_SERVE_STALL_CANCEL=1), arming the flight recorder
        self.stall_s = max(0.0, env_knob("MRTPU_SERVE_STALL", float, 0.0))
        self.stall_cancel = env_flag("MRTPU_SERVE_STALL_CANCEL", False)
        self.stall_count = 0
        # server-side default execution deadline (ms) for submits that
        # carry none (0 = unlimited)
        self.default_deadline_ms = max(
            0, env_knob("MRTPU_SERVE_DEADLINE", int, 0))
        # mesh autoscaler (serve/autoscale.py): session width from the
        # tenant's profiled exchange volume, MRTPU_SERVE_MESH_AUTO=1
        from .autoscale import MeshAutoscaler
        self.autoscaler = MeshAutoscaler(comm, self.profiles)
        self.sessions: Dict[str, Session] = {}
        self._order: List[str] = []        # admission order, for /v1/jobs
        self._lock = threading.Lock()
        self._submit_lock = threading.Lock()
        self._seq = 0
        self._draining = False
        self._stopped = threading.Event()
        self._workers: List[threading.Thread] = []
        self._active = 0
        self._ewma_wall = 1.0              # Retry-After estimator
        self._journal = None
        self._owns_httpd = False
        self._listener = None              # fleet mode: private httpd
        # request-scoped observability (obs/context.py): trace_id →
        # sid routing for the span feed, and per-session watcher queues
        # behind /v1/jobs/<id>/events
        self._watch: Dict[str, List] = {}
        self._trace_sids: Dict[str, str] = {}
        self._watch_lock = threading.Lock()
        # standing queries: POST /v1/streams opens micro-batch streams
        # that outlive any one request (serve/streams.py +
        # stream/engine.py); journaled like submits, recovered like
        # sessions, adopted on fleet takeover
        from .streams import StreamManager
        self.streams = StreamManager(self)

    # -- paths -------------------------------------------------------------
    def session_dir(self, sid: str) -> str:
        return os.path.join(self.state_dir, "sessions", sid)

    def result_path(self, sid: str) -> str:
        # fleet mode: ONE shared result store for every replica —
        # takeover dedupe ("is this session already finished?") and the
        # router's read fallback both need results findable without the
        # replica that wrote them (sids are rid-prefixed, no collisions)
        if self.fleet_dir is not None:
            return os.path.join(self.fleet_dir, "results", sid + ".json")
        return os.path.join(self.state_dir, "results", sid + ".json")

    def _mint_sid(self) -> str:
        """Caller holds ``_submit_lock``.  Fleet sids carry the replica
        id (``<rid>.s<seq>``) so they are fleet-unique AND routable —
        the router parses the owner straight out of the id."""
        self._seq += 1
        base = f"s{self._seq:06d}"
        return f"{self.rid}.{base}" if self.fleet_dir is not None \
            else base

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> int:
        """Recover + serve; returns the bound port."""
        global _CURRENT
        from ..ft.journal import Journal
        os.makedirs(self.state_dir, exist_ok=True)
        # mrlint: disable=lock-unguarded-mutation — start() runs before
        # any worker/http thread exists; shutdown's locked close is the
        # only concurrent writer
        self._journal = Journal(self.state_dir, script_mode=True)
        self._recover()
        from ..obs import httpd, metrics
        reg = metrics.enable_metrics()
        reg.register_collector(_collect_serve)
        # the span→events feed: finished top-level spans route to any
        # watcher of the session whose trace_id they carry (enable_
        # metrics above already turned tracing on for the bridge)
        from ..obs.tracer import get_tracer
        get_tracer().subscribe_once(self._span_feed)
        _CURRENT = self
        # the card and the kernels are ready before the listener
        # answers (the kernels build at first use otherwise)
        self._warm_imports()
        if self._fleet is not None:
            # fleet replicas ALWAYS listen privately: two in-process
            # replicas (tests, embedded fleets) must not fight over the
            # process-global /v1/ route table, and each replica's
            # /healthz must report ITS readiness
            self._listener = httpd.MetricsServer(
                port=self.port, routes=[("/v1/", self._handle)],
                health=self._health_status)
            self.port = self._listener.start()
        else:
            httpd.register_routes("/v1/", self._handle)
            httpd.set_health(self._health_status)
            prev = httpd.get_server()
            self._owns_httpd = prev is None or not prev.running
            self.port = httpd.ensure_server(self.port)
        atomic_write_json(os.path.join(self.state_dir, "serve.json"),
                          {"port": self.port, "pid": os.getpid(),
                           "paused": self.paused, "rid": self.rid})
        if self._fleet is not None:
            from . import fleet as _fleet_mod
            self._fleet.join(self.port, self.state_dir,
                             state="draining" if self.paused
                             else "ready")
            _fleet_mod.enable_fleet_metrics(self._fleet)
            self._fleet_thread = threading.Thread(
                target=self._fleet_loop, name=f"mrtpu-fleet-{self.rid}",
                daemon=True)
            self._fleet_thread.start()
        if not self.paused:
            self._start_workers()
        if self.ttl_s > 0:
            t = threading.Thread(target=self._gc_loop,
                                 name="mrtpu-serve-gc", daemon=True)
            t.start()
        if self.stall_s > 0:
            t = threading.Thread(target=self._stall_loop,
                                 name="mrtpu-serve-watchdog",
                                 daemon=True)
            t.start()
        return self.port

    def _start_workers(self) -> None:
        for i in range(max(0, self.nworkers)):
            t = threading.Thread(target=self._worker_loop,
                                 name=f"mrtpu-serve-w{i}",
                                 daemon=True)
            t.start()
            self._workers.append(t)

    def _health_status(self) -> str:
        """/healthz readiness (obs/httpd.set_health): liveness is the
        response existing at all; the STATUS tells load balancers and
        the fleet router whether to send work here."""
        if self._fenced:
            return "fenced"
        if self._draining or self.paused or self._stopped.is_set():
            # paused is a maintenance drain too: admitted work queues
            # but does not execute, so routers/LBs must look elsewhere
            return "draining"
        if self.disk.check():
            # resource pressure: alive, running sessions finish, but
            # new work must go elsewhere (doc/reliability.md#daemon-
            # under-overload) — fleet replicas publish this state on
            # their lease, so the router drops them from the ring
            return "degraded"
        return "ok"

    def session_comm(self, sess: Session) -> tuple:
        """(comm, width) for one session — the mesh autoscaler's pick
        (full mesh when disarmed; serve/autoscale.py)."""
        if not self.autoscaler.enabled:
            return self.comm, None
        return self.autoscaler.comm_for(sess.tenant)

    def _warm_imports(self) -> None:
        """Import the session execution stack on the main thread BEFORE
        any worker exists: two workers lazily importing the same module
        tree can hit CPython's partially-initialized-module window, and
        a warm daemon should pay import cost at start, not on the first
        tenant's request."""
        from ..oink.command import COMMANDS  # noqa: F401
        from ..oink.script import OinkScript  # noqa: F401
        from ..ft.journal import read_journal  # noqa: F401
        from .session import run_session  # noqa: F401
        from ..plan.cache import cache_stats
        cache_stats()       # pulls parallel/shuffle (the /v1/stats path)
        from ..stream import Stream  # noqa: F401
        if self.device.type == "cuda":
            # CUDA initialisation from a worker thread would race the
            # other workers', and nvcc would run at the first launch:
            # both happen here, on the main thread, before serving
            import torch
            from ..ops.cuda import load_all
            torch.cuda.init()
            torch.empty(1, device=self.device)
            self.warm = load_all()
            torch.cuda.synchronize(self.device)

    def _recover(self) -> None:
        """Replay the serve journal: accepted-but-unfinished sessions
        re-enter the queue in admission order (``force=True`` — the
        journal's accept beats the restart's queue cap) at their
        recorded priority, ONTO WHATEVER MESH this restart carries —
        degraded-mode recovery: a daemon restarted with fewer (or more)
        devices still finishes every accepted session, and a resumed
        session whose checkpoint came from a different mesh width
        reports ``meta.resharded`` (ft/journal.resume_into).  Finished
        sessions reload as DONE/FAILED stubs whose results serve from
        disk; GC'd sessions (``serve_gc`` intent records) are neither
        listed nor replayed, and their leftover directories are swept
        to completion (a kill -9 mid-GC resumes the delete, never
        orphans a live session — live sessions are never journaled for
        GC in the first place)."""
        from ..ft.journal import read_journal
        try:
            recs = read_journal(self.state_dir)
        except MRError:
            return
        done: Dict[str, str] = {}
        gcd: set = set()
        cancels: Dict[str, str] = {}    # acknowledged mid-run cancels
        submits: List[dict] = []
        claim_recs: List[tuple] = []    # (idx, fleet_claimed record)
        cas_intents: List[list] = []    # interrupted CAS chunk sweeps
        memo_intents: List[list] = []   # interrupted memo-entry sweeps
        stream_opens: List[dict] = []   # standing queries (streams.py)
        stream_closes: set = set()
        for i, r in enumerate(recs):
            if r.get("kind") == "serve_submit":
                submits.append({**r, "_idx": i})
                # _recover runs inside start(), before the workers
                self._seq = max(self._seq, int(r.get("seq", 0)))
            elif r.get("kind") == "stream_open":
                stream_opens.append({**r, "_idx": i})
                self.streams.note_seq(r)
            elif r.get("kind") == "stream_close":
                stream_closes.add(r.get("stid", ""))
            elif r.get("kind") == "serve_done":
                done[r.get("sid", "")] = r.get("status", DONE)
            elif r.get("kind") == "serve_cancel":
                cancels[r.get("sid", "")] = r.get("reason", "client")
            elif r.get("kind") == "serve_gc":
                gcd.add(r.get("sid", ""))
            elif r.get("kind") == "cas_gc":
                cas_intents.append(list(r.get("digests") or []))
            elif r.get("kind") == "memo_gc":
                memo_intents.append(list(r.get("keys") or []))
            elif r.get("kind") == "fleet_claimed":
                claim_recs.append((i, r))
        if cas_intents or memo_intents:
            # finish interrupted cache sweeps (journaled-intent replay:
            # both halves are idempotent — an entry already removed is
            # skipped, one re-referenced since the intent survives)
            try:
                from ..utils.cas import cas_store
                from . import memo as memo_mod
                store = cas_store()
                for digests in cas_intents:
                    if store is not None:
                        store.gc_finish(digests)
                for keys in memo_intents:
                    memo_mod.sweep_finish(keys)
            except Exception:
                pass
        if claim_recs and self._fleet is None:
            # restarted OUTSIDE fleet mode with a claimed journal: no
            # lease/claim state to arbitrate with — conservatively
            # leave everything before the last claim to its claimant
            submits = [r for r in submits
                       if r["_idx"] > claim_recs[-1][0]]
            stream_opens = [r for r in stream_opens
                            if r["_idx"] > claim_recs[-1][0]]
        elif claim_recs:
            # a peer claimed this journal (we died, it took over).
            # Every submit before a COMPLETED claim belongs to that
            # claimant — replaying it here would be the double
            # execution fencing exists to prevent.  Submits after it
            # (post-revival work at a newer epoch) replay normally.
            done_gens = {gen for gen, crec in
                         self._fleet.claims(self.rid)
                         if crec.get("done")}
            boundary = max((i for i, r in claim_recs
                            if r.get("gen", -1) in done_gens),
                           default=-1)
            submits = [r for r in submits if r["_idx"] > boundary]
            stream_opens = [r for r in stream_opens
                            if r["_idx"] > boundary]
            cur = self._fleet.current_claim(self.rid)
            if cur is not None and not cur[1].get("done"):
                # an UNFINISHED claim: those sessions are in takeover
                # limbo — if we simply dropped them and rejoined at a
                # newer epoch, a claimant that died mid-takeover would
                # orphan them forever (we look alive, so no peer ever
                # supersedes).  Re-claim our own journal through the
                # same O_EXCL arbitration every survivor uses: a LIVE
                # claimant keeps the claim (it replays, we drop), a
                # dead one loses the supersede race to us and the
                # sessions stay ours
                reclaim = self._fleet.claim(self.rid)
                if reclaim is None:
                    last = max(i for i, r in claim_recs)
                    submits = [r for r in submits if r["_idx"] > last]
                    stream_opens = [r for r in stream_opens
                                    if r["_idx"] > last]
                else:
                    # ours again — already durably journaled HERE,
                    # which is exactly what claim_done certifies
                    self._fleet.claim_done(self.rid, reclaim["gen"])
        for r in submits:
            sid = r["sid"]
            if done.get(sid) == "rejected":
                # compensated submit (a shutdown race): the client was
                # told "not accepted" — never replay or list it
                continue
            if sid in gcd:
                self._gc_files(sid)       # finish an interrupted GC
                continue
            from ..obs.context import new_trace_id
            sess = Session(sid=sid, tenant=r.get("tenant", "default"),
                           payload=r.get("payload", ""),
                           fmt=r.get("fmt", "oink"),
                           submitted_utc=r.get("utc", ""),
                           priority=int(r.get("priority", 0)),
                           failed_over=bool(r.get("fo")),
                           deadline_ms=r.get("dl") or None,
                           # the replayed session keeps its original
                           # trace_id (pre-trace journals get a fresh
                           # one) so the pre-crash artifacts still link
                           trace_id=r.get("trace") or new_trace_id())
            if sid in done:
                sess.state = done[sid]
                try:    # TTL ages from the durable result's mtime
                    sess.finished_ts = os.path.getmtime(
                        self.result_path(sid))
                except OSError:
                    sess.finished_ts = time.time()
            elif sid in cancels and \
                    os.path.exists(self.result_path(sid)):
                # crash between the result write and its serve_done
                # record, with an acknowledged cancel in flight: the
                # durable result wins (never overwrite completed work
                # with an empty cancelled record) — reload it as a
                # terminal stub
                try:
                    import json as _json
                    with open(self.result_path(sid)) as f:
                        sess.state = _json.load(f).get("status", DONE)
                    sess.finished_ts = os.path.getmtime(
                        self.result_path(sid))
                except (OSError, ValueError):
                    sess.state = CANCELLED
                    sess.finished_ts = time.time()
            elif sid in cancels:
                # the client was told "cancelling" before the crash:
                # the replay must honor that, not resurrect and run
                # the session to completion.  Register first (the
                # finalize pushes events/metrics), then finalize —
                # result + serve_done + CANCELLED state
                with self._lock:
                    self.sessions[sid] = sess
                    self._order.append(sid)
                with self._watch_lock:
                    self._trace_sids[sess.trace_id] = sid
                self._finalize_cancelled(sess, cancels[sid])
                continue
            else:
                self.queue.offer(sess, force=True,
                                 priority=sess.priority)
            with self._lock:
                self.sessions[sid] = sess
                self._order.append(sid)
            with self._watch_lock:
                self._trace_sids[sess.trace_id] = sid
        # standing queries without a stream_close re-open here: each
        # engine resumes from ITS journal's last committed cursors, so
        # a kill -9 mid-batch restarts at exactly-once state
        self.streams.recover(
            [r for r in stream_opens
             if r.get("stid", "") not in stream_closes])

    # -- fleet: heartbeat, failover, fencing -------------------------------
    def _fleet_loop(self) -> None:
        """Heartbeat our lease, notice our own fencing, and claim any
        peer whose lease expired.  Membership upkeep must never take
        the daemon down."""
        fleet = self._fleet
        while not self._stopped.wait(fleet.heartbeat_s):
            if self._fleet_suspended:     # test hook: a stalled replica
                continue
            try:
                if not self._fenced and fleet.fenced():
                    self._fenced = True   # a peer owns our old work now
                st = self._health_status()
                fleet.renew(state="ready" if st == "ok" else st)
                # only a replica that can actually EXECUTE work claims:
                # paused/draining/fenced replicas would sit on a claim,
                # and a disk-degraded one would adopt sessions straight
                # into the ENOSPC failures its own submit path sheds —
                # leave the dead peer to a healthy survivor
                if self._fenced or self.paused or self._draining \
                        or not self._workers or self.disk.check():
                    continue
                now = time.time()
                for rid, lease in fleet.peers().items():
                    if rid == self.rid:
                        continue
                    st = fleet.replica_state(rid, lease, now)
                    if st == "expired":
                        self._takeover(rid, lease)
                    elif st == "fenced" and fleet.expired(lease, now):
                        # a DEAD peer under an UNFINISHED claim: the
                        # claimant died mid-takeover (or it is our own
                        # claim, resuming after a restart) — without
                        # this branch the supersede path in claim()
                        # is unreachable and the dead peer's
                        # un-re-journaled sessions are orphaned.  A
                        # fenced-but-RENEWING lease (revived zombie)
                        # fails the expired() check and stays skipped;
                        # claim() itself arbitrates a live claimant
                        # (returns None while the takeover is in
                        # flight)
                        cur = fleet.current_claim(rid)
                        if cur is not None and not cur[1].get("done"):
                            self._takeover(rid, lease)
            except Exception:
                pass

    def _fence_ok(self) -> bool:
        """The lease discipline a worker checks before EVERY session:
        execute only while our own lease is current (by our own clock —
        no skew allowance on ourselves) and no peer has claimed our
        journal.  A paused-then-revived replica fails this check and
        drops its stale queue instead of double-executing sessions the
        claimant already owns."""
        if self._fleet is None:
            return True
        if self._fenced or self._fleet.fenced():
            self._fenced = True
            return False
        return not self._fleet.self_expired()

    def _takeover(self, dead_rid: str, lease: dict) -> None:
        """Claim + replay one dead peer's journal.  The claim file
        (O_EXCL — serve/fleet.py) settles the survivor race; the
        ``fleet_claimed`` record lands in the DEAD journal before any
        replay so a restarted/revived dead replica skips the sessions
        we now own; each replayed session is re-journaled HERE before
        it enters the queue, so our own death mid- or post-takeover is
        covered by the normal recovery path."""
        import shutil
        claim = self._fleet.claim(dead_rid)
        if claim is None:
            return                        # peer won (or already done)
        t0 = time.monotonic()
        from ..ft.journal import Journal, read_journal
        from ..obs import get_tracer
        from . import fleet as fleet_mod
        dead_state = lease.get("state_dir") or os.path.join(
            self.fleet_dir, "replicas", dead_rid)
        with get_tracer().span("fleet.failover", cat="fleet",
                               dead=dead_rid, by=self.rid,
                               epoch=claim["epoch"]) as sp:
            try:
                recs = read_journal(dead_state)
            except MRError:
                recs = []                 # died before its first record
            # sids an EARLIER (superseded) claimant already re-journaled
            # belong to ITS claim chain — its own failover replays them
            owned_elsewhere: set = set()
            done_gens: set = set()
            for gen, crec in self._fleet.claims(dead_rid):
                if crec.get("done"):
                    done_gens.add(gen)
                prev = crec.get("by")
                if gen >= claim["gen"] or not prev or prev == self.rid:
                    continue
                please = self._fleet.lease(prev) or {}
                pstate = please.get("state_dir") or os.path.join(
                    self.fleet_dir, "replicas", prev)
                try:
                    prs = read_journal(pstate)
                    owned_elsewhere.update(
                        pr.get("sid", "") for pr in prs
                        if pr.get("kind") == "serve_submit")
                    owned_elsewhere.update(
                        pr.get("stid", "") for pr in prs
                        if pr.get("kind") == "stream_open")
                except MRError:
                    pass
            # the fence record, BEFORE any replay
            fj = Journal(dead_state, script_mode=True)
            try:
                fj.append({"kind": "fleet_claimed", "dead": dead_rid,
                           "by": self.rid, "epoch": claim["epoch"],
                           "gen": claim["gen"]})
            finally:
                fj.close()
            done: Dict[str, str] = {}
            gcd: set = set()
            cancels: Dict[str, str] = {}
            submits: List[dict] = []
            stream_opens: List[dict] = []
            stream_closes: set = set()
            boundary = -1
            for i, r in enumerate(recs):
                kind = r.get("kind")
                if kind == "serve_submit":
                    submits.append({**r, "_idx": i})
                elif kind == "stream_open":
                    stream_opens.append({**r, "_idx": i})
                elif kind == "stream_close":
                    stream_closes.add(r.get("stid", ""))
                elif kind == "serve_done":
                    done[r.get("sid", "")] = r.get("status", DONE)
                elif kind == "serve_cancel":
                    cancels[r.get("sid", "")] = r.get("reason",
                                                      "client")
                elif kind == "serve_gc":
                    gcd.add(r.get("sid", ""))
                elif kind == "fleet_claimed" and \
                        r.get("by") != self.rid and \
                        r.get("gen", -1) in done_gens:
                    # only a COMPLETED prior claim is a hard boundary
                    # (its submits were fully re-journaled under the
                    # claimant — the rejoin-then-die case).  An
                    # UNFINISHED claim we are superseding must NOT
                    # hide the dead replica's submits: the ones its
                    # claimant did adopt are excluded per-sid via
                    # owned_elsewhere, the rest replay here
                    boundary = i
            n = 0
            for r in submits:
                sid = r.get("sid", "")
                if not sid or done.get(sid) is not None or sid in gcd \
                        or sid in owned_elsewhere:
                    continue
                if r["_idx"] <= boundary:
                    continue              # a prior claim chain owns it
                if os.path.exists(self.result_path(sid)):
                    continue              # finished; shared store has it
                if sid in cancels:
                    # the dead replica ACKNOWLEDGED this cancel but
                    # died before the barrier finalized it: honor it —
                    # write the terminal record into the shared store
                    # (reads keep working fleet-wide) and never adopt
                    try:
                        atomic_write_json(
                            self.result_path(sid),
                            cancelled_record(
                                sid, r.get("tenant", "default"),
                                cancels[sid],
                                trace_id=r.get("trace"),
                                deadline_ms=r.get("dl") or None,
                                failed_over=True))
                    except Exception:
                        pass
                    continue
                with self._lock:
                    if sid in self.sessions:
                        continue          # idempotent takeover resume
                src = os.path.join(dead_state, "sessions", sid)
                dst = self.session_dir(sid)
                if os.path.isdir(src) and not os.path.isdir(dst):
                    # a mid-run session's journal + auto-checkpoints
                    # ride along; run_session detects them and resumes
                    shutil.copytree(src, dst)
                from ..obs.context import new_trace_id
                sess = Session(
                    sid=sid, tenant=r.get("tenant", "default"),
                    payload=r.get("payload", ""),
                    fmt=r.get("fmt", "oink"),
                    submitted_utc=r.get("utc", ""),
                    priority=int(r.get("priority", 0)),
                    failed_over=True,
                    deadline_ms=r.get("dl") or None,
                    trace_id=r.get("trace") or new_trace_id())
                with self._submit_lock:
                    if self._journal is None:
                        return            # shutting down mid-takeover
                    self._journal.append(
                        {"kind": "serve_submit", "sid": sid,
                         "tenant": sess.tenant, "fmt": sess.fmt,
                         "payload": sess.payload, "seq": 0,
                         "priority": sess.priority,
                         "utc": sess.submitted_utc, "fo": dead_rid,
                         "dl": sess.deadline_ms,
                         "trace": sess.trace_id})
                    self.queue.offer(sess, force=True,
                                     priority=sess.priority)
                    with self._lock:
                        self.sessions[sid] = sess
                        self._order.append(sid)
                    with self._watch_lock:
                        self._trace_sids[sess.trace_id] = sid
                n += 1
            # the dead replica's OPEN streams move here too: copy each
            # durable stream directory, re-journal stream_open under
            # OUR journal, resume from its last committed cursor
            nst = 0
            for r in stream_opens:
                stid = r.get("stid", "")
                if not stid or stid in stream_closes \
                        or stid in owned_elsewhere \
                        or r["_idx"] <= boundary:
                    continue
                if self.streams.adopt(r, dead_state, dead_rid):
                    nst += 1
            self._fleet.claim_done(dead_rid, claim["gen"])
            sp.set(sessions=n, streams=nst)
        fleet_mod.note_failover(time.monotonic() - t0)

    def drain(self) -> None:
        self._draining = True

    def shutdown(self, timeout: float = 60.0) -> None:
        """Drain, finish the queue, stop workers and (if we bound it)
        the HTTP listener.  Idempotent."""
        global _CURRENT
        self.drain()
        self.queue.close()
        self._stopped.set()
        # open streams SUSPEND (runners stop, engine journals close, no
        # stream_close record): they are durable state the next start —
        # or a fleet survivor — resumes from the last committed cursor
        try:
            self.streams.suspend_all()
        except Exception:
            pass
        for t in self._workers:
            t.join(timeout=timeout)
        self._workers = []
        from ..obs import httpd
        from ..obs.tracer import get_tracer
        try:
            get_tracer().unsubscribe(self._span_feed)
        except Exception:
            pass
        if self._fleet is not None:
            # graceful exit is not a failure: drop the lease so no
            # survivor claims a journal whose queue we just drained.  The
            # heartbeat stops first: a renew in flight would write the
            # lease again after the leave
            if self._fleet_thread is not None:
                self._fleet_thread.join(timeout=timeout)
            self._fleet.leave()
        if self._listener is not None:
            self._listener.stop()
            self._listener = None
        else:
            httpd.unregister_routes("/v1/")
            httpd.set_health(None)
        if _CURRENT is self:
            _CURRENT = None
        if self._owns_httpd:
            httpd.stop_server()
        # the submit lock serializes the close against an in-flight
        # submit's journal append (an embedded daemon that does not own
        # the HTTP listener has no handler drain to rely on)
        with self._submit_lock:
            if self._journal is not None:
                self._journal.close()
                self._journal = None

    def wait(self, timeout: Optional[float] = None) -> bool:
        return self._stopped.wait(timeout)

    # -- submission --------------------------------------------------------
    def submit(self, body: dict) -> tuple:
        """→ (http_code, response_dict, extra_headers_or_None)."""
        if self._draining:
            return 503, {"error": "draining: not admitting new work"}, \
                {"Retry-After": 60}
        if self._fenced:
            # a fenced replica's journal belongs to its claimant; new
            # accepts here could never be claimed coherently — refuse
            # and let the client's retry find the healthy ring
            return 503, {"error": f"replica {self.rid!r} is fenced "
                                  f"(its journal was claimed)"}, \
                {"Retry-After": 5}
        try:
            payload = normalize_payload(body)
        except MRError as e:
            return 400, {"error": str(e)}, None
        tenant = str(body.get("tenant") or "default")
        fmt = "ops" if body.get("ops") is not None else "oink"
        try:
            # clamp: priority is a scheduling hint, not a weapon
            priority = max(-9, min(9, int(body.get("priority") or 0)))
        except (TypeError, ValueError):
            return 400, {"error": "priority must be an integer"}, None
        deadline_ms = body.get("deadline_ms")
        if deadline_ms is None:
            deadline_ms = self.default_deadline_ms or None
        else:
            try:
                deadline_ms = int(deadline_ms)
                if deadline_ms <= 0:
                    raise ValueError(deadline_ms)
            except (TypeError, ValueError):
                return 400, {"error": "deadline_ms must be a positive "
                                      "integer (milliseconds)"}, None
        # resource-pressure degradation (serve/overload.py): low disk /
        # recent ENOSPC sheds NEW admissions while running sessions
        # keep their pages and finish — accepting work we cannot
        # durably journal or spill would fail it mid-run instead
        pressure = self.disk.check()
        if pressure:
            self._note_shed(tenant, "disk")
            return 503, {"error": f"degraded: {pressure}"}, \
                {"Retry-After": 30}
        # per-tenant rate quota BEFORE the shared queue: a throttled
        # tenant's Retry-After reflects its OWN bucket, and its 429
        # never consumes shared queue capacity
        ok, ra = self.ratelimit.check(tenant)
        if not ok:
            self._metric_admission("throttled", tenant)
            return 429, {"error": f"tenant {tenant!r} over its "
                                  f"request rate"}, \
                {"Retry-After": max(1, int(ra + 0.999))}
        # SLO-burn shedding (serve/overload.py): a tenant burning its
        # error budget in every window absorbs the backpressure FIRST —
        # its expensive-profile submits shed with an honest per-tenant
        # Retry-After, its cheap ones lose priority — before the shared
        # queue's 429 starts hitting polite tenants
        action, priority, shed_ra = self.shedder.decide(tenant, priority)
        if action == "shed":
            self._note_shed(tenant, "slo_burn")
            return 429, {"error": f"tenant {tenant!r} is over its SLO "
                                  f"error budget; new work is shed"}, \
                {"Retry-After": max(1, int(shed_ra + 0.999))}
        with self._submit_lock:
            if self._journal is None:       # shutdown closed it
                return 503, {"error": "shutting down"}, \
                    {"Retry-After": 60}
            if self.queue.full():
                self.queue.reject()
                self._metric_admission("rejected", tenant)
                return 429, {"error": "admission queue full"}, \
                    {"Retry-After": self.retry_after()}
            sid = self._mint_sid()
            from ..obs.context import new_trace_id
            sess = Session(
                sid=sid, tenant=tenant, payload=payload, fmt=fmt,
                priority=priority, trace_id=new_trace_id(),
                deadline_ms=deadline_ms,
                submitted_utc=time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                            time.gmtime()))
            # the journal record lands BEFORE the queue sees the
            # session (and before the client's 202): a crash after
            # this line replays the session; a crash before it means
            # the client never heard "accepted" — either way the
            # journal and the promise agree.  The trace_id rides the
            # record so a REPLAYED session keeps the id the original
            # 202's artifacts already carry
            self._journal.append(
                {"kind": "serve_submit", "sid": sid, "tenant": tenant,
                 "fmt": fmt, "payload": payload, "seq": self._seq,
                 "priority": priority, "utc": sess.submitted_utc,
                 "dl": deadline_ms, "trace": sess.trace_id})
            if not self.queue.offer(sess, force=True,
                                    priority=priority):
                # capacity is held by the submit lock, so the only way
                # force-offer fails is a shutdown() that closed the
                # queue after the drain check above — compensate the
                # already-journaled submit so a restart never replays
                # a session whose client heard "not accepted"
                self._journal.append({"kind": "serve_done", "sid": sid,
                                      "status": "rejected"})
                return 503, {"error": "shutting down"}, \
                    {"Retry-After": 60}
            with self._lock:
                self.sessions[sid] = sess
                self._order.append(sid)
            with self._watch_lock:
                self._trace_sids[sess.trace_id] = sid
        self._metric_admission("accepted", tenant)
        # an admitted submit ends any shed episode for this tenant —
        # the NEXT shed is a fresh rising edge worth a journal record
        self._clear_shed_edge(tenant, "slo_burn")
        self._clear_shed_edge(tenant, "disk")
        return 202, {"id": sid, "state": QUEUED, "tenant": tenant,
                     "deadline_ms": deadline_ms,
                     "trace_id": sess.trace_id}, None

    # Retry-After floor for a replica with NO draining capacity (paused
    # / 0 workers): depth × wall / workers is 0 × anything or a divide
    # by zero there — and any finite estimate would be a lie, since the
    # queue is not draining at all.  A constant says "come back when an
    # operator has unpaused me".
    _RETRY_AFTER_IDLE = 30

    def retry_after(self) -> int:
        """Honest backpressure: the queue's expected drain time under
        the rolling mean session wall — clamped to a sane floor, never
        a division by zero or a 0s "immediately" hint."""
        workers = len(self._workers)
        if workers <= 0 or self.paused:
            return self._RETRY_AFTER_IDLE
        per = max(0.05, self._ewma_wall) / workers
        return max(1, int(self.queue.depth() * per + 0.5))

    # a shed more than this long after the previous one for the same
    # (tenant, reason) is a NEW episode and journals a fresh rising
    # edge — a tenant whose clients gave up (so no admit ever cleared
    # the edge) must not have its next week's episode go unrecorded
    _SHED_EPISODE_S = 600.0

    def _note_shed(self, tenant: str, reason: str) -> None:
        """One shed decision: count it (every shed response bumps
        ``mrtpu_serve_shed_total{tenant,reason}``) and journal the
        RISING EDGE per (tenant, reason) episode — post-mortems need
        "when did shedding start", not one fsync per rejected
        request."""
        try:
            from ..obs.metrics import get_registry
            get_registry().counter(
                "mrtpu_serve_shed_total",
                "admissions shed by the self-protection plane "
                "(reason: slo_burn/disk)",
                ("tenant", "reason")).inc(tenant=tenant, reason=reason)
        except Exception:
            pass
        key = f"{tenant}|{reason}"
        now = time.monotonic()
        with self._shed_lock:
            last = self._shed_edges.get(key)
            if len(self._shed_edges) > 512 and last is None:
                # tenant names come from request bodies: expire
                # finished episodes (and, failing that, everything) so
                # a client cycling names against a degraded daemon
                # can't grow this
                self._shed_edges = {
                    k: t for k, t in self._shed_edges.items()
                    if now - t < self._SHED_EPISODE_S}
                if len(self._shed_edges) > 512:
                    self._shed_edges.clear()
            self._shed_edges[key] = now
        if last is not None and now - last < self._SHED_EPISODE_S:
            return              # same episode: already journaled
        with self._submit_lock:
            if self._journal is not None:
                try:
                    self._journal.append({"kind": "serve_shed",
                                          "tenant": tenant,
                                          "reason": reason})
                except (ValueError, OSError):
                    pass    # a full disk must not turn shedding into 500s

    def _clear_shed_edge(self, tenant: str, reason: str) -> None:
        with self._shed_lock:
            self._shed_edges.pop(f"{tenant}|{reason}", None)

    def _metric_admission(self, outcome: str, tenant: str = "default"
                          ) -> None:
        try:
            from ..obs.metrics import get_registry
            get_registry().counter(
                "mrtpu_serve_admission_total",
                "admission decisions by outcome and tenant "
                "(accepted/rejected/throttled)",
                ("outcome", "tenant")).inc(outcome=outcome,
                                           tenant=tenant)
        except Exception:
            pass

    # -- cancellation (DELETE /v1/jobs/<id>) -------------------------------
    def cancel(self, sid: str, reason: str = "client") -> tuple:
        """→ (code, body).  QUEUED sessions finalize as ``cancelled``
        right here (they never run); RUNNING ones get their request
        account flagged and stop cooperatively at the next op barrier
        (obs/context.barrier_check).  A cancel landing after the
        terminal record is a 409 no-op — it never touches the result
        (doc/serve.md#deadlines-and-cancel)."""
        with self._lock:
            sess = self.sessions.get(sid)
            if sess is None:
                return 404, {"error": f"no session {sid!r}"}
            st = sess.state
            if st in TERMINAL:
                return 409, {"error": f"session {sid!r} already "
                                      f"{st}; cancel is a no-op"}
            if st == QUEUED:
                if sess.cancel_requested is None:
                    sess.cancel_requested = reason
                    claim = True
                else:
                    claim = False     # an earlier cancel owns finalize
            else:                     # RUNNING
                claim = False
                first = sess.cancel_requested is None
                sess.cancel_requested = sess.cancel_requested or reason
                acct = sess.account
        if st == QUEUED:
            if claim:
                self._finalize_cancelled(sess, reason)
            return 202, {"id": sid, "state": CANCELLED,
                         "cancel_reason": reason}
        # RUNNING: journal the acknowledged cancel BEFORE arming the
        # flag — a kill -9 between this 202 and the session's next
        # barrier must not resurrect and complete a session its client
        # was told is cancelling (recovery finalizes serve_cancel'd
        # sids as cancelled instead of re-queueing them).  Only the
        # FIRST cancel journals: a client hammering DELETE while the
        # barrier approaches must not grow the journal one fsync per
        # request
        if first:
            with self._submit_lock:
                if self._journal is not None:
                    try:
                        self._journal.append(
                            {"kind": "serve_cancel", "sid": sid,
                             "reason": reason, "trace": sess.trace_id})
                    except (ValueError, OSError):
                        pass
        # arm the account (it may lag sess.state by a few lines in
        # run_session — cancel_requested covers that window:
        # run_session re-checks it after PUBLISHING the account, so one
        # side always sees the other)
        if acct is not None:
            acct.cancel(reason)
        self._push_event(sid, {"event": "status", "id": sid,
                               "state": "cancelling",
                               "cancel_reason": reason})
        return 202, {"id": sid, "state": "cancelling",
                     "cancel_reason": reason}

    def _finalize_cancelled(self, sess: Session, reason: str) -> None:
        """Terminal bookkeeping for a session cancelled BEFORE it ran:
        the ``serve_cancel`` intent record FIRST (a crash anywhere past
        it recovers to ``cancelled``, never to a resurrected run that
        overwrites this result), then the durable result, then the
        ``serve_done`` record, then the state flip — same ordering
        discipline as the worker path."""
        sess.cancel_reason = reason
        sess.error = f"cancelled ({reason})"
        with self._submit_lock:
            if self._journal is not None:
                try:
                    self._journal.append(
                        {"kind": "serve_cancel", "sid": sess.sid,
                         "reason": reason, "trace": sess.trace_id})
                except (ValueError, OSError):
                    pass
        try:
            atomic_write_json(
                self.result_path(sess.sid),
                cancelled_record(sess.sid, sess.tenant, reason,
                                 trace_id=sess.trace_id,
                                 deadline_ms=sess.deadline_ms,
                                 failed_over=sess.failed_over))
        except Exception:
            pass
        with self._submit_lock:
            if self._journal is not None:
                try:
                    self._journal.append(
                        {"kind": "serve_done", "sid": sess.sid,
                         "status": CANCELLED, "trace": sess.trace_id})
                except (ValueError, OSError):
                    pass
        sess.state = CANCELLED
        sess.finished_ts = time.time()
        self._metric_cancel(sess.tenant, reason)
        self._metric_session(sess)
        self._push_event(sess.sid, {"event": "status", **sess.summary()})

    def _metric_cancel(self, tenant: str, reason: str) -> None:
        try:
            from ..obs.metrics import get_registry
            get_registry().counter(
                "mrtpu_serve_cancel_total",
                "sessions cancelled, by reason "
                "(client/deadline/stall)",
                ("tenant", "reason")).inc(tenant=tenant, reason=reason)
        except Exception:
            pass

    # -- hung-session watchdog ---------------------------------------------
    def _stall_loop(self) -> None:
        """MRTPU_SERVE_STALL armed: flag any RUNNING session with no
        barrier progress for that long (a wedged collective, a hung
        input read), arm the flight recorder so the forensic ring is
        already collecting, and — under MRTPU_SERVE_STALL_CANCEL=1 —
        cancel it so the worker comes back.  The flag clears itself
        when progress resumes: a slow op is not a hang."""
        interval = max(0.05, min(self.stall_s / 4.0, 5.0))
        while not self._stopped.wait(interval):
            try:
                self._stall_scan(time.monotonic())
            except Exception:
                pass    # the watchdog must never take the daemon down

    def _stall_scan(self, now: float) -> None:
        """One watchdog pass (split from the loop so tests drive it
        with a synthetic clock)."""
        with self._lock:
            running = [s for s in self.sessions.values()
                       if s.state == RUNNING and s.account is not None]
        for sess in running:
            acct = sess.account
            idle = now - acct.last_barrier
            if idle < self.stall_s:
                sess.stalled = False
                continue
            if sess.stalled:
                continue              # already flagged this episode
            sess.stalled = True
            self.stall_count += 1
            try:
                from ..obs import flight as _flight
                _flight.enable()
            except Exception:
                pass
            try:
                from ..obs.metrics import get_registry
                get_registry().counter(
                    "mrtpu_serve_stalled_total",
                    "sessions flagged by the stall watchdog (no "
                    "barrier progress for MRTPU_SERVE_STALL)",
                    ("tenant",)).inc(tenant=sess.tenant)
            except Exception:
                pass
            self._push_event(sess.sid, {
                "event": "stalled", "id": sess.sid,
                "idle_s": round(idle, 3),
                "cancelling": self.stall_cancel})
            if self.stall_cancel:
                acct.cancel("stall")

    # -- session TTL / GC --------------------------------------------------
    def _gc_files(self, sid: str) -> None:
        """Delete one session's durable footprint (idempotent — also
        the recovery path that finishes an interrupted GC)."""
        import shutil
        shutil.rmtree(self.session_dir(sid), ignore_errors=True)
        try:
            os.remove(self.result_path(sid))
        except OSError:
            pass

    def _gc_once(self) -> int:
        """One TTL sweep: journal the GC intent per expired DONE/FAILED
        session FIRST (the intent record is what makes a kill -9
        mid-delete resumable — and only terminal sessions are ever
        journaled, so a live session can never be orphaned), then
        delete its directories and drop it from the listing.  The
        caching-tier half (:meth:`_gc_cache`) rides the same sweep."""
        if self.ttl_s <= 0:
            return self._gc_cache()
        now = time.time()
        expired: List[Session] = []
        with self._lock:
            for sess in self.sessions.values():
                if sess.state in TERMINAL and \
                        sess.finished_ts is not None and \
                        now - sess.finished_ts >= self.ttl_s:
                    expired.append(sess)
        n = 0
        for sess in expired:
            with self._submit_lock:
                if self._journal is None:
                    return n           # shutting down: next restart GCs
                self._journal.append({"kind": "serve_gc",
                                      "sid": sess.sid,
                                      "tenant": sess.tenant})
            self._gc_files(sess.sid)
            with self._lock:
                self.sessions.pop(sess.sid, None)
                try:
                    self._order.remove(sess.sid)
                except ValueError:
                    pass
                self.gc_count += 1
            with self._watch_lock:
                self._trace_sids.pop(sess.trace_id, None)
            n += 1
            try:
                from ..obs.metrics import get_registry
                get_registry().counter(
                    "mrtpu_serve_gc_total",
                    "expired sessions swept by the TTL GC",
                    ("tenant",)).inc(tenant=sess.tenant)
            except Exception:
                pass
        return n + self._gc_cache()

    def _gc_cache(self) -> int:
        """Caching-tier half of the TTL sweep: memoized results past
        ``MRTPU_MEMO_TTL`` (0 = keep forever), then CAS chunks with no
        external hardlink untouched past ``MRTPU_CAS_GRACE``.  Each
        batch journals its intent record (``memo_gc`` / ``cas_gc``)
        BEFORE removing anything — a kill -9 mid-sweep finishes on
        restart (_recover), and both finish halves are idempotent, so
        a chunk re-referenced after the intent survives and a refcount
        can never go negative."""
        from ..utils.cas import cas_store
        from . import memo as memo_mod
        n = 0
        try:
            keys = memo_mod.sweep_candidates(self.memo_ttl_s) \
                if self.memo_ttl_s > 0 else []
            if keys:
                with self._submit_lock:
                    if self._journal is None:
                        return n   # shutting down: next restart sweeps
                    self._journal.append({"kind": "memo_gc",
                                          "keys": keys})
                n += memo_mod.sweep_finish(keys)
            store = cas_store()
            digests = store.gc_candidates(self.cas_grace_s) \
                if store is not None else []
            if digests:
                with self._submit_lock:
                    if self._journal is None:
                        return n
                    self._journal.append({"kind": "cas_gc",
                                          "digests": digests})
                n += store.gc_finish(digests)
        except Exception:
            return n          # cache GC must never take the daemon down
        if n:
            with self._lock:
                self.cache_gc_count += n
            try:
                from ..obs.metrics import get_registry
                get_registry().counter(
                    "mrtpu_cas_gc_total",
                    "caching-tier entries swept (expired memo records "
                    "+ unreferenced CAS chunks)").inc(n)
            except Exception:
                pass
        return n

    def _gc_loop(self) -> None:
        interval = max(0.2, min(self.ttl_s / 4.0, 60.0))
        while not self._stopped.wait(interval):
            try:
                self._gc_once()
            except Exception:
                pass               # the GC must never take the daemon down

    # -- workers -----------------------------------------------------------
    def _worker_loop(self) -> None:
        while True:
            sess = self.queue.take(timeout=0.25)
            if sess is None:
                if self._stopped.is_set() and self.queue.depth() == 0:
                    return
                continue
            if not self._fence_ok():
                # our lease lapsed or a peer claimed our journal: this
                # session belongs to the claimant now.  Dropping it is
                # the fence — executing it would be the double run
                from . import fleet as fleet_mod
                with self._lock:
                    self.fenced_drops += 1
                fleet_mod.note_fenced_drop(self.rid)
                continue
            with self._lock:
                if sess.cancel_requested is not None and \
                        sess.state != RUNNING:
                    # cancelled while QUEUED: the DELETE handler owns
                    # (or already finished) the terminal bookkeeping —
                    # executing it now would be the double run the 202
                    # "state: cancelled" promised against
                    continue
                # the RUNNING flip happens UNDER the lock so a
                # concurrent DELETE always sees either "still queued"
                # (it finalizes, we skip above) or "running" (it arms
                # the account) — never a gap between the two
                sess.state = RUNNING
                self._active += 1
            self._push_event(sess.sid,
                             {"event": "status", "id": sess.sid,
                              "state": RUNNING,
                              "trace_id": sess.trace_id})
            try:
                result = run_session(self, sess)
            except Exception as e:    # run_session already shields; belt
                sess.error = f"{type(e).__name__}: {e}"
                self.disk.note_error(e)   # a result-write ENOSPC
                #                           must flip us degraded
                try:
                    atomic_write_json(
                        self.result_path(sess.sid),
                        {"id": sess.sid, "tenant": sess.tenant,
                         "status": FAILED, "error": sess.error})
                except Exception:
                    pass
                sess.state = FAILED    # after the durable result, like
                #                        run_session's flip ordering
            finally:
                sess.finished_ts = time.time()   # the TTL GC's clock
                with self._lock:
                    self._active -= 1
            self._ewma_wall = 0.7 * self._ewma_wall + \
                0.3 * float(sess.wall_s or 1.0)
            if sess.state == CANCELLED:
                self._metric_cancel(sess.tenant,
                                    sess.cancel_reason or "client")
            # cost-profile evidence (serve/overload.py): what the SLO
            # shedder ranks expensive-vs-cheap by, and what the mesh
            # autoscaler sizes the next session's width from
            acct0 = sess.account
            if acct0 is not None:
                self.profiles.record(
                    sess.tenant, sess.wall_s or 0.0,
                    acct0.exchange_sent + acct0.exchange_pad)
            # completion record follows the durable result file.  A
            # worker draining past shutdown's join timeout may find the
            # journal closed — the missing done record only costs one
            # redundant (idempotent) replay on the next restart
            try:
                meta = {}
                try:
                    meta = result.get("meta") or {}
                except NameError:
                    pass
                memo_meta = meta.get("memo") or {}
                if memo_meta.get("hit"):
                    # durable proof the session was memo-served: a
                    # kill -9 replay sees cache_hit+serve_done and
                    # re-serves from the store — never recomputes.
                    # mrlint: disable=lock-unguarded-mutation — the
                    # drain race above: a closed journal costs one
                    # idempotent replay; Journal.append has its own lock
                    self._journal.append({"kind": "cache_hit",
                                          "sid": sess.sid,
                                          "key": memo_meta.get("key"),
                                          "trace": sess.trace_id})
                # mrlint: disable=lock-unguarded-mutation — the drain
                # race above: a closed journal costs one idempotent
                # replay; Journal.append has its own lock
                self._journal.append({"kind": "serve_done",
                                      "sid": sess.sid,
                                      "status": sess.state,
                                      "trace": sess.trace_id})
            except (ValueError, OSError, AttributeError):
                pass
            self._metric_session(sess)
            # watchers see the profile BEFORE the terminal status —
            # the terminal status is the stream's end-of-feed marker
            acct = sess.account
            if acct is not None:
                self._push_event(sess.sid, {"event": "profile",
                                            "profile": acct.profile()})
            self._push_event(sess.sid,
                             {"event": "status", **sess.summary()})

    def _metric_session(self, sess: Session) -> None:
        try:
            from ..obs.metrics import get_registry
            reg = get_registry()
            reg.counter("mrtpu_serve_sessions_total",
                        "finished sessions by tenant and status",
                        ("tenant", "status")).inc(
                            tenant=sess.tenant, status=sess.state)
            reg.histogram("mrtpu_serve_session_seconds",
                          "session wall time by tenant and status",
                          ("tenant", "status")).observe(
                              float(sess.wall_s or 0.0),
                              tenant=sess.tenant, status=sess.state)
        except Exception:
            pass

    def active_count(self) -> int:
        with self._lock:
            return self._active

    def _mesh_width(self) -> int:
        """Shards of the mesh this daemon instance runs sessions on —
        after a degraded restart this is "whatever is available now"."""
        if self.comm is None:
            return 1
        from ..parallel.mesh import mesh_axis_size
        return mesh_axis_size(self.comm)

    def _mesh_status(self) -> dict:
        """The stats()/mrctl view of the mesh, including whether the
        data plane is running DEGRADED (shrunk after a rank loss —
        parallel/dist.py): operators must see a narrowed fleet in the
        same place they see width, not infer it from missing ranks."""
        from ..parallel.dist import surviving_width
        out = {"nprocs": self._mesh_width()}
        cap = surviving_width()
        if cap is not None and cap < out["nprocs"]:
            out["degraded"] = True
            out["surviving_width"] = cap
        elif getattr(self.autoscaler, "dist_cap", None):
            out["degraded"] = True
            out["surviving_width"] = self.autoscaler.dist_cap
        return out

    # -- request-scoped observability (obs/context.py) ---------------------
    def _span_feed(self, ev: dict) -> None:
        """Tracer sink: a finished TOP-LEVEL span whose trace_id maps
        to a watched session becomes one event on that session's
        stream.  Must never raise (the tracer drops raising sinks) and
        must stay cheap — it runs on every span emission process-wide."""
        try:
            tid = ev.get("trace")
            if not tid or ev.get("parent"):
                return
            with self._watch_lock:
                sid = self._trace_sids.get(tid)
                if sid is None or sid not in self._watch:
                    return
            self._push_event(sid, {
                "event": "span", "name": ev.get("name"),
                "cat": ev.get("cat"),
                "dur_ms": round(float(ev.get("dur", 0.0)) / 1000.0, 3),
                "args": ev.get("args") or {}})
        except Exception:
            pass

    def _push_event(self, sid: str, item: dict) -> None:
        with self._watch_lock:
            qs = list(self._watch.get(sid, ()))
        for q in qs:
            try:
                q.put_nowait(item)
            except _queue.Full:
                pass    # a stalled watcher drops events, never blocks
                #         the worker (the stream is telemetry, not a
                #         durable log — the result record is)

    def _events_stream(self, sid: str, timeout: float = 600.0):
        """Generator behind ``GET /v1/jobs/<id>/events``: one JSON line
        per event (status transitions, top-level spans, the final cost
        profile), pushed as they happen — the no-polling exposure.  The
        subscription attaches BEFORE the state snapshot is read, so a
        transition in the gap arrives on the queue instead of being
        missed; ends at terminal state, daemon stop, or the timeout."""
        import json as _json

        from ..obs.sinks import _jsonable

        def line(obj) -> str:
            return _json.dumps(obj, default=_jsonable) + "\n"

        q: _queue.Queue = _queue.Queue(maxsize=512)
        with self._watch_lock:
            self._watch.setdefault(sid, []).append(q)
        try:
            with self._lock:
                sess = self.sessions.get(sid)
            if sess is None:
                yield line({"event": "error",
                            "error": f"no session {sid!r}"})
                return
            if sess.state in TERMINAL:
                # already finished: replay the durable profile, THEN
                # the terminal status — same order as the live path
                # (worker pushes profile before the final status), so
                # a client that stops at the terminal marker still got
                # the whole story
                code, prof = self.profile(sid)
                if code == 200 and prof.get("profile"):
                    yield line({"event": "profile",
                                "profile": prof["profile"]})
                yield line({"event": "status", **sess.summary()})
                return
            yield line({"event": "status", **sess.summary()})
            deadline = time.monotonic() + timeout
            last_beat = time.monotonic()
            while time.monotonic() < deadline \
                    and not self._stopped.is_set():
                try:
                    item = q.get(timeout=0.25)
                except _queue.Empty:
                    if time.monotonic() - last_beat >= 15.0:
                        last_beat = time.monotonic()
                        yield line({"event": "tick"})
                    continue
                yield line(item)
                if item.get("event") == "status" and \
                        item.get("state") in TERMINAL:
                    return
        finally:
            with self._watch_lock:
                qs = self._watch.get(sid)
                if qs is not None and q in qs:
                    qs.remove(q)
                    if not qs:
                        del self._watch[sid]

    def profile(self, sid: str) -> tuple:
        """→ (code, dict): the per-request cost profile.  RUNNING
        sessions serve the LIVE account snapshot (partial, marked
        ``live``); terminal sessions serve the durable one from the
        result record; queued sessions 202 like /result."""
        with self._lock:
            sess = self.sessions.get(sid)
        if sess is None:
            return 404, {"error": f"no session {sid!r}"}
        if sess.state == QUEUED:
            return 202, sess.summary()
        if sess.state == RUNNING:
            acct = sess.account
            if acct is None:        # racing the worker's first line
                return 202, sess.summary()
            return 200, {"id": sid, "trace_id": sess.trace_id,
                         "live": True, "profile": acct.profile()}
        import json
        try:
            with open(self.result_path(sid)) as f:
                res = json.load(f)
            prof = (res.get("meta") or {}).get("profile")
            if prof:
                return 200, {"id": sid, "trace_id": sess.trace_id,
                             "live": False, "profile": prof}
        except (OSError, ValueError):
            pass
        return 200, {**sess.summary(),
                     "error": "profile unavailable"}

    # -- reads -------------------------------------------------------------
    def status(self, sid: str) -> Optional[dict]:
        with self._lock:
            sess = self.sessions.get(sid)
        return sess.summary() if sess else None

    def result(self, sid: str) -> tuple:
        """→ (code, dict): 200 done/failed, 202 pending, 404 unknown."""
        with self._lock:
            sess = self.sessions.get(sid)
        if sess is None:
            return 404, {"error": f"no session {sid!r}"}
        if sess.state in (QUEUED, RUNNING):
            return 202, sess.summary()
        import json
        try:
            with open(self.result_path(sid)) as f:
                return 200, json.load(f)
        except (OSError, ValueError):
            # done per journal but the result file is missing/torn (a
            # crash window) — surface the summary rather than a 500
            return 200, {**sess.summary(),
                         "error": sess.error or "result file unavailable"}

    def _cache_stats(self) -> dict:
        """The caching-tier section of /v1/stats (mrctl cache): CAS
        store shape, memoization counters, and sweep totals."""
        from ..utils.cas import cas_store
        from . import memo as memo_mod
        store = cas_store()
        cas = store.stats() if store is not None \
            else {"enabled": 0, "chunks": 0, "bytes": 0}
        with self._lock:
            swept = self.cache_gc_count
        return {"cas": cas,
                "memo": memo_mod.memo_stats(),
                "gc": {"memo_ttl_s": self.memo_ttl_s,
                       "cas_grace_s": self.cas_grace_s,
                       "swept": swept}}

    def stats(self) -> dict:
        from ..plan.cache import cache_stats
        with self._lock:
            states: Dict[str, int] = {}
            for s in self.sessions.values():
                states[s.state] = states.get(s.state, 0) + 1
            active = self._active
        fleet = None
        if self._fleet is not None:
            fleet = {"rid": self.rid, "epoch": self._fleet.epoch,
                     "fenced": self._fenced,
                     "fenced_drops": self.fenced_drops,
                     "replicas": {rid: self._fleet.replica_state(rid, l)
                                  for rid, l in
                                  self._fleet.peers().items()}}
        return {"queue": self.queue.stats(),
                "fleet": fleet,
                "sessions": {"active": active, "by_state": states,
                             "total": len(self._order)},
                "streams": self.streams.snapshot(),
                "tenants": self.budgets.snapshot(),
                "ratelimit": self.ratelimit.snapshot(),
                "gc": {"ttl_s": self.ttl_s, "swept": self.gc_count},
                "mesh": self._mesh_status(),
                "plan": cache_stats(),
                "cache": self._cache_stats(),
                # the self-protection plane (doc/serve.md): auth arming,
                # shed/deprioritize counts, cost evidence, disk
                # pressure, watchdog and autoscaler state
                "overload": {
                    "auth": self.auth.snapshot(),
                    "shed": self.shedder.snapshot(),
                    "profiles": self.profiles.snapshot(),
                    "disk": self.disk.snapshot(),
                    "stall": {"stall_s": self.stall_s,
                              "cancel": self.stall_cancel,
                              "flagged": self.stall_count},
                    "deadline_default_ms": self.default_deadline_ms,
                    "autoscale": self.autoscaler.snapshot()},
                "draining": self._draining, "paused": self.paused,
                "workers": len(self._workers), "port": self.port,
                "device": str(self.device),
                "state_dir": self.state_dir}

    # -- HTTP routing (obs/httpd.register_routes handler) ------------------
    def _session_tenant(self, sid: str) -> Optional[str]:
        with self._lock:
            sess = self.sessions.get(sid)
        return sess.tenant if sess else None

    def _authz(self, ident: Optional[str],
               tenant: Optional[str] = None,
               admin: bool = False) -> Optional[tuple]:
        """Route-level auth gate over the ONE token resolution the
        handler already did: None = allowed, else a full response tuple
        (401 missing/invalid token, 403 out-of-tenant or non-admin
        operator verb) — decided BEFORE any journal write or queue
        mutation (serve/auth.py)."""
        code, err = self.auth.gate_ident(ident, tenant=tenant,
                                         admin=admin)
        if not code:
            return None
        extra = {"WWW-Authenticate": "Bearer"} if code == 401 else None
        return code, err, "application/json", extra

    def _handle(self, method: str, path: str, body: bytes,
                headers: dict) -> tuple:
        import json
        parts = [p for p in path.split("/") if p]      # ["v1", ...]
        if len(parts) < 2 or parts[0] != "v1":
            return 404, {"error": "not found"}, "application/json", None
        rest = parts[1:]
        # every /v1/ request needs a VALID token when auth is armed
        # (tenant scoping per route below); the telemetry plane
        # (/metrics, /healthz) stays open — doc/serve.md#tenant-auth
        ident = self.auth.identify(headers) if self.auth.armed else None
        if self.auth.armed and ident is None:
            return 401, {"error": "missing or invalid bearer token"}, \
                "application/json", {"WWW-Authenticate": "Bearer"}
        if method == "POST" and rest == ["jobs"]:
            try:
                obj = json.loads(body.decode() or "{}")
                if not isinstance(obj, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, UnicodeDecodeError) as e:
                return 400, {"error": f"bad JSON body: {e}"}, \
                    "application/json", None
            if ident is not None and ident != "*" \
                    and not obj.get("tenant"):
                obj["tenant"] = ident     # the token names the tenant
            denied = self._authz(
                ident, tenant=str(obj.get("tenant") or "default"))
            if denied:
                return denied
            code, out, extra = self.submit(obj)
            return code, out, "application/json", extra
        if method == "DELETE" and len(rest) == 2 and rest[0] == "jobs":
            owner = self._session_tenant(rest[1])
            if owner is None:
                return 404, {"error": f"no session {rest[1]!r}"}, \
                    "application/json", None
            denied = self._authz(ident, tenant=owner)
            if denied:
                if denied[0] == 403:
                    # foreign sid reads as NONEXISTENT: sids are
                    # sequential, so 403-vs-404 would be an existence
                    # oracle over other tenants' session volume
                    return 404, {"error": f"no session {rest[1]!r}"}, \
                        "application/json", None
                return denied
            code, out = self.cancel(rest[1])
            return code, out, "application/json", None
        if method == "GET" and rest == ["jobs"]:
            with self._lock:
                out = [self.sessions[sid].summary()
                       for sid in self._order]
            if ident is not None and ident != "*":
                # a tenant token lists its OWN sessions only
                out = [s for s in out if s.get("tenant") == ident]
            return 200, {"jobs": out}, "application/json", None
        if method == "GET" and len(rest) in (2, 3) and rest[0] == "jobs":
            # tenant tokens read only their own sessions (admin: all);
            # a foreign sid answers 404, not 403 — no existence oracle
            owner = self._session_tenant(rest[1])
            if owner is not None:
                denied = self._authz(ident, tenant=owner)
                if denied:
                    if denied[0] == 403:
                        return 404, {"error": f"no session "
                                              f"{rest[1]!r}"}, \
                            "application/json", None
                    return denied
        if method == "GET" and len(rest) == 2 and rest[0] == "jobs":
            st = self.status(rest[1])
            if st is None:
                return 404, {"error": f"no session {rest[1]!r}"}, \
                    "application/json", None
            return 200, st, "application/json", None
        if method == "GET" and len(rest) == 3 and rest[0] == "jobs" \
                and rest[2] == "result":
            code, out = self.result(rest[1])
            return code, out, "application/json", None
        if method == "GET" and len(rest) == 3 and rest[0] == "jobs" \
                and rest[2] == "profile":
            code, out = self.profile(rest[1])
            return code, out, "application/json", None
        if method == "GET" and len(rest) == 3 and rest[0] == "jobs" \
                and rest[2] == "events":
            with self._lock:
                known = rest[1] in self.sessions
            if not known:
                return 404, {"error": f"no session {rest[1]!r}"}, \
                    "application/json", None
            return 200, self._events_stream(rest[1]), \
                "application/x-ndjson", None
        if rest and rest[0] == "streams":
            return self._handle_streams(method, rest[1:], body, ident)
        if method == "GET" and rest == ["slo"]:
            # burn rates cover EVERY tenant — operator surface, like
            # /v1/stats below (a tenant token must not read its
            # neighbors' cost profiles or traffic shape)
            denied = self._authz(ident, admin=True)
            if denied:
                return denied
            from ..obs import slo as _slo
            eng = _slo.get_engine()
            if eng is None:
                return 200, {"objectives": [], "burn": {},
                             "firing": [], "alerts": []}, \
                    "application/json", None
            # force: an explicit operator ask must never serve a burn
            # snapshot the scrape-path rate limiter left stale
            eng.tick(force=True)
            return 200, eng.snapshot(), "application/json", None
        if method == "GET" and rest == ["stats"]:
            # stats spans every tenant (page accounts, cost profiles,
            # shed state) — admin-only when auth is armed
            denied = self._authz(ident, admin=True)
            if denied:
                return denied
            return 200, self.stats(), "application/json", None
        if method == "POST" and rest == ["drain"]:
            denied = self._authz(ident, admin=True)
            if denied:
                return denied
            self.drain()
            return 200, {"draining": True}, "application/json", None
        if method == "POST" and rest == ["shutdown"]:
            denied = self._authz(ident, admin=True)
            if denied:
                return denied
            # respond first, stop after: the stop path drains in-flight
            # HTTP handlers, and THIS handler is one of them
            threading.Thread(target=self._deferred_shutdown,
                             daemon=True).start()
            return 200, {"shutting_down": True}, "application/json", None
        return 404, {"error": "not found"}, "application/json", None

    def _handle_streams(self, method: str, rest: List[str],
                        body: bytes, ident: Optional[str]) -> tuple:
        """``/v1/streams`` routing (serve/streams.py): open / list /
        status / feed / events / close.  Tenant scoping mirrors jobs:
        a foreign stream id answers 404, never 403 (no existence
        oracle over sequential ids)."""
        import json
        if method == "POST" and not rest:
            try:
                obj = json.loads(body.decode() or "{}")
                if not isinstance(obj, dict):
                    raise ValueError("body must be a JSON object")
            except (ValueError, UnicodeDecodeError) as e:
                return 400, {"error": f"bad JSON body: {e}"}, \
                    "application/json", None
            if ident is not None and ident != "*" \
                    and not obj.get("tenant"):
                obj["tenant"] = ident
            denied = self._authz(
                ident, tenant=str(obj.get("tenant") or "default"))
            if denied:
                return denied
            code, out, extra = self.streams.open(obj)
            return code, out, "application/json", extra
        if method == "GET" and not rest:
            out = self.streams.list()
            if ident is not None and ident != "*":
                out = [s for s in out if s.get("tenant") == ident]
            return 200, {"streams": out}, "application/json", None
        if not rest:
            return 404, {"error": "not found"}, "application/json", None
        stid = rest[0]
        ss = self.streams.get(stid)
        if ss is None:
            return 404, {"error": f"no stream {stid!r}"}, \
                "application/json", None
        denied = self._authz(ident, tenant=ss.tenant)
        if denied:
            if denied[0] == 403:
                return 404, {"error": f"no stream {stid!r}"}, \
                    "application/json", None
            return denied
        if method == "GET" and len(rest) == 1:
            return 200, ss.summary(), "application/json", None
        if method == "GET" and rest[1:] == ["events"]:
            return 200, self.streams.events_stream(stid), \
                "application/x-ndjson", None
        if method == "POST" and rest[1:] == ["feed"]:
            code, out = self.streams.feed(stid, body)
            return code, out, "application/json", None
        if (method == "DELETE" and len(rest) == 1) or \
                (method == "POST" and rest[1:] == ["close"]):
            drain = True
            if method == "POST" and body:
                try:
                    drain = bool(json.loads(body.decode() or "{}")
                                 .get("drain", True))
                except (ValueError, UnicodeDecodeError):
                    pass
            code, out = self.streams.close(stid, drain=drain)
            return code, out, "application/json", None
        return 404, {"error": "not found"}, "application/json", None

    def _deferred_shutdown(self) -> None:
        time.sleep(0.2)          # let the 200 flush to the client
        try:
            self.shutdown()
        except Exception:
            pass
