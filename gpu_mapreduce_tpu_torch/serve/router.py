"""The fleet front tier: consistent-hash routing + degraded-mode reads
(the port of ``gpu_mapreduce_tpu/serve/router.py``).

A thin, stateless process (or embedded object) that fronts N serve/
replicas sharing one fleet directory (serve/fleet.py).  It holds no
queue and no sessions — everything it knows it re-reads from the lease
files — so the router itself restarts in milliseconds and can be
replicated behind any plain TCP LB.

* ``POST /v1/jobs`` routes by consistent hash of the submission's
  session key (``body["session"]`` when the client wants affinity,
  else a per-request key) over the HEALTHY ring — replicas with a live
  lease in the ``ready`` state.  A connection failure mid-submit
  reroutes to the next healthy replica (the body was not yet accepted
  anywhere — no double accept is possible).
* reads (``status`` / ``result`` / ``profile`` / ``events``) resolve
  the owner straight from the fleet session id (``<rid>.s<seq>``),
  follow the claim chain to wherever the session lives NOW, and proxy
  there; when no live replica answers, the shared result store
  (``<fleet>/results/``) serves terminal sessions directly — reads
  survive ownership moves and even a fully-dead fleet.
* **degraded mode is honest**: with zero healthy replicas the router
  answers ``503`` with a ``Retry-After`` derived from the lease TTL —
  never a hang, never a 500 — and ``mrtpu_fleet_replicas{state}`` /
  ``mrtpu_fleet_router_total{outcome}`` say exactly what happened.

``python -m gpu_mapreduce_tpu_torch.serve --router --fleet DIR`` runs it
standalone; its port lands in ``<fleet>/router.json`` so
``python -m gpu_mapreduce_tpu_torch.ctl --state <fleet_dir>`` discovers
it first (doc/serve.md).  The router runs no job: it never resolves a
device and never initialises CUDA, so it holds no context on the card.
"""

from __future__ import annotations

import json
import os
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Iterable, List, Optional, Tuple

from ..utils.env import env_flag, env_knob
from .auth import TokenAuth
from .fleet import FleetMember, enable_fleet_metrics, owner_of, ring_route
from .session import atomic_write_json


class Router:
    def __init__(self, fleet_dir: str, port: Optional[int] = None,
                 vnodes: Optional[int] = None,
                 redirect_reads: Optional[bool] = None,
                 proxy_timeout: float = 30.0):
        self.fleet_dir = fleet_dir
        # an OBSERVER member: reads leases/claims, never joins the ring
        self.fleet = FleetMember(fleet_dir, f"router{os.getpid()}")
        self.port = port if port is not None \
            else env_knob("MRTPU_ROUTER_PORT", int, 0)
        self.vnodes = vnodes
        # 307 reads instead of proxying: one less hop for fat results
        # when clients (mrctl / ServeClient) follow redirects
        self.redirect_reads = redirect_reads if redirect_reads is not None \
            else env_flag("MRTPU_ROUTER_REDIRECT", False)
        self.proxy_timeout = proxy_timeout
        # the SAME token set the replicas arm (one MRTPU_SERVE_TOKENS
        # file fleet-wide): proxied paths are enforced by the replica
        # that answers, but the shared-result-store FALLBACKS answer
        # from disk with no replica in the loop — the router must
        # enforce there itself or a dead owner becomes an auth bypass
        self.auth = TokenAuth()
        self._listener = None
        self._lock = threading.Lock()

    # -- lifecycle ---------------------------------------------------------
    def start(self) -> int:
        from ..obs import httpd, metrics
        metrics.enable_metrics()
        enable_fleet_metrics(self.fleet)
        self._listener = httpd.MetricsServer(
            port=self.port,
            routes=[("/v1/", self._handle),
                    # fleet-wide metrics federation (doc/observability
                    # .md "Fleet & mesh"); prefix-matches the .json
                    # variant too, and cannot shadow the builtin
                    # /metrics (exact-matched before routes)
                    ("/metrics/fleet", self._metrics_fleet)],
            health=self._health)
        self.port = self._listener.start()
        atomic_write_json(os.path.join(self.fleet_dir, "router.json"),
                          {"port": self.port, "pid": os.getpid()})
        return self.port

    def stop(self) -> None:
        if self._listener is not None:
            self._listener.stop()
            self._listener = None
        # retire our discovery record so clients fall through to the
        # replica leases instead of hammering a gone router (only OUR
        # record — a replacement router may have already overwritten it)
        path = os.path.join(self.fleet_dir, "router.json")
        try:
            with open(path) as f:
                if json.load(f).get("pid") == os.getpid():
                    os.remove(path)
        except (OSError, ValueError):
            pass

    def _health(self) -> str:
        """The router is ready when it can route somewhere; otherwise
        it AGGREGATES the replica states so "every replica is shedding
        under resource pressure" reads ``degraded`` (one curl tells the
        operator which runbook page to open) while "every lease
        expired" reads ``unavailable``."""
        if self.fleet.healthy():
            return "ok"
        states = {self.fleet.replica_state(rid, lease)
                  for rid, lease in self.fleet.peers().items()}
        if "degraded" in states:
            return "degraded"
        return "unavailable"

    # -- plumbing ----------------------------------------------------------
    def _metric(self, outcome: str) -> None:
        try:
            from ..obs.metrics import get_registry
            get_registry().counter(
                "mrtpu_fleet_router_total",
                "router decisions (routed/rerouted/proxied/fallback/"
                "unavailable)", ("outcome",)).inc(outcome=outcome)
        except Exception:
            pass

    def _replica_port(self, rid: str) -> Optional[int]:
        lease = self.fleet.lease(rid)
        if lease is None:
            return None
        try:
            return int(lease["port"])
        except (KeyError, TypeError, ValueError):
            return None

    def _unavailable(self) -> tuple:
        """The honest zero-replicas answer: 503 + a Retry-After a lease
        revival could actually meet, never a hang or a 500."""
        self._metric("unavailable")
        ra = max(1, int(self.fleet.lease_s + self.fleet.skew_s + 0.999))
        return 503, {"error": "no fleet replica holds a valid lease"}, \
            "application/json", {"Retry-After": ra}

    @staticmethod
    def _fwd_headers(headers: Optional[dict],
                     body: bytes = b"") -> dict:
        """Headers a proxied hop forwards VERBATIM: the bearer token
        (replicas enforce auth — the router holds no secrets) plus the
        content type.  Everything else (Host, connection management)
        belongs to the router's own hop."""
        out = {"Content-Type": "application/json"} if body else {}
        for k, v in (headers or {}).items():
            if str(k).lower() == "authorization":
                out["Authorization"] = v
        return out

    def _proxy(self, rid: str, method: str, path: str, body: bytes,
               headers: Optional[dict] = None) -> Optional[tuple]:
        """One proxied hop to ``rid``; None when the replica did not
        answer at the TCP level (caller reroutes or falls back).  HTTP
        error codes — 401/403/429 included — pass through VERBATIM,
        body and Retry-After untouched: the client must see the
        replica's own story, not a router paraphrase."""
        port = self._replica_port(rid)
        if port is None:
            return None
        req = urllib.request.Request(
            f"http://127.0.0.1:{port}{path}",
            data=body if method in ("POST", "DELETE") and body else None,
            method=method,
            headers=self._fwd_headers(headers, body))
        try:
            with urllib.request.urlopen(
                    req, timeout=self.proxy_timeout) as r:
                payload = r.read()
                return r.status, payload, \
                    r.headers.get("Content-Type") or "application/json", \
                    {"X-Mrtpu-Replica": rid}
        except urllib.error.HTTPError as e:
            payload = e.read()
            extra = {"X-Mrtpu-Replica": rid}
            ra = e.headers.get("Retry-After")
            if ra is not None:
                extra["Retry-After"] = ra
            return e.code, payload, \
                e.headers.get("Content-Type") or "application/json", extra
        except (urllib.error.URLError, OSError):
            return None

    def _proxy_stream(self, rid: str, path: str,
                      headers: Optional[dict] = None
                      ) -> Optional[Iterable]:
        """Pass-through for the /events NDJSON stream: yield the
        replica's lines as they arrive (the router adds no buffering)."""
        port = self._replica_port(rid)
        if port is None:
            return None
        try:
            resp = urllib.request.urlopen(urllib.request.Request(
                f"http://127.0.0.1:{port}{path}",
                headers=self._fwd_headers(headers)), timeout=120.0)
        except (urllib.error.URLError, OSError):
            return None

        def gen():
            with resp:
                for line in resp:
                    yield line
        return gen()

    # -- result-store fallback ---------------------------------------------
    def _auth_fallback(self, headers: Optional[dict],
                       res: dict) -> Optional[tuple]:
        """Auth for answers served straight from the shared result
        store (no replica in the loop to enforce): same decision a
        replica would make — the stored record's tenant scopes it."""
        code, err = self.auth.gate(dict(headers or {}),
                                   tenant=str(res.get("tenant")
                                              or "default"))
        if not code:
            return None
        if code == 403:
            # match the daemons: a foreign sid reads as nonexistent
            # (403-vs-404 would be an existence oracle)
            return 404, {"error": f"no session "
                                  f"{res.get('id')!r}"}, \
                "application/json", None
        return code, err, "application/json", \
            {"WWW-Authenticate": "Bearer"}

    def _stored_result(self, sid: str) -> Optional[dict]:
        try:
            with open(os.path.join(self.fleet_dir, "results",
                                   sid + ".json")) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def _owner_candidates(self, sid: str) -> List[str]:
        """Live replicas that may hold ``sid``, most likely first: the
        END of its claim chain (the current owner after failovers),
        then the chain's predecessors back to the minting replica.
        The predecessors matter because a claim is per-EPOCH, not
        forever: a minter that REJOINED after a completed claim owns
        every sid it minted since, while its old claimant still serves
        the sids it adopted — only trying both finds a live session on
        either side of the failover."""
        rid = owner_of(sid)
        if rid is None:
            return []
        chain = [rid]
        for _ in range(16):
            claim = self.fleet.current_claim(chain[-1])
            nxt = claim[1].get("by") if claim is not None else None
            if not nxt or nxt in chain:
                break
            chain.append(nxt)
        out = []
        for r in reversed(chain):
            lease = self.fleet.lease(r)
            if lease is not None and not self.fleet.expired(lease):
                out.append(r)
        return out

    # -- the handler --------------------------------------------------------
    def _handle(self, method: str, path: str, body: bytes,
                headers: dict) -> tuple:
        parts = [p for p in path.split("/") if p]
        if len(parts) < 2 or parts[0] != "v1":
            return 404, {"error": "not found"}, "application/json", None
        rest = parts[1:]
        if method == "POST" and rest == ["jobs"]:
            return self._route_submit(body, headers)
        if rest == ["stats"] and method == "GET":
            return self._fleet_stats(headers)
        if rest == ["slo"] and method == "GET":
            return self._any_healthy(method, path, body, headers)
        if rest == ["jobs"] and method == "GET":
            return self._merged_jobs(headers)
        if method == "POST" and rest[0] in ("drain", "shutdown") \
                and len(rest) == 1:
            return self._broadcast(method, path, body, headers)
        if rest[0] == "jobs" and len(rest) == 2 and method == "DELETE":
            return self._route_cancel(rest[1], path, headers)
        if rest[0] == "jobs" and len(rest) in (2, 3) and method == "GET":
            return self._route_read(rest, path, headers)
        return 404, {"error": "not found"}, "application/json", None

    def _route_cancel(self, sid: str, path: str,
                      headers: Optional[dict]) -> tuple:
        """``DELETE /v1/jobs/<sid>``: walk the claim chain like a read
        and proxy the cancel to whichever live replica knows the
        session.  A 404 from one candidate falls through to the next;
        when nobody live knows it but the shared store holds a terminal
        result, answer the daemon's own 409 no-op contract."""
        for owner in self._owner_candidates(sid):
            out = self._proxy(owner, "DELETE", path, b"", headers)
            if out is not None and out[0] != 404:
                self._metric("proxied")
                return out
        res = self._stored_result(sid)
        if res is not None:
            denied = self._auth_fallback(headers, res)
            if denied:
                return denied
            return 409, {"error": f"session {sid!r} already "
                                  f"{res.get('status')}; cancel is a "
                                  f"no-op"}, "application/json", None
        if not self.fleet.healthy():
            return self._unavailable()
        return 404, {"error": f"no session {sid!r} reachable"}, \
            "application/json", None

    def _route_submit(self, body: bytes,
                      headers: Optional[dict] = None) -> tuple:
        try:
            obj = json.loads(body.decode() or "{}")
            if not isinstance(obj, dict):
                raise ValueError("body must be a JSON object")
        except (ValueError, UnicodeDecodeError) as e:
            return 400, {"error": f"bad JSON body: {e}"}, \
                "application/json", None
        healthy = self.fleet.healthy()
        if not healthy:
            return self._unavailable()
        # the routing key: client-chosen affinity key, else a fresh one
        # per submission (uniform spread); the chosen replica mints the
        # real <rid>.s<seq> id the client keeps
        key = str(obj.get("session") or uuid.uuid4().hex)
        first = ring_route(key, healthy, vnodes=self.vnodes)
        order = [first] + [r for r in healthy if r != first]
        for i, rid in enumerate(order):
            out = self._proxy(rid, "POST", "/v1/jobs", body, headers)
            if out is None:
                continue        # dead mid-route: next healthy replica
            code, payload, ctype, extra = out
            if code == 503 and i + 1 < len(order):
                continue        # draining/fenced since its last beat
            self._metric("routed" if i == 0 else "rerouted")
            return code, payload, ctype, extra
        return self._unavailable()

    def _route_read(self, rest: List[str], path: str,
                    headers: Optional[dict] = None) -> tuple:
        sid = rest[1]
        sub = rest[2] if len(rest) == 3 else ""
        candidates = self._owner_candidates(sid)
        # redirect only straight to the sid's MINTING replica when it
        # heads the candidate list (it always knows its own sessions);
        # a claim-chain owner may never have adopted an already-
        # finished sid — proxy those so the 404 fallthrough below can
        # try the rest of the chain and the result store
        if self.redirect_reads and sub != "events" and candidates \
                and candidates[0] == owner_of(sid):
            port = self._replica_port(candidates[0])
            self._metric("proxied")
            return 307, {"redirect": candidates[0]}, \
                "application/json", \
                {"Location": f"http://127.0.0.1:{port}{path}"}
        for owner in candidates:
            if sub == "events":
                stream = self._proxy_stream(owner, path, headers)
                if stream is not None:
                    self._metric("proxied")
                    return 200, stream, "application/x-ndjson", \
                        {"X-Mrtpu-Replica": owner}
            else:
                out = self._proxy(owner, "GET", path, b"", headers)
                # a live candidate may not know this sid (a claimant
                # never adopts sessions that FINISHED before their
                # owner died; a rejoined minter dropped its claimed
                # ones) — its 404 is not the final answer while the
                # rest of the chain or the result store may hold it
                if out is not None and out[0] != 404:
                    self._metric("proxied")
                    return out
        # every candidate dead, unreachable or answering 404: the
        # shared result store still serves every TERMINAL session
        # (reads survive ownership moves)
        res = self._stored_result(sid)
        if res is None:
            if not self.fleet.healthy():
                return self._unavailable()
            return 404, {"error": f"no session {sid!r} reachable "
                                  f"(owner down, no stored result)"}, \
                "application/json", None
        denied = self._auth_fallback(headers, res)
        if denied:
            return denied
        self._metric("fallback")
        if sub == "result":
            return 200, res, "application/json", None
        summary = {"id": res.get("id"), "tenant": res.get("tenant"),
                   "state": res.get("status"),
                   "error": res.get("error"),
                   "failed_over": (res.get("meta") or {}).get(
                       "failed_over", False),
                   "trace_id": (res.get("meta") or {}).get("trace_id")}
        if sub == "profile":
            prof = (res.get("meta") or {}).get("profile")
            if prof:
                return 200, {"id": sid, "live": False,
                             "trace_id": summary["trace_id"],
                             "profile": prof}, "application/json", None
            return 200, {**summary, "error": "profile unavailable"}, \
                "application/json", None
        if sub == "events":
            lines = []
            prof = (res.get("meta") or {}).get("profile")
            if prof:
                lines.append(json.dumps({"event": "profile",
                                         "profile": prof}) + "\n")
            lines.append(json.dumps({"event": "status", **summary})
                         + "\n")
            return 200, iter(lines), "application/x-ndjson", None
        return 200, summary, "application/json", None

    def _any_healthy(self, method: str, path: str, body: bytes,
                     headers: Optional[dict] = None) -> tuple:
        for rid in self.fleet.healthy():
            out = self._proxy(rid, method, path, body, headers)
            if out is not None:
                return out
        return self._unavailable()

    def _merged_jobs(self, headers: Optional[dict] = None) -> tuple:
        jobs: List[dict] = []
        seen = set()
        for rid in self.fleet.healthy():
            out = self._proxy(rid, "GET", "/v1/jobs", b"", headers)
            if out is not None and out[0] in (401, 403):
                # a replica refused the credentials: pass its answer
                # through verbatim — 200 {"jobs": []} would disguise a
                # bad token as an empty fleet
                return out
            if out is None or out[0] != 200:
                continue
            try:
                for j in json.loads(out[1].decode()).get("jobs", []):
                    if j.get("id") not in seen:
                        seen.add(j.get("id"))
                        jobs.append(j)
            except (ValueError, AttributeError):
                continue
        return 200, {"jobs": jobs}, "application/json", None

    def _fleet_stats(self, headers: Optional[dict] = None) -> tuple:
        # the daemons gate /v1/stats admin-only; the router's SELF-
        # composed topology answer (replica ids/ports/epochs/ring)
        # must hold the same line — no replica is in the loop to
        # enforce it for us
        if self.auth.armed:
            code, err = self.auth.gate(dict(headers or {}), admin=True)
            if code:
                extra = {"WWW-Authenticate": "Bearer"} \
                    if code == 401 else None
                return code, err, "application/json", extra
        replicas = {}
        for rid, lease in sorted(self.fleet.peers().items()):
            state = self.fleet.replica_state(rid, lease)
            row = {"state": state, "port": lease.get("port"),
                   "epoch": lease.get("epoch")}
            if state in ("ready", "draining", "degraded"):
                out = self._proxy(rid, "GET", "/v1/stats", b"", headers)
                if out is not None and out[0] == 200:
                    try:
                        row["stats"] = json.loads(out[1].decode())
                    except ValueError:
                        pass
            replicas[rid] = row
        return 200, {"fleet_dir": self.fleet_dir,
                     "healthy": self.fleet.healthy(),
                     "replicas": replicas}, "application/json", None

    # -- metrics federation -------------------------------------------------
    def _fleet_members(self, headers: Optional[dict] = None
                       ) -> List[dict]:
        """Every federation member with its registry snapshot: the
        replicas from the lease table (live ones scraped over
        ``/metrics.json``), the data-plane ranks from the run dir's
        dump channel (``metrics-r<rank>.json``).  A member that is dead
        or unreachable is STILL a row — up=0, stale=1 — never silently
        absent."""
        from ..obs.fleetobs import (member_row, rank_dump_stale,
                                    read_rank_dumps)
        from ..utils.env import env_str
        now = time.time()
        members: List[dict] = []
        for rid, lease in sorted(self.fleet.peers().items()):
            state = self.fleet.replica_state(rid, lease)
            try:
                age = max(0.0, now - float(lease.get("ts", now)))
            except (TypeError, ValueError):
                age = 0.0
            snap = None
            if state in ("ready", "draining", "degraded"):
                out = self._proxy(rid, "GET", "/metrics.json", b"",
                                  headers)
                if out is not None and out[0] == 200:
                    try:
                        snap = json.loads(out[1].decode())
                    except ValueError:
                        snap = None
            members.append(member_row(
                replica=rid, up=snap is not None,
                stale=snap is None, age_s=age, metrics=snap,
                state=state))
        rundir = env_str("MRTPU_FLEET_RUNDIR", "") \
            or env_str("MRTPU_DIST_RUNDIR", "")
        if rundir:
            for rank, doc in sorted(read_rank_dumps(rundir).items()):
                age = min(rank_dump_stale(doc, now), 9e9)
                try:
                    every = float(doc.get("every_s", 5.0))
                except (TypeError, ValueError):
                    every = 5.0
                fresh = age <= 3.0 * every + 1.0
                members.append(member_row(
                    rank=str(rank), up=fresh, stale=not fresh,
                    age_s=age, metrics=doc.get("metrics"),
                    state=str(doc.get("reason", ""))))
        return members

    def _metrics_fleet(self, method: str, path: str, body: bytes,
                       headers: Optional[dict] = None) -> tuple:
        """``GET /metrics/fleet`` (Prometheus text) and
        ``/metrics/fleet.json`` — the whole fleet's series under one
        scrape, ``{replica,rank}``-labeled, with honest staleness.
        Ungated, like the builtin ``/metrics`` it federates."""
        if method != "GET":
            return 405, {"error": "GET only"}, "application/json", None
        from ..obs.fleetobs import federate_text
        members = self._fleet_members(headers)
        if path.endswith(".json"):
            return 200, {"fleet_dir": self.fleet_dir,
                         "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                              time.gmtime()),
                         "members": members}, "application/json", None
        return 200, federate_text(members), \
            "text/plain; version=0.0.4; charset=utf-8", None

    def _broadcast(self, method: str, path: str, body: bytes,
                   headers: Optional[dict] = None) -> tuple:
        out = {}
        for rid, lease in sorted(self.fleet.peers().items()):
            if self.fleet.expired(lease):
                continue
            got = self._proxy(rid, method, path, body, headers)
            out[rid] = None if got is None else got[0]
        if not out:
            return self._unavailable()
        return 200, {"sent": out}, "application/json", None


def discover(fleet_dir: str) -> Optional[Tuple[str, int]]:
    """Find SOMETHING serving this fleet: the router first
    (``router.json``), else any live ready replica's lease.  Returns
    ``(kind, port)`` or None — the client-side half of "a client
    pointed at a dead replica finds the fleet"."""
    import socket
    rec = None
    try:
        with open(os.path.join(fleet_dir, "router.json")) as f:
            rec = json.load(f)
    except (OSError, ValueError):
        pass
    if rec and rec.get("port"):
        # a kill -9'd router leaves its record behind — probe before
        # trusting, else every re-discovery retry would loop back to
        # the same dead port while live replicas hold valid leases
        port = int(rec["port"])
        try:
            socket.create_connection(("127.0.0.1", port),
                                     timeout=0.5).close()
            return ("router", port)
        except OSError:
            pass                # stale record: fall through to leases
    member = FleetMember(fleet_dir, f"probe{os.getpid()}")
    now = time.time()
    for rid in member.healthy(now):
        lease = member.lease(rid)
        if lease and lease.get("port"):
            return ("replica", int(lease["port"]))
    return None
