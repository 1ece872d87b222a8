"""Thin HTTP client for the serve/ daemon (stdlib urllib only).

Used by ``python -m gpu_mapreduce_tpu_torch.ctl``, ``chip_smoke.py``
and the tests — one implementation of the wire protocol, so "what does
a 429 look like" has a single answer.
"""

from __future__ import annotations

import json
import time
import urllib.error
import urllib.request
from typing import Optional

from ..core.errors import MRError


class ServeError(MRError):
    """Non-2xx daemon response; carries the code and Retry-After."""

    def __init__(self, code: int, body: dict,
                 retry_after: Optional[int] = None):
        self.code = code
        self.body = body
        self.retry_after = retry_after
        super().__init__(f"serve HTTP {code}: "
                         f"{body.get('error') or body}")


class ServeClient:
    def __init__(self, base: str, timeout: float = 30.0,
                 retries: int = 0, state_dir: Optional[str] = None,
                 token: Optional[str] = None):
        self.base = base.rstrip("/")
        self.timeout = timeout
        # connection-level resilience (fleet clients, ctl): retry a
        # refused/reset connection up to ``retries`` times with the ft/
        # backoff curve, re-discovering the fleet between attempts when
        # we know the state dir — a client pointed at a dead replica
        # finds the survivors instead of exiting
        self.retries = max(0, int(retries))
        self.state_dir = state_dir
        # tenant bearer token (MRTPU_SERVE_TOKENS on the daemon side):
        # rides every request, including the /events stream and the
        # healthz probe; defaults from MRTPU_SERVE_TOKEN so ctl
        # inherits it — doc/serve.md#tenant-auth
        if token is None:
            from ..utils.env import env_str
            token = env_str("MRTPU_SERVE_TOKEN", "") or None
        self.token = token

    @classmethod
    def local(cls, port: int, **kw) -> "ServeClient":
        return cls(f"http://127.0.0.1:{port}", **kw)

    @classmethod
    def from_state_dir(cls, state_dir: str, **kw) -> "ServeClient":
        """Discover the daemon's bound port from ``<state>/serve.json``
        (written atomically at start — ephemeral-port friendly).  A
        FLEET directory (``<state>/fleet/`` exists) discovers the
        router (``router.json``) first, then any live ready replica."""
        import os
        kw.setdefault("state_dir", state_dir)
        if os.path.isdir(os.path.join(state_dir, "fleet")):
            from .router import discover
            found = discover(state_dir)
            if found is not None:
                return cls.local(found[1], **kw)
            raise OSError(f"no live router or replica under "
                          f"{state_dir!r}")
        with open(os.path.join(state_dir, "serve.json")) as f:
            return cls.local(int(json.load(f)["port"]), **kw)

    def _rediscover(self) -> None:
        """Between connection retries: re-resolve who is serving (the
        dead replica's lease lapses; the router or a survivor answers)."""
        if self.state_dir is None:
            return
        try:
            fresh = ServeClient.from_state_dir(self.state_dir)
            self.base = fresh.base
        except (OSError, ValueError):
            pass              # nothing found YET — retry the old base

    @staticmethod
    def _refused(e: BaseException) -> bool:
        """A connection-level failure worth retrying (the ft/retry
        transient classification, applied to the socket layer)."""
        from ..ft.retry import classify
        reason = getattr(e, "reason", e)
        return classify("serve.connect", reason if isinstance(
            reason, BaseException) else e) == "transient"

    @staticmethod
    def _never_sent(e: BaseException) -> bool:
        """The CONNECT itself was refused: nothing was listening, so
        the request was never delivered anywhere.  Only this narrow
        class is safe to retry for a non-idempotent POST — a reset
        mid-exchange may have been ACCEPTED (journaled, 202 lost on
        the wire), and resubmitting would mint a second session for
        the same logical job."""
        reason = getattr(e, "reason", e)
        return isinstance(reason, ConnectionRefusedError)

    # -- wire --------------------------------------------------------------
    def _req(self, method: str, path: str,
             obj: Optional[dict] = None) -> dict:
        attempt = 0
        while True:
            try:
                return self._req_once(method, path, obj)
            except ServeError:
                raise
            except urllib.error.URLError as e:
                retryable = self._never_sent(e) if method == "POST" \
                    else self._refused(e)
                if attempt >= self.retries or not retryable:
                    raise
                from ..ft.retry import _backoff
                time.sleep(_backoff(attempt))
                attempt += 1
                self._rediscover()

    def _headers(self, data: bool = False) -> dict:
        h = {"Content-Type": "application/json"} if data else {}
        if self.token:
            h["Authorization"] = f"Bearer {self.token}"
        return h

    def _req_once(self, method: str, path: str,
                  obj: Optional[dict] = None, hops: int = 0) -> dict:
        data = json.dumps(obj).encode() if obj is not None else None
        req = urllib.request.Request(
            self.base + path, data=data, method=method,
            headers=self._headers(data is not None))
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read().decode() or "{}")
        except urllib.error.HTTPError as e:
            if e.code in (307, 308) and hops < 4:
                # the fleet router's replica redirect: follow it to the
                # owning replica (urllib only auto-follows GET 30x; the
                # explicit hop also covers POST and keeps the count
                # bounded)
                loc = e.headers.get("Location")
                e.read()
                if loc:
                    from urllib.parse import urlsplit
                    u = urlsplit(loc)
                    base = f"{u.scheme}://{u.netloc}"
                    saved, self.base = self.base, base
                    try:
                        return self._req_once(
                            method, u.path + (f"?{u.query}" if u.query
                                              else ""), obj,
                            hops=hops + 1)
                    finally:
                        self.base = saved
            raw = e.read().decode(errors="replace")
            try:
                body = json.loads(raw)
            except ValueError:
                body = {"error": raw}
            ra = e.headers.get("Retry-After")
            raise ServeError(e.code, body,
                             int(ra) if ra and ra.isdigit() else None) \
                from None

    # -- API ---------------------------------------------------------------
    def submit(self, script: Optional[str] = None,
               ops: Optional[list] = None,
               tenant: Optional[str] = None,
               priority: Optional[int] = None,
               session: Optional[str] = None,
               deadline_ms: Optional[int] = None,
               retry_after_wait: float = 0.0) -> dict:
        """Submit one job.  ``tenant`` omitted means "whatever my
        bearer token names" on an auth-armed daemon (else "default").
        ``deadline_ms`` bounds the session's EXECUTION time (cancelled
        at the next op barrier past it).

        ``retry_after_wait`` (seconds, opt-in): when the daemon answers
        429 **with a Retry-After** (rate limit, queue backpressure, SLO
        shed), sleep that hint and resubmit — but only while the TOTAL
        slept stays within the budget, so a shed client waits honestly
        instead of hot-looping, yet can never hang past its own bound.
        0 (default) = raise immediately."""
        body: dict = {} if tenant is None else {"tenant": tenant}
        if script is not None:
            body["script"] = script
        if ops is not None:
            body["ops"] = ops
        if priority is not None:
            body["priority"] = int(priority)
        if deadline_ms is not None:
            body["deadline_ms"] = int(deadline_ms)
        if session is not None:
            # fleet-router affinity key: submissions sharing a key land
            # on the same replica of the healthy ring (serve/router.py)
            body["session"] = str(session)
        budget = max(0.0, float(retry_after_wait))
        slept = 0.0
        while True:
            try:
                return self._req("POST", "/v1/jobs", body)
            except ServeError as e:
                ra = e.retry_after
                if e.code != 429 or ra is None or ra <= 0 \
                        or slept + ra > budget:
                    raise
                time.sleep(ra)
                slept += ra

    def cancel(self, sid: str) -> dict:
        """``DELETE /v1/jobs/<sid>`` — cooperative cancel: queued
        sessions finalize ``cancelled`` immediately, running ones stop
        at their next op barrier.  Raises ServeError(409) once the
        session is terminal (the no-op contract — the result is never
        touched)."""
        return self._req("DELETE", f"/v1/jobs/{sid}")

    def jobs(self) -> list:
        return self._req("GET", "/v1/jobs")["jobs"]

    def status(self, sid: str) -> dict:
        return self._req("GET", f"/v1/jobs/{sid}")

    def result(self, sid: str) -> dict:
        """The result record; raises ServeError(202 body) only via
        :meth:`wait` — a not-done result returns the status summary."""
        return self._req("GET", f"/v1/jobs/{sid}/result")

    def wait(self, sid: str, timeout: float = 120.0,
             poll_s: float = 0.05) -> dict:
        """Poll until the session finishes; returns the result record."""
        deadline = time.monotonic() + timeout
        from .session import TERMINAL as terminal   # ONE definition
        while True:
            out = self._req("GET", f"/v1/jobs/{sid}/result")
            if out.get("status") in terminal or \
                    out.get("state") in terminal:
                return out
            if time.monotonic() > deadline:
                raise ServeError(408, {"error": f"session {sid} still "
                                       f"{out.get('state')!r} after "
                                       f"{timeout}s"})
            time.sleep(poll_s)

    def profile(self, sid: str) -> dict:
        """The per-request cost profile (live while running, durable
        once finished — doc/serve.md)."""
        return self._req("GET", f"/v1/jobs/{sid}/profile")

    def events(self, sid: str, timeout: Optional[float] = None):
        """Generator over ``GET /v1/jobs/<id>/events``: one dict per
        streamed JSON line (status transitions, top-level spans, the
        final profile) until the stream ends — ONE HTTP request, no
        polling.  ``timeout`` is the per-read socket timeout (the
        server heartbeats every ~15 s, so a dead daemon surfaces as an
        OSError rather than a hang)."""
        req = urllib.request.Request(self.base + f"/v1/jobs/{sid}/events",
                                     headers=self._headers())
        try:
            r = urllib.request.urlopen(
                req, timeout=timeout if timeout is not None else 60.0)
        except urllib.error.HTTPError as e:
            raw = e.read().decode(errors="replace")
            try:
                body = json.loads(raw)
            except ValueError:
                body = {"error": raw}
            raise ServeError(e.code, body) from None
        with r:
            for line in r:
                line = line.decode(errors="replace").strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    continue    # torn final line on daemon stop

    # -- standing queries (doc/streaming.md) -------------------------------
    def stream_open(self, sources: Optional[list] = None,
                    parser: str = "words", reduce: str = "count",
                    window: int = 0, tenant: Optional[str] = None,
                    deadline_ms: Optional[int] = None,
                    batch: Optional[dict] = None) -> dict:
        """``POST /v1/streams`` — open a standing query.  ``sources``
        omitted opens a FEED stream (push bytes via
        :meth:`stream_feed`); otherwise the daemon tails the given
        files/directories.  Returns ``{"id", "state", ...}``."""
        body: dict = {"parser": parser, "reduce": reduce}
        if sources is not None:
            body["sources"] = list(sources)
        if window:
            body["window"] = int(window)
        if tenant is not None:
            body["tenant"] = tenant
        if deadline_ms is not None:
            body["deadline_ms"] = int(deadline_ms)
        if batch:
            body["batch"] = dict(batch)
        return self._req("POST", "/v1/streams", body)

    def stream_feed(self, stid: str, data: bytes) -> dict:
        """``POST /v1/streams/<id>/feed`` — append raw bytes to a feed
        stream (newline-terminated records; a torn tail line waits for
        its newline)."""
        if isinstance(data, str):
            data = data.encode()
        req = urllib.request.Request(
            self.base + f"/v1/streams/{stid}/feed", data=data,
            method="POST", headers={**self._headers(),
                                    "Content-Type":
                                        "application/octet-stream"})
        try:
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return json.loads(r.read().decode() or "{}")
        except urllib.error.HTTPError as e:
            raw = e.read().decode(errors="replace")
            try:
                body = json.loads(raw)
            except ValueError:
                body = {"error": raw}
            ra = e.headers.get("Retry-After")
            raise ServeError(e.code, body,
                             int(ra) if ra and ra.isdigit() else None) \
                from None

    def streams(self) -> list:
        return self._req("GET", "/v1/streams")["streams"]

    def stream_status(self, stid: str) -> dict:
        return self._req("GET", f"/v1/streams/{stid}")

    def stream_close(self, stid: str, drain: bool = True) -> dict:
        """``POST /v1/streams/<id>/close`` — final-drain (unless
        ``drain=False``) and retire the query; returns the terminal
        summary."""
        return self._req("POST", f"/v1/streams/{stid}/close",
                         {"drain": bool(drain)})

    def stream_events(self, stid: str, timeout: Optional[float] = None):
        """Generator over ``GET /v1/streams/<id>/events``: one dict
        per streamed JSON line (status, per-batch commits, ticks)
        until a terminal status — same chunked contract as
        :meth:`events`."""
        req = urllib.request.Request(
            self.base + f"/v1/streams/{stid}/events",
            headers=self._headers())
        try:
            r = urllib.request.urlopen(
                req, timeout=timeout if timeout is not None else 60.0)
        except urllib.error.HTTPError as e:
            raw = e.read().decode(errors="replace")
            try:
                body = json.loads(raw)
            except ValueError:
                body = {"error": raw}
            raise ServeError(e.code, body) from None
        with r:
            for line in r:
                line = line.decode(errors="replace").strip()
                if not line:
                    continue
                try:
                    yield json.loads(line)
                except ValueError:
                    continue    # torn final line on daemon stop

    def slo(self) -> dict:
        return self._req("GET", "/v1/slo")

    def stats(self) -> dict:
        return self._req("GET", "/v1/stats")

    def fleet_metrics(self) -> dict:
        """``GET /metrics/fleet.json`` (router-only): every federation
        member — replicas and data-plane ranks — with liveness,
        staleness and its merged registry snapshot (``ctl top``)."""
        return self._req("GET", "/metrics/fleet.json")

    def drain(self) -> dict:
        return self._req("POST", "/v1/drain")

    def shutdown(self) -> dict:
        return self._req("POST", "/v1/shutdown")

    def healthz(self) -> bool:
        """READY (200 ``{"status": "ok"}``), not merely alive: a
        draining/paused/fenced replica answers 503 here and reads
        False — the router/LB routing predicate."""
        try:
            req = urllib.request.Request(self.base + "/healthz",
                                         headers=self._headers())
            with urllib.request.urlopen(req, timeout=self.timeout) as r:
                return r.status == 200
        except (urllib.error.URLError, OSError):
            return False
