"""Serve-plane standing queries: the daemon side of ``/v1/streams``.

One :class:`StreamManager` per Server owns every open stream: minting
ids (``st<seq>``), the ``stream_open``/``stream_close`` serve-journal records that
make streams recoverable (journal before the 202, same discipline as
submits), one runner thread per stream driving the engine's scheduler,
and the tenant plumbing — budget defaults pin the resident dataset's
page settings, the per-stream :class:`~..obs.context.RequestAccount`
carries the deadline and charges every batch's spans/counters to the
tenant, and ``page_account_scope`` bills resident pages to the tenant
gauge.

Recovery rides the session machinery's rails: a restarted daemon
re-opens every stream whose ``stream_open`` has no ``stream_close``
(the engine resumes from its journal's last committed cursor) —
doc/streaming.md#the-serve-surface.  The fleet takeover of a dead
replica's streams comes with fleet mode, which is not ported yet.

Memoization never applies to streams: a standing query's result is a
moving target, not a pure function of its submission
(serve/memo.py skips any script that mentions ``stream`` for the same
reason).
"""

from __future__ import annotations

import os
import threading
import time
from typing import Dict, List, Optional

from ..core.runtime import CancelledError, MRError
from ..utils.env import env_knob

ST_OPEN, ST_CLOSED, ST_FAILED = "open", "closed", "failed"
ST_TERMINAL = (ST_CLOSED, ST_FAILED)


class StreamSession:
    """One open stream on this daemon: engine + runner thread +
    tenant account."""

    def __init__(self, stid: str, tenant: str, spec: dict,
                 sources: List[str], dir: str,
                 deadline_ms: Optional[int], trace_id: str,
                 failed_over: bool = False):
        self.stid = stid
        self.tenant = tenant
        self.spec = dict(spec)
        self.sources = list(sources)
        self.dir = dir
        self.deadline_ms = deadline_ms
        self.trace_id = trace_id
        self.failed_over = failed_over
        self.state = ST_OPEN
        self.error: Optional[str] = None
        self.created_utc = time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                         time.gmtime())
        self.feed_path: Optional[str] = None
        self.engine = None
        self.account = None
        self._thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        self._wake = threading.Event()

    def summary(self) -> dict:
        out = {"id": self.stid, "tenant": self.tenant,
               "state": self.state, "error": self.error,
               "created_utc": self.created_utc,
               "deadline_ms": self.deadline_ms,
               "failed_over": self.failed_over,
               "trace_id": self.trace_id,
               "feed": bool(self.feed_path)}
        eng = self.engine
        if eng is not None:
            out["stream"] = eng.status()
        return out


class StreamManager:
    """The Server's stream registry and lifecycle."""

    def __init__(self, server):
        self.server = server
        self.streams: Dict[str, StreamSession] = {}
        self._order: List[str] = []
        self._lock = threading.Lock()
        self._seq = 0
        self.max_open = max(1, env_knob("MRTPU_SERVE_STREAMS", int, 8))
        self.poll_s = max(0.005,
                          env_knob("MRTPU_STREAM_POLL_MS", int, 20)
                          / 1000.0)

    # -- id minting --------------------------------------------------------
    def _mint(self) -> str:
        self._seq += 1
        return f"st{self._seq:06d}"

    def note_seq(self, rec: dict) -> None:
        """Recovery: keep the mint counter ahead of every journaled
        stream id."""
        self._seq = max(self._seq, int(rec.get("stseq", 0)))

    def stream_dir(self, stid: str) -> str:
        return os.path.join(self.server.state_dir, "streams", stid)

    # -- open --------------------------------------------------------------
    def open(self, body: dict) -> tuple:
        """→ (code, dict, extra_headers).  Journal before the 202,
        admission gates first — same shape as Server.submit."""
        srv = self.server
        if srv._draining:
            return 503, {"error": "draining: not admitting new "
                                  "streams"}, {"Retry-After": 60}
        pressure = srv.disk.check()
        if pressure:
            srv._note_shed(str(body.get("tenant") or "default"),
                           "disk")
            return 503, {"error": f"degraded: {pressure}"}, \
                {"Retry-After": 30}
        tenant = str(body.get("tenant") or "default")
        from ..stream.engine import ACCUMULATORS, PARSERS
        parser = str(body.get("parser") or "words")
        reduce = str(body.get("reduce") or "count")
        if parser not in PARSERS:
            return 400, {"error": f"unknown parser {parser!r}"}, None
        if reduce not in ACCUMULATORS:
            return 400, {"error": f"unknown reduce {reduce!r}"}, None
        try:
            window = max(0, int(body.get("window") or 0))
        except (TypeError, ValueError):
            return 400, {"error": "window must be an integer"}, None
        sources = body.get("sources")
        if sources is not None and (
                not isinstance(sources, list)
                or not all(isinstance(s, str) for s in sources)):
            return 400, {"error": "sources must be a list of "
                                  "paths"}, None
        deadline_ms = body.get("deadline_ms")
        if deadline_ms is not None:
            try:
                deadline_ms = int(deadline_ms)
                if deadline_ms <= 0:
                    raise ValueError(deadline_ms)
            except (TypeError, ValueError):
                return 400, {"error": "deadline_ms must be a "
                                      "positive integer"}, None
        batch = body.get("batch") or {}
        spec = {"parser": parser, "reduce": reduce, "window": window,
                "batch": {k: batch[k] for k in
                          ("rows", "bytes", "wait_ms")
                          if isinstance(batch, dict) and k in batch}}
        with self._lock:
            live = sum(1 for s in self.streams.values()
                       if s.state == ST_OPEN)
            if live >= self.max_open:
                return 429, {"error": f"stream cap reached "
                                      f"({self.max_open} open)"}, \
                    {"Retry-After": 30}
        with srv._submit_lock:
            if srv._journal is None:
                return 503, {"error": "shutting down"}, \
                    {"Retry-After": 60}
            stid = self._mint()
            sdir = self.stream_dir(stid)
            feed = sources is None
            src_list = [os.path.join(sdir, "feed.dat")] if feed \
                else [os.path.abspath(s) for s in sources]
            from ..obs.context import new_trace_id
            trace_id = new_trace_id()
            # the record lands BEFORE the client's 202 — a crash after
            # this line re-opens the stream on restart, before it the
            # client never heard "open"
            srv._journal.append({
                "kind": "stream_open", "stid": stid, "tenant": tenant,
                "stseq": self._seq, "spec": spec,
                "sources": src_list, "feed": feed,
                "dl": deadline_ms, "trace": trace_id})
        ss = StreamSession(stid, tenant, spec, src_list, sdir,
                           deadline_ms, trace_id)
        if feed:
            ss.feed_path = src_list[0]
            os.makedirs(sdir, exist_ok=True)
            with open(ss.feed_path, "ab"):
                pass
        try:
            self._boot(ss)
        except Exception as e:        # noqa: BLE001 — isolate the open
            ss.state = ST_FAILED
            ss.error = f"{type(e).__name__}: {e}"
        with self._lock:
            self.streams[stid] = ss
            self._order.append(stid)
        with srv._watch_lock:
            srv._trace_sids[trace_id] = stid
        if ss.state == ST_FAILED:
            return 500, ss.summary(), None
        return 202, {"id": stid, "state": ss.state, "tenant": tenant,
                     "feed": bool(ss.feed_path),
                     "trace_id": trace_id}, None

    def _boot(self, ss: StreamSession,
              start_runner: Optional[bool] = None) -> None:
        """Construct the engine (resuming from its journal when the
        directory has committed batches) and start the runner."""
        from ..obs import context as obs_context
        from ..stream import Stream
        srv = self.server
        os.makedirs(ss.dir, exist_ok=True)
        spill = os.path.join(ss.dir, "spill")
        os.makedirs(spill, exist_ok=True)
        settings = srv.budgets.defaults_for(ss.tenant, spill)
        batch = ss.spec.get("batch") or {}
        wait_ms = batch.get("wait_ms")
        ss.engine = Stream(
            ss.dir, ss.sources, parser=ss.spec["parser"],
            reduce=ss.spec["reduce"],
            window=int(ss.spec.get("window") or 0),
            comm=srv.comm, device=srv.device, settings=settings,
            rows=batch.get("rows"), nbytes=batch.get("bytes"),
            wait_s=None if wait_ms is None
            else max(0.0, int(wait_ms) / 1000.0),
            name=ss.stid)
        req = obs_context.RequestAccount(trace_id=ss.trace_id,
                                         tenant=ss.tenant,
                                         label=f"stream:{ss.stid}")
        if ss.deadline_ms:
            req.set_deadline(ss.deadline_ms / 1000.0)
        ss.account = req
        if start_runner is None:
            start_runner = not srv.paused
        if start_runner:
            t = threading.Thread(target=self._runner, args=(ss,),
                                 name=f"mrtpu-stream-{ss.stid}",
                                 daemon=True)
            t.start()
            ss._thread = t

    def _runner(self, ss: StreamSession) -> None:
        """One stream's scheduler loop: poll under the tenant's page
        account + request context, push a ``batch`` event per commit,
        finalize on deadline/cancel/failure."""
        from ..core.runtime import page_account_scope
        from ..obs import context as obs_context
        srv = self.server
        acct = srv.budgets.account(ss.tenant)
        eng = ss.engine
        try:
            while not ss._stop.is_set() and ss.state == ST_OPEN:
                with page_account_scope(acct), \
                        obs_context.use(ss.account):
                    rows = eng.poll_once()
                if rows > 0:
                    st = eng.status()
                    srv._push_event(ss.stid, {
                        "event": "batch", "id": ss.stid,
                        "seq": st["batches"], "rows": rows,
                        "pending_bytes": st["pending_bytes"],
                        "lag_s": st["lag_s"]})
                    continue            # drain hot: no sleep mid-burst
                ss._wake.wait(self.poll_s)
                ss._wake.clear()
        except CancelledError as e:
            ss.state = ST_CLOSED
            ss.error = f"cancelled ({e.reason})"
            self._journal_close(ss)
            srv._push_event(ss.stid,
                            {"event": "status", **ss.summary()})
        except Exception as e:          # noqa: BLE001 — isolation
            ss.state = ST_FAILED
            ss.error = f"{type(e).__name__}: {e}"
            disk = getattr(srv, "disk", None)
            if disk is not None:
                disk.note_error(e)
            srv._push_event(ss.stid,
                            {"event": "status", **ss.summary()})

    # -- feed / status / close ---------------------------------------------
    def feed(self, stid: str, data: bytes) -> tuple:
        ss = self.get(stid)
        if ss is None:
            return 404, {"error": f"no stream {stid!r}"}
        if ss.state != ST_OPEN:
            return 409, {"error": f"stream {stid!r} is {ss.state}"}
        if not ss.feed_path:
            return 409, {"error": f"stream {stid!r} tails external "
                                  f"sources; append to those instead"}
        with open(ss.feed_path, "ab") as f:
            f.write(data)
            f.flush()
            os.fsync(f.fileno())
        ss._wake.set()
        return 202, {"id": stid, "bytes": len(data),
                     "pending_bytes":
                         ss.engine.tailer.pending_bytes()}

    def get(self, stid: str) -> Optional[StreamSession]:
        with self._lock:
            return self.streams.get(stid)

    def list(self) -> List[dict]:
        with self._lock:
            order = list(self._order)
            return [self.streams[s].summary() for s in order
                    if s in self.streams]

    def close(self, stid: str, drain: bool = True) -> tuple:
        """Stop the runner, final-drain, journal ``stream_close`` —
        the stream's terminal record (recovery stops re-opening it)."""
        ss = self.get(stid)
        if ss is None:
            return 404, {"error": f"no stream {stid!r}"}
        if ss.state in ST_TERMINAL:
            return 409, {"error": f"stream {stid!r} already "
                                  f"{ss.state}"}
        ss._stop.set()
        ss._wake.set()
        if ss._thread is not None:
            ss._thread.join(timeout=60.0)
        from ..core.runtime import page_account_scope
        from ..obs import context as obs_context
        acct = self.server.budgets.account(ss.tenant)
        try:
            with page_account_scope(acct), \
                    obs_context.use(ss.account):
                ss.engine.close(drain=drain)
            ss.state = ST_CLOSED if ss.engine.state != "failed" \
                else ST_FAILED
            ss.error = ss.error or ss.engine.error
        except Exception as e:          # noqa: BLE001
            ss.state = ST_FAILED
            ss.error = f"{type(e).__name__}: {e}"
        self._journal_close(ss)
        self.server._push_event(stid,
                                {"event": "status", **ss.summary()})
        return 200, ss.summary()

    def _journal_close(self, ss: StreamSession) -> None:
        srv = self.server
        with srv._submit_lock:
            if srv._journal is not None:
                try:
                    srv._journal.append({"kind": "stream_close",
                                         "stid": ss.stid,
                                         "state": ss.state,
                                         "trace": ss.trace_id})
                except (ValueError, OSError):
                    pass

    # -- recovery / failover -----------------------------------------------
    def recover(self, opens: List[dict]) -> None:
        """Re-open every journaled stream without a close record: the
        engine resumes from ITS journal (last committed cursors +
        state), so the re-opened stream picks up exactly where the
        dead process stopped."""
        for rec in opens:
            self.note_seq(rec)
            stid = rec.get("stid", "")
            if not stid:
                continue
            ss = StreamSession(
                stid, rec.get("tenant", "default"),
                rec.get("spec") or {}, list(rec.get("sources") or []),
                self.stream_dir(stid), rec.get("dl") or None,
                rec.get("trace") or "", failed_over=bool(rec.get("fo")))
            if rec.get("feed"):
                ss.feed_path = ss.sources[0] if ss.sources else None
            try:
                self._boot(ss)
            except Exception as e:      # noqa: BLE001
                ss.state = ST_FAILED
                ss.error = f"{type(e).__name__}: {e}"
            with self._lock:
                self.streams[stid] = ss
                self._order.append(stid)
            if ss.trace_id:
                with self.server._watch_lock:
                    self.server._trace_sids[ss.trace_id] = stid

    def suspend_all(self) -> None:
        """Daemon shutdown: stop runners and release journal handles
        WITHOUT stream_close records — open streams are durable state,
        and the next start resumes them."""
        with self._lock:
            sessions = list(self.streams.values())
        for ss in sessions:
            ss._stop.set()
            ss._wake.set()
        for ss in sessions:
            if ss._thread is not None:
                ss._thread.join(timeout=10.0)
            eng = ss.engine
            if eng is not None:
                try:
                    eng.suspend()
                except Exception:
                    pass

    def snapshot(self) -> dict:
        with self._lock:
            by_state: Dict[str, int] = {}
            for s in self.streams.values():
                by_state[s.state] = by_state.get(s.state, 0) + 1
            return {"open": by_state.get(ST_OPEN, 0),
                    "by_state": by_state,
                    "total": len(self._order),
                    "cap": self.max_open}

    # -- events ------------------------------------------------------------
    def events_stream(self, stid: str, timeout: float = 600.0):
        """NDJSON generator behind ``GET /v1/streams/<id>/events`` —
        the jobs events shape: subscribe before snapshot,
        per-batch events as they commit, 15 s ticks, ends at a
        terminal state, daemon stop, or the timeout."""
        import json as _json
        import queue as _queue

        from ..obs.sinks import _jsonable

        def line(obj) -> str:
            return _json.dumps(obj, default=_jsonable) + "\n"

        srv = self.server
        q: _queue.Queue = _queue.Queue(maxsize=512)
        with srv._watch_lock:
            srv._watch.setdefault(stid, []).append(q)
        try:
            ss = self.get(stid)
            if ss is None:
                yield line({"event": "error",
                            "error": f"no stream {stid!r}"})
                return
            yield line({"event": "status", **ss.summary()})
            if ss.state in ST_TERMINAL:
                return
            deadline = time.monotonic() + timeout
            last_beat = time.monotonic()
            while time.monotonic() < deadline \
                    and not srv._stopped.is_set():
                try:
                    item = q.get(timeout=0.25)
                except _queue.Empty:
                    if time.monotonic() - last_beat >= 15.0:
                        last_beat = time.monotonic()
                        yield line({"event": "tick"})
                    continue
                yield line(item)
                if item.get("event") == "status" and \
                        item.get("state") in ST_TERMINAL:
                    return
        finally:
            with srv._watch_lock:
                qs = srv._watch.get(stid)
                if qs is not None and q in qs:
                    qs.remove(q)
                    if not qs:
                        del srv._watch[stid]
