"""One accepted request = one session.

A session owns: its own OINK namespace (a caller-owned ObjectManager —
two tenants both running ``mr x`` never collide), a private directory
under ``<state>/sessions/<sid>/`` holding its output files (``out/``),
its spill scratch (``spill/``), and its ft/ journal + auto-checkpoints
(``journal.jsonl``, ``ckpt-*``), and a tenant page account installed as
a thread scope for the whole run.

Crash recovery: a session that was RUNNING when the daemon died left a
journal with a ``begin`` record (and usually a checkpoint) in its
directory; :func:`run_session` detects that on the replayed attempt and
drives ``ft.resume_into`` instead of a fresh ``run_string`` — the
recorded command prefix is skipped, the MRs restore from the last
durable checkpoint, and the remaining commands re-execute, reproducing
the session's output FILES byte-identically (screen output of already-
checkpointed commands is not replayed — doc/serve.md#recovery).

On the card, a session that meets a CUDA error or an out-of-memory
(``ft.retry.device_error``) finishes FAILED with the error in its
result: it is never retried and never rerun on the CPU.  Sessions
share the card's default stream, so a session's synchronise also waits
for another session's queued launches; its ``meta`` deltas stay exact
because they are charged through its own thread-scoped request account.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
from dataclasses import dataclass, field
from typing import Optional

from ..core.errors import CancelledError, MRError

QUEUED, RUNNING, DONE, FAILED, CANCELLED = \
    "queued", "running", "done", "failed", "cancelled"
# the states a session never leaves (and the only ones whose result
# files exist): terminal-ness has ONE definition so a new state can't
# silently leak out of half the checks
TERMINAL = (DONE, FAILED, CANCELLED)

# result files stay fetchable but must not become a covert bulk store:
# bigger payloads ship as sha256 + size only
_INLINE_FILE_CAP = 256 * 1024
# same discipline for captured screen output: one print-happy tenant
# must not grow the daemon's heap (or the fsync'd result file) without
# bound — the tail past the cap is dropped with a marker
_OUTPUT_CAP = 4 * _INLINE_FILE_CAP


class _CappedScreen:
    """A write-only text sink that keeps the first ``cap`` characters
    and counts the rest (bounds both worker heap and result size)."""

    def __init__(self, cap: int = _OUTPUT_CAP):
        self.cap = cap
        self._parts: list = []
        self._len = 0
        self.dropped = 0

    def write(self, s: str) -> int:
        room = self.cap - self._len
        if room > 0:
            kept = s[:room]
            self._parts.append(kept)
            self._len += len(kept)
            self.dropped += len(s) - len(kept)
        else:
            self.dropped += len(s)
        return len(s)

    def flush(self) -> None:
        pass

    def getvalue(self) -> str:
        text = "".join(self._parts)
        if self.dropped:
            text += f"\n...[output truncated: {self.dropped} more " \
                    f"characters dropped past the {self.cap} cap]\n"
        return text


@dataclass
class Session:
    sid: str
    tenant: str
    payload: str                  # the OINK script text (ops batches
    #                               normalize to one at submit time)
    fmt: str = "oink"
    state: str = QUEUED
    submitted_utc: str = ""
    error: Optional[str] = None
    wall_s: Optional[float] = None
    resumed: bool = False
    priority: int = 0             # admission priority (higher first)
    resharded: bool = False       # resumed onto a different mesh width
    failed_over: bool = False     # replayed here from a dead replica's
    #                               claimed journal (serve/fleet.py)
    finished_ts: Optional[float] = None   # TTL GC clock (epoch seconds)
    trace_id: str = ""            # request trace context (obs/context)
    deadline_ms: Optional[int] = None     # execution budget (submit body
    #                               `deadline_ms`; rides the journal)
    cancel_requested: Optional[str] = None  # reason, set by DELETE /
    #                               watchdog before the account exists
    cancel_reason: Optional[str] = None   # why a CANCELLED session died
    stalled: bool = False         # watchdog: no barrier progress for
    #                               MRTPU_SERVE_STALL seconds
    mesh_width: Optional[int] = None      # autoscaler-chosen width
    account: Optional[object] = field(default=None, repr=False,
                                      compare=False)   # live profile

    def summary(self) -> dict:
        return {"id": self.sid, "tenant": self.tenant,
                "state": self.state,
                "submitted_utc": self.submitted_utc,
                "wall_s": self.wall_s, "error": self.error,
                "resumed": self.resumed, "priority": self.priority,
                "resharded": self.resharded,
                "failed_over": self.failed_over,
                "deadline_ms": self.deadline_ms,
                "cancel_reason": self.cancel_reason,
                "stalled": self.stalled,
                "trace_id": self.trace_id}


def normalize_payload(body: dict) -> str:
    """Accept either an OINK script (``{"script": "..."}``) or a JSON
    batch of MR op lines (``{"ops": ["mr x", "x map/file ...", ...]}``)
    and return the script text both execute as."""
    script = body.get("script")
    ops = body.get("ops")
    if isinstance(script, str) and script.strip():
        if ops is not None:
            raise MRError("submit takes script OR ops, not both")
        return script
    if isinstance(ops, list) and ops and \
            all(isinstance(o, str) for o in ops):
        return "\n".join(ops) + "\n"
    raise MRError("submit body needs a non-empty 'script' string or "
                  "'ops' list of command strings")


def _resumable(sdir: str) -> bool:
    from ..ft.journal import read_journal
    try:
        return any(r.get("kind") == "begin" for r in read_journal(sdir))
    except MRError:
        return False


def _collect_files(outdir: str) -> dict:
    out = {}
    for root, _dirs, files in os.walk(outdir):
        for name in sorted(files):
            path = os.path.join(root, name)
            rel = os.path.relpath(path, outdir)
            try:
                # stream the hash: a multi-GB -o dump must not spike
                # the worker's heap by its own size
                h = hashlib.sha256()
                nbytes = 0
                head = b""
                with open(path, "rb") as f:
                    while True:
                        chunk = f.read(1 << 20)
                        if not chunk:
                            break
                        if nbytes <= _INLINE_FILE_CAP:
                            head += chunk
                        h.update(chunk)
                        nbytes += len(chunk)
            except OSError:
                continue
            rec = {"sha256": h.hexdigest(), "bytes": nbytes}
            if nbytes <= _INLINE_FILE_CAP:
                try:
                    rec["text"] = head.decode()
                except UnicodeDecodeError:
                    pass
            out[rel] = rec
    return out


def cancelled_record(sid: str, tenant: str, reason: str,
                     trace_id: Optional[str] = None,
                     deadline_ms: Optional[int] = None,
                     failed_over: bool = False) -> dict:
    """The terminal result record of a session cancelled WITHOUT ever
    running — one function for the DELETE-while-queued finalize, the
    recovery finalize, and the fleet-takeover store write, so the
    record shape cannot drift between them (a session cancelled
    mid-run gets its full record from run_session instead)."""
    return {"id": sid, "tenant": tenant, "status": CANCELLED,
            "error": f"cancelled ({reason})",
            "output": "", "files": {}, "mrs": {},
            "meta": {"trace_id": trace_id, "cancel_reason": reason,
                     "deadline_ms": deadline_ms,
                     "failed_over": failed_over, "ran": False}}


def atomic_write_json(path: str, obj: dict) -> None:
    """tmp + fsync + rename: a crash mid-write leaves only ``*.tmp``,
    never a torn result a restarted daemon would serve."""
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(obj, f, default=str)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _serve_memoized(server, sess: Session, mkey: str,
                    prior: dict) -> dict:
    """Serve one session from the memo store (serve/memo.py): the
    stored output/files/mrs verbatim — byte-identical to the recompute
    by the exactness contract — with 0 plan compiles, 0 dispatches and
    0 MR ops executed.  The worker loop sees ``meta.memo.hit`` and
    journals a ``cache_hit`` record next to the ``serve_done``."""
    from ..obs import context as obs_context
    t0 = time.perf_counter()
    if not sess.trace_id:
        sess.trace_id = obs_context.new_trace_id()
    sess.resumed = False
    prior_meta = prior.get("meta") or {}
    result = {
        "id": sess.sid, "tenant": sess.tenant, "status": DONE,
        "error": None,
        "output": prior.get("output", ""),
        "files": prior.get("files", {}),
        "mrs": prior.get("mrs", {}),
        "meta": {
            "wall_s": None,           # stamped below (routing+verify)
            "trace_id": sess.trace_id,
            "resumed": False,
            "resharded": False,
            "failed_over": sess.failed_over,
            "cancel_reason": None,
            "deadline_ms": sess.deadline_ms,
            "mesh_width": sess.mesh_width,
            "dispatches": 0,
            "plan_cache": {"plan": {"hits": 0, "misses": 0}},
            "pages": {},
            "profile": {"dispatches": 0},
            "kernels": {},
            "memo": {"hit": True, "key": mkey,
                     "source_wall_s": prior_meta.get("wall_s"),
                     "source_trace_id": prior_meta.get("trace_id")},
        },
    }
    sess.wall_s = round(time.perf_counter() - t0, 6)
    result["meta"]["wall_s"] = sess.wall_s
    atomic_write_json(server.result_path(sess.sid), result)
    sess.state = DONE
    return result


def run_session(server, sess: Session) -> dict:
    """Execute one session on a worker thread; returns (and durably
    writes) the result record.  Never raises — a failing script is a
    FAILED session, not a dead worker.

    The whole run executes under the session's request trace context
    (obs/context.py): every span, journal record, quarantine record and
    counter bump — including those from the exec/ prefetch producer,
    the background spill writer, and the shared ingest pool — carries
    the session's trace_id and charges its :class:`RequestAccount`, so
    the ``meta`` deltas are EXACT under concurrency, not
    "exact only when idle"."""
    from ..core.runtime import page_account_scope
    from ..ft.journal import Journal, resume_into
    from ..obs import context as obs_context
    from ..oink.objects import ObjectManager
    from ..oink.script import OinkScript
    from . import memo as memo_mod

    sdir = server.session_dir(sess.sid)
    outdir = os.path.join(sdir, "out")
    spill = os.path.join(sdir, "spill")
    os.makedirs(outdir, exist_ok=True)
    os.makedirs(spill, exist_ok=True)

    # result memoization (serve/memo.py): a previously-seen submission
    # — same script bytes, same input-file bytes — serves the stored,
    # integrity-verified result without executing anything.  Checked
    # BEFORE the resume probe on purpose: a failed-over or replayed
    # session whose payload a peer already computed is also a hit.
    mkey = memo_mod.memo_key(sess.payload) \
        if memo_mod.memoize_enabled() else None
    if mkey is not None:
        prior = memo_mod.lookup(mkey)
        if prior is not None:
            return _serve_memoized(server, sess, mkey, prior)

    screen = _CappedScreen()
    # mesh autoscaling (serve/autoscale.py): the daemon may hand this
    # session a NARROW sub-mesh sized from its tenant's profiled
    # exchange volume; plain servers (and tests driving run_session
    # directly) fall back to the daemon's full comm
    session_comm = getattr(server, "session_comm", None)
    if session_comm is not None:
        comm, sess.mesh_width = session_comm(sess)
    else:
        comm = server.comm
    # the daemon's device (the card unless it was started with
    # device="cpu"); a mesh names its own shards' devices
    om = ObjectManager(device=server.device, comm=comm)
    defaults = server.budgets.defaults_for(sess.tenant, spill)
    if server.budgets.pages > 0:
        # an armed tenant budget is PINNED: the script's own `set`
        # cannot lift maxpage/memsize/outofcore (or redirect fpath out
        # of the session scratch) past the allowance
        om.pin(**defaults)
    else:
        for k, v in defaults.items():
            om.set_default(k, v)
    script = OinkScript(screen=screen, obj=om)
    script._path_prepend = outdir    # -o files land in the session dir
    script._path_root = outdir       # `set prepend` re-roots UNDER it
    if script._ft_journal is not None:
        # MRTPU_JOURNAL in the daemon's environment armed a script
        # journal pointing somewhere global — sessions journal into
        # their OWN directory, always.  Deactivate it BEFORE closing:
        # from_env installed it as the process-global op sink, and a
        # barrier op writing to the closed handle would fail the
        # session (ft/journal.note_op reads the active journal)
        from ..ft.journal import activate, active
        env_j = script._ft_journal
        script._ft_journal = None
        if active() is env_j:
            activate(None)
        env_j.close()

    acct = server.budgets.account(sess.tenant)
    if not sess.trace_id:
        sess.trace_id = obs_context.new_trace_id()
    req = obs_context.RequestAccount(trace_id=sess.trace_id,
                                     tenant=sess.tenant,
                                     label=f"serve:{sess.sid}")
    # deadlines + cancellation (doc/serve.md#deadlines-and-cancel):
    # the account is the flag the barrier sites check.  deadline_ms
    # budgets EXECUTION time (from here), not queue time — a replayed
    # session after a crash must not be dead on arrival.
    if sess.deadline_ms:
        req.set_deadline(sess.deadline_ms / 1000.0)
    sess.account = req          # the /v1/jobs/<id>/profile live view
    # re-check AFTER publishing the account (store-then-load on both
    # sides): a concurrent DELETE either saw the account just published
    # (it arms the flag itself) or set cancel_requested before this
    # load (we arm it here) — either way the cancel is never lost
    if sess.cancel_requested:
        req.cancel(sess.cancel_requested)
    sess.state = RUNNING
    sess.resumed = _resumable(sdir)
    # autoscaler live promotion: if this session runs NARROW and its
    # observed exchange volume outgrows the prediction, reshard wide at
    # the next command boundary (oink post_cmd hook)
    autoscaler = getattr(server, "autoscaler", None)
    if autoscaler is not None and sess.mesh_width is not None:
        def _note_promoted() -> None:
            sess.resharded = True
            sess.mesh_width = autoscaler.full_width
        hook = autoscaler.promote_hook(req, sess.mesh_width,
                                       on_promote=_note_promoted)
        if hook is not None:
            script.post_cmd.append(hook)
    t0 = time.perf_counter()
    error: Optional[str] = None
    cancelled: Optional[str] = None
    try:
        with page_account_scope(acct), obs_context.use(req):
            if sess.resumed:
                # degraded-mode recovery: the replay runs on WHATEVER
                # mesh this daemon instance carries; resume_into flags
                # a checkpoint taken on a different width (the restored
                # frames are host-side, so the restore itself is
                # topology-portable — doc/serve.md#recovery)
                resume_into(script, sdir)
                sess.resharded = bool(getattr(script, "_ft_resharded",
                                              False))
            else:
                script._ft_journal = Journal(sdir, script_mode=True)
                try:
                    script.run_string(sess.payload)
                finally:
                    if script._ft_journal is not None:
                        script._ft_journal.close()
            cur = script.obj      # a script-level `clear` REPLACES the
            #                       manager; report/clean the live one
            mrs = {name: (cur.named[name].kv.nkv
                          if cur.named[name].kv is not None else None)
                   for name in sorted(cur.named)}
    except CancelledError as e:
        # a cooperative stop at an op barrier: NOT a failure.  The
        # journal + auto-checkpoints written so far stay in the session
        # dir, so the work is resumable at the exact boundary it
        # stopped (doc/serve.md#deadlines-and-cancel)
        cancelled = e.reason
        sess.cancel_reason = e.reason
        mrs = {}
        # the cancel may have tripped with DEFERRED stages recorded
        # (fuse=1): discard them — the release path below reads kv/kmv
        # (flush barriers) AFTER disarm_cancel, and a cancelled chain
        # must never dispatch from its own cleanup
        try:
            cur = script.obj
            for m in list(cur.named.values()) + list(cur._temps):
                m.discard_plan()
        except Exception:
            pass
    except Exception as e:       # noqa: BLE001 — session isolation
        error = f"{type(e).__name__}: {e}"
        mrs = {}
        # resource-pressure latch (serve/overload.py): an ENOSPC in
        # this session's failure chain flips the daemon DEGRADED so it
        # sheds new admissions instead of failing more sessions the
        # same way
        disk = getattr(server, "disk", None)
        if disk is not None:
            disk.note_error(e)
    finally:
        # sessions are one-shot: release every frame the namespace
        # still holds (inside the account scope callers of free() run
        # on this thread, so the tenant gauge deflates too — and inside
        # the request context, so the release bills THIS session).
        # Disarm the cancel flag FIRST: the release path crosses the
        # same barrier sites and must never itself be cancelled
        req.disarm_cancel()
        with page_account_scope(acct), obs_context.use(req):
            try:
                cur = script.obj
                cur.cleanup()
                for name in list(cur.named):
                    cur.delete_mr(name)
            except Exception:
                pass
    wall = time.perf_counter() - t0

    sess.wall_s = round(wall, 4)
    if cancelled:
        status = CANCELLED
        error = f"cancelled ({cancelled})"
    else:
        status = FAILED if error else DONE
    sess.error = error
    # the meta deltas come from the session's OWN RequestAccount — fed
    # from the same funnels as the process-global counters, scoped to
    # this request's context — so they are exact with any number of
    # concurrent sessions (the two-session regression test's contract;
    # doc/serve.md)
    profile = req.profile()
    profile["wall_s"] = sess.wall_s
    plan_delta = {c: dict(v) for c, v in profile["plan_cache"].items()}
    plan_delta.setdefault("plan", {"hits": 0, "misses": 0})
    result = {
        "id": sess.sid, "tenant": sess.tenant, "status": status,
        "error": error,
        "output": screen.getvalue(),
        "files": _collect_files(outdir),
        "mrs": mrs,
        "meta": {
            "wall_s": sess.wall_s,
            "trace_id": sess.trace_id,
            "resumed": sess.resumed,
            "resharded": sess.resharded,
            "failed_over": sess.failed_over,
            "cancel_reason": cancelled,
            "deadline_ms": sess.deadline_ms,
            "mesh_width": sess.mesh_width,
            "dispatches": profile["dispatches"],
            "plan_cache": plan_delta,
            "pages": acct.snapshot(),
            "profile": profile,
            # the port's own: this session's launches of each
            # hand-written kernel (a replica's card is its process's)
            "kernels": dict(req.kernels),
            "memo": {"hit": False, "key": mkey},
        },
    }
    # memoize a clean fresh run: byte-identical resubmissions anywhere
    # in the fleet are served from this record (serve/memo.py).  Resumed
    # sessions are excluded — their output may reflect a partial replay
    # boundary, and the contract is "what a fresh run produces".
    if mkey is not None and status == DONE and not sess.resumed:
        try:
            memo_mod.store(mkey, result,
                           writer=getattr(server, "rid", ""),
                           payload=sess.payload)
        except Exception:
            pass
    # the durable result lands BEFORE the state flips: a client polling
    # at 50 ms must never observe state=done while the result file is
    # still unwritten (it would read a bogus "result file unavailable"
    # final record)
    try:
        atomic_write_json(server.result_path(sess.sid), result)
    except OSError as e:
        # the MOST likely ENOSPC site (inode/quota exhaustion passes
        # the free-byte probe): latch the pressure monitor so the
        # daemon degrades instead of admitting more work that fails
        # at this exact line, then let the worker's belt record FAILED
        disk = getattr(server, "disk", None)
        if disk is not None:
            disk.note_error(e)
        raise
    sess.state = status
    return result
