"""ctl — operator client for the port's serve/ daemon and fleet (the port
of the reference package's ``scripts/mrctl.py``; doc/serve.md).

Run as ``python -m gpu_mapreduce_tpu_torch.ctl`` (``ctl`` below); the
verbs, flags, discovery order and exit codes are ``scripts/mrctl.py``'s:

    ctl [--port N | --state DIR] [--token TOK] submit FILE
        [--tenant T] [--wait] [--deadline-ms N] [--priority P]
        [--retry-wait SECS]
    ctl [...] submit - --tenant T          # script from stdin
    ctl [...] status [SID]                 # one session / all
    ctl [...] result SID [--wait SECS]
    ctl [...] cancel SID                   # DELETE /v1/jobs/<sid>
    ctl [...] profile SID                  # per-request cost profile
    ctl [...] watch SID [--timeout SECS]   # stream /events (no poll)
    ctl [...] stream open [--source PATH ...] [--parser P]
        [--reduce R] [--window N] [--tenant T]   # standing query
    ctl [...] stream status [STID]
    ctl [...] stream feed STID FILE|-      # append bytes (feed mode)
    ctl [...] stream close STID [--no-drain]
    ctl [...] stream watch STID [--timeout SECS]  # /events client
    ctl [...] slo
    ctl [...] stats
    ctl [...] cache [--json]               # caching-tier view
    ctl [...] top [--watch SECS] [--json]  # fleet member live view
    ctl [...] drain
    ctl [...] shutdown

Daemon discovery: ``--port`` wins; otherwise ``--state DIR`` (or
``MRTPU_SERVE_STATE``) reads the bound port from ``DIR/serve.json`` —
which is how an ephemeral-port (``--port 0``) daemon is addressed.  A
FLEET directory (``DIR/fleet/`` exists) discovers the router first,
then any live replica, and a refused connection retries with backoff
(``--retries``, ft/retry semantics) re-running discovery between
attempts — a client pointed at a dead replica finds the fleet instead
of exiting 3.  Router replica redirects (307) are followed.
``--token`` (or ``MRTPU_SERVE_TOKEN``) rides as the bearer token when
the daemon has ``MRTPU_SERVE_TOKENS`` armed.
Exit codes: 0 ok, 2 usage, 3 daemon unreachable, 4 rejected (429/503 —
stderr carries Retry-After), 5 session failed, 6 still running at the
--wait/--timeout deadline (`watch` included: a stream that ends before
the terminal status exits 6), 7 session cancelled.
"""

from __future__ import annotations

import argparse
import json
import sys



def _client(args):
    from .serve.client import ServeClient
    token = args.token or None   # None → ServeClient falls back to
    #                              MRTPU_SERVE_TOKEN from the env
    if args.port is not None:
        return ServeClient.local(args.port, retries=args.retries,
                                 token=token)
    from .utils.env import env_str
    state = args.state or env_str("MRTPU_SERVE_STATE", None)
    if not state:
        print("need --port or --state (or MRTPU_SERVE_STATE)",
              file=sys.stderr)
        sys.exit(2)
    try:
        return ServeClient.from_state_dir(state, retries=args.retries,
                                          token=token)
    except (OSError, ValueError) as e:
        print(f"cannot discover daemon from {state!r}: {e}",
              file=sys.stderr)
        sys.exit(3)


def _top_table(doc: dict) -> str:
    """The ``ctl top`` member table: one row per federation member
    (replica or data-plane rank), its liveness/staleness verdict, and
    the headline straggler number when the member reports one."""
    rows = [("member", "state", "up", "stale", "age_s", "series",
             "avg_sync_spread_s")]
    for m in doc.get("members", []):
        name = (f"replica:{m['replica']}" if m.get("replica")
                else f"rank:{m.get('rank', '?')}")
        snap = m.get("metrics") or {}
        spread = "-"
        fam = snap.get("mrtpu_dist_sync_spread_seconds")
        if fam:
            tot = cnt = 0.0
            for s in fam.get("samples", []):
                tot += float(s.get("sum", 0.0))
                cnt += float(s.get("count", 0))
            if cnt:
                spread = f"{tot / cnt:.3f}"
        rows.append((name, str(m.get("state", "")),
                     "1" if m.get("up") else "0",
                     "1" if m.get("stale") else "0",
                     f"{m.get('age_s', 0.0):.1f}", str(len(snap)),
                     spread))
    widths = [max(len(r[i]) for r in rows) for i in range(len(rows[0]))]
    lines = []
    for i, row in enumerate(rows):
        lines.append("  ".join(c.ljust(w) if j == 0 else c.rjust(w)
                               for j, (c, w) in enumerate(zip(row,
                                                              widths))))
        if i == 0:
            lines.append("  ".join("-" * w for w in widths))
    if len(rows) == 1:
        lines.append("(no federation members)")
    return "\n".join(lines)


def _cache_table(doc: dict) -> str:
    """The ``ctl cache`` view: one line per caching tier
    (doc/perf.md#the-caching-tier) — hit ratios, store size, GC
    counts — distilled from the daemon's /v1/stats record."""
    cache = doc.get("cache") or {}
    cas = cache.get("cas") or {}
    memo = cache.get("memo") or {}
    gc = cache.get("gc") or {}
    plan = (doc.get("plan") or {}).get("persistent") or {}

    def ratio(h, m):
        return f"{h / (h + m):.2f}" if (h + m) else "-"

    return "\n".join([
        f"cas   enabled={cas.get('enabled', 0)} "
        f"chunks={cas.get('chunks', 0)} bytes={cas.get('bytes', 0)} "
        f"dedup_hits={cas.get('dedup_hits', 0)} "
        f"quarantined={cas.get('quarantined', 0)}",
        f"plan  enabled={plan.get('enabled', 0)} "
        f"entries={plan.get('entries', 0)} "
        f"bytes={plan.get('bytes', 0)} "
        f"hit_ratio={ratio(plan.get('hits', 0), plan.get('misses', 0))} "
        f"evictions={plan.get('evictions', 0)}",
        f"memo  enabled={memo.get('enabled', 0)} "
        f"entries={memo.get('entries', 0)} "
        f"bytes={memo.get('bytes', 0)} "
        f"hit_ratio={ratio(memo.get('hits', 0), memo.get('misses', 0))} "
        f"corrupt={memo.get('corrupt', 0)}",
        f"gc    swept={gc.get('swept', 0)} "
        f"chunks_removed={cas.get('gc_removed', 0)} "
        f"bytes_reclaimed={cas.get('gc_bytes', 0)} "
        f"memo_ttl_s={gc.get('memo_ttl_s', 0)} "
        f"cas_grace_s={gc.get('cas_grace_s', 0)}",
    ])


def _terminal_code(r: dict) -> int:
    """0 done, 5 failed, 7 cancelled — one mapping for every verb that
    reports a terminal session."""
    status = r.get("status") or r.get("state")
    return {"failed": 5, "cancelled": 7}.get(status, 0)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python -m gpu_mapreduce_tpu_torch.ctl",
                                description=__doc__.split("\n", 1)[0],
                                formatter_class=argparse.
                                RawDescriptionHelpFormatter)
    p.add_argument("--port", type=int, default=None)
    p.add_argument("--state", default=None)
    p.add_argument("--retries", type=int, default=3,
                   help="connection-refused retries (backoff + fleet "
                        "re-discovery between attempts; 0 = one shot)")
    p.add_argument("--token", default=None,
                   help="bearer token for a MRTPU_SERVE_TOKENS-armed "
                        "daemon (default MRTPU_SERVE_TOKEN)")
    sub = p.add_subparsers(dest="cmd", required=True)
    sp = sub.add_parser("submit")
    sp.add_argument("file", help="OINK script path, or - for stdin")
    sp.add_argument("--tenant", default=None,
                    help="tenant the job bills to (default: the "
                         "token's tenant on an auth-armed daemon, "
                         "else 'default')")
    sp.add_argument("--deadline-ms", type=int, default=None,
                    help="execution deadline: the session cancels at "
                         "its next op barrier past this budget")
    sp.add_argument("--priority", type=int, default=None,
                    help="admission priority (higher first, ±9)")
    sp.add_argument("--retry-wait", type=float, default=0.0,
                    metavar="SECS",
                    help="honor 429 Retry-After by waiting up to this "
                         "total budget before giving up (0 = fail "
                         "fast)")
    sp.add_argument("--wait", action="store_true",
                    help="block until the session finishes; print the "
                         "result record")
    sp.add_argument("--timeout", type=float, default=3600.0,
                    metavar="SECS",
                    help="--wait poll deadline (default 3600); a "
                         "session still running at the deadline exits "
                         "6, not 3")
    st = sub.add_parser("status")
    st.add_argument("sid", nargs="?")
    rs = sub.add_parser("result")
    rs.add_argument("sid")
    rs.add_argument("--wait", type=float, default=0.0, metavar="SECS")
    cn = sub.add_parser("cancel")
    cn.add_argument("sid")
    pf = sub.add_parser("profile")
    pf.add_argument("sid")
    wt = sub.add_parser("watch")
    wt.add_argument("sid")
    wt.add_argument("--timeout", type=float, default=3600.0,
                    metavar="SECS",
                    help="give up (exit 6) if the session has not "
                         "reached a terminal state by then")
    sm = sub.add_parser("stream", help="standing-query micro-batch "
                                       "streams (doc/streaming.md)")
    ssub = sm.add_subparsers(dest="streamcmd", required=True)
    so = ssub.add_parser("open")
    so.add_argument("--source", action="append", default=None,
                    metavar="PATH",
                    help="file/directory the daemon tails (repeatable); "
                         "omitted = feed mode, push bytes with "
                         "'stream feed'")
    so.add_argument("--parser", default="words",
                    help="record parser: words, lines, kv")
    so.add_argument("--reduce", default="count",
                    help="reduce kernel: count, sum, min, max")
    so.add_argument("--window", type=int, default=0,
                    help="keep only the last N micro-batches resident "
                         "(0 = accumulate forever)")
    so.add_argument("--tenant", default=None)
    so.add_argument("--deadline-ms", type=int, default=None,
                    help="total execution budget across the stream's "
                         "life")
    so.add_argument("--rows", type=int, default=None,
                    help="micro-batch row trigger")
    so.add_argument("--bytes", type=int, default=None,
                    help="micro-batch byte trigger")
    so.add_argument("--wait-ms", type=int, default=None,
                    help="latency floor: cut any pending data older "
                         "than this")
    ss = ssub.add_parser("status")
    ss.add_argument("stid", nargs="?")
    sf = ssub.add_parser("feed")
    sf.add_argument("stid")
    sf.add_argument("file", help="bytes to append, or - for stdin")
    sc = ssub.add_parser("close")
    sc.add_argument("stid")
    sc.add_argument("--no-drain", action="store_true",
                    help="retire without processing pending data")
    sw = ssub.add_parser("watch")
    sw.add_argument("stid")
    sw.add_argument("--timeout", type=float, default=3600.0,
                    metavar="SECS",
                    help="give up (exit 6) if the stream has not "
                         "reached a terminal state by then")
    sub.add_parser("slo")
    sub.add_parser("stats")
    cc = sub.add_parser("cache", help="caching-tier hit ratios, store "
                                      "size and GC counts")
    cc.add_argument("--json", action="store_true",
                    help="print the raw cache + plan stats sections")
    tp = sub.add_parser("top", help="fleet-wide member table from the "
                                    "router's /metrics/fleet.json")
    tp.add_argument("--watch", type=float, default=0.0, metavar="SECS",
                    help="refresh every SECS until interrupted "
                         "(0 = print once)")
    tp.add_argument("--json", action="store_true",
                    help="print the raw federation doc instead")
    sub.add_parser("drain")
    sub.add_parser("shutdown")
    args = p.parse_args(argv)

    from .serve.client import ServeError
    c = _client(args)
    try:
        if args.cmd == "submit":
            text = sys.stdin.read() if args.file == "-" else \
                open(args.file).read()
            r = c.submit(script=text, tenant=args.tenant,
                         deadline_ms=args.deadline_ms,
                         priority=args.priority,
                         retry_after_wait=args.retry_wait)
            if args.wait:
                r = c.wait(r["id"], timeout=args.timeout)
                print(json.dumps(r, indent=2))
                return _terminal_code(r)
            print(json.dumps(r))
        elif args.cmd == "status":
            out = c.status(args.sid) if args.sid else c.jobs()
            print(json.dumps(out, indent=2))
        elif args.cmd == "result":
            r = c.wait(args.sid, timeout=args.wait) if args.wait \
                else c.result(args.sid)
            print(json.dumps(r, indent=2))
            return _terminal_code(r)
        elif args.cmd == "cancel":
            print(json.dumps(c.cancel(args.sid)))
        elif args.cmd == "profile":
            r = c.profile(args.sid)
            print(json.dumps(r, indent=2))
            return 5 if r.get("state") == "failed" and \
                not r.get("profile") else 0
        elif args.cmd == "watch":
            # streamed events, no polling: print each line, exit on the
            # session's terminal status like `result --wait`.  The
            # server caps one stream (~10 min), so reconnect until OUR
            # deadline — and an event already in hand is always
            # processed, even past the deadline (the deadline is only
            # checked on heartbeats and reconnects, so a terminal
            # status arriving late is reported, not discarded)
            import time as _time

            from .serve.session import TERMINAL
            deadline = _time.monotonic() + args.timeout
            last_state = None
            expired = False
            while not expired:
                for ev in c.events(args.sid, timeout=60.0):
                    kind = ev.get("event")
                    if kind == "tick":
                        if _time.monotonic() > deadline:
                            expired = True
                            break
                        continue
                    if kind == "status" and \
                            ev.get("state") == last_state:
                        continue    # a reconnect replayed a known state
                    print(json.dumps(ev))
                    if kind == "error":
                        print(ev.get("error"), file=sys.stderr)
                        return 3
                    if kind == "status":
                        last_state = ev.get("state")
                        if last_state in TERMINAL:
                            return _terminal_code(ev)
                else:
                    # server-side stream cap without a terminal status:
                    # reconnect unless the operator's deadline passed
                    expired = _time.monotonic() > deadline
            print(f"session {args.sid} not finished by the --timeout "
                  f"deadline", file=sys.stderr)
            return 6
        elif args.cmd == "stream":
            if args.streamcmd == "open":
                batch = {k: v for k, v in
                         (("rows", args.rows), ("bytes", args.bytes),
                          ("wait_ms", args.wait_ms)) if v is not None}
                r = c.stream_open(sources=args.source,
                                  parser=args.parser,
                                  reduce=args.reduce,
                                  window=args.window,
                                  tenant=args.tenant,
                                  deadline_ms=args.deadline_ms,
                                  batch=batch or None)
                print(json.dumps(r))
            elif args.streamcmd == "status":
                out = c.stream_status(args.stid) if args.stid \
                    else c.streams()
                print(json.dumps(out, indent=2))
            elif args.streamcmd == "feed":
                data = sys.stdin.buffer.read() if args.file == "-" \
                    else open(args.file, "rb").read()
                print(json.dumps(c.stream_feed(args.stid, data)))
            elif args.streamcmd == "close":
                r = c.stream_close(args.stid,
                                   drain=not args.no_drain)
                print(json.dumps(r, indent=2))
                return 5 if r.get("state") == "failed" else 0
            elif args.streamcmd == "watch":
                # same contract as `watch`: streamed events, reconnect
                # across the server-side cap, exit at terminal status
                # (0 closed / 5 failed) or 6 at the operator deadline
                import time as _time
                deadline = _time.monotonic() + args.timeout
                last_state = None
                expired = False
                while not expired:
                    for ev in c.stream_events(args.stid, timeout=60.0):
                        kind = ev.get("event")
                        if kind == "tick":
                            if _time.monotonic() > deadline:
                                expired = True
                                break
                            continue
                        if kind == "status" and \
                                ev.get("state") == last_state:
                            continue
                        print(json.dumps(ev))
                        if kind == "error":
                            print(ev.get("error"), file=sys.stderr)
                            return 3
                        if kind == "status":
                            last_state = ev.get("state")
                            if last_state in ("closed", "failed"):
                                return 5 if last_state == "failed" \
                                    else 0
                    else:
                        expired = _time.monotonic() > deadline
                print(f"stream {args.stid} not finished by the "
                      f"--timeout deadline", file=sys.stderr)
                return 6
        elif args.cmd == "slo":
            print(json.dumps(c.slo(), indent=2))
        elif args.cmd == "stats":
            print(json.dumps(c.stats(), indent=2))
        elif args.cmd == "cache":
            doc = c.stats()
            if args.json:
                print(json.dumps({"cache": doc.get("cache"),
                                  "plan": doc.get("plan")}, indent=2))
            else:
                print(_cache_table(doc))
        elif args.cmd == "top":
            import time as _time
            while True:
                doc = c.fleet_metrics()
                if args.json:
                    print(json.dumps(doc, indent=2))
                else:
                    print(_top_table(doc))
                if not args.watch:
                    break
                try:
                    _time.sleep(args.watch)
                except KeyboardInterrupt:
                    break
                print()
        elif args.cmd == "drain":
            print(json.dumps(c.drain()))
        elif args.cmd == "shutdown":
            print(json.dumps(c.shutdown()))
        return 0
    except ServeError as e:
        print(f"{e}", file=sys.stderr)
        if e.retry_after is not None:
            print(f"Retry-After: {e.retry_after}s", file=sys.stderr)
        if e.code in (429, 503):
            return 4
        if e.code == 409:
            return 0     # cancel of a terminal session: no-op by design
        return 6 if e.code == 408 else 3    # 408 = still running at
        #                                     the --wait deadline
    except OSError as e:
        print(f"daemon unreachable: {e}", file=sys.stderr)
        return 3


if __name__ == "__main__":
    sys.exit(main())
