"""The port's standing queries (``exec/prefetch.tail_chunks``,
``stream/``, ``MapReduce.stream``, the OINK ``stream`` command) against
the JAX package's ``Stream`` on the same appends, on the CPU.

Each case drives both packages' streams over one source file, append by
append: the snapshots equal each other and a ``collections.Counter``
oracle at every step, the journal records are the JAX package's field
for field, and the exactly-once goldens hold: a child process running the
port, SIGKILLed before or after a batch's commit record, resumes to the
uninterrupted snapshot with no row counted twice.  Every comparison is
exact."""

import json
import os
import signal
import subprocess
import sys
import textwrap
import time
from collections import Counter

import pytest

from gpu_mapreduce_tpu.core.mapreduce import MapReduce as JMapReduce
from gpu_mapreduce_tpu.core.runtime import MRError as JMRError
from gpu_mapreduce_tpu.exec.prefetch import tail_chunks as j_tail_chunks
from gpu_mapreduce_tpu.ft.journal import read_journal as j_read_journal
from gpu_mapreduce_tpu.oink.command import run_command as j_run_command
from gpu_mapreduce_tpu.parallel.mesh import make_mesh as j_make_mesh
from gpu_mapreduce_tpu.stream import BatchCutter as JBatchCutter
from gpu_mapreduce_tpu.stream import Stream as JStream
from gpu_mapreduce_tpu.stream import Tailer as JTailer
from gpu_mapreduce_tpu_torch import MapReduce, MRError
from gpu_mapreduce_tpu_torch.exec.prefetch import tail_chunks
from gpu_mapreduce_tpu_torch.ft.journal import read_journal
from gpu_mapreduce_tpu_torch.oink.command import run_command
from gpu_mapreduce_tpu_torch.oink.objects import ObjectManager
from gpu_mapreduce_tpu_torch.plan.cache import cache_stats
from gpu_mapreduce_tpu_torch.stream import BatchCutter, Stream, Tailer

from test_torch_parallel import tmesh
from test_torch_serve import no_flight_left  # noqa: F401

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def oracle(text: str) -> str:
    c = Counter(text.split())
    return "".join(f"{k} {c[k]}\n" for k in sorted(c))


def append(path, text):
    with open(path, "a") as f:
        f.write(text)


class Pair:
    """A port stream and a JAX stream over the same sources, each in its
    own directory of the same basename (so their records match)."""

    def __init__(self, tmp_path, sources, comm_p=None, jcomm=None, **kw):
        self.t = Stream(str(tmp_path / "port" / "st"), sources, device="cpu",
                        comm=comm_p, **kw)
        self.j = JStream(str(tmp_path / "jax" / "st"), sources, comm=jcomm,
                         **kw)

    def drain(self, **kw):
        return self.t.drain(**kw), self.j.drain(**kw)

    def snapshot(self) -> str:
        a, b = self.t.snapshot(), self.j.snapshot()
        assert a == b
        return a

    def close(self):
        return self.t.close(), self.j.close()


# ---------------------------------------------------------------------------
# units: tailing and the cut policy
# ---------------------------------------------------------------------------

def test_tail_chunks_newline_alignment(tmp_path):
    for side, fn in (("port", tail_chunks), ("jax", j_tail_chunks)):
        p = str(tmp_path / f"{side}.txt")
        seen = []
        with open(p, "w") as f:
            f.write("one two\nthree")                 # a torn tail
        seen.append(fn(p, 0))
        off = seen[-1][1]
        append(p, " four\nfive\n")
        seen.append(fn(p, off))
        off2 = seen[-1][1]
        seen.append(fn(p, off2))                      # nothing new
        seen.append(fn(p, off, max_bytes=6))          # a bounded poll
        append(p, "six")
        seen.append(fn(p, off2))                      # torn again
        seen.append(fn(p, off2, final=True))          # taken at the end
        seen.append(fn(str(tmp_path / "unborn"), 5))
        with open(p, "w") as f:
            f.write("tiny")
        with pytest.raises(OSError):
            fn(p, off2)                               # shrank
        if side == "port":
            port = seen
    assert port == seen
    assert port[0] == ([b"one two\n"], 8)
    assert port[1] == ([b"three four\nfive\n"], 24)
    assert port[5] == ([b"six"], 27) and port[6] == ([], 5)


def test_tailer_picks_up_new_files(tmp_path):
    d = tmp_path / "dir"
    d.mkdir()
    (d / "a.txt").write_text("a b\n")
    tails = [Tailer([str(d), str(tmp_path / "later.txt")]),
             JTailer([str(d), str(tmp_path / "later.txt")])]
    polls = [[] for _ in tails]
    for step in range(3):
        if step == 1:
            (d / "b.txt").write_text("c\n")            # born after open
            (d / "sub").mkdir()
        if step == 2:
            (tmp_path / "later.txt").write_text("x y\nz")
        for i, t in enumerate(tails):
            chunks, wm = t.poll()
            polls[i].append((chunks, wm > 0, t.pending_bytes(),
                             dict(t.cursors), t.files()))
    assert polls[0] == polls[1]
    assert [p[0] for p in polls[0]] == [[b"a b\n"], [b"c\n"], [b"x y\n"]]
    assert polls[0][2][2] == 1                        # the torn "z"


def test_batch_cutter_triggers():
    seq = []
    for c in (BatchCutter(rows=10, nbytes=100, wait_s=5.0),
              JBatchCutter(rows=10, nbytes=100, wait_s=5.0)):
        out = [c.should_cut(0, 0, now=0.0), c.should_cut(50, 5, now=0.0),
               c.should_cut(50, 10, now=0.1)]
        c.cut_done()
        out.append(c.should_cut(100, 1, now=0.2))
        c.cut_done()
        out += [c.should_cut(1, 1, now=10.0), c.should_cut(1, 1, now=15.0)]
        seq.append(out)
    assert seq[0] == seq[1] == [False, False, True, True, False, True]


def test_cutter_defaults_from_the_environment(monkeypatch):
    monkeypatch.setenv("MRTPU_STREAM_ROWS", "7")
    monkeypatch.setenv("MRTPU_STREAM_BYTES", "99")
    monkeypatch.setenv("MRTPU_STREAM_WAIT_MS", "1500")
    for c in (BatchCutter(), JBatchCutter()):
        assert (c.rows, c.nbytes, c.wait_s) == (7, 99, 1.5)


# ---------------------------------------------------------------------------
# the incremental goldens against the JAX package
# ---------------------------------------------------------------------------

PARTS = ["apple banana apple\ncherry banana\n",
         "banana date apple\n",
         "cherry cherry date elderberry\nfig\n"]


@pytest.mark.parametrize("fuse", [0, 1])
def test_incremental_wordfreq(tmp_path, fuse):
    """Snapshot equal to the JAX package's and to the Counter oracle at
    every step; the status and the journal records match."""
    src = str(tmp_path / "in.txt")
    pair = Pair(tmp_path, [src], settings={"fuse": fuse})
    seen = ""
    for part in PARTS:
        append(src, part)
        seen += part
        assert pair.drain() == (part.count("\n"),) * 2
        assert pair.snapshot() == oracle(seen)
    st, jst = pair.t.status(), pair.j.status()
    drop = ("ingest",)
    assert {k: v for k, v in st.items() if k not in drop} \
        == {k: v for k, v in jst.items() if k not in drop}
    assert st["batches"] == 3 and st["rows"] == 5
    assert st["bytes"] == len(seen.encode())
    pair.close()
    recs = read_journal(str(tmp_path / "port" / "st"))
    jrecs = j_read_journal(str(tmp_path / "jax" / "st"))
    assert [r["kind"] for r in recs] == ["stream_open"] \
        + ["stream_batch"] * 3 + ["stream_close"]
    # the trace id differs by run, and with it the record's crc
    strip = lambda rs: [{k: v for k, v in r.items() if k not in ("trace",
                                                                "c")}
                        for r in rs]
    assert strip(recs) == strip(jrecs)
    # one-shot over the whole input agrees byte for byte
    one = Stream(str(tmp_path / "one"), [src], device="cpu",
                 settings={"fuse": fuse})
    one.drain(final=True)
    assert one.snapshot() == oracle(seen)
    one.close()


def test_kv_parser_sum_reduce(tmp_path):
    src = tmp_path / "kv.txt"
    src.write_text("a 3\nb 2\na 5\nnot-a-number x\n")
    pair = Pair(tmp_path, [str(src)], parser="kv", reduce="sum")
    pair.drain()
    assert pair.snapshot() == "a 8\nb 2\n"
    append(src, "b 10\nc\n")
    pair.drain()
    assert pair.snapshot() == "a 8\nb 12\n"
    pair.close()


@pytest.mark.parametrize("parser,reduce", [("lines", "max"),
                                           ("words", "min")])
def test_other_parsers_and_accumulators(tmp_path, parser, reduce):
    src = str(tmp_path / "in.txt")
    pair = Pair(tmp_path, [src], parser=parser, reduce=reduce)
    for part in ("x y\nx y\nz\n", "z\nx y\nq\n"):
        append(src, part)
        pair.drain()
        pair.snapshot()
    pair.close()


def test_window_retire_and_merge(tmp_path):
    src = str(tmp_path / "in.txt")
    pair = Pair(tmp_path, [src], window=2)
    batches = ["a a b\n", "b c\n", "c d d\n"]
    for part in batches:
        append(src, part)
        pair.drain()
    assert pair.snapshot() == oracle(batches[1] + batches[2])
    assert pair.t.status()["buckets"] == 2
    pair.close()


def test_mr_stream_external_resident(tmp_path):
    """Merges land in the caller's MapReduce, on its device."""
    src = tmp_path / "in.txt"
    src.write_text("x y x\n")
    out = []
    for mr in (MapReduce(device="cpu"), JMapReduce()):
        s = mr.stream([str(src)], dir=str(tmp_path / type(mr).__module__))
        s.drain()
        got = {}
        mr2 = mr.copy()
        mr2.gather(1)
        mr2.sort_keys(1)
        mr2.scan_kv(lambda k, v, p: got.__setitem__(bytes(k), int(v)))
        out.append((s.snapshot(), got))
        s.close()
    assert out[0] == out[1] == ("x 2\ny 1\n", {b"x": 2, b"y": 1})


def test_bad_parser_and_reduce_raise(tmp_path):
    for cls, err in ((Stream, MRError), (JStream, JMRError)):
        with pytest.raises(err):
            cls(str(tmp_path / "a"), [], parser="nope")
        with pytest.raises(err):
            cls(str(tmp_path / "b"), [], reduce="cull")


def test_watermark_and_lag(tmp_path):
    src = str(tmp_path / "in.txt")
    with open(src, "w") as f:
        f.write("a b\n")
    old = time.time() - 50.0
    os.utime(src, (old, old))
    pair = Pair(tmp_path, [src])
    pair.drain()
    for s in (pair.t, pair.j):
        st = s.status()
        assert abs(st["watermark"] - old) < 2.0 and st["lag_s"] == 0.0
    append(src, "c d\n")
    for s in (pair.t, pair.j):
        st = s.status()
        assert st["pending_bytes"] == 4 and st["lag_s"] >= 45.0
    pair.drain()
    st = pair.t.status()
    assert st["lag_s"] == 0.0 and st["ingest"]["prefetch_wait_s"] >= 0.0
    assert "prefetch_depth" in st["ingest"]
    pair.close()


# ---------------------------------------------------------------------------
# exactly-once
# ---------------------------------------------------------------------------

def test_suspend_and_resume(tmp_path):
    src = str(tmp_path / "in.txt")
    with open(src, "w") as f:
        f.write("a b a\n")
    s = Stream(str(tmp_path / "st"), [src], device="cpu")
    s.drain()
    s.suspend()
    assert s.poll_once(force=True) == 0            # a detached handle
    append(src, "b c\n")
    s2 = Stream(str(tmp_path / "st"), [src], device="cpu")
    assert s2.seq == 1 and s2.status()["resumed"]
    s2.drain()
    assert s2.snapshot() == oracle("a b a\nb c\n")
    s2.close()


_KILL_CHILD = textwrap.dedent(r"""
    import os, signal, sys
    sys.path.insert(0, {root!r})
    from gpu_mapreduce_tpu_torch.stream import Stream
    sdir, src, mode = sys.argv[1], sys.argv[2], sys.argv[3]
    s = Stream(sdir, [src], device="cpu", settings={{"fuse": 1}})
    assert s.poll_once(force=True) > 0      # batch 1 commits
    with open(src, "a") as f:
        f.write("banana elderberry banana\nfig\n")
    orig = s._journal.append
    def boom(rec):
        if mode == "before":                # after the checkpoint, before
            os.kill(os.getpid(), signal.SIGKILL)    # the record
        orig(rec)
        os.kill(os.getpid(), signal.SIGKILL)
    s._journal.append = boom
    s.poll_once(force=True)
    raise SystemExit("unreachable: SIGKILL must have fired")
""")


@pytest.mark.parametrize("mode", ["before", "after"])
def test_kill9_resume_is_exactly_once(tmp_path, mode):
    src = str(tmp_path / "in.txt")
    part1 = "apple banana apple\ncherry\n"
    part2 = "banana elderberry banana\nfig\n"
    with open(src, "w") as f:
        f.write(part1)
    sdir = str(tmp_path / "st")
    child = tmp_path / "child.py"
    child.write_text(_KILL_CHILD.format(root=ROOT))
    r = subprocess.run([sys.executable, str(child), sdir, src, mode],
                       capture_output=True, text=True, timeout=180, cwd=ROOT)
    assert r.returncode == -signal.SIGKILL, (r.returncode, r.stderr)
    s = Stream(sdir, [src], device="cpu", settings={"fuse": 1})
    assert s.status()["resumed"]
    assert s.seq == (1 if mode == "before" else 2)
    s.drain(final=True)
    uninterrupted = Stream(str(tmp_path / "ref"), [src], device="cpu")
    uninterrupted.drain(final=True)
    assert s.snapshot() == uninterrupted.snapshot() \
        == oracle(part1 + part2)
    assert s.status()["rows"] == 4                # never counted twice
    s.close()
    uninterrupted.close()


def test_generation_fallback_and_checkpoint_gc(tmp_path, monkeypatch):
    """A newest checkpoint that no longer loads falls back to the one
    before it, whose cursors re-read the gap; ``MRTPU_STREAM_KEEP``
    bounds the generations kept."""
    monkeypatch.setenv("MRTPU_STREAM_KEEP", "2")
    src = str(tmp_path / "in.txt")
    sdir = str(tmp_path / "st")
    s = Stream(sdir, [src], device="cpu")
    for part in PARTS:
        append(src, part)
        s.drain()
    s.suspend()
    assert sorted(os.listdir(os.path.join(sdir, "ckpt"))) \
        == ["g000002", "g000003"]
    man = os.path.join(sdir, "ckpt", "g000003", "resident", "manifest.json")
    os.remove(man)
    s2 = Stream(sdir, [src], device="cpu")
    assert s2.seq == 2
    s2.drain()
    assert s2.snapshot() == oracle("".join(PARTS))
    s2.close()


def test_resume_surfaces_a_card_failure(tmp_path, monkeypatch):
    """A card failure while a generation loads is fatal: the resume
    raises it rather than fall back a generation or restart at seq 0."""
    from gpu_mapreduce_tpu_torch.core import checkpoint
    from gpu_mapreduce_tpu_torch.core.runtime import DeviceError
    src = str(tmp_path / "in.txt")
    sdir = str(tmp_path / "st")
    s = Stream(sdir, [src], device="cpu")
    for part in PARTS:
        append(src, part)
        s.drain()
    s.suspend()

    def load(mr, path):
        raise DeviceError("CUDA error: an illegal memory access")
    monkeypatch.setattr(checkpoint, "load", load)
    with pytest.raises(DeviceError):
        Stream(sdir, [src], device="cpu")


# ---------------------------------------------------------------------------
# the plan cache, the command family, a mesh
# ---------------------------------------------------------------------------

def test_warm_micro_batches_add_no_plan_misses(tmp_path):
    src = str(tmp_path / "in.txt")
    s = Stream(str(tmp_path / "st"), [src], device="cpu",
               settings={"fuse": 1})
    batch = "alpha beta gamma alpha\ndelta beta\n"

    def feed():
        append(src, batch)
        s.drain()

    feed()
    feed()
    warm = cache_stats()["plan"]["misses"]
    for _ in range(3):
        feed()
    assert cache_stats()["plan"]["misses"] == warm
    assert s.snapshot() == oracle(batch * 5)
    s.close()


def test_oink_stream_command_family(tmp_path):
    """open, poll, snapshot, status and close, each invocation a fresh
    handle that resumes: the messages, statuses, snapshot and
    ``stream.json`` of the JAX package's commands."""
    sides = {
        "port": lambda a: run_command("stream", a, screen=False,
                                      obj=ObjectManager(device="cpu")),
        "jax": lambda a: j_run_command("stream", a, screen=False)}
    seen = {}
    for side, run in sides.items():
        base = tmp_path / side
        base.mkdir()
        src = str(base / "in.txt")
        with open(src, "w") as f:
            f.write("a b a\nb c\n")
        sdir = str(base / "st")
        out = [run(["open", sdir, src, "parser=words"]).result_msg]
        c = run(["poll", sdir])
        out.append((c.result_msg, c.stream_status["rows"]))
        append(src, "c c d\n")
        c = run(["poll", sdir])
        out.append((c.result_msg, c.stream_status["rows"]))
        snap = str(base / "snap.txt")
        out.append(run(["snapshot", sdir, snap]).result_msg)
        out.append(open(snap).read())
        c = run(["status", sdir])
        out.append((c.result_msg, c.stream_status["state"]))
        c = run(["close", sdir])
        out.append((c.result_msg, c.stream_status["state"]))
        with open(os.path.join(sdir, "stream.json")) as f:
            spec = json.load(f)
        assert spec.pop("sources") == [src]
        out.append(spec)
        for bad in (["poll"], ["open", sdir], ["poll", sdir, "x"],
                    ["poll", str(base / "none")]):
            with pytest.raises((MRError, JMRError)):
                run(bad)
        seen[side] = [x.replace(str(base), "<base>") if isinstance(x, str)
                      else x for x in out]
    assert seen["port"] == seen["jax"]
    assert seen["port"][1][1] == 2 and seen["port"][2][1] == 3
    assert seen["port"][4] == oracle("a b a\nb c\nc c d\n")
    assert seen["port"][5][1] == "open" and seen["port"][6][1] == "closed"


def test_stream_on_a_mesh_matches_jax(tmp_path):
    """A stream over a P = 3 CPU mesh equals the JAX package's over
    ``make_mesh(3)``, at every step, fused."""
    src = str(tmp_path / "in.txt")
    pair = Pair(tmp_path, [src], comm_p=tmesh(3), jcomm=j_make_mesh(3),
                settings={"fuse": 1})
    seen = ""
    for part in PARTS:
        append(src, part)
        seen += part
        pair.drain()
        assert pair.snapshot() == oracle(seen)
    pair.close()


# ---------------------------------------------------------------------------
# the serve surface: /v1/streams on one daemon of each package
# ---------------------------------------------------------------------------

def _stream_view(st):
    """A stream's summary without ids, times and lags."""
    out = {k: st[k] for k in ("tenant", "state", "error", "feed",
                              "deadline_ms", "failed_over")}
    s = st.get("stream") or {}
    out["stream"] = {k: s.get(k) for k in ("batches", "rows", "resumed")}
    return out


def test_serve_stream_http_roundtrip_and_events(tmp_path):
    import threading

    from gpu_mapreduce_tpu.serve import ServeError as JServeError
    from gpu_mapreduce_tpu_torch.serve import ServeError
    from test_torch_serve import Pair, wait_until
    with Pair(tmp_path, workers=1) as p:
        got = {}
        for name, c in (("jax", p.jc), ("port", p.tc)):
            r = c.stream_open(tenant="acme")
            assert r["state"] == "open" and r["feed"] and r["id"] == "st000001"
            stid = r["id"]
            events = []

            def watch(c=c, stid=stid, events=events):
                for ev in c.stream_events(stid, timeout=60.0):
                    events.append(ev)
                    if ev.get("state") in ("closed", "failed"):
                        return
            t = threading.Thread(target=watch, daemon=True)
            t.start()
            wait_until(lambda: events, msg="the events snapshot")
            c.stream_feed(stid, b"apple banana apple\ncherry\n")
            wait_until(lambda: c.stream_status(stid)["stream"]["batches"]
                       >= 1, msg="the first micro-batch")
            st = c.stream_status(stid)
            assert st["stream"]["watermark"] > 0
            assert "prefetch_depth" in st["stream"]["ingest"]
            listed = [_stream_view(s) for s in c.streams()]
            closed = c.stream_close(stid)
            t.join(timeout=60)
            assert not t.is_alive()
            with pytest.raises((ServeError, JServeError)) as ei:
                c.stream_feed(stid, b"late\n")
            assert ei.value.code == 409
            got[name] = (_stream_view(st), listed, _stream_view(closed),
                         [e["event"] for e in events],
                         [(e["rows"], e["seq"]) for e in events
                          if e["event"] == "batch"])
        assert got["jax"] == got["port"]
        assert got["port"][2]["stream"]["rows"] == 2
        assert got["port"][3][0] == "status" and \
            got["port"][3][-1] == "status"
        assert p.t.stats()["streams"] == p.j.stats()["streams"]
        assert p.journal_kinds() == ["stream_open", "stream_close"]


def test_serve_stream_validation_cap_and_budget_pin(tmp_path, monkeypatch):
    from test_torch_serve import Pair
    monkeypatch.setenv("MRTPU_SERVE_STREAMS", "1")
    with Pair(tmp_path, workers=1) as p:
        for body in ({"parser": "nope"}, {"reduce": "cull"},
                     {"window": "x"}, {"sources": "a.txt"},
                     {"deadline_ms": 0}):
            (code, _, _), _ = p.http("POST", "/v1/streams", body)
            assert code == 400
        stid = p.tc.stream_open()["id"]
        assert p.jc.stream_open()["id"] == stid
        (code, _, hdr), _ = p.http("POST", "/v1/streams", {})
        assert code == 429 and "Retry-After" in hdr
        eng = p.t.streams.get(stid).engine
        assert eng.settings.get("fpath", "").startswith(
            p.t.streams.stream_dir(stid))
        for c in (p.jc, p.tc):
            c.stream_close(stid)
        assert p.tc.stream_open()["id"] == p.jc.stream_open()["id"] != stid
        for name in ("GET /v1/streams/st999999",
                     "POST /v1/streams/st999999/feed"):
            method, path = name.split()
            (code, _, _), _ = p.http(method, path)
            assert code == 404


def test_serve_stream_resumes_across_daemon_restart(tmp_path):
    from gpu_mapreduce_tpu_torch.serve import ServeClient, Server
    from test_torch_serve import wait_until
    state = str(tmp_path / "state")
    srv = Server(port=0, workers=1, state_dir=state, device="cpu")
    srv.start()
    c = ServeClient.local(srv.port)
    stid = c.stream_open()["id"]
    c.stream_feed(stid, b"x y x\n")
    wait_until(lambda: c.stream_status(stid)["stream"]["batches"] >= 1,
               msg="a batch before the restart")
    srv.shutdown()                    # suspends: no stream_close
    srv2 = Server(port=0, workers=1, state_dir=state, device="cpu")
    srv2.start()
    try:
        c2 = ServeClient.local(srv2.port)
        st = c2.stream_status(stid)
        assert st["state"] == "open"
        assert st["stream"]["batches"] == 1 and st["stream"]["resumed"]
        c2.stream_feed(stid, b"z z\n")
        wait_until(lambda: c2.stream_status(stid)["stream"]["batches"] >= 2,
                   msg="a batch after the restart")
        assert c2.stream_close(stid)["state"] == "closed"
        assert srv2.streams.get(stid).engine.snapshot() == \
            oracle("x y x\nz z\n")
    finally:
        srv2.shutdown()
    assert [r["kind"] for r in read_journal(state)] == \
        [r["kind"] for r in j_read_journal(state)] == \
        ["stream_open", "stream_close"]
    srv3 = Server(port=0, workers=1, state_dir=state, device="cpu")
    srv3.start()
    try:
        assert srv3.streams.get(stid) is None   # closed stays closed
    finally:
        srv3.shutdown()
