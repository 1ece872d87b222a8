"""launch — the process group's supervisor (the port of the reference
package's ``scripts/mrlaunch.py``).

Starts N worker processes that form one process group
(``parallel/dist.py``: ``torch.distributed`` over the cards, or over the
CPU with ``--device cpu``), runs a chunked, checkpointed wordfreq over
the exchange across ranks, and survives a rank's death: when a rank is
SIGKILLed or hangs, the survivors' collective watchdog turns the stall
into a bounded ``PeerLostError`` exit, and the launcher fences the dead
rank, shrinks the world to the largest power of two ≤ the survivors and
starts a fresh generation on a fresh port, which resumes from the last
durable checkpoint manifest.  The output is byte-identical to an
uninterrupted run at the narrow width.

Usage::

    python -m gpu_mapreduce_tpu_torch.launch --np 4 --rundir /tmp/run \\
        [--device cpu] wordfreq --files a.txt b.txt --out /tmp/run/out.txt \\
        --chunks 8 --ckpt-every 1

Chaos (deterministic, ``ft/inject``'s process kinds)::

    MRTPU_FAULTS='site=dist.exchange;kind=peer_kill;rank=2;after=1;n=1' \\
        python -m gpu_mapreduce_tpu_torch.launch --np 4 ...

Worker exit codes: 0 done, 75 a survivor that saw a peer lost
(``EXIT_PEER_LOST``), 76 a fenced zombie (``EXIT_FENCED``); anything
else, and any signal, marks the rank dead.  The launcher prints one
summary JSON line (``mrlaunch:``) with the generations, the dead ranks
and ``recover_seconds`` (first fault seen → every rank of the shrunk
generation heartbeating), and writes it to ``<rundir>/launch.json``.

One trace id covers the whole launch, kept across shrinks: it is in
``launch.json`` and in every rank's ``MRTPU_DIST_TRACE_ID`` (an outer
``MRTPU_DIST_TRACE_ID`` is kept), so every rank's spans, journal
records, flight dumps and metrics dumps carry it.  A worker leaving
through ``os._exit`` (which skips the excepthook and atexit) first
writes its last words: the flight ring's dump and a final metrics dump
with the exit's reason.

Run directory: ``workload.json``, ``g<gen>-rank<r>.log``, the heartbeat,
fence and exit-report files and the sync records under ``hb-g<gen>/``,
``ckpt/step-<k>/{rank<r>.npz, MANIFEST.json}``, ``final/rank<r>.npz``,
the trace shards ``trace-r<r>.jsonl``, the metrics dumps
``metrics-r<r>.json`` and the flight dumps ``mr_flight.<pid>.<seq>.json``.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os
import shutil
import signal
import socket
import subprocess
import sys
import time

import numpy as np
import torch

from .ops.bits import from_order_key, order_key, to_numpy
from .parallel import dist as D
from .parallel.reshard import _offsets
from .parallel.sharded import even_counts
from .parallel.shuffle import exchange
from .utils.env import env_knob, env_str
from .utils.fsio import atomic_replace, atomic_write_json, read_json
from .utils.io import read_words

_REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_WORKLOAD_SPEC = "workload.json"


# ---------------------------------------------------------------------------
# shared helpers (launcher and worker)
# ---------------------------------------------------------------------------

def pick_port() -> int:
    """A free TCP port on localhost for a process group's rendezvous."""
    s = socket.socket()
    try:
        s.bind(("localhost", 0))
        return s.getsockname()[1]
    finally:
        s.close()


def _ckpt_root(rundir: str) -> str:
    return os.path.join(rundir, "ckpt")


def _step_dir(rundir: str, step: int) -> str:
    return os.path.join(_ckpt_root(rundir), f"step-{step:05d}")


def _manifest_path(step_dir: str) -> str:
    return os.path.join(step_dir, "MANIFEST.json")


def _sha256(path: str) -> str:
    h = hashlib.sha256()
    with open(path, "rb") as f:
        for block in iter(lambda: f.read(1 << 20), b""):
            h.update(block)
    return h.hexdigest()


def latest_manifest(rundir: str):
    """(manifest, step dir) of the newest VALID checkpoint: every shard
    file present and matching its digest; a torn or half-written step
    falls back to the one before.  (None, None) when there is none."""
    root = _ckpt_root(rundir)
    try:
        steps = sorted(d for d in os.listdir(root) if d.startswith("step-"))
    except OSError:
        return None, None
    for d in reversed(steps):
        sdir = os.path.join(root, d)
        man = read_json(_manifest_path(sdir))
        if not man or "shards" not in man:
            continue
        ok = True
        for meta in man["shards"].values():
            path = os.path.join(sdir, meta["file"])
            if not os.path.exists(path) or _sha256(path) != meta["sha256"]:
                ok = False
                break
        if ok:
            return man, sdir
        print(f"mrlaunch: checkpoint {d} damaged/incomplete; "
              f"falling back", file=sys.stderr)
    return None, None


def _atomic_npz(path: str, **arrays) -> None:
    """Durable npz: tmp + fsync + rename + directory fsync."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez(f, **arrays)
        f.flush()
        os.fsync(f.fileno())
    atomic_replace(tmp, path)


# ---------------------------------------------------------------------------
# the worker: one rank of the process group
# ---------------------------------------------------------------------------

def _stable_ids(words):
    """bytes word → u64 id by blake2b-8: the same in every process and
    run (Python's ``hash()`` is salted, intern tables are per process)."""
    cache = {}
    out = np.empty(len(words), np.uint64)
    for i, w in enumerate(words):
        v = cache.get(w)
        if v is None:
            v = cache[w] = int.from_bytes(
                hashlib.blake2b(w, digest_size=8).digest(), "little")
        out[i] = v
    return out


def _merge_table(tk, tc, nk, nc):
    """Add the pairs (nk, nc) into the table (tk, tc): u64 keys as int64
    bits, sorted in unsigned order as ``np.unique`` sorts them, with
    exact int64 sums; on the tensors' device."""
    allk = torch.cat([tk, nk])
    allc = torch.cat([tc, nc])
    uk, inv = torch.unique(order_key(allk, np.uint64), sorted=True,
                           return_inverse=True)
    sums = torch.zeros(uk.shape[0], dtype=torch.int64, device=uk.device)
    sums.index_add_(0, inv, allc)
    return from_order_key(uk, np.uint64, torch.int64), sums


class _Worker:
    """One rank's run of the chunked wordfreq."""

    def __init__(self, spec: dict):
        self.spec = spec
        self.rundir = spec["rundir"]
        self.rt = D.init_from_env()
        if self.rt is None:
            raise SystemExit("launch worker started without MRTPU_DIST_* "
                             "env — use the launcher")
        self.W = self.rt.world
        self.rank = self.rt.rank
        self.device = self.rt.device
        print(f"launch: rank {self.rank} of {self.W}, gen {self.rt.gen}, "
              f"device {self.device}, backend {self.rt.backend}, "
              f"transport {self.rt.transport}", file=sys.stderr, flush=True)

    def _empty(self):
        z = torch.zeros(0, dtype=torch.int64, device=self.device)
        return z, z.clone()

    def _rank_kv(self, keys, vals, counts):
        return D.shard_local_rows((keys, vals), counts,
                                  key_dtype=np.uint64, value_dtype=np.int64)

    def _allgather_sizes(self, n_local: int) -> np.ndarray:
        """Every rank's table size: the range rebalance's schedule input
        (each rank knows only its own)."""
        return self.rt.guard("reshard", D.all_gather_host,
                             np.array([n_local], np.int64))[:, 0]

    def _barrier(self, site: str = "ckpt_barrier") -> None:
        """The all-ranks gate: a checkpoint manifest may name only shards
        that are durable on EVERY rank."""
        got = self.rt.guard(site, D.barrier_count)
        if got != self.W:
            raise RuntimeError(f"barrier counted {got}, world {self.W}")

    # -- checkpoints --------------------------------------------------------
    def _checkpoint(self, step: int, tk, tc, chunks_done: int) -> None:
        sdir = _step_dir(self.rundir, step)
        os.makedirs(sdir, exist_ok=True)
        _atomic_npz(os.path.join(sdir, f"rank{self.rank}.npz"),
                    k=to_numpy(tk, np.uint64), c=to_numpy(tc, np.int64))
        self._barrier("ckpt_barrier")
        if self.rank == 0:
            shards = {}
            for r in range(self.W):
                f = f"rank{r}.npz"
                path = os.path.join(sdir, f)
                with np.load(path) as z:
                    nrows = int(z["k"].shape[0])
                shards[str(r)] = {"file": f, "nrows": nrows,
                                  "sha256": _sha256(path)}
            atomic_write_json(_manifest_path(sdir), {
                "step": step, "width": self.W,
                "chunks_done": chunks_done, "gen": self.rt.gen,
                "shards": shards})
            self._gc_ckpts(keep=2)

    def _gc_ckpts(self, keep: int) -> None:
        root = _ckpt_root(self.rundir)
        try:
            steps = sorted(d for d in os.listdir(root)
                           if d.startswith("step-"))
        except OSError:
            return
        done = [d for d in steps
                if os.path.exists(_manifest_path(os.path.join(root, d)))]
        for d in done[:-keep]:
            shutil.rmtree(os.path.join(root, d), ignore_errors=True)

    def _restore(self):
        """(table keys, table counts, chunks done): the last durable
        manifest's shards re-keyed onto THIS generation's width by the
        hash exchange the live path uses.  Old rank r's shard is read by
        new rank ``r % W``, in ascending r."""
        man, sdir = latest_manifest(self.rundir)
        if man is None:
            return (*self._empty(), 0)
        old_w = int(man["width"])
        nrows = {int(r): int(meta["nrows"])
                 for r, meta in man["shards"].items()}
        counts = np.zeros(self.W, np.int64)
        for r in range(old_w):
            counts[r % self.W] += nrows[r]
        ks, cs = [], []
        for r in range(old_w):
            if r % self.W != self.rank:
                continue
            with np.load(os.path.join(
                    sdir, man["shards"][str(r)]["file"])) as z:
                ks.append(z["k"].astype(np.uint64))
                cs.append(z["c"].astype(np.int64))
        myk = np.concatenate(ks) if ks else np.zeros(0, np.uint64)
        myc = np.concatenate(cs) if cs else np.zeros(0, np.int64)
        # hash % W over the new width: old shards' keys may meet on one
        # rank (hash % old_w partitions differ); the merge sums them
        out = exchange(self._rank_kv(myk, myc, counts), ("hash", None))
        tk, tc = _merge_table(*self._empty(), *out.valid_rows())
        return tk, tc, int(man["chunks_done"])

    # -- the workload -------------------------------------------------------
    def run_wordfreq(self) -> None:
        spec = self.spec
        words = []
        for path in spec["files"]:
            with open(path, "rb") as f:
                words.extend(read_words(f.read()))
        ids = _stable_ids(words)
        C = max(1, int(spec.get("chunks", 4)))
        ckpt_every = max(1, int(spec.get("ckpt_every", 1)))
        bounds = np.linspace(0, ids.shape[0], C + 1).astype(np.int64)

        tk, tc, start = self._restore()
        for c in range(start, C):
            chunk = ids[bounds[c]:bounds[c + 1]]
            counts = even_counts(chunk.shape[0], self.W)
            offs = np.concatenate([[0], np.cumsum(counts)])
            mine = chunk[offs[self.rank]:offs[self.rank + 1]]
            skv = self._rank_kv(mine, np.ones(mine.shape[0], np.int64),
                                counts)
            out = exchange(skv, ("hash", None))
            tk, tc = _merge_table(tk, tc, *out.valid_rows())
            if (c + 1 - start) % ckpt_every == 0 or c == C - 1:
                self._checkpoint(c + 1, tk, tc, chunks_done=c + 1)

        self._finalize(tk, tc, words)

    def _finalize(self, tk, tc, words) -> None:
        """Rebalance the hash-partitioned table by the range exchange,
        write each rank's final shard, and let rank 0 decode and write
        the output behind the fence check."""
        sizes = self._allgather_sizes(int(tk.shape[0]))
        total = int(sizes.sum())
        offsets = _offsets(sizes)
        ends = tuple(int(x) for x in
                     np.cumsum(even_counts(total, self.W)))
        out = exchange(self._rank_kv(tk, tc, sizes),
                       ("range", offsets, ends), site="reshard")
        k, c = out.valid_rows()
        fdir = os.path.join(self.rundir, "final")
        os.makedirs(fdir, exist_ok=True)
        _atomic_npz(os.path.join(fdir, f"rank{self.rank}.npz"),
                    k=to_numpy(k, np.uint64), c=to_numpy(c, np.int64))
        self._barrier("ckpt_barrier")
        if self.rank == 0:
            if self.rt.fenced():       # the zombie guard on the output
                raise D.RankFencedError(self.rank, "finalize")
            decode = {}
            for w in sorted(set(words)):
                decode.setdefault(int(_stable_ids([w])[0]), w)
            rows = []
            for r in range(self.W):
                with np.load(os.path.join(fdir, f"rank{r}.npz")) as z:
                    for kk, cc in zip(z["k"], z["c"]):
                        rows.append((int(cc), decode.get(int(kk), b"?")))
            rows.sort(key=lambda rc: (-rc[0], rc[1]))
            out_path = self.spec["out"]
            tmp = f"{out_path}.{os.getpid()}.tmp"
            with open(tmp, "wb") as f:
                for cnt, word in rows:
                    f.write(word + b" %d\n" % cnt)
                f.flush()
                os.fsync(f.fileno())
            atomic_replace(tmp, out_path)


def _worker_last_words(w, reason: str, flight: bool = True) -> None:
    """The forensic artifacts of a worker on its way out (JAX
    ``mrlaunch.py:413-435``): ``os._exit`` skips the excepthook and
    atexit, so the flight ring's dump and the final metrics dump are
    written here.  Never raises: the exit code comes first."""
    if flight:
        try:
            from .obs import flight as _flight
            rec = _flight.get()
            if rec is not None:
                rec.dump(reason)
        except Exception:
            pass
    try:
        if w.rt.metrics_dumper is not None:
            w.rt.metrics_dumper.stop(reason)
    except Exception:
        pass
    try:
        if w.rt.sync_obs is not None:
            w.rt.sync_obs.close()
    except Exception:
        pass


def worker_main(argv) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--rundir", required=True)
    args = ap.parse_args(argv)
    with open(os.path.join(args.rundir, _WORKLOAD_SPEC)) as f:
        spec = json.load(f)
    spec["rundir"] = args.rundir

    w = _Worker(spec)
    try:
        if spec["workload"] == "wordfreq":
            w.run_wordfreq()
        else:
            raise SystemExit(f"unknown workload {spec['workload']!r}")
    except D.PeerLostError as e:
        print(f"mrlaunch worker rank {w.rank}: {e}", file=sys.stderr,
              flush=True)
        D.write_exit_report(w.rundir, w.rank, w.rt.gen, "peer_lost",
                            dead=e.dead, site=e.site)
        # every survivor dumps its flight ring (with the lease table) and
        # its metrics: the post-mortem does not depend on the rank asked
        _worker_last_words(w, f"peer_lost:{e.site}")
        # os._exit: never tear down a wedged communicator
        os._exit(D.EXIT_PEER_LOST)
    except D.RankFencedError as e:
        print(f"mrlaunch worker rank {w.rank}: {e}", file=sys.stderr,
              flush=True)
        D.write_exit_report(w.rundir, w.rank, w.rt.gen, "fenced")
        _worker_last_words(w, "fenced")
        os._exit(D.EXIT_FENCED)
    D.write_exit_report(w.rundir, w.rank, w.rt.gen, "done")
    _worker_last_words(w, "done", flight=False)
    w.rt.stop()
    sys.stdout.flush()
    sys.stderr.flush()
    # every rank finished every collective: skip the interpreter's
    # teardown of the process group, as the other exits do
    os._exit(0)


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _spawn_generation(rundir: str, width: int, gen: int, device: str = "",
                      trace_id: str = ""):
    port = pick_port()
    procs = {}
    for rank in range(width):
        env = dict(os.environ)
        env.update({
            "MRTPU_DIST_WORLD": str(width),
            "MRTPU_DIST_RANK": str(rank),
            "MRTPU_DIST_COORD": f"localhost:{port}",
            "MRTPU_DIST_RUNDIR": rundir,
            "MRTPU_DIST_GEN": str(gen),
            "MRTPU_DIST_DEVICE": device,
        })
        if trace_id:
            # every rank of every generation carries the launch's id
            env["MRTPU_DIST_TRACE_ID"] = trace_id
        log = open(os.path.join(rundir, f"g{gen}-rank{rank}.log"), "ab")
        procs[rank] = (subprocess.Popen(
            [sys.executable, "-m", "gpu_mapreduce_tpu_torch.launch",
             "--worker", "--rundir", rundir],
            env=env, cwd=_REPO, stdout=log, stderr=log), log)
    return procs


def _reap(procs):
    """{rank: returncode} (None while running)."""
    return {r: p.poll() for r, (p, _log) in procs.items()}


def _read_exit_reports(rundir: str, gen: int, width: int):
    out = {}
    for r in range(width):
        rec = read_json(D.exit_path(rundir, r, gen))
        if rec:
            out[r] = rec
    return out


def _classify_dead(codes: dict, hung: list, reports: dict) -> set:
    """Which ranks of a failed generation died, by three tiers of
    evidence: (1) exit reports — a rank that wrote one is a survivor, and
    the dead lists of its ``peer_lost`` report are its watchdog's
    observations; (2) hard evidence — SIGKILL, any other signal but
    SIGABRT, unexpected exit codes, and ranks the launcher had to kill
    (hung); (3) SIGABRT — a survivor torn down by its collective
    library's abort in a cascade, counted dead only when tiers 1-2 found
    nothing."""
    dead = set()
    for r, rec in reports.items():
        if rec.get("code") == "peer_lost":
            dead.update(int(d) for d in rec.get("dead", []))
    dead.update(hung)
    abrt = set()
    for r, rc in codes.items():
        if r in reports or rc in (0, 75, 76) or rc is None:
            continue
        if rc == -signal.SIGABRT:
            abrt.add(r)
        else:
            dead.add(r)
    if not dead:
        dead = abrt
    return dead - set(reports)


def run_launcher(args, workload_spec: dict) -> dict:
    rundir = os.path.abspath(args.rundir)
    os.makedirs(rundir, exist_ok=True)
    with open(os.path.join(rundir, _WORKLOAD_SPEC), "w") as f:
        json.dump(workload_spec, f)

    grace = args.grace
    width, gen = args.np, 0
    # one trace id for the whole launch, the same across generations; an
    # outer orchestrator may give its own
    trace_id = env_str("MRTPU_DIST_TRACE_ID", "") or os.urandom(8).hex()
    t_start = time.monotonic()
    t_detect = None
    recover_s = None
    history = []

    while True:
        procs = _spawn_generation(rundir, width, gen, args.device,
                                  trace_id)
        if t_detect is not None and recover_s is None:
            # the recovery clock: first fault seen → every rank of the
            # shrunk generation heartbeating (a rank that already exited
            # 0 beat before it removed its lease)
            deadline = time.monotonic() + grace + 60
            while time.monotonic() < deadline:
                codes = _reap(procs)
                if all(codes[r] == 0
                       or os.path.exists(D.hb_path(rundir, r, gen))
                       for r in range(width)):
                    recover_s = time.monotonic() - t_detect
                    break
                if any(rc is not None and rc != 0
                       for rc in codes.values()):
                    break
                time.sleep(0.05)
        fault = False
        while True:
            codes = _reap(procs)
            abnormal = {r: rc for r, rc in codes.items()
                        if rc is not None
                        and rc not in (0, D.EXIT_PEER_LOST, D.EXIT_FENCED)}
            reported = {r for r, rc in codes.items()
                        if rc == D.EXIT_PEER_LOST}
            if abnormal or reported:
                fault = True
                if t_detect is None:
                    t_detect = time.monotonic()
                break
            if all(rc is not None for rc in codes.values()):
                break                       # all exited, none faulted
            time.sleep(0.05)
        if not fault:
            for _p, log in procs.values():
                log.close()
            if not all(rc == 0 for rc in codes.values()):
                # only EXIT_FENCED gets here: a zombie of THIS generation
                # means the fencing broke — fail loudly
                raise SystemExit(f"mrlaunch: generation {gen} exited "
                                 f"{codes} with no fault reported")
            break

        # give the survivors `grace` to trip their watchdogs and exit,
        # then SIGKILL what is left (hung ranks)
        deadline = time.monotonic() + grace
        while time.monotonic() < deadline:
            if all(rc is not None for rc in _reap(procs).values()):
                break
            time.sleep(0.1)
        hung = []
        for r, (p, _log) in procs.items():
            if p.poll() is None:
                hung.append(r)
                try:
                    p.send_signal(signal.SIGKILL)
                except OSError:
                    pass
                p.wait()
        codes = _reap(procs)
        for _p, log in procs.values():
            log.close()
        reports = _read_exit_reports(rundir, gen, width)
        dead = {r for r in _classify_dead(codes, hung, reports)
                if 0 <= r < width}
        for r in sorted(dead):
            D.fence_rank(rundir, r, by="launcher", gen=gen)
        new_width = D.shrink_width(width - len(dead))
        history.append({"gen": gen, "width": width,
                        "dead": sorted(dead), "codes": codes})
        print(f"mrlaunch: gen {gen} lost rank(s) {sorted(dead)} "
              f"(codes {codes}); shrinking {width} -> {new_width}",
              file=sys.stderr, flush=True)
        if new_width < 1:
            raise SystemExit("mrlaunch: no survivors to shrink onto")
        if gen + 1 > args.max_generations:
            raise SystemExit(f"mrlaunch: gave up after "
                             f"{args.max_generations} generations")
        width, gen = new_width, gen + 1

    summary = {"generations": gen + 1, "final_width": width,
               "trace_id": trace_id, "history": history, "recover_seconds": recover_s,
               "wall_seconds": time.monotonic() - t_start}
    print("mrlaunch: " + json.dumps(summary), flush=True)
    atomic_write_json(os.path.join(rundir, "launch.json"), summary)
    return summary


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] == "--worker":
        return worker_main(argv[1:])
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--np", type=int, default=2,
                    help="process count (the world; one shard a rank)")
    ap.add_argument("--rundir", required=True,
                    help="run directory: heartbeats, checkpoints, logs")
    ap.add_argument("--device", choices=("cpu",), default="",
                    help="run the ranks on the CPU (default: the cards)")
    ap.add_argument("--grace", type=float, default=None,
                    help="seconds to let survivors trip their watchdog "
                         "before SIGKILLing the rest (default: "
                         "MRTPU_DIST_SYNC_TIMEOUT + 10)")
    ap.add_argument("--max-generations", type=int, default=3)
    sub = ap.add_subparsers(dest="workload", required=True)
    wf = sub.add_parser("wordfreq", help="chunked checkpointed wordfreq")
    wf.add_argument("--files", nargs="+", required=True)
    wf.add_argument("--out", required=True)
    wf.add_argument("--chunks", type=int, default=4)
    wf.add_argument("--ckpt-every", type=int, default=1)
    args = ap.parse_args(argv)
    if args.grace is None:
        args.grace = env_knob("MRTPU_DIST_SYNC_TIMEOUT", float, 60.0) + 10
    # absolute against the launcher's cwd: workers run from the repo root
    spec = {"workload": "wordfreq",
            "files": [os.path.abspath(f) for f in args.files],
            "out": os.path.abspath(args.out),
            "chunks": args.chunks, "ckpt_every": args.ckpt_every}
    run_launcher(args, spec)
    return 0


if __name__ == "__main__":
    sys.exit(main())
