"""The op journal, auto-checkpoints and ``resume`` (the port's copy of
``gpu_mapreduce_tpu/ft/journal.py``).

* An **append-only JSONL journal** under ``MRTPU_JOURNAL=dir``
  (``journal.jsonl``): a ``begin`` record with the script's lines, a
  ``cmd`` record per completed script command, an ``op`` record per
  completed MapReduce barrier op (forensics), a ``ckpt`` record per
  durable checkpoint set and a ``resume`` record per resume.  Every
  record carries a crc of its own payload (``"c"``) and is written only
  after the thing it describes completed; ``cmd`` and ``ckpt`` records
  are fsync'd before the run goes on.
* **Auto-checkpoints** every ``MRTPU_CKPT_EVERY`` completed commands
  (default 5): every named MR saves through ``core/checkpoint.py`` into
  ``dir/ckpt-<seq>/<name>``; the ``ckpt`` record lands only after every
  save succeeded, and only the two newest sets are kept.  A run with no
  script checkpoints the reporting MapReduce into ``dir/auto`` every N
  ops instead.
* **Resume** (:func:`resume`, or the OINK builtin ``resume <dir>``)
  re-runs the recorded lines, skipping the first K command executions
  (K = the last usable checkpoint's sequence number; builtins re-run so
  loop variables and jumps reproduce), restores the named MRs from that
  checkpoint, then goes on live, journaling into the same directory.

The files are those of the JAX package: a journal either package wrote
resumes in the other.  A checkpoint holds host rows, so a resume loads
them onto whatever device or mesh the new interpreter runs on.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import threading
import time
import zlib
from typing import Dict, List, Optional

from ..core.runtime import MRError

_FILE = "journal.jsonl"

_LOCK = threading.Lock()
_ACTIVE: Optional["Journal"] = None


def _rec_crc(body: str) -> str:
    """crc of a record's serialized payload (its ``"c"`` field)."""
    return f"{zlib.crc32(body.encode()) & 0xFFFFFFFF:08x}"


def _rec_valid(rec: dict) -> bool:
    """A record without ``"c"`` passes; a mismatch is corruption."""
    c = rec.get("c")
    if c is None:
        return True
    body = json.dumps({k: v for k, v in rec.items() if k != "c"},
                      default=str)
    return _rec_crc(body) == c


class Journal:
    """One append-only journal and its checkpoint directory."""

    def __init__(self, dir: str, script_mode: bool = False,
                 every: Optional[int] = None):
        from ..utils.env import env_knob
        from ..utils.fsio import fsync_dir
        self.dir = dir
        os.makedirs(dir, exist_ok=True)
        self.path = os.path.join(dir, _FILE)
        # a torn tail from a killed writer (no final newline) is sealed
        # before the first append, so it cannot swallow a new record
        sealed = True
        try:
            with open(self.path, "rb") as f:
                f.seek(-1, os.SEEK_END)
                sealed = f.read(1) == b"\n"
        except (OSError, ValueError):
            pass        # missing or empty: nothing to seal
        created = not os.path.exists(self.path)
        self._f = open(self.path, "a")
        if created:
            fsync_dir(dir)       # the journal's own name is durable
        if not sealed:
            self._f.write("\n")
            self._f.flush()
        self.script_mode = script_mode
        self.every = max(1, every if every is not None
                         else env_knob("MRTPU_CKPT_EVERY", int, 5))
        self.cmd_seq = 0          # completed script-command executions
        self.op_seq = 0           # completed MR barrier ops
        self.nckpt = 0
        self._since = 0           # commands (or ops) since the last set
        self._wlock = threading.Lock()

    # -- append -------------------------------------------------------------
    def append(self, rec: dict, sync: bool = True) -> None:
        """Append one record with its crc; on disk when this returns
        (``sync=False``, for the forensic op records, skips the fsync)."""
        body = json.dumps(rec, default=str)
        line = json.dumps({**json.loads(body), "c": _rec_crc(body)},
                          default=str)
        with self._wlock:
            self._f.write(line + "\n")
            self._f.flush()
            if sync:
                os.fsync(self._f.fileno())

    def begin(self, lines: List[str], name: str) -> None:
        # the command count is per script: a resume skips within the
        # last begin's lines
        self.cmd_seq = 0
        self._since = 0
        self.append({"kind": "begin", "name": name, "lines": list(lines),
                     "pid": os.getpid(),
                     "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ",
                                          time.gmtime())})

    def cmd_done(self, command: str) -> None:
        self.cmd_seq += 1
        self.append({"kind": "cmd", "seq": self.cmd_seq, "cmd": command})

    def note_op(self, op: str, **extra) -> None:
        self.op_seq += 1
        self.append({"kind": "op", "op_seq": self.op_seq, "op": op,
                     **extra}, sync=False)

    # -- checkpointing ------------------------------------------------------
    def maybe_checkpoint(self, obj) -> None:
        """Checkpoint every named MR of ``obj`` every ``every`` completed
        commands."""
        self._since += 1
        if self._since >= self.every:
            self.checkpoint(obj)

    def checkpoint(self, obj) -> bool:
        """Save every named MR, then append the ``ckpt`` record.  A save
        that fails (an MR with uncompleted adds, a disk error, a fault
        past its budget) drops the partial set: the round is tried again
        after the next command, and the run goes on; a failure of the
        card raises.  Returns whether a set landed."""
        import dataclasses
        from ..core.checkpoint import save as _cksave
        from .retry import device_error, retry_call
        seq = self.cmd_seq
        reldir = f"ckpt-{seq:05d}"
        cdir = os.path.join(self.dir, reldir)
        mrs: Dict[str, dict] = {}
        nprocs = 1
        try:
            for name in sorted(obj.named):
                mr = obj.named[name]
                path = os.path.join(cdir, name)
                retry_call("checkpoint.save",
                           lambda m=mr, p=path: _cksave(m, p),
                           detail=path)
                nprocs = max(nprocs, int(mr.backend.nprocs))
                mrs[name] = {"path": f"{reldir}/{name}",
                             "settings": dataclasses.asdict(mr.settings)}
        except Exception as e:
            shutil.rmtree(cdir, ignore_errors=True)
            if device_error(e):
                raise           # the card failed: never an optional miss
            return False
        self.append({"kind": "ckpt", "seq": seq, "mrs": mrs,
                     "nprocs": nprocs})
        self.nckpt += 1
        self._since = 0
        self._gc(keep=2)
        return True

    def auto_checkpoint(self, mr) -> None:
        """A run with no script: every ``every`` ops, checkpoint the
        reporting MR into the one ``auto`` slot."""
        self._since += 1
        if self._since < self.every:
            return
        from ..core.checkpoint import save as _cksave
        from .retry import device_error, retry_call
        path = os.path.join(self.dir, "auto")
        try:
            retry_call("checkpoint.save", lambda: _cksave(mr, path),
                       detail=path)
        except Exception as e:
            if device_error(e):
                raise
            return      # tried again after the next op
        self.append({"kind": "auto_ckpt", "op_seq": self.op_seq,
                     "path": "auto", "nprocs": int(mr.backend.nprocs)})
        self.nckpt += 1
        self._since = 0

    def _gc(self, keep: int) -> None:
        """Keep the ``keep`` newest ckpt directories, by mtime: a re-run
        in the same directory restarts the numbering, and its fresh
        low-numbered sets must outlive the stale high-numbered ones."""
        try:
            dirs = sorted((d for d in os.listdir(self.dir)
                           if d.startswith("ckpt-")),
                          key=lambda d: os.path.getmtime(
                              os.path.join(self.dir, d)))
            for d in dirs[:-keep]:
                shutil.rmtree(os.path.join(self.dir, d),
                              ignore_errors=True)
        except OSError:
            pass

    def stats(self) -> dict:
        return {"dir": self.dir, "cmds": self.cmd_seq, "ops": self.op_seq,
                "ckpts": self.nckpt, "every": self.every}

    def close(self) -> None:
        try:
            self._f.close()
        except OSError:
            pass


# ---------------------------------------------------------------------------
# the process's active journal (MapReduce._op_stats reports to it)
# ---------------------------------------------------------------------------

def active() -> Optional[Journal]:
    return _ACTIVE


def activate(journal: Optional[Journal]) -> Optional[Journal]:
    """Install ``journal`` as the op-record sink; returns the previous
    one."""
    global _ACTIVE
    with _LOCK:
        prev, _ACTIVE = _ACTIVE, journal
    return prev


def from_env(script_mode: bool = False) -> Optional[Journal]:
    """A fresh, activated Journal for ``MRTPU_JOURNAL``, or None.  A
    previous programmatic journal is closed; a script's stays open (its
    interpreter still appends through it)."""
    from ..utils.env import env_str
    dir = env_str("MRTPU_JOURNAL", "")
    if not dir:
        return None
    j = Journal(dir, script_mode=script_mode)
    prev = activate(j)
    if prev is not None and prev is not j and not prev.script_mode:
        prev.close()
    return j


_ENV_APPLIED: Optional[str] = None


def configure_from_env() -> None:
    """Arm the programmatic journal from ``MRTPU_JOURNAL`` when it
    changed (every MapReduce construction); a script's own journal is
    never replaced, and an unusable directory warns and disarms."""
    global _ENV_APPLIED
    from ..utils.env import env_str
    raw = env_str("MRTPU_JOURNAL", "")
    with _LOCK:
        if raw == (_ENV_APPLIED or ""):
            return
        _ENV_APPLIED = raw
        active_now = _ACTIVE
    if raw and active_now is None:
        try:
            from_env(script_mode=False)
        except OSError as e:
            print(f"MRTPU_JOURNAL ignored: {e!r}", file=sys.stderr)
    elif not raw and active_now is not None and not active_now.script_mode:
        reset()


def note_op(mr, op: str, n=None) -> None:
    """After every completed barrier op (``MapReduce._op_stats``): one
    check when no journal is armed."""
    j = _ACTIVE
    if j is None:
        return
    try:
        j.note_op(op, **({"n": int(n)} if isinstance(n, (int, float))
                         else {}))
        if not j.script_mode:
            j.auto_checkpoint(mr)
    except ValueError:
        # the journal closed under us (a resume finishing elsewhere):
        # op records and optional checkpoints never fail the op
        return


# ---------------------------------------------------------------------------
# reading + resume
# ---------------------------------------------------------------------------

def read_journal(dir: str) -> List[dict]:
    """Every durable record: a torn line (a kill mid-append) is skipped,
    a line that fails its own crc is skipped and counted."""
    path = os.path.join(dir, _FILE)
    try:
        with open(path) as f:
            out = []
            for ln in f:
                ln = ln.strip()
                if not ln:
                    continue
                try:
                    rec = json.loads(ln)
                except ValueError:
                    continue
                if isinstance(rec, dict) and not _rec_valid(rec):
                    from ..utils.integrity import record_integrity_failure
                    record_integrity_failure("journal")
                    continue
                out.append(rec)
            return out
    except FileNotFoundError:
        raise MRError(f"no journal under {dir!r}")


def _ckpt_usable(dir: str, ckpt: dict) -> bool:
    """Whether every checkpoint directory of a ``ckpt`` record
    validates."""
    from ..core.checkpoint import validate
    try:
        return all(validate(os.path.join(dir, meta["path"]))
                   for meta in ckpt.get("mrs", {}).values())
    except Exception:
        return False


def plan_resume(dir: str) -> dict:
    """The replay plan: the recorded lines, the command executions to
    skip and the checkpoint record to restore (the newest that
    validates; none → replay from the start)."""
    recs = read_journal(dir)
    begin_i = max((i for i, r in enumerate(recs)
                   if r.get("kind") == "begin"), default=None)
    if begin_i is None:
        raise MRError(f"journal under {dir!r} has no begin record "
                      f"(nothing to resume)")
    begin = recs[begin_i]
    tail = recs[begin_i:]
    ckpts = [r for r in tail if r.get("kind") == "ckpt"]
    done = max((int(r.get("seq", 0)) for r in tail
                if r.get("kind") == "cmd"), default=0)
    ckpt = None
    fell_back = 0
    for cand in reversed(ckpts):
        if _ckpt_usable(dir, cand):
            ckpt = cand
            break
        fell_back += 1
        print(f"ft.resume: checkpoint generation seq={cand.get('seq')} "
              f"under {dir!r} is damaged or incomplete; falling back",
              file=sys.stderr)
    return {"lines": begin["lines"], "name": begin.get("name", "<resume>"),
            "skip": int(ckpt["seq"]) if ckpt else 0, "ckpt": ckpt,
            "cmds_done": done, "generations_skipped": fell_back}


def restore_mrs(obj, ckpt: dict, dir: str) -> None:
    """Rebuild every named MR of a ``ckpt`` record into ``obj``: its
    settings, then its dataset from the checkpoint directory."""
    for name, meta in ckpt.get("mrs", {}).items():
        mr = obj.named.get(name)
        if mr is None:
            mr = obj.create_mr()
            obj.name_mr(name, mr)
        settings = dict(meta.get("settings", {}))
        if settings:
            mr.set(**settings)
        mr.load(os.path.join(dir, meta["path"]))


def resume_into(script, dir: str) -> None:
    """Drive an OinkScript through the resume plan: skip the
    checkpointed command executions, restore the MRs, go on live with
    the journal re-armed in the same directory (closed at the end: what
    an enclosing script runs after ``resume`` is not part of the
    recorded lines)."""
    plan = plan_resume(dir)
    if getattr(script, "_ft_journal", None) is not None:
        script._ft_journal.close()   # replace an env-armed journal
    j = Journal(dir, script_mode=True)
    activate(j)
    j.cmd_seq = plan["skip"]      # the count goes on from the restore
    ckpt_np = int((plan["ckpt"] or {}).get("nprocs") or 0)
    here_np = int(script._nprocs())
    script._ft_resharded = bool(ckpt_np and ckpt_np != here_np)
    j.append({"kind": "resume", "from_seq": plan["skip"],
              "cmds_done_before_crash": plan["cmds_done"],
              "nprocs": here_np, "ckpt_nprocs": ckpt_np or None,
              "generations_skipped": plan.get("generations_skipped", 0),
              "pid": os.getpid()})
    script._ft_journal = j
    script._ft_pending_begin = None   # never shadow the real begin
    script._ft_skip = plan["skip"]
    script._ft_restore = (plan["ckpt"], dir) if plan["ckpt"] else None
    script._ft_resuming = True
    try:
        script._run_lines(plan["lines"])
    finally:
        script._ft_resuming = False
    j.close()
    script._ft_journal = None
    if active() is j:
        activate(None)


def resume(dir: str, comm=None, screen=False, logfile: Optional[str] = None,
           mesh=None, device=None):
    """A fresh interpreter (on ``device``, or over ``comm``/``mesh``, of
    any width) replaying the journal under ``dir`` from its last usable
    checkpoint.  Returns the finished OinkScript."""
    if mesh is not None:
        if comm is not None and comm is not mesh:
            raise MRError("resume: pass comm OR mesh, not both")
        comm = mesh
    from ..oink.script import OinkScript
    s = OinkScript(device=device, comm=comm, screen=screen, logfile=logfile)
    resume_into(s, dir)
    return s


def latest_checkpoint(dir: str) -> Optional[str]:
    """The newest usable checkpoint under a journal directory: the
    ``auto`` slot or the last script set that validates; None when there
    is none."""
    from ..core.checkpoint import validate
    for r in reversed(read_journal(dir)):
        if r.get("kind") == "auto_ckpt":
            path = os.path.join(dir, r.get("path", "auto"))
            if validate(path):
                return path
        if r.get("kind") == "ckpt" and _ckpt_usable(dir, r):
            return os.path.join(dir, f"ckpt-{int(r['seq']):05d}")
    return None


def reset() -> None:
    """Close and drop the active journal and the env cache."""
    global _ACTIVE, _ENV_APPLIED
    with _LOCK:
        if _ACTIVE is not None:
            _ACTIVE.close()
        _ACTIVE = None
        _ENV_APPLIED = None
