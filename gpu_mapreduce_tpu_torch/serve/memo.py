"""Job-result memoization: a byte-identical resubmission never
recomputes (doc/serve.md#result-memoization).

The key is the sha256 of one canonical document: the normalized script
text, the schema version, and the **input manifest** — (path, size,
crc) of every existing file the script's tokens name (glob patterns
expanded, so ``variable``-driven file lists are covered).  Change one
input byte and the key changes; resubmit the same bytes and any daemon
on the same store serves the stored result from
``<cas>/memo/<key>.json`` without executing a single op.

The **exactness contract** (doc/perf.md#the-caching-tier): the key
deliberately EXCLUDES ``fuse``/``wire``/``megafuse``/mesh width —
those tiers are byte-identical by construction (the repo's standing
invariant, re-asserted by the memo acceptance tests), so a shrunk
fleet reuses what a wide fleet produced.  Anything that could make a
rerun differ makes the submission *non-memoizable* instead of keyed:
``set timer`` / ``set verbosity`` (wall-clock text on the screen
channel) and ``save``/``load`` (checkpoint side effects outside the
result record).

Integrity: entries are stamped on write and verified on read — the
record's own crc AND the sha256 of every inline output file must agree
with what run_session recorded.  A bit-flip bumps
``mrtpu_integrity_failures_total{artifact="cas"}``, removes the entry,
and reads as a miss: corruption degrades to recompute, never to a
wrong answer.

``MRTPU_MEMOIZE=0`` opts the tier out; without a CAS root
(``utils/cas.py``) it is off by construction.
"""

from __future__ import annotations

import glob
import hashlib
import json
import os
import threading
import time
from typing import List, Optional, Tuple

from ..utils.env import env_flag

MEMO_SCHEMA = 1

# script features that break the exactness contract (module docstring).
# ``stream`` is here because a standing query's answer is a moving
# target over growing inputs — never a pure function of the submission
# (doc/streaming.md#memoization)
_NONDET_SET = ("timer", "verbosity")
_SIDE_EFFECT_CMDS = ("save", "load", "stream")

_LOCK = threading.Lock()
_COUNTS = {"hits": 0, "misses": 0, "stores": 0, "corrupt": 0}


def memoize_enabled() -> bool:
    from ..utils.cas import cas_enabled
    return cas_enabled() and env_flag("MRTPU_MEMOIZE", True)


def memo_dir() -> Optional[str]:
    from ..utils.cas import cas_root
    root = cas_root()
    return os.path.join(root, "memo") if root else None


def _memo_path(key: str) -> Optional[str]:
    d = memo_dir()
    return os.path.join(d, key + ".json") if d else None


def _note(outcome: str) -> None:
    with _LOCK:
        if outcome in _COUNTS:
            _COUNTS[outcome] += 1
    try:
        from ..obs.metrics import get_registry
        get_registry().counter(
            "mrtpu_memo_total",
            "result-memoization events by outcome "
            "(hit/miss/store/corrupt)", ("outcome",)).inc(outcome=outcome)
    except Exception:
        pass


def input_manifest(payload: str) -> Optional[List[Tuple[str, int, str]]]:
    """(abspath, bytes, crc) per existing file any script token names —
    conservative on purpose: a token the script never reads only makes
    the key stricter (a spurious recompute), never a wrong hit.  None =
    non-memoizable (a token names a directory, or an input vanished
    mid-scan)."""
    from ..utils.integrity import file_digest
    files = {}
    for raw in payload.split():
        tok = raw.strip("\"'").rstrip(",;")
        if not tok or tok.startswith("-"):
            continue
        if any(c in tok for c in "*?["):
            matches = sorted(glob.glob(tok))
        elif os.path.exists(tok):
            matches = [tok]
        else:
            continue
        for m in matches:
            if os.path.isdir(m):
                return None
            if not os.path.isfile(m):
                continue
            try:
                files[os.path.abspath(m)] = (os.path.getsize(m),
                                             file_digest(m))
            except OSError:
                return None
    return sorted((p, s, d) for p, (s, d) in files.items())


def stat_manifest(payload: str) -> List[Tuple[str, int, float]]:
    """(abspath, size, mtime) per existing input file — the CHEAP
    staleness probe stored alongside the result.  Unlike
    :func:`input_manifest` (which feeds the key and pays a crc per
    file), this one only stats: it exists so :func:`lookup` can detect
    a file that GREW between key computation and the hit being served
    (append-only inputs under a standing query do exactly that) and
    fall through to recompute instead of serving a stale record."""
    files = {}
    for raw in payload.split():
        tok = raw.strip("\"'").rstrip(",;")
        if not tok or tok.startswith("-"):
            continue
        if any(c in tok for c in "*?["):
            matches = sorted(glob.glob(tok))
        elif os.path.exists(tok):
            matches = [tok]
        else:
            continue
        for m in matches:
            if not os.path.isfile(m):
                continue
            try:
                st = os.stat(m)
                files[os.path.abspath(m)] = (st.st_size, st.st_mtime)
            except OSError:
                continue
    return sorted((p, s, t) for p, (s, t) in files.items())


def manifest_stale(manifest) -> bool:
    """True when any recorded input changed shape since the record was
    stored — grew, shrank, vanished, or was rewritten in place (mtime
    moved)."""
    for ent in manifest or ():
        try:
            path, size, mtime = ent[0], int(ent[1]), float(ent[2])
        except (TypeError, ValueError, IndexError):
            return True
        try:
            st = os.stat(path)
        except OSError:
            return True
        if st.st_size != size or st.st_mtime != mtime:
            return True
    return False


def memo_key(payload: str) -> Optional[str]:
    """Stable key of one submission, or None when the script is not
    memoizable under the exactness contract.  Reads NO env knobs by
    design — every key input is in the returned expression, and the
    document is the JAX package's byte for byte (no backend in it)."""
    for line in payload.splitlines():
        toks = line.split()
        if len(toks) >= 2 and toks[0] == "set" \
                and toks[1] in _NONDET_SET:
            return None
        if any(t in _SIDE_EFFECT_CMDS for t in toks[:2]):
            return None
    manifest = input_manifest(payload)
    if manifest is None:
        return None
    doc = {"schema": MEMO_SCHEMA, "script": payload,
           "inputs": manifest}
    return hashlib.sha256(
        json.dumps(doc, sort_keys=True).encode()).hexdigest()


def _verify_record(rec: dict) -> Optional[dict]:
    """Stamp + inline-file verification; the stored result dict on
    success, None on any mismatch."""
    from ..utils.integrity import digest_bytes, verify_enabled
    result = rec.get("result")
    if not isinstance(result, dict):
        return None
    if not verify_enabled():
        return result
    body = json.dumps(result, sort_keys=True).encode()
    if rec.get("c") != digest_bytes(body):
        return None
    for frec in (result.get("files") or {}).values():
        text = frec.get("text")
        if text is not None and hashlib.sha256(
                text.encode()).hexdigest() != frec.get("sha256"):
            return None
    return result


def lookup(key: str) -> Optional[dict]:
    """The stored result for ``key`` — integrity-verified; a corrupt
    entry is removed, counted
    (``mrtpu_integrity_failures_total{artifact="cas"}``), and reads as
    a miss so the session recomputes."""
    from ..utils.integrity import record_integrity_failure
    path = _memo_path(key)
    if path is None:
        return None
    try:
        with open(path) as f:
            rec = json.load(f)
    except OSError:
        _note("misses")
        return None
    except ValueError:
        rec = None
    result = _verify_record(rec) if rec is not None else None
    if result is None:
        record_integrity_failure("cas")
        _note("corrupt")
        try:
            os.remove(path)
        except OSError:
            pass
        return None
    # staleness re-stat (size+mtime) BEFORE serving the hit: an input
    # that grew since the record was stored (append-only files under a
    # standing query do) must recompute, not serve the old answer.  Not
    # corruption — the entry stays for the key that still matches it
    if manifest_stale(rec.get("manifest")):
        _note("misses")
        return None
    _note("hits")
    return result


def store(key: str, result: dict, writer: str = "",
          payload: Optional[str] = None) -> bool:
    """Persist one DONE result under its key (atomic + stamped).  The
    record keeps the full result — output, files (inline text included)
    and mrs — because a hit must reproduce all of them byte-for-byte.
    ``payload`` (the script text) adds the stat manifest
    (:func:`stat_manifest`) that :func:`lookup` re-checks before
    serving: a grown input reads as a miss."""
    from ..utils.integrity import digest_bytes
    path = _memo_path(key)
    if path is None or result.get("status") != "done":
        return False
    body = json.dumps(result, sort_keys=True).encode()
    rec = {"c": digest_bytes(body), "schema": MEMO_SCHEMA, "key": key,
           "writer": writer,
           "manifest": stat_manifest(payload) if payload else [],
           "utc": time.strftime("%Y-%m-%dT%H:%M:%SZ", time.gmtime()),
           "result": result}
    try:
        os.makedirs(os.path.dirname(path), exist_ok=True)
        tmp = f"{path}.tmp.{os.getpid()}.{threading.get_ident()}"
        with open(tmp, "w") as f:
            json.dump(rec, f)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, path)
    except (OSError, TypeError, ValueError):
        return False
    _note("stores")
    return True


# -- GC (driven by serve/daemon._gc_cache with journaled intents) ----------

def sweep_candidates(ttl_s: float,
                     now: Optional[float] = None) -> List[str]:
    """Memo keys whose entries aged past ``ttl_s`` (by mtime)."""
    d = memo_dir()
    if d is None or ttl_s <= 0:
        return []
    now = time.time() if now is None else now
    out: List[str] = []
    try:
        names = os.listdir(d)
    except OSError:
        return out
    for n in names:
        if not n.endswith(".json") or ".tmp" in n:
            continue
        try:
            if now - os.path.getmtime(os.path.join(d, n)) >= ttl_s:
                out.append(n[:-len(".json")])
        except OSError:
            continue
    return out


def sweep_finish(keys: List[str]) -> int:
    """Second half of a journaled memo sweep — idempotent removal (the
    kill -9 recovery path re-runs it; a missing entry just skips)."""
    removed = 0
    for key in keys:
        path = _memo_path(key)
        if path is None:
            continue
        try:
            os.remove(path)
            removed += 1
        except OSError:
            continue
    return removed


def memo_stats() -> dict:
    entries = 0
    nbytes = 0
    d = memo_dir()
    enabled = 1 if memoize_enabled() else 0
    if d is not None:
        try:
            for n in os.listdir(d):
                if not n.endswith(".json") or ".tmp" in n:
                    continue
                try:
                    nbytes += os.path.getsize(os.path.join(d, n))
                except OSError:
                    continue
                entries += 1
        except OSError:
            pass
    with _LOCK:
        return {"enabled": enabled, "entries": entries, "bytes": nbytes,
                **dict(_COUNTS)}


def reset_counts() -> None:
    """Test isolation."""
    with _LOCK:
        for k in _COUNTS:
            _COUNTS[k] = 0
