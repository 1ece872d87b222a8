"""Bounded background prefetch over an iterator, and the follow-mode
poll of an append-only file (the port's copy of
``gpu_mapreduce_tpu/exec/prefetch.py``'s ``prefetch_iter`` and
``tail_chunks``).

A daemon thread pulls items from the source up to ``depth`` ahead of the
consumer, so chunk N+1 is read while chunk N's callback runs.  Order is
the source order (one FIFO queue); a producer exception re-raises in the
consumer; a consumer that leaves early stops the producer.  Busy and wait
seconds go to ``exec.note_overlap``.  The producer runs under the
consumer's request context (``obs/context.py``) inside one
``exec.prefetch`` span a stream, and the stream reports
``mrtpu_prefetch_depth{path}`` (items banked ahead of the consumer) and
``mrtpu_prefetch_wait_seconds_total{path}`` (the consumer's time blocked
on the producer).
"""

from __future__ import annotations

import os
import queue
import threading
import time
from typing import Iterable, Iterator, List, Optional, Tuple

_END = "end"
_ITEM = "item"
_ERR = "err"


def _prefetch_metrics(path: str):
    """(depth setter, wait adder) of one stream's metrics; no-ops when
    the registry is unavailable."""
    try:
        from ..obs.metrics import get_registry
        reg = get_registry()
        depth = reg.gauge(
            "mrtpu_prefetch_depth",
            "items the prefetch producer holds ahead of the consumer",
            ("path",))
        wait = reg.counter(
            "mrtpu_prefetch_wait_seconds_total",
            "seconds the consumer spent blocked on the prefetch "
            "producer (ingest-bound time)", ("path",))
        return (lambda n: depth.set(n, path=path),
                lambda s: wait.inc(s, path=path))
    except Exception:
        return (lambda n: None), (lambda s: None)


def prefetch_iter(src: Iterable, depth: Optional[int] = None,
                  path: str = "ingest") -> Iterator:
    """Iterate ``src`` through a producer thread with a look-ahead of
    ``depth`` items (default ``MRTPU_PREFETCH``); ``depth <= 0`` yields
    from ``src`` directly, with no thread."""
    if depth is None:
        from . import prefetch_depth
        depth = prefetch_depth()
    if depth <= 0:
        yield from src
        return

    q: queue.Queue = queue.Queue(maxsize=depth)
    stop = threading.Event()
    state = {"busy": 0.0, "items": 0}
    set_depth, add_wait = _prefetch_metrics(path)
    # the producer runs the consumer's request: its span and counters
    # charge that request
    from ..obs import context as _obs_ctx
    req_ctx = _obs_ctx.capture()

    def _put(msg) -> None:
        # a bounded put that gives up once the consumer is gone
        while not stop.is_set():
            try:
                q.put(msg, timeout=0.1)
                return
            except queue.Full:
                continue

    def producer() -> None:
        err = None
        try:
            from ..obs import get_tracer
            it = iter(src)
            with _obs_ctx.use(req_ctx), \
                    get_tracer().span("exec.prefetch", cat="exec",
                                      path=path, depth=depth) as sp:
                while not stop.is_set():
                    t0 = time.perf_counter()
                    try:
                        item = next(it)
                    except StopIteration:
                        break
                    except BaseException as e:
                        err = e
                        break
                    state["busy"] += time.perf_counter() - t0
                    state["items"] += 1
                    set_depth(q.qsize() + 1)
                    _put((_ITEM, item))
                sp.set(items=state["items"],
                       busy_s=round(state["busy"], 6),
                       error=type(err).__name__ if err is not None
                       else "")
        except BaseException as e:
            err = err or e
        finally:
            _put((_ERR, err) if err is not None else (_END, None))

    t = threading.Thread(target=producer, daemon=True,
                         name=f"mrtpu-prefetch-{path}")
    t.start()
    wait = 0.0
    try:
        while True:
            t0 = time.perf_counter()
            kind, payload = q.get()
            wait += time.perf_counter() - t0
            set_depth(q.qsize())
            if kind == _END:
                break
            if kind == _ERR:
                raise payload
            yield payload
    finally:
        stop.set()
        try:                 # unblock a producer stuck on a full queue
            while True:
                q.get_nowait()
        except queue.Empty:
            pass
        t.join(timeout=10.0)
        set_depth(0)
        add_wait(wait)
        from . import note_overlap
        note_overlap(path, busy_s=state["busy"], wait_s=wait,
                     items=state["items"])


def tail_chunks(path: str, offset: int = 0,
                max_bytes: Optional[int] = None,
                final: bool = False) -> Tuple[List[bytes], int]:
    """One follow-mode poll of an append-only file: the bytes ``path``
    grew past ``offset``, newline-aligned, as ``(chunks, new_offset)``.

    Only whole lines are taken: a torn tail (a writer caught mid-line)
    stays pending until its newline lands, so a record never splits
    across two micro-batches; ``final=True`` takes the unterminated tail
    too.  ``max_bytes`` bounds one poll.  A missing file has nothing
    pending; a file shorter than ``offset`` (not append-only) raises
    ``OSError``."""
    try:
        size = os.path.getsize(path)
    except OSError:
        return [], offset
    if size < offset:
        raise OSError(f"{path!r} shrank below cursor {offset} "
                      f"(size {size}): tailed sources must be "
                      f"append-only")
    if size == offset:
        return [], offset
    want = size - offset
    if max_bytes is not None:
        want = min(want, max_bytes)
    with open(path, "rb") as f:
        f.seek(offset)
        buf = f.read(want)
    if not buf:
        return [], offset
    cut = len(buf)
    if not final:
        nl = buf.rfind(b"\n")
        if nl < 0:
            return [], offset           # a torn line: wait for its \n
        cut = nl + 1
    return [buf[:cut]], offset + cut
