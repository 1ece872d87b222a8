"""Bounded background prefetch over an iterator (the port's copy of
``gpu_mapreduce_tpu/exec/prefetch.py``'s ``prefetch_iter``).

A daemon thread pulls items from the source up to ``depth`` ahead of the
consumer, so chunk N+1 is read while chunk N's callback runs.  Order is
the source order (one FIFO queue); a producer exception re-raises in the
consumer; a consumer that leaves early stops the producer.  Busy and wait
seconds go to ``exec.note_overlap``.
"""

from __future__ import annotations

import queue
import threading
import time
from typing import Iterable, Iterator, Optional

_END = "end"
_ITEM = "item"
_ERR = "err"


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
            it = iter(src)
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
                _put((_ITEM, item))
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
        from . import note_overlap
        note_overlap(path, busy_s=state["busy"], wait_s=wait,
                     items=state["items"])
