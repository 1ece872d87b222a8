"""Plan IR: the deferred-op record a pipeline compiles from.

A :class:`PlanStage` is one deferred MapReduce op call: op name,
positional/keyword args (callbacks included) and the settings snapshot
taken at record time (replay runs under the settings the user had when
they issued the call).  A :class:`Plan` is the ordered stage chain plus a
structural fingerprint, the first component of the plan-cache key.
Fusibility is not decided here: the fuser classifies stages against the
live dataset when the plan runs.
"""

from __future__ import annotations

import copy
from dataclasses import dataclass, field
from typing import Optional, Tuple

import numpy as np
import torch


@dataclass
class PlanStage:
    op: str                      # MapReduce method name (aggregate, ...)
    args: tuple = ()
    kw: dict = field(default_factory=dict)
    settings: object = None      # Settings snapshot at record time
    result: Optional[int] = None  # pair/group count, set at execution

    def signature(self) -> tuple:
        """Hashable structural identity: op name plus the identity of any
        callback/flag arguments (callbacks hash by function object)."""
        def _sig(x):
            if callable(x):
                return ("fn", x)
            if isinstance(x, (int, float, str, bytes, bool, type(None))):
                return x
            return ("repr", repr(x))
        return (self.op,
                tuple(_sig(a) for a in self.args),
                tuple(sorted((k, _sig(v)) for k, v in self.kw.items())))

    def describe(self) -> str:
        parts = [repr(a) if not callable(a)
                 else getattr(a, "__name__", repr(a)) for a in self.args]
        parts += [f"{k}={getattr(v, '__name__', None) or v!r}"
                  for k, v in self.kw.items()]
        return f"{self.op}({', '.join(parts)})"


class Plan:
    """One recorded stage chain, in issue order."""

    def __init__(self, stages: Tuple[PlanStage, ...]):
        self.stages = tuple(stages)

    def fingerprint(self) -> tuple:
        return tuple(s.signature() for s in self.stages)

    def describe(self) -> list:
        return [s.describe() for s in self.stages]

    def __repr__(self):
        return f"Plan([{', '.join(self.describe())}])"


def snapshot_settings(settings):
    return copy.deepcopy(settings)


def frame_signature(frame) -> tuple:
    """Shape/dtype identity of the dataset the plan will run over, the
    second component of the plan-cache key: for each column its padded
    shape and its logical dtype (``bytes``/``object`` for a host text
    column, its row count as its shape).  A mesh frame keys on its
    shards' padded blocks stacked (the JAX frame's global shape)."""
    from ..core.column import BytesColumn, ObjectColumn
    sig = [type(frame).__name__]
    shards = getattr(frame, "shards", None)
    if shards is not None:
        for name in ("key", "value"):
            t = getattr(shards[0], name)
            sig.append((name, (len(shards) * t.shape[0],)
                        + tuple(t.shape[1:]),
                        str(getattr(frame, f"{name}_dtype"))))
        return tuple(sig)
    for name in ("key", "value"):
        col = getattr(frame, name, None)
        if col is None:
            continue
        if isinstance(col, (BytesColumn, ObjectColumn)):
            kind = "bytes" if isinstance(col, BytesColumn) else "object"
            sig.append((name, (len(col),), kind))
            continue
        data = col if isinstance(col, torch.Tensor) else np.asarray(col.data)
        dtype = getattr(frame, f"{name}_dtype", data.dtype)
        sig.append((name, tuple(data.shape), str(dtype)))
    return tuple(sig)
