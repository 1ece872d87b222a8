"""Environment knobs (the port's copy of ``gpu_mapreduce_tpu/utils/env.py``'s
readers): an unset or empty variable gives the default, a malformed one
gives the default with one line on stderr."""

from __future__ import annotations

import os
import sys
from typing import Callable, TypeVar

T = TypeVar("T")

_TRUE = ("1", "true", "yes", "on")
_FALSE = ("0", "false", "no", "off")


def env_knob(name: str, cast: Callable[[str], T], default: T) -> T:
    """``cast(os.environ[name])``, or ``default``."""
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return cast(raw)
    except (TypeError, ValueError) as e:
        print(f"{name} ignored: {e!r}", file=sys.stderr)
        return default


def env_str(name: str, default: str = "") -> str:
    """The raw string value, or ``default`` when unset or empty."""
    raw = os.environ.get(name)
    return default if raw is None or raw == "" else raw


def env_flag(name: str, default: bool) -> bool:
    """Boolean knob: 1/true/yes/on and 0/false/no/off, case-insensitive."""
    def cast(raw: str) -> bool:
        v = raw.strip().lower()
        if v in _TRUE:
            return True
        if v in _FALSE:
            return False
        raise ValueError(f"not a boolean flag: {raw!r}")
    return env_knob(name, cast, default)
