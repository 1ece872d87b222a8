"""Ranges that the benchmark wraps around functions of the system in a
traced run, where the system has no span of its own.

A wrap names ``module:attribute`` and the range name.  Every wrap opens
a ``record_function`` range, so the profiler charges the range the
device time of the kernels, copies and sets launched in it.  No wrap
synchronises: the traced run's idle share is the system's own."""

from __future__ import annotations

import functools
import importlib
from typing import Callable, List

import torch


def install(wraps: List[dict]) -> Callable[[], None]:
    """Install ``wraps`` (each ``{"target": "pkg.mod:attr", "name":
    str}``); returns the function that removes them."""
    saved = []
    for w in wraps:
        mod_name, attr = w["target"].split(":")
        mod = importlib.import_module(mod_name)
        fn = getattr(mod, attr)
        saved.append((mod, attr, fn))
        setattr(mod, attr, _wrap(fn, w["name"]))

    def remove():
        for mod, attr, fn in reversed(saved):
            setattr(mod, attr, fn)
    return remove


def _wrap(fn, name: str):
    @functools.wraps(fn)
    def wrapper(*args, **kw):
        with torch.profiler.record_function(name):
            return fn(*args, **kw)
    return wrapper
