"""Where the benchmark finds what it runs: ``BENCHMARK.json`` at the
root of the checkout, ``configs/<name>.json``, ``workloads/<cell>.json``
and ``metrics/<name>.py``, each by the name ``BENCHMARK.json`` gives it.
A new configuration, cell or per-layer metric is a new file here and a
new entry there; nothing else changes."""

from __future__ import annotations

import importlib
import importlib.util
import json
import os
from typing import List

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def benchmark() -> dict:
    with open(os.path.join(ROOT, "BENCHMARK.json")) as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    with open(os.path.join(HERE, kind, name + ".json")) as f:
        return json.load(f)


def config(name: str) -> dict:
    return _json("configs", name)


def workload(name: str) -> dict:
    return _json("workloads", name)


def cell(bench: dict, name: str) -> dict:
    for w in bench["workloads"]:
        if w["name"] == name:
            return w
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def _applies(metric: dict, cell_name: str) -> bool:
    return "workloads" not in metric or cell_name in metric["workloads"]


def end_to_end(bench: dict, cell_name: str) -> List[dict]:
    """The end-to-end metrics a cell reports."""
    return [m for m in bench["end_to_end"] if _applies(m, cell_name)]


def per_layer(bench: dict, cell_name: str) -> List[dict]:
    """The per-layer metrics a cell reports: those that list it, and
    those without a list whose end-to-end metric the cell reports."""
    e2e = {m["name"] for m in end_to_end(bench, cell_name)}
    return [m for m in bench["per_layer"]
            if cell_name in m.get("workloads", ())
            or ("workloads" not in m and m["moves"] in e2e)]


def metric_module(name: str):
    """``metrics/<name>.py``, loaded from its file (a metric's name may
    hold characters a module name may not)."""
    path = os.path.join(HERE, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "mrbench.metrics._" + name.replace(".", "_").replace("-", "_"), path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def module(package: str, name: str):
    """``mrbench.<package>.<name>``: a driver or a judge."""
    return importlib.import_module(f"mrbench.{package}.{name}")
