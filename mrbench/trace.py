"""What a traced run reads from ``torch.profiler``'s trace (exported as
Chrome trace JSON and read back, which is far quicker than the
profiler's event tree): the device's busy time (the union of its
kernels', copies' and sets' intervals, a card at a time), device time by
kernel name, device time under each host range (``record_function``:
the benchmark's own and the system's spans; a kernel counts under every
range open on the launching thread when it was launched), and the idle
gaps of the device, each named by the innermost host range open at its
middle."""

from __future__ import annotations

import json
import os
import tempfile
from typing import Dict, List, Tuple

WINDOW = "mrbench.window"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[Tuple[float, float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1] = (out[-1][0], e)
        else:
            out.append((s, e))
    return out


def read_profile(prof) -> List[dict]:
    """The profile's trace events (its Chrome trace, written to a
    temporary file and read back)."""
    fd, path = tempfile.mkstemp(prefix="mrbench-trace-", suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    finally:
        os.remove(path)
    return data["traceEvents"] if isinstance(data, dict) else data


class TraceSummary:
    """``busy_s``, ``window_s``, ``kernels`` {name: [count, device s]},
    ``ranges`` {name: [count, device s, host s]}, ``idle`` {range name:
    idle s}."""

    def __init__(self, events: List[dict], ndevices: int = 1):
        dev, ranges, launch = [], [], {}
        for e in events:
            if e.get("ph") != "X":
                continue
            cat = e.get("cat")
            if cat in DEVICE_CATS:
                dev.append(e)
            elif cat == "user_annotation":
                ranges.append(e)
            elif cat in LAUNCH_CATS:
                c = (e.get("args") or {}).get("correlation")
                if c is not None:
                    launch[c] = e
        win = [r for r in ranges if r["name"] == WINDOW]
        if win:
            w0, w1 = win[0]["ts"], win[0]["ts"] + win[0]["dur"]
        else:
            w0 = min((e["ts"] for e in dev), default=0.0)
            w1 = max((e["ts"] + e["dur"] for e in dev), default=0.0)
        self.window_s = (w1 - w0) / 1e6
        per: Dict[int, list] = {}
        self.kernels: Dict[str, List[float]] = {}
        for e in dev:
            a, b = e["ts"], e["ts"] + e["dur"]
            k = self.kernels.setdefault(e["name"], [0, 0.0])
            k[0] += 1
            k[1] += e["dur"] / 1e6
            if b > w0 and a < w1:
                d = (e.get("args") or {}).get("device", 0)
                per.setdefault(d, []).append((max(a, w0), min(b, w1)))
        unions = {d: _union(iv) for d, iv in per.items()}
        # the mean over the devices used
        self.busy_s = sum(b - a for u in unions.values() for a, b in u) \
            / 1e6 / ndevices
        self.ranges: Dict[str, List[float]] = {}
        for r in ranges:
            k = self.ranges.setdefault(r["name"], [0, 0.0, 0.0])
            k[0] += 1
            k[2] += r["dur"] / 1e6
        self._charge_ranges(dev, ranges, launch)
        busy = unions[min(unions)] if unions else []
        main = max({r["tid"] for r in ranges} or {0},
                   key=lambda t: sum(r["tid"] == t for r in ranges))
        # the first card's gaps (on several cards, the one that sums)
        self.idle = self._idle_by_range(
            busy, [r for r in ranges if r["tid"] == main], w0, w1)

    def _charge_ranges(self, dev, ranges, launch) -> None:
        """Each device event's time to every range (by name, once) open on
        its launching thread at its launch."""
        points = []
        for i, r in enumerate(ranges):
            points.append((r["tid"], r["ts"], 0, i))
            points.append((r["tid"], r["ts"] + r["dur"], 2, i))
        for e in dev:
            c = (e.get("args") or {}).get("correlation")
            lc = launch.get(c)
            if lc is not None:
                points.append((lc["tid"], lc["ts"], 1, e["dur"]))
        points.sort(key=lambda p: (p[0], p[1], p[2]))
        open_: Dict[int, List[int]] = {}
        for tid, _, kind, x in points:
            stack = open_.setdefault(tid, [])
            if kind == 0:
                stack.append(x)
            elif kind == 2:
                if x in stack:
                    stack.remove(x)
            else:
                for name in {ranges[i]["name"] for i in stack}:
                    self.ranges[name][1] += x / 1e6

    @staticmethod
    def _idle_by_range(busy, ranges, w0, w1) -> Dict[str, float]:
        """Each idle gap of the device inside the window, charged to the
        innermost host range open at its middle."""
        gaps, t = [], w0
        for a, b in busy:
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if w1 > t:
            gaps.append((t, w1))
        points = []
        for i, r in enumerate(ranges):
            if r["name"] != WINDOW:
                points.append((r["ts"], 0, i))
                points.append((r["ts"] + r["dur"], 2, i))
        for j, (a, b) in enumerate(gaps):
            points.append(((a + b) / 2, 1, j))
        points.sort()
        stack: List[int] = []
        out: Dict[str, float] = {}
        for _, kind, i in points:
            if kind == 0:
                stack.append(i)
            elif kind == 2:
                if stack and stack[-1] == i:
                    stack.pop()
                elif i in stack:
                    stack.remove(i)
            else:
                name = ranges[stack[-1]]["name"] if stack else "(no range)"
                a, b = gaps[i]
                out[name] = out.get(name, 0.0) + (b - a) / 1e6
        return out

    def range_device_s(self, *names: str) -> Tuple[int, float]:
        """(calls, device seconds) summed over the ranges named."""
        n, s = 0, 0.0
        for name in names:
            c, d, _ = self.ranges.get(name, (0, 0.0, 0.0))
            n += c
            s += d
        return n, s

    def kernel_s(self, part: str) -> Tuple[int, float]:
        """(launches, device seconds) of kernels whose name holds
        ``part``."""
        n, s = 0, 0.0
        for name, (c, d) in self.kernels.items():
            if part in name:
                n += c
                s += d
        return n, s

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.kernels.items(), key=lambda kv: -kv[1][1])[:top]
        gaps = sorted(self.idle.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[k[:120], v[1]] for k, v in ops],
                "idle_gaps": [[k[:120], v] for k, v in gaps]}
