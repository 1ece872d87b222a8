#!/usr/bin/env python3
"""Where the PyTorch/CUDA port's composed graph engines spend their time,
on one GPU.

    python3 scripts/profile_torch_composed.py [--scale 22] [--tri-scale 18]

Builds the smoke's R-MAT graph (``chip_smoke.graph_script``'s parameters:
rmat, edge_upper, add_weight) through ``OinkScript`` on the card, then for
each composed engine (cc_find, luby_find and sssp at ``--scale``,
tri_find on its own graph at ``--tri-scale``):

* runs the command once with every ``MapReduce`` op timed between device
  synchronises: seconds and calls by op (map_mr, collate, reduce,
  compress, add, ...), and the command's seconds and peak memory;
* runs it again under ``torch.profiler``: the wall time, the device-busy
  time (union of the kernels' intervals), the idle share, the number of
  kernel launches and the top operators by device time.

Prints one JSON line per engine, with the card's name and power limit.
Needs a CUDA device; imports nothing of JAX.
"""

import argparse
import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

OPS = ("map", "map_mr", "aggregate", "collate", "convert", "clone",
       "reduce", "compress", "add", "open", "close")
LINES = {"cc_find": "cc_find 0 -i mru -o NULL mrcc",
         "luby_find": "luby_find 6789 -i mru -o NULL mrlc",
         "sssp": "sssp 2 12345 -i mre -o NULL mrsc",
         "tri_find": "tri_find -i mru -o NULL mrtc"}


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def busy_ms(events) -> float:
    """Length of the union of the device kernels' [start, end) intervals."""
    spans = sorted((e.time_range.start, e.time_range.end) for e in events)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


@contextlib.contextmanager
def op_times(sync):
    """{op: [calls, seconds]} of the MapReduce ops called in the block,
    each between two ``sync()`` (an op nested in another counts in
    both)."""
    from gpu_mapreduce_tpu_torch.core.mapreduce import MapReduce
    acc = {}
    saved = {name: getattr(MapReduce, name) for name in OPS}

    def timed(fn, name):
        def wrapper(*args, **kw):
            sync()
            t0 = time.perf_counter()
            out = fn(*args, **kw)
            sync()
            rec = acc.setdefault(name, [0, 0.0])
            rec[0] += 1
            rec[1] += time.perf_counter() - t0
            return out
        return wrapper

    for name, fn in saved.items():
        setattr(MapReduce, name, timed(fn, name))
    try:
        yield acc
    finally:
        for name, fn in saved.items():
            setattr(MapReduce, name, fn)


def profile_engine(script, name: str, smi: str) -> dict:
    """One composed command, timed by op, then under torch.profiler."""
    import torch
    from chip_smoke import engine
    line = LINES[name]

    def run():
        script.screen = buf = io.StringIO()
        with engine(name, "composed"):
            script.one(line)
        torch.cuda.synchronize()
        script.obj.named.pop(line.split()[-1]).kv.free()
        return buf.getvalue().splitlines()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    with op_times(torch.cuda.synchronize) as ops:
        t0 = time.perf_counter()
        msg = run()
        seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        run()
        wall = (time.perf_counter() - t0) * 1e3
    kern = [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA]
    busy = busy_ms(kern)

    def dev_us(r):
        return getattr(r, "self_device_time_total",
                       getattr(r, "self_cuda_time_total", 0))

    rows = sorted(prof.key_averages(), key=lambda r: -dev_us(r))
    top = [{"name": r.key[:80], "count": r.count,
            "device_ms": dev_us(r) / 1e3} for r in rows[:15] if dev_us(r)]
    return {"engine": name, "card": smi, "line": line, "message": msg,
            "seconds": seconds, "peak_bytes": peak,
            "op_s": {k: {"calls": c, "s": s} for k, (c, s) in
                     sorted(ops.items(), key=lambda kv: -kv[1][1])},
            "profiled_wall_ms": wall, "device_busy_ms": busy,
            "idle_share": (1 - busy / wall) if wall else None,
            "kernel_launches": len(kern), "top": top}


def graph(scale: int, device="cuda"):
    """The smoke's graph at ``scale`` in a fresh OinkScript on
    ``device``."""
    import chip_smoke
    from gpu_mapreduce_tpu_torch import OinkScript
    script = OinkScript(device=device, screen=False, logfile=None)
    for line in chip_smoke.composed_script(scale)[:3]:
        script.one(line)
    return script


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scale", type=int, default=22)
    ap.add_argument("--tri-scale", type=int, default=18)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_composed: no CUDA device", file=sys.stderr)
        return 2
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    tmp = tempfile.mkdtemp(prefix="profile_torch_composed_")
    cwd = os.getcwd()
    os.chdir(tmp)
    try:
        script = graph(args.scale)
        for name in ("cc_find", "luby_find", "sssp"):
            emit({"scale": args.scale,
                  **profile_engine(script, name, smi)})
        del script
        torch.cuda.empty_cache()
        emit({"scale": args.tri_scale,
              **profile_engine(graph(args.tri_scale), "tri_find", smi)})
    finally:
        os.chdir(cwd)
        shutil.rmtree(tmp, ignore_errors=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
