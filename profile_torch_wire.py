#!/usr/bin/env python3
"""The exchange as the JAX package runs it by default, alone on the card.

    python3 profile_torch_wire.py [--rounds 1] [--profile]

Runs chip_smoke's ``wire`` phase (``chip_smoke.run_wire``) without the
rest of the smoke: the kernels built from the checkout, the IntCount
keys (2^25 u32 each, uniform and zipf, seed 7), then ``--rounds`` times
wire-p4-uniform and -zipf (the eager exchange with the codec on and
off; the fused group under it by ``chip_smoke.run_mesh_fuse`` on four
shards of card 0), mesh2-2x2, dist-local-2x2 and the card-vs-CPU check,
with the smoke's gates.  With four cards or more
every cell places one shard a card.  Prints the phase's JSON lines,
then the card's name and power limit.  Exits nonzero without a card.

With ``--profile`` it instead traces, under ``torch.profiler``, one warm
hash exchange and one range exchange (``reshard_kv`` 4 → 2) of the
uniform cell's rows with the codec on and off, and prints one JSON line
each: wall ms, and for each card its busy ms (the union of its kernels'
spans) and idle share over the exchange, and the ten ops that take the
most device time.  A card busy longer than the wall clock is a fault of
the measurement and stops the script.
"""

import argparse
import json
import os
import shutil
import sys
import tempfile

ROOT = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, ROOT)


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("profile_torch_wire: no CUDA device is available",
              file=sys.stderr)
        return 2
    ap = argparse.ArgumentParser()
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--profile", action="store_true")
    args = ap.parse_args()

    import chip_smoke as cs
    from gpu_mapreduce_tpu_torch.ops import cuda as kcuda
    from gpu_mapreduce_tpu_torch.ops.cuda import group, match
    kernels = [match.mark_words, group.segment_table, match.mark]
    smi = cs.nvidia_smi()
    built = kcuda.build_all()
    cs.emit({"phase": "build", "seconds": built["seconds"]})
    tmp = tempfile.mkdtemp(prefix="profile_wire_")
    try:
        int_keys = cs.intcount_files(tmp)[1]
        if args.profile:
            profile(cs, int_keys["uniform"], smi)
        for r in range(args.rounds if not args.profile else 0):
            fuse = {cell: cs.run_mesh_fuse(cell, keys, tmp, kernels, smi)
                    for cell, keys in int_keys.items()}
            rec = cs.run_wire(int_keys, tmp, kernels, smi,
                              {"wire_plans": "not run (the text phase)"},
                              fuse)
            cs.emit({"round": r, **{k: rec[k] for k in (
                "phase", "card", "p", "cards", "devices", "check",
                "launches", "seconds")}})
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True}), flush=True)
    return 0


def profile(cs, keys_u32, smi: str) -> None:
    """The exchanges of ``--profile`` under torch.profiler, each after
    two untraced warm-up calls."""
    import time

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile as tprofile
    from gpu_mapreduce_tpu_torch.parallel.mesh import make_mesh
    from gpu_mapreduce_tpu_torch.parallel.reshard import reshard_kv
    from gpu_mapreduce_tpu_torch.parallel.shuffle import exchange
    count = torch.cuda.device_count()
    devices = [torch.device("cuda", i) for i in range(4)] if count >= 4 \
        else cs.mesh_devices()
    mesh = make_mesh(4, devices=devices)
    frame = cs.wire_frame(keys_u32, mesh)
    narrow = make_mesh(2, devices=devices[:2])
    calls = {"hash": lambda: exchange(frame, ("hash", None)),
             "range": lambda: reshard_kv(frame, narrow)}
    for name, fn in calls.items():
        for wire in ("1", "0"):
            with cs.wire_env(wire):
                for _ in range(2):
                    fn()
                cs.sync_all()
                with tprofile(activities=[ProfilerActivity.CPU,
                                          ProfilerActivity.CUDA]) as prof:
                    t0 = time.perf_counter()
                    fn()
                    cs.sync_all()
                    wall = (time.perf_counter() - t0) * 1e3
            # the kernels themselves (an aten op's row repeats their time)
            kern = sorted((e for e in prof.key_averages()
                           if e.device_type == DeviceType.CUDA),
                          key=lambda e: -e.self_device_time_total)
            busy = busy_ms(prof)
            if not busy:
                raise RuntimeError(f"profile {name} wire={wire}: the "
                                   "trace holds no device time")
            for dev, ms in busy.items():
                if ms > wall:
                    raise RuntimeError(
                        f"profile {name} wire={wire}: card {dev} busy "
                        f"{ms:.3f} ms in a {wall:.3f} ms wall clock")
            cs.emit({"profile": name, "wire": wire, "card": smi,
                     "devices": [str(d) for d in devices],
                     "wall_ms": wall, "busy_ms": busy,
                     "idle_share": {d: 1 - ms / wall
                                    for d, ms in busy.items()},
                     "top": [{"op": e.key[:60],
                              "ms": e.self_device_time_total / 1e3,
                              "calls": e.count} for e in kern[:10]]})


def busy_ms(prof) -> dict:
    """Each card's busy ms in a trace: the union of its kernels' spans,
    so kernels that overlap on one card count once."""
    from torch.autograd import DeviceType
    spans: dict = {}
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            spans.setdefault(e.device_index, []).append(
                (e.time_range.start, e.time_range.end))
    out = {}
    for dev, iv in sorted(spans.items()):
        iv.sort()
        total, (lo, hi) = 0, iv[0]
        for a, b in iv[1:]:
            if a > hi:
                total, lo, hi = total + hi - lo, a, b
            else:
                hi = max(hi, b)
        out[f"cuda:{dev}"] = (total + hi - lo) / 1e3
    return out


if __name__ == "__main__":
    sys.exit(main())
