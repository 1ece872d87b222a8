"""Run one cell of the benchmark once.

    python3 -m mrbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up makes the cell's inputs from the seed, builds the system's objects
and runs one job to warm every shape.  Then one client runs jobs back to
back until ``--seconds`` have passed, each ending in a device
synchronise (a closed loop, MR-MPI's batch model).  Once the window has
closed the peak memory is read, the system's state is freed, and a
plain reference judges a sample of the window's outputs, drawn from the
seed, and the counts every job reported.  The last line printed is one
JSON object: ``correct``, ``attempted``, ``failed``, ``metrics``,
``device``, with ``--trace 1`` also ``breakdown``, and last ``checks``,
each number compared beside its limit (also the last lines of standard
error).  With ``--trace 0`` the metrics are the cell's end-to-end ones;
with ``--trace 1`` the window runs under ``torch.profiler`` and the
metrics are its per-layer ones.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from typing import Dict, List, Optional  # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from mrbench import spec  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "gpu_mapreduce_tpu")
CACHE = os.path.join(spec.ROOT, ".mrbench_cache")


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    tops = {name.split(".")[0] for name in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def fix_cache_dirs() -> None:
    """Every kernel cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"


class Context:
    """What the metric readers see (``metrics/<name>.py``)."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.job_times: List[float] = []
        self.jobs = 0
        self.counters: Dict[str, List[float]] = {}
        self.sizes: Dict[str, float] = {}
        self.peak_bytes = 0
        self.trace = None
        self.kind = ""
        self.ndevices = 1


def _sync(devices) -> None:
    import torch
    for d in devices:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def _peak(devices, reset: bool = False) -> int:
    import torch
    cuda = [d for d in devices if d.type == "cuda"]
    peak = max((torch.cuda.max_memory_allocated(d) for d in cuda), default=0)
    if reset:
        for d in cuda:
            torch.cuda.reset_peak_memory_stats(d)
    return peak


def run_cell(name: str, seed: int, seconds: float, trace: bool, *,
             t0: Optional[float] = None, devices=None,
             config_override: Optional[dict] = None,
             control: bool = False, err=None) -> dict:
    """One run of cell ``name``; returns the result object.  ``devices``
    (a list of torch devices) skips the look for cards; ``control`` puts
    the reference at the lower precision in the system's place for the
    comparison (the run's readings are then the control's)."""
    import torch
    err = err or sys.stderr
    t0 = time.perf_counter() if t0 is None else t0
    bench = spec.benchmark()
    c = spec.cell(bench, name)
    cfg = {**spec.config(c["config"]), **(config_override or {})}
    wl = spec.workload(name)
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(c["chips"])]
    env = wl.get("env", {})
    saved = {k: os.environ.get(k) for k in env}
    os.environ.update({k: str(v) for k, v in env.items()})
    try:
        return _run(name, seed, seconds, trace, t0, devices, bench, cfg, wl,
                    control, err)
    finally:
        for k, v in saved.items():
            if v is None:
                os.environ.pop(k, None)
            else:
                os.environ[k] = v


def _run(name, seed, seconds, trace, t0, devices, bench, cfg, wl, control,
         err) -> dict:
    import torch
    driver = spec.module("drivers", wl["driver"])
    judge = spec.module("judges", wl["judge"])

    ctx = Context()
    ctx.ndevices = len(devices)
    t1 = time.perf_counter()
    state = driver.setup(cfg, wl, seed, devices)
    ctx.sizes = state["sizes"]
    t2 = time.perf_counter()
    out, _ = driver.job(state)               # warm every shape
    driver.drop(state, out)
    _sync(devices)
    ctx.setup_s = time.perf_counter() - t0
    setup_parts = {"before_inputs": t1 - t0, "inputs": t2 - t1,
                   "warm_job": ctx.setup_s - (t2 - t0)}
    setup_peak = _peak(devices, reset=True)

    metrics = spec.end_to_end(bench, name) if not trace \
        else spec.per_layer(bench, name)
    readers = {m["name"]: spec.metric_module(m["name"]) for m in metrics}
    remove, prof = None, None
    if trace:
        from gpu_mapreduce_tpu_torch.obs import get_tracer
        from mrbench import hooks
        get_tracer().enable()
        wraps = list({w["target"]: w for r in readers.values()
                      for w in getattr(r, "WRAPS", ())}.values())
        remove = hooks.install(wraps)
        acts = [torch.profiler.ProfilerActivity.CPU]
        if any(d.type == "cuda" for d in devices):
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        prof = torch.profiler.profile(activities=acts)
        prof.__enter__()

    rng = random.Random(seed * 1000003 + 7)
    kept: Dict[int, object] = {}
    sample = None
    raised = 0
    jobs: List[Optional[dict]] = []
    window = torch.profiler.record_function("mrbench.window")
    window.__enter__()
    w0 = time.perf_counter()
    while time.perf_counter() - w0 < seconds:
        i = len(jobs)
        t = time.perf_counter()
        try:
            with torch.profiler.record_function("mrbench.job"):
                out, counts = driver.job(state)
            _sync(devices)
        except Exception:
            raised += 1
            jobs.append(None)
            ctx.job_times.append(time.perf_counter() - t)
            traceback.print_exc(limit=4, file=err)
            continue
        ctx.job_times.append(time.perf_counter() - t)
        jobs.append(counts)
        kept[i] = out
        # one job drawn from the seed (reservoir) and the last one
        if rng.randrange(i + 1) == 0:
            sample = i
        for j in [j for j in kept if j not in (sample, i)]:
            driver.drop(state, kept.pop(j))
    ctx.window_s = time.perf_counter() - w0
    window.__exit__(None, None, None)
    if trace:
        prof.__exit__(None, None, None)
        remove()
        get_tracer().disable()
        from mrbench.trace import TraceSummary, read_profile
        ctx.trace = TraceSummary(read_profile(prof), len(devices))
        del prof
    ctx.peak_bytes = _peak(devices)
    memory_peak = max(setup_peak, ctx.peak_bytes)
    ctx.jobs = len(jobs) - raised
    for counts in jobs:
        for k, v in (counts or {}).items():
            ctx.counters.setdefault(k, []).append(v)
    ctx.kind = torch.cuda.get_device_name(devices[0]) \
        if devices[0].type == "cuda" else str(devices[0])

    found = forbidden_modules()
    if found:
        raise SystemExit(f"mrbench: loaded after the window: {found}")

    outputs = driver.collect(state, {i: kept[i] for i in sorted(kept)})
    inputs = driver.release(state)
    del kept, state
    ref = judge.reference(inputs, cfg, wl, devices[0])
    got = judge.control(inputs, cfg, wl, devices[0], ref) if control \
        else {"outputs": outputs, "jobs": jobs}
    checks, wrong = judge.compare(got, ref, wl)
    if hasattr(driver, "cleanup"):
        driver.cleanup(inputs)
    failed = raised + (0 if control else len(wrong))
    correct = bool(jobs) and failed == 0 and all(
        v <= lim for v, lim in checks.values())

    values = {}
    for m in metrics:
        v = readers[m["name"]].read(ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    result = {"correct": correct, "attempted": len(jobs), "failed": failed,
              "metrics": values,
              "device": {"platform": "gpu" if devices[0].type == "cuda"
                         else devices[0].type, "kind": ctx.kind,
                         "count": len(devices),
                         "memory_peak_bytes": memory_peak}}
    if trace:
        result["device"]["busy_s"] = ctx.trace.busy_s
        result["device"]["window_s"] = ctx.trace.window_s
        result["breakdown"] = ctx.trace.breakdown()
    result["job_times"] = ctx.job_times
    result["setup_parts"] = setup_parts
    result["sizes"] = {**ctx.sizes, **{k: v[-1] for k, v in
                                       ctx.counters.items() if v}}
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="mrbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    fix_cache_dirs()
    import torch
    need = spec.cell(spec.benchmark(), a.workload)["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"mrbench: {a.workload} needs {need} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    result = run_cell(a.workload, a.seed, a.seconds, bool(a.trace),
                      t0=T_START)
    times = sorted(result.pop("job_times"))
    print(f"mrbench: sizes {json.dumps(result.pop('sizes'))}, set-up s "
          f"{json.dumps(result.pop('setup_parts'))}", file=sys.stderr)
    if times:
        print(f"mrbench: {len(times)} jobs, seconds min {times[0]!r} "
              f"median {times[len(times) // 2]!r} max {times[-1]!r}",
              file=sys.stderr)
    for k, c in result["checks"].items():
        print(f"check {k} = {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stderr.flush()
    sys.stdout.write(json.dumps(result) + "\n")
    sys.stdout.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
