"""The per-layer metrics that read the port's own spans, on planted trace
events of the shape the profiler writes (the CPU has no device events):
each reads its value where the spans are, and None where they are not,
as on a system without them; and a traced four-card run on the CPU
carries the spans into the trace the readers see."""

import pytest

from mrbench import run, spec, trace

CPU_SEED = 2 ** 31 + 101


def ev(name, cat, ts, dur, tid=1, **args):
    return {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur,
            "tid": tid, "args": args}


def rng(name, ts, dur):
    return ev(name, "user_annotation", ts, dur)


def busy(ts, dur, corr=None):
    """A kernel on the first card (launched by ``corr``'s launch, if
    given)."""
    args = {"device": 0}
    if corr is not None:
        args["correlation"] = corr
    return ev("k", "kernel", ts, dur, **args)


def launch(ts, corr):
    return ev("cudaLaunchKernel", "cuda_runtime", ts, 2, correlation=corr)


WINDOW = rng("mrbench.window", 0, 1000)
# staging: gaps 100-200 (under graph.unique) and 250-400 (graph.rank)
STAGING = [WINDOW, rng("graph.stage", 100, 300), rng("graph.unique", 100, 100),
           rng("graph.rank", 250, 150), busy(0, 100), busy(200, 50),
           busy(400, 600)]
# two steps in a loop: gaps 100-150 (step), 160-240 (its sum), 300-310
# (the benchmark's wrap of the step), 320-360 (the read), 380-400 (the
# loop's glue); 20-40 lies outside the loop and is not counted
STEPS = [WINDOW, rng("pagerank.loop", 50, 900),
         rng("mrbench.pagerank_step", 90, 220),
         rng("pagerank.step", 100, 200), rng("mesh.allreduce", 150, 100),
         rng("pagerank.delta", 320, 30), rng("pagerank.step", 400, 200),
         busy(0, 20), busy(40, 60), busy(150, 10), busy(240, 60),
         busy(310, 10), busy(360, 20), busy(400, 600)]
# two rounds, 100 and 300 µs of device time launched in them
ROUNDS = [WINDOW, rng("cc.round", 0, 500), rng("cc.round", 500, 500),
          launch(10, 1), busy(20, 100, 1), launch(510, 2),
          busy(520, 300, 2)]
# two packs, 0.25 and 0.35 s of host time
PACKS = [rng("mrbench.window", 0, 2e6), rng("stage.pack", 0, 250000),
         rng("stage.pack", 1e6, 350000)]
NOTHING = [WINDOW, rng("mrbench.job", 0, 1000), busy(0, 100)]

CASES = {"stage_idle_ms": (STAGING, 1, 0.25),
         "pagerank_gap_ms": (STEPS, 1, 0.1),
         "cc_round_ms": (ROUNDS, 1, 0.2),
         "pack_s": (PACKS, 2, 0.3)}


def _ctx(events, jobs):
    ctx = run.Context()
    ctx.trace = trace.TraceSummary(events, ndevices=1)
    ctx.jobs = jobs
    return ctx


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_reads_the_ports_spans(name):
    events, jobs, want = CASES[name]
    assert spec.metric_module(name).read(_ctx(events, jobs)) \
        == pytest.approx(want)


@pytest.mark.parametrize("name", sorted(CASES))
def test_reader_reads_none_without_the_spans(name):
    mod = spec.metric_module(name)
    assert mod.read(_ctx(NOTHING, 1)) is None
    assert mod.read(run.Context()) is None


def test_traced_run_carries_the_ports_spans(monkeypatch):
    """The four-card cell at a tiny size on the CPU, traced: the port's
    staging, step, read and sum spans are ranges in the run's trace."""
    made = []
    init = trace.TraceSummary.__init__

    def keep(self, *a, **k):
        init(self, *a, **k)
        made.append(self)
    monkeypatch.setattr(trace.TraceSummary, "__init__", keep)
    import torch
    r = run.run_cell("rmat26-pagerank-p4", CPU_SEED, 0.3, True,
                     devices=[torch.device("cpu")] * 4,
                     config_override={"scale": 10})
    assert r["correct"]
    ranges = made[0].ranges
    for name in ("graph.stage", "graph.unique", "graph.merge", "graph.rank",
                 "pagerank.loop", "pagerank.step", "pagerank.delta",
                 "mesh.allreduce"):
        assert ranges[name][0] > 0, name
    assert ranges["graph.unique"][0] == 4 * ranges["graph.stage"][0]
    assert ranges["pagerank.step"][0] == ranges["pagerank.delta"][0]
