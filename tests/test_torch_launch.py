"""The port's launcher (``python -m gpu_mapreduce_tpu_torch.launch``) end
to end on the CPU (``--device cpu``, gloo): the goldens of the JAX
package's ``scripts/mrlaunch.py`` (``tests/test_dist.py``).

* ``--np 2``: the output equals the serial answer byte for byte;
* peer_kill: four ranks, rank 2 SIGKILLed at its second exchange; the
  survivors see it within lease + skew, the launcher fences it, shrinks
  to 2 and resumes from the last checkpoint; the output equals an
  uninterrupted ``--np 2`` run's byte for byte;
* peer_hang: rank 1 sleeps at its third count sync while its heartbeat
  goes on; rank 0's watchdog trips on the sync deadline, the launcher
  kills the hung rank and finishes at width 1."""

import json
import os
import subprocess
import sys
import time

import pytest

from test_dist import _expected_output, _write_corpus

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _launch(nproc, rundir, corpus, out, chunks=4, env=None, grace=None,
            timeout=120):
    e = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1")
    e.pop("MRTPU_FAULTS", None)
    e.update(env or {})
    args = [sys.executable, "-m", "gpu_mapreduce_tpu_torch.launch",
            "--np", str(nproc), "--rundir", rundir, "--device", "cpu"]
    if grace is not None:
        args += ["--grace", str(grace)]
    r = subprocess.run(args + ["wordfreq", "--files", corpus, "--out", out,
                               "--chunks", str(chunks)],
                       env=e, cwd=ROOT, capture_output=True, timeout=timeout)
    assert r.returncode == 0, \
        f"launch rc={r.returncode}\n{r.stdout.decode()[-2000:]}" \
        f"\n{r.stderr.decode()[-2000:]}"
    summary = json.loads(
        r.stdout.decode().split("mrlaunch: ", 1)[1].splitlines()[0])
    with open(os.path.join(rundir, "launch.json")) as f:
        assert json.load(f) == summary
    with open(out, "rb") as f:
        return f.read(), summary


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    """An uninterrupted --np 2 run: (corpus, output, summary, rundir)."""
    d = tmp_path_factory.mktemp("np2")
    corpus = _write_corpus(str(d / "c.txt"))
    out, summary = _launch(2, str(d / "run"), corpus, str(d / "out.txt"),
                           chunks=6)
    return corpus, out, summary, d / "run"


def test_two_ranks_match_serial(two_ranks):
    corpus, got, summary, run = two_ranks
    assert got == _expected_output([corpus])
    assert summary["generations"] == 1 and summary["final_width"] == 2
    assert summary["history"] == [] and summary["recover_seconds"] is None
    with open(run / "g0-rank1.log", "rb") as f:
        assert b"device cpu, backend gloo, transport gloo" in f.read()


def test_peer_kill_shrinks_and_matches(two_ranks, tmp_path):
    corpus, want, _, _ = two_ranks
    t0 = time.monotonic()
    got, summary = _launch(4, str(tmp_path / "run"), corpus,
                           str(tmp_path / "out.txt"), chunks=6, env={
                               "MRTPU_FAULTS": "site=dist.exchange;"
                               "kind=peer_kill;rank=2;after=1;n=1",
                               "MRTPU_DIST_SYNC_TIMEOUT": "20"})
    assert got == want == _expected_output([corpus])
    assert summary["final_width"] == 2 and summary["generations"] == 2
    assert summary["history"][0]["dead"] == [2]
    assert summary["history"][0]["codes"]["2"] == -9
    assert summary["recover_seconds"] is not None
    assert summary["recover_seconds"] < 60.0
    assert time.monotonic() - t0 < 100.0
    # the dead rank of generation 0 is fenced; generation 1's is not
    hb = tmp_path / "run" / "hb-g0"
    assert (hb / "rank2.fence.json").exists()
    assert not (tmp_path / "run" / "hb-g1" / "rank0.fence.json").exists()


def test_peer_hang_trips_the_watchdog(tmp_path):
    corpus = _write_corpus(str(tmp_path / "c.txt"))
    t0 = time.monotonic()
    got, summary = _launch(2, str(tmp_path / "run"), corpus,
                           str(tmp_path / "out.txt"), chunks=6, grace=1,
                           env={"MRTPU_FAULTS": "site=dist.count_sync;"
                                "kind=peer_hang;rank=1;after=2;n=1",
                                "MRTPU_DIST_SYNC_TIMEOUT": "4"})
    wall = time.monotonic() - t0
    assert got == _expected_output([corpus])
    assert summary["generations"] == 2 and summary["final_width"] == 1
    assert summary["history"][0]["dead"] == [1]
    # generation 1 (one rank) may finish before the launcher looks for
    # its lease: its clean exit counts as having beaten
    assert summary["recover_seconds"] is not None
    assert summary["recover_seconds"] < 30.0
    with open(tmp_path / "run" / "hb-g0" / "rank0.exit.json") as f:
        report = json.load(f)
    assert report["code"] == "peer_lost" and report["site"] == "count_sync"
    assert wall < 100.0, "the hang was not bounded by the watchdog"
