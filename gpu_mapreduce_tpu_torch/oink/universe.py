"""Multi-world (``-partition``) runs: the OINK Universe (the port's copy
of ``gpu_mapreduce_tpu/oink/universe.py``).

Reference: ``oink/universe.{h,cpp}`` (``NxM`` / ``P`` world specs,
``add_world`` ``universe.cpp:55-88``, ``consistent`` ``:94-99``) and
``oink/oink.cpp:46-57,138-236`` (the -partition switch, the per-world
communicators, the per-world ``screen.N`` and log files, the universe
banner).

The reference's procs are MPI ranks; here they are the shards of a mesh
driven by one process.  ``-partition`` splits the mesh's device list into
consecutive sub-meshes (world i owns shards ``[root_proc[i],
root_proc[i] + procs_per_world[i])``, ``make_mesh(devices=...)``) and
runs one interpreter a world, each in its own thread, as the reference's
worlds are concurrent MPI jobs.  On one card every world's shards share
the card and its default stream: correct, and serialised there.  ULOOP
work sharing goes through a shared, locked counter
(``variables.UloopCounter``).

What the worlds share in the process is locked: the exchange's plan
cache, the fused plan cache, the kernel loader, the cumulative counters
and the ft/ counters.  Intern tables belong to their frames, so a world
only ever decodes its own ids.  ``shell cd`` changes the process's
directory for every world, as in the reference's shared file system.

Per-world files follow the reference: the default screen is
``screen.N`` (oink.cpp:170-174), ``-screen base`` is ``base.N``, ``-log
base`` is ``base.N``, and the default log is ``log.oink.N`` (the JAX
package's name for the reference's ``log.lammps.N``).
"""

from __future__ import annotations

import sys
import threading
from typing import List, Optional, Sequence

from ..core.runtime import MRError
from .variables import UloopCounter, WorldContext


class Universe:
    """World layout over ``nprocs`` procs (reference Universe class)."""

    def __init__(self, nprocs: int):
        self.nprocs = nprocs
        self.procs_per_world: List[int] = []
        self.root_proc: List[int] = []

    @property
    def nworlds(self) -> int:
        return len(self.procs_per_world)

    def add_world(self, spec: Optional[str]):
        """None → 1 world of all procs; ``NxM`` → N worlds of M procs;
        ``P`` → 1 world of P procs (universe.cpp:55-88)."""
        if spec is None:
            n, nper = 1, self.nprocs
        elif "x" in spec:
            a, b = spec.split("x", 1)
            n, nper = int(a), int(b)
        else:
            n, nper = 1, int(spec)
        for _ in range(n):
            root = 0 if not self.root_proc else \
                self.root_proc[-1] + self.procs_per_world[-1]
            self.procs_per_world.append(nper)
            self.root_proc.append(root)

    def consistent(self) -> bool:
        return sum(self.procs_per_world) == self.nprocs


def _world_comm(comm, universe: Universe, iworld: int):
    """World ``iworld``'s sub-mesh of consecutive shards (the
    MPI_Comm_split of oink.cpp:165)."""
    if comm is None:
        return None
    from ..parallel.mesh import make_mesh
    lo = universe.root_proc[iworld]
    hi = lo + universe.procs_per_world[iworld]
    return make_mesh(devices=list(comm.devices)[lo:hi])


def _world_filename(base: Optional[str], default: str, iworld: int
                    ) -> Optional[str]:
    """``none`` → no file; an explicit base → base.N; unset → default.N
    (oink.cpp:168-202)."""
    if base == "none":
        return None
    return f"{base or default}.{iworld}"


def run_universe(infile: str, partition_specs: Sequence[str], comm=None,
                 logname: Optional[str] = None,
                 screenname: Optional[str] = None,
                 echo: Optional[str] = None,
                 varsets: Sequence = (), uscreen=None,
                 device=None) -> Universe:
    """Run ``infile`` once a world, the worlds concurrently.

    ``comm``: the mesh to split (None → 1 proc on ``device``, the card
    unless ``"cpu"``).  ``logname``/``screenname``: the CLI's -log and
    -screen values (``"none"`` → off).  ``varsets``: ``[(name,
    [values...])]`` from -var switches.  ``uscreen``: the universe's
    stream (None → stdout, False → silent)."""
    from .script import OinkScript

    nprocs = 1 if comm is None else comm.size
    universe = Universe(nprocs)
    for spec in partition_specs:
        universe.add_world(spec)
    if not universe.procs_per_world:
        universe.add_world(None)
    if not universe.consistent():
        raise MRError("Processor partitions are inconsistent")

    if uscreen is None:
        uscreen = sys.stdout
    ulock = threading.Lock()

    def uemit(text: str):
        if uscreen is not False and uscreen is not None:
            with ulock:
                uscreen.write(text)
                uscreen.flush()

    uemit(f"Running on {universe.nworlds} partitions of processors\n")

    counter = UloopCounter(universe.nworlds)

    def on_advance(nextindex: int, iworld: int):
        # the reference's universe-level progress line
        # (variable.cpp:367-374 prints nextindex + 1)
        uemit(f"Increment via next: value {nextindex + 1} on partition "
              f"{iworld}\n")

    errors: List[tuple] = []

    def run_world(iworld: int):
        # everything inside the try: a failed screen or log open must
        # reach `errors`, never the thread's default excepthook
        screen: object = False
        interp = None
        try:
            world = WorldContext(iworld, universe.nworlds, counter,
                                 on_advance)
            wcomm = _world_comm(comm, universe, iworld)
            screenfile = _world_filename(screenname, "screen", iworld)
            logfile = _world_filename(logname, "log.oink", iworld)
            screen = open(screenfile, "w") if screenfile else False
            interp = OinkScript(device=device, comm=wcomm, screen=screen,
                                logfile=logfile, world=world)
            interp._emit(f"Processor partition = {iworld}\n")
            if echo:
                interp.cmd_echo([echo])
            for name, vals in varsets:
                interp.variables.set([name, "index"] + list(vals))
            interp.run_file(infile)
        except BaseException as e:  # reported after the join
            errors.append((iworld, e))
        finally:
            if interp is not None:
                interp.close()
            if screen:
                screen.close()

    threads = [threading.Thread(target=run_world, args=(i,),
                                name=f"oink-world-{i}")
               for i in range(universe.nworlds)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        errors.sort(key=lambda t: t[0])
        detail = "; ".join(f"world {i}: {e}" for i, e in errors)
        raise MRError(f"{len(errors)} world(s) failed: {detail}") \
            from errors[0][1]
    return universe
