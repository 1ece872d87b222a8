"""Command base class + registry.

The counterpart of ``gpu_mapreduce_tpu/oink/command.py``: a decorator
registry stands in for the reference's generated ``style_command.h``.  A
command declares ``ninputs``/``noutputs`` and implements ``params(args)``
+ ``run()``, talking to data through ``self.obj`` (the ObjectManager).
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Type

from ..core.runtime import MRError
from .objects import ObjectManager

COMMANDS: Dict[str, Type["Command"]] = {}


def command(name: str):
    """Register a Command subclass (the CommandStyle macro)."""
    def deco(cls):
        cls.name = name
        COMMANDS[name] = cls
        return cls
    return deco


def select_engine(engine: Optional[str], env: str, name: str) -> str:
    """The engine a graph command runs: its ``engine`` attribute, else
    the environment variable ``env``, else ``fused``.  ``fused`` runs the
    device model (``models/``), ``composed`` the reference's MapReduce
    composition over the device bodies of ``parallel/devkernels.py``."""
    engine = engine or os.environ.get(env, "fused")
    if engine not in ("fused", "composed"):
        raise MRError(f"{name}: unknown engine {engine!r} "
                      f"(use 'fused' or 'composed')")
    return engine


class Command:
    name: str = ""
    ninputs = 0
    noutputs = 0

    def __init__(self, obj: ObjectManager, screen=None):
        self.obj = obj     # its MRs live on obj's device or mesh
        self.screen = screen  # None → print to stdout, False → silent
        self.result_msg = ""  # the last message, as the JAX package keeps it

    def params(self, args: List[str]):
        if args:
            raise MRError(f"Illegal {self.name} command")

    def run(self):
        raise NotImplementedError

    def message(self, msg: str):
        """Result message (reference error->message on rank 0)."""
        self.result_msg = msg
        if self.screen is None:
            print(msg)
        elif self.screen is not False:
            self.screen.write(msg + "\n")


def run_command(name: str, args: List[str] = (), obj: ObjectManager = None,
                inputs=(), outputs=(), screen=None) -> Command:
    """Programmatic command invocation.  ``inputs``: path-or-MR per -i
    slot; ``outputs``: (path, mr_name) tuples per -o slot."""
    if name not in COMMANDS:
        raise MRError(f"unknown command {name!r}")
    if obj is None:
        obj = ObjectManager()
    cmd = COMMANDS[name](obj, screen=screen)
    cmd.params(list(args))
    for src in inputs:
        obj.add_input(src)
    for out in outputs:
        if isinstance(out, tuple):
            obj.add_output(*out)
        else:
            obj.add_output(path=out)
    try:
        cmd.run()
    finally:
        obj.cleanup()  # a failed run must not leak descriptors/temps
    return cmd
