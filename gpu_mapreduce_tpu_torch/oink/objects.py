"""OINK object manager: named/temporary MapReduce objects + I/O
descriptors.

The counterpart of ``gpu_mapreduce_tpu/oink/objects.py`` on one device:

* named MRs persist across commands; temporaries from :meth:`create_mr`
  die at :meth:`cleanup`;
* an input descriptor (``-i``) is file paths (the command reads them with
  a parser callback) or a named MR, used as it is;
* an output descriptor (``-o``) carries a file path (written by the
  command's printer) and/or a name to register the result MR under;
* ``set`` defaults apply to every MR the manager creates.

Every MR lives on the manager's device (``device=None`` → the card;
``MRError`` when there is none).  One device means one output file at
the exact path, with no ``.0`` suffix, as the JAX package writes at P = 1.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional, Sequence, Union

from ..core.mapreduce import MapReduce
from ..core.runtime import MRError, resolve_device


@dataclass
class InputDescriptor:
    paths: Optional[List[str]] = None     # file/glob mode
    mr_name: Optional[str] = None         # named-MR mode


@dataclass
class OutputDescriptor:
    path: Optional[str] = None            # write file via print callback
    mr_name: Optional[str] = None         # register result as named MR


class ObjectManager:
    """Holds named MRs, temporaries, descriptors, and MR defaults."""

    # the settings `set` may change; the JAX package's others (timer,
    # outofcore, paging, fpath, onfault) are not ported yet
    MR_SETTINGS = ("verbosity", "memsize", "fuse")

    def __init__(self, device=None):
        self.device = resolve_device(device)
        self.named: Dict[str, MapReduce] = {}
        self._temps: List[MapReduce] = []
        self._anon_names: List[str] = []
        self._anon_counter = 0
        self.defaults: Dict[str, object] = {}
        self.inputs: List[InputDescriptor] = []
        self.outputs: List[OutputDescriptor] = []
        # per-slot settings of the `input`/`output` builtins, kept as the
        # JAX package keeps them (only unported chunk maps read them)
        self.input_settings: Dict[int, dict] = {}
        self.output_settings: Dict[int, dict] = {}

    def set_default(self, name: str, value):
        if name not in self.MR_SETTINGS:
            raise MRError(f"set parameter {name!r} is unknown or not "
                          f"ported yet")
        self.defaults[name] = value

    # -- MR lifecycle ------------------------------------------------------
    def create_mr(self) -> MapReduce:
        mr = MapReduce(device=self.device, **self.defaults)
        self._temps.append(mr)
        return mr

    def name_mr(self, name: str, mr: MapReduce):
        self.named[name] = mr
        self._temps = [m for m in self._temps if m is not mr]

    def get_mr(self, name: str) -> MapReduce:
        if name not in self.named:
            raise MRError(f"no MapReduce object named {name!r}")
        return self.named[name]

    def delete_mr(self, name: str):
        mr = self.named.pop(name, None)
        if mr is not None:
            _free(mr)

    def cleanup(self):
        """Free temporaries and drop anonymous input registrations.
        Anonymous MRs are caller-owned: only the registry entry goes."""
        for mr in self._temps:
            _free(mr)
        self._temps = []
        for name in self._anon_names:
            self.named.pop(name, None)
        self._anon_names = []
        self.inputs = []
        self.outputs = []

    # -- descriptors -------------------------------------------------------
    def add_input(self, source: Union[str, "os.PathLike",
                                      Sequence[str], MapReduce]):
        """Add the next -i descriptor: path(s), an MR, or an MR's name."""
        if isinstance(source, os.PathLike):
            source = os.fspath(source)
        if isinstance(source, MapReduce):
            self._anon_counter += 1
            name = f"_anon{self._anon_counter}"
            self.named[name] = source
            self._anon_names.append(name)
            self.inputs.append(InputDescriptor(mr_name=name))
        elif isinstance(source, str) and source in self.named:
            self.inputs.append(InputDescriptor(mr_name=source))
        else:
            paths = [source] if isinstance(source, str) else list(source)
            self.inputs.append(InputDescriptor(paths=paths))

    def add_output(self, path: Optional[str] = None,
                   mr_name: Optional[str] = None):
        self.outputs.append(OutputDescriptor(path=path, mr_name=mr_name))

    # -- the command-facing protocol (reference obj->input/obj->output) ----
    def input(self, index: int, parser: Optional[Callable] = None,
              ptr=None) -> MapReduce:
        """Resolve -i descriptor #index (1-based).  File mode runs
        ``parser(itask, filename, kv, ptr)`` over the paths; MR mode
        returns the named MR as it is."""
        if index > len(self.inputs):
            raise MRError(f"command input {index} not provided")
        d = self.inputs[index - 1]
        if d.mr_name is not None:
            return self.get_mr(d.mr_name)
        if parser is None:
            raise MRError("file input requires a parser callback")
        mr = self.create_mr()
        mr.map_files(d.paths, parser, ptr)
        return mr

    def output(self, index: int, mr: MapReduce,
               printer: Optional[Callable] = None):
        """Handle -o descriptor #index: write ``printer(key, value, fp)``
        lines (``key value`` without one) to its path, register mr under
        its name.  A missing descriptor is a no-op."""
        if index > len(self.outputs):
            return
        d = self.outputs[index - 1]
        if d.path is not None:
            parent = os.path.dirname(d.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            with open(d.path, "w") as fp:
                for k, v in _iter_pairs(mr):
                    if printer is None:
                        fp.write(f"{k} {v}\n")
                    else:
                        printer(k, v, fp)
        if d.mr_name is not None:
            self.name_mr(d.mr_name, mr)


def _free(mr: MapReduce) -> None:
    mr.discard_plan()
    for ds in (mr.kv, mr.kmv):
        if ds is not None:
            ds.free()


def _iter_pairs(mr: MapReduce):
    """(key, value) per KV pair, or (key, [values]) per KMV group when
    the MR holds a KMV (neighbor's adjacency lists)."""
    if mr.kv is not None:
        for fr in mr.kv.frames():
            yield from fr.pairs()
    elif mr.kmv is not None:
        for fr in mr.kmv.frames():
            yield from fr.groups()
