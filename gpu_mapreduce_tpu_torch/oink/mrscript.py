"""Named-MR method lines: ``<MRname> <method> args...`` in a script.

The counterpart of ``gpu_mapreduce_tpu/oink/mrscript.py`` (reference
``oink/mrmpi.cpp:37-349``): a method table over the ``MapReduce`` ops,
with callbacks named through the registries of :mod:`.kernels`
(``oink/mrmpi.cpp:354-466``): delete, copy, add, aggregate, broadcast,
clone, close, collapse, collate, compress, convert, gather, map/task,
map/file, map/mr, open, print, reduce, save, load, scan_kv and scan_kmv
(which print the dataset, as the reference's script does), scrunch,
sort_keys, sort_values, sort_multivalues, stats and set.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np

from ..core.runtime import MRError
from . import kernels
from .objects import ObjectManager


def expand_path_variable(variables, arg: str) -> Optional[List[str]]:
    """``v_name`` → one path per value of the variable, or None when arg
    is not a known path variable (the shared ``v_`` idiom of ``-i``
    descriptors and map/file, reference object.cpp:450-462)."""
    if variables is None or not arg.startswith("v_"):
        return None
    vname = arg[2:]
    if variables.find(vname) is None:
        return None
    if variables.equal_style(vname):
        raise MRError("Command input is equal-style variable")
    n = variables.retrieve_count(vname)
    return [variables.retrieve_single(vname, i) for i in range(n)]


def _collapse_key(type_: str, value: str):
    """The typed key of ``collapse``/``scrunch`` lines."""
    if type_ == "int":
        return np.int64(value)
    if type_ == "uint64":
        return np.uint64(value)
    if type_ == "double":
        return np.float64(value)
    if type_ == "str":
        return value.encode()
    raise MRError("Illegal MR object collapse command")


class MRScriptDispatch:
    """Runs one ``<MRname> <method> args`` line against the
    ObjectManager."""

    def __init__(self, obj: ObjectManager, variables=None):
        self.obj = obj
        self.variables = variables

    def run(self, name: str, args: List[str]) -> None:
        if not args:
            raise MRError("Illegal MapReduce object command")
        mr = self.obj.get_mr(name)
        method, rest = args[0], args[1:]
        fn = getattr(self, "m_" + method.replace("/", "_"), None)
        if fn is None:
            raise MRError(f"Unknown MR object method {method!r}")
        fn(name, mr, rest)

    # -- lifecycle ---------------------------------------------------------
    def m_delete(self, name, mr, a):
        if a:
            raise MRError("Illegal MR object delete command")
        self.obj.delete_mr(name)

    def m_copy(self, name, mr, a):
        if len(a) != 1:
            raise MRError("Illegal MR object copy command")
        if a[0] in self.obj.named:
            raise MRError("MR object created by copy already exists")
        self.obj.name_mr(a[0], mr.copy())

    def m_add(self, name, mr, a):
        if len(a) != 1:
            raise MRError("Illegal MR object add command")
        mr.add(self.obj.get_mr(a[0]))

    # -- shuffle / grouping ------------------------------------------------
    def _hash(self, arg: str):
        return None if arg == "NULL" else \
            kernels.lookup(kernels.HASH_KERNELS, arg, "hash")

    def m_broadcast(self, name, mr, a):
        if len(a) != 1:
            raise MRError("Illegal MR object broadcast command")
        mr.broadcast(int(a[0]))

    def m_clone(self, name, mr, a):
        mr.clone()

    def m_collapse(self, name, mr, a):
        if len(a) != 2:
            raise MRError("Illegal MR object collapse command")
        mr.collapse(_collapse_key(a[0], a[1]))

    def m_scrunch(self, name, mr, a):
        if len(a) != 3:
            raise MRError("Illegal MR object scrunch command")
        mr.scrunch(int(a[0]), _collapse_key(a[1], a[2]))

    def m_open(self, name, mr, a):
        mr.open(addflag=1 if a else 0)

    def m_close(self, name, mr, a):
        mr.close()

    def m_aggregate(self, name, mr, a):
        if len(a) != 1:
            raise MRError("Illegal MR object aggregate command")
        mr.aggregate(self._hash(a[0]))

    def m_collate(self, name, mr, a):
        if len(a) != 1:
            raise MRError("Illegal MR object collate command")
        mr.collate(self._hash(a[0]))

    def m_convert(self, name, mr, a):
        mr.convert()

    def m_gather(self, name, mr, a):
        if len(a) != 1:
            raise MRError("Illegal MR object gather command")
        mr.gather(int(a[0]))

    # -- maps (reference mrmpi.cpp:116-260) --------------------------------
    def m_map_task(self, name, mr, a):
        if len(a) not in (2, 3):
            raise MRError("Illegal MR object map/task command")
        raise MRError("map/task requires a registered task kernel; none "
                      "are defined (the reference's style_map.h has no "
                      "nmap-style entries either beyond rmat_generate, "
                      "which is the rmat command here)")

    def m_map_file(self, name, mr, a):
        if len(a) not in (2, 3):
            raise MRError("Illegal MR object map/file command")
        fn = kernels.lookup(kernels.MAP_FILE_KERNELS, a[1], "map/file")
        paths = expand_path_variable(self.variables, a[0]) or [a[0]]
        mr.map_files(paths, fn, addflag=1 if len(a) == 3 else 0)

    def m_map_mr(self, name, mr, a):
        if len(a) not in (2, 3):
            raise MRError("Illegal MR object map/mr command")
        src = self.obj.get_mr(a[0])
        fn = kernels.lookup(kernels.MAP_MR_KERNELS, a[1], "map/mr")
        mr.map_mr(src, fn, addflag=1 if len(a) == 3 else 0, batch=True)

    # -- reduce ------------------------------------------------------------
    def m_reduce(self, name, mr, a):
        if len(a) != 1:
            raise MRError("Illegal MR object reduce command")
        mr.reduce(kernels.lookup(kernels.REDUCE_KERNELS, a[0], "reduce"),
                  batch=True)

    def m_scan_kv(self, name, mr, a):
        mr.print()

    def m_scan_kmv(self, name, mr, a):
        mr.print()

    def m_save(self, name, mr, a):
        """save <dir> — checkpoint the dataset (core/checkpoint.py)."""
        if len(a) != 1:
            raise MRError("Illegal MR object save command")
        mr.save(a[0])

    def m_load(self, name, mr, a):
        """load <dir> — restore a checkpointed dataset."""
        if len(a) != 1:
            raise MRError("Illegal MR object load command")
        mr.load(a[0])

    def m_print(self, name, mr, a):
        """print [proc nstride kflag vflag] (reference mrmpi.cpp print;
        one process here, so proc is accepted and ignored)."""
        if len(a) not in (0, 4):
            raise MRError("Illegal MR object print command")
        if a:
            mr.print(nstride=int(a[1]), kflag=int(a[2]), vflag=int(a[3]))
        else:
            mr.print()

    def m_compress(self, name, mr, a):
        if len(a) != 1:
            raise MRError("Illegal MR object compress command")
        mr.compress(kernels.lookup(kernels.REDUCE_KERNELS, a[0], "reduce"),
                    batch=True)

    # -- sorts -------------------------------------------------------------
    def m_sort_keys(self, name, mr, a):
        if len(a) != 1:
            raise MRError("Illegal MR object sort_keys command")
        mr.sort_keys(int(a[0]))

    def m_sort_values(self, name, mr, a):
        if len(a) != 1:
            raise MRError("Illegal MR object sort_values command")
        mr.sort_values(int(a[0]))

    def m_sort_multivalues(self, name, mr, a):
        if len(a) != 1:
            raise MRError("Illegal MR object sort_multivalues command")
        mr.sort_multivalues(int(a[0]))

    # -- stats / settings --------------------------------------------------
    def m_stats(self, name, mr, a):
        level = int(a[0]) if a else 1
        if mr.kv is not None:
            mr.kv_stats(level)
        if mr.kmv is not None:
            mr.kmv_stats(level)

    def m_set(self, name, mr, a):
        if len(a) != 2:
            raise MRError("Illegal MR object set command")
        key = a[0]
        mr.set(**{key: a[1] if key in ("fpath", "onfault") else int(a[1])})
