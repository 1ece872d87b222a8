"""gpu_mapreduce_tpu_torch: the MapReduce system in PyTorch and CUDA.

The port of ``gpu_mapreduce_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
GPU.  It imports nothing of JAX or of the JAX package.  Entry points run
on the card unless the caller passes ``device="cpu"``; kernels are built
from ``csrc/`` on first use, never at import.  The names below are
imported at first use.
"""

import importlib

# each public name and the module that holds it, imported at first use:
# the operator tools (``ctl``, ``serve.client``, ``obs.trace_view``) then
# start without torch
_EXPORTS = {
    "InvertedIndex": ".apps.invertedindex",
    "MapReduce": ".core.mapreduce",
    "MRError": ".core.errors",
    "OinkScript": ".oink.script",
    "Stream": ".stream",
    "intcount": ".apps.intcount",
    "wordfreq": ".apps.wordfreq",
    "wordfreq_interned": ".apps.wordfreq",
}

__all__ = ["InvertedIndex", "MapReduce", "MRError", "OinkScript", "Stream", "ft",
           "intcount", "wordfreq", "wordfreq_interned"]


def __getattr__(name):
    if name == "ft":
        return importlib.import_module(".ft", __name__)
    if name in _EXPORTS:
        value = getattr(importlib.import_module(_EXPORTS[name], __name__),
                        name)
        globals()[name] = value
        return value
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
