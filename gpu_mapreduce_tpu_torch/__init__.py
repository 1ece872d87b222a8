"""gpu_mapreduce_tpu_torch: the MapReduce system in PyTorch and CUDA.

The port of ``gpu_mapreduce_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA
GPU.  It imports nothing of JAX or of the JAX package.  Entry points run
on the card unless the caller passes ``device="cpu"``; kernels are built
from ``csrc/`` on first use, never at import.
"""

from . import ft                      # ft.schedule, ft.resume, ...
from .apps.intcount import intcount
from .apps.invertedindex import InvertedIndex
from .apps.wordfreq import wordfreq, wordfreq_interned
from .core.mapreduce import MapReduce
from .core.runtime import MRError
from .oink.script import OinkScript

__all__ = ["InvertedIndex", "MapReduce", "MRError", "OinkScript", "ft",
           "intcount", "wordfreq", "wordfreq_interned"]
