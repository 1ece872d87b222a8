"""OINK: the script layer and graph commands on top of the MapReduce
object (the counterpart of ``gpu_mapreduce_tpu/oink``)."""

from . import commands  # noqa: F401,E402  (registers the ported commands)
