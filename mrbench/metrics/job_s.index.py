"""``job_s`` of the InvertedIndex cells, read per layer: those jobs are
paced by the host (the read of the files and the copies before the
card), and their runs drift with the host's speed from run to run by
more than half of the widest bound an end-to-end metric may have.  It
moves the cell's end-to-end ``peak_GB``."""

from mrbench import spec

_job = spec.metric_module("job_s")
LAYER = "Entry (oink/script.OinkScript.one, apps/invertedindex.InvertedIndex.run)"
UNIT = _job.UNIT
MOVES = "peak_GB"
read = _job.read
