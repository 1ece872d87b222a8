"""``collate_ms`` of the InvertedIndex cells, which moves ``peak_GB``: that
cell's job time drifts with the host, so it is read per layer
(``job_s.index``) and ``peak_GB`` is its end-to-end metric besides
``setup_s``."""

from mrbench import spec

_base = spec.metric_module("collate_ms")
LAYER = _base.LAYER
UNIT = _base.UNIT
MOVES = "peak_GB"
read = _base.read
