"""The command-line example drivers of the port (the counterparts of the
JAX package's ``examples/*.py``): ``intcount``, ``invertedindex``,
``rmat``, ``wordfreq`` and ``wordfreq2``.

Each takes its JAX driver's arguments, prints the same lines, and runs as
``python -m gpu_mapreduce_tpu_torch.examples.<name> ARGS``; ``main(argv)``
takes the arguments without the program's name and returns the exit
code.  Every driver runs on the card unless ``-device cpu`` is given
anywhere in its arguments (the OINK command line's convention,
``oink/script.py``); without a card and without ``-device cpu`` it
raises ``MRError``.
"""

from __future__ import annotations

from typing import List, Optional, Tuple


def split_device(argv: List[str]) -> Tuple[Optional[str], List[str]]:
    """``(device, the other arguments)``: the value of a ``-device`` (or
    ``-d``) pair anywhere in ``argv`` (None: the card)."""
    device, rest, i = None, [], 0
    while i < len(argv):
        if argv[i] in ("-device", "-d") and i + 1 < len(argv):
            device = argv[i + 1]
            i += 2
        else:
            rest.append(argv[i])
            i += 1
    return device, rest

