"""Sorting for columns of logical numpy dtypes.

``torch.sort`` orders int64 as signed; a u64 column sorts through
``bits.order_key`` so its order is unsigned.  :func:`lexsort` follows
numpy's convention (the LAST key is primary) as a chain of stable sorts.
"""

from __future__ import annotations

from typing import Sequence

import torch


def lexsort(keys: Sequence[torch.Tensor]) -> torch.Tensor:
    """Indices that sort by ``keys[-1]``, then ``keys[-2]``, ...; each key
    already in a native-order form (see ``bits.order_key``; bools sort
    False first).  Ties keep their input order."""
    order = None
    for k in keys:
        k = k if order is None else k[order]
        if k.dtype == torch.bool:
            k = k.to(torch.uint8)
        o = torch.sort(k, stable=True).indices
        order = o if order is None else order[o]
    return order

