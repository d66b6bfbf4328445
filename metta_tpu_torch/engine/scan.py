"""Inclusive prefix sum over the last axis, taken over a leading axis.

The engine's scans run over short axes (token candidates of a block, the 8
neighbours of a station) of very many rows. CUDA's ``cumsum`` over the
innermost axis costs about the same for 3 elements a row as for 25 (0.6 ms
for 98k rows on an H100); moved to the leading axis, the same scan is one
coalesced pass. Integer sums, so the result is the same either way.
"""

from __future__ import annotations

import torch


def cumsum_last(x):
    """``x.cumsum(-1)`` as int64, computed over a leading axis."""
    return x.to(torch.int64).movedim(-1, 0).cumsum(0).movedim(0, -1)
