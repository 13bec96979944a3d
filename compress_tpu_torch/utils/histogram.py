"""256-bin byte histograms (counterpart of the JAX package's
``utils/histogram.py``): ``histogram256`` on the host and
``histogram256_torch`` on a tensor's own device.

The reference counts on the device with one-hot compares summed per
segment; here the count is a scatter-add of ones into LANES rows of 257
bins (position p counts in row p % LANES, so neighbouring bytes add into
different rows instead of contending for one counter), the last bin
taking every value outside 0..255 (the reference counts none of them),
and the rows are summed.  One PyTorch call, ``torch.bincount``, computes
the same function for uint8 input; ``chip_smoke.py`` times it beside this
one.
"""

from __future__ import annotations

import numpy as np
import torch

LANES = 1024  # rows of counters of histogram256_torch


def histogram256(data) -> np.ndarray:
    """Host path: counts of each byte value, shape (256,), int64."""
    buf = (data if isinstance(data, np.ndarray)
           else np.frombuffer(bytes(data), dtype=np.uint8))
    return np.bincount(buf.reshape(-1), minlength=256).astype(np.int64)


def histogram256_torch(x: torch.Tensor, segment: int = 1 << 14):
    """(256,) int32 counts of the values 0..255 of ``x`` (any shape and
    integer dtype, flattened), on ``x``'s device.  ``segment`` is the
    reference's tile length (a positive integer); the counts do not
    depend on it."""
    if segment <= 0:
        raise ValueError(f"segment must be positive, got {segment}")
    v = x.reshape(-1).to(torch.int64)
    lane = torch.arange(v.numel(), device=x.device) % LANES
    idx = lane * 257 + torch.where((v >= 0) & (v < 256), v, 256)
    hist = torch.zeros(LANES * 257, dtype=torch.int64, device=x.device)
    hist.scatter_add_(0, idx, torch.ones(1, dtype=torch.int64,
                                         device=x.device).expand_as(idx))
    return hist.view(LANES, 257)[:, :256].sum(dim=0).to(torch.int32)
