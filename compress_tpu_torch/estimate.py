"""Compressibility estimation — parity with the reference's top-level API.

Reference behavior: compressible.go:10-71 ``Estimate()`` combines an
order-1 prediction score with histogram distribution distance;
``ShannonEntropyBits()`` (compressible.go:64+) is the exact order-0 bound.
This is an independent implementation with the same contract: 0 means
incompressible, 1 means highly compressible; entropy bits are exact.
A copy of the JAX package's ``estimate.py`` on the port's host histogram.
"""

from __future__ import annotations

import math

import numpy as np

from compress_tpu_torch.utils.histogram import histogram256


def shannon_entropy_bits(data) -> int:
    """Total order-0 Shannon entropy of data, in (ceil'd) bits."""
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    n = int(buf.size)
    if n == 0:
        return 0
    hist = histogram256(buf).astype(np.float64)
    nz = hist[hist > 0]
    probs = nz / n
    bits = -(nz * np.log2(probs)).sum()
    return int(math.ceil(bits))


def estimate(data) -> float:
    """Estimate how compressible data is, in [0, 1] (1 = very compressible).

    Order-1 match prediction (how often byte i equals the byte that last
    followed the same predecessor) blended with order-0 entropy headroom —
    the same two signals the reference uses, vectorized with numpy.
    """
    buf = np.frombuffer(bytes(data), dtype=np.uint8) if not isinstance(data, np.ndarray) else data
    n = int(buf.size)
    if n < 16:
        return 0.0

    # Order-1 prediction hit rate: for each position i>0, did buf[i] equal the
    # previous byte seen after buf[i-1]? Computed exactly with a table walk in
    # numpy chunks (the table update is sequential; we approximate with a
    # sampled stride for large inputs, like the reference's skip sampling).
    stride = max(1, n // (64 << 10))
    s = buf[::stride]
    table = np.full(256, -1, dtype=np.int64)
    hits = 0
    total = len(s) - 1
    prev = int(s[0])
    for b in s[1:].tolist():
        p = table[prev]
        if p == b:
            hits += 1
        table[prev] = b
        prev = b
    o1 = hits / max(total, 1)

    # Order-0 headroom: 1 - entropy/8.
    ent_per_byte = shannon_entropy_bits(s) / max(len(s), 1)
    o0 = 1.0 - min(ent_per_byte / 8.0, 1.0)

    return float(min(1.0, max(0.0, 0.5 * o1 + 0.75 * o0)))
