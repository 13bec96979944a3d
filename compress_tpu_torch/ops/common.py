"""Shared integer primitives of the port (counterpart of the JAX package's
``ops/common.py``).

On the TPU, stable compaction and tile routing run as one-hot matmuls on
the matrix unit.  Here they are what they compute: an exclusive prefix sum
and an integer scatter.  No value goes through a float matmul, which on
the card may run in TF32 and drop low bits.
"""

from __future__ import annotations

import torch


def wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values reduced to int32 two's-complement range (what int32
    arithmetic that overflows gives in the reference), still int64."""
    return torch.remainder(x + (1 << 31), 1 << 32) - (1 << 31)


def mul32(a: torch.Tensor, c: int) -> torch.Tensor:
    """(a * c) mod 2^32 in [0, 2^32) as int64, for any int64 ``a`` and
    int ``c``, without overflowing int64 (16-bit halves of ``a``)."""
    a = torch.remainder(a, 1 << 32)
    c = c % (1 << 32)
    lo = a & 0xFFFF
    hi = a >> 16
    return torch.remainder(lo * c + torch.remainder(hi * c, 1 << 16) * 65536,
                           1 << 32)


def floor_log2(v: torch.Tensor) -> torch.Tensor:
    """Exact floor(log2(v)) for every integer v >= 1 (bit length - 1).

    The reference computes it through float32 ``log2`` and is exact only up
    to 2^20: at 2097150, 2097151, 4194302 and 4194303 it returns one more.
    This one is exact in integer arithmetic everywhere."""
    x = v.to(torch.int64)
    out = torch.zeros_like(x)
    for s in (32, 16, 8, 4, 2, 1):
        big = x >= (1 << s)
        out = out + torch.where(big, s, 0)
        x = torch.where(big, x >> s, x)
    return out.to(v.dtype if v.dtype != torch.bool else torch.int32)


def exclusive_cumsum(x: torch.Tensor, dim: int = -1) -> torch.Tensor:
    c = torch.cumsum(x, dim=dim)
    return c - x


def compact(valid: torch.Tensor, arrays):
    """Stable compaction along the last axis of (B, N) tensors: the k-th
    valid entry of a row lands at column k, every other column is 0.
    Returns (alive, arrays) with alive marking columns < the row's count
    (the reference's ``compact_route`` / ``compact_logshift`` contract)."""
    B, N = valid.shape
    v = valid.to(torch.int64)
    rank = exclusive_cumsum(v, 1)
    counts = v.sum(dim=1)
    dest = torch.where(valid, rank, N)             # invalid -> spill column
    out = []
    for a in arrays:
        buf = torch.zeros((B, N + 1), dtype=a.dtype, device=a.device)
        buf.scatter_(1, dest, torch.where(valid, a, torch.zeros_like(a)))
        out.append(buf[:, :N])
    alive = torch.arange(N, device=valid.device)[None, :] < counts[:, None]
    return alive, out


def route_tiles(dests: torch.Tensor, planes, out_width: int,
                accumulate_shifts: int = 0):
    """Sum-route ``planes`` values to per-row slots (the reference's
    one-hot routing, as an integer scatter-add).

    dests: (N, P) slot index per item, all in [0, out_width); planes: list
    of (N, P) integer values.  Returns (N, K, out_width) sums, or with
    ``accumulate_shifts`` the (N, out_width) sum of plane j rolled j slots
    right (wrapping, as ``jnp.roll`` does)."""
    n = dests.shape[0]
    d = dests.to(torch.int64)
    outs = []
    for j, p in enumerate(planes):
        buf = torch.zeros((n, out_width), dtype=torch.int64, device=d.device)
        dj = torch.remainder(d + j, out_width) if accumulate_shifts else d
        buf.scatter_add_(1, dj, p.to(torch.int64))
        outs.append(buf)
    if accumulate_shifts:
        return sum(outs[1:], outs[0])
    return torch.stack(outs, dim=1)
