"""LZ execute over a byte arena (counterpart of the JAX package's
``ops/exec_pallas.py`` ``execute_rounds_pallas``, and of the XLA round
graph ``ops/execute.execute_rounds`` it replaces, which is the same
function over an arena scaled by M).

Arena of block b: LR * 128 literal bytes (LR = lit_rows.shape[1] = 512 *
M), then LR * 128 output bytes, zero at the start.  Round r runs the slots
[sum(caps[:r]), sum(caps[:r+1])) of the round-major plan (clipped to the
plan's rows): slot k of block b copies bytes j < min(len, 128 - (dst &
127)) from arena byte src + j to arena byte dst + j, reading the arena as
it stood at the start of the round.  A source byte a outside the arena
reads row clip(a >> 7, 0, 2 * LR - 1), lane a & 127; a piece whose dst
row lies outside the arena writes nothing.  Returns the output rows
(B, LR, 128) uint8.

The reference sums each round's masked strips into the arena.  Plans
from ``pack_plans`` cover every output byte exactly once and a round-r
piece reads only bytes of earlier rounds, so the sum equals a plain
store: the CUDA kernel stores, with a CTA-wide barrier between rounds;
the plain version keeps the reference's sum.

``execute_rounds`` launches the CUDA kernel (``csrc/exec.cu``) on CUDA
tensors and runs ``execute_rounds_ref`` on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from compress_tpu_torch import _cuda

__all__ = ["execute_rounds", "execute_rounds_ref"]


def _round_bounds(caps, total: int) -> list[int]:
    """Slot bounds of each round, clipped to the plan's ``total`` rows."""
    return [min(int(x), total) for x in np.concatenate([[0], np.cumsum(
        np.asarray(caps, np.int64))])]


def _check_inputs(lit_rows, src, dst, length):
    if lit_rows.dim() != 3 or lit_rows.shape[2] != 128 \
            or lit_rows.shape[1] % 512:
        raise ValueError(f"lit_rows: expected (B, 512 * M, 128), got "
                         f"{tuple(lit_rows.shape)}")
    B = lit_rows.shape[0]
    if src.dim() != 2 or src.shape[1] != B or dst.shape != src.shape \
            or length.shape != src.shape:
        raise ValueError("src, dst, length: expected (total, B) each")
    if any(t.device != lit_rows.device for t in (src, dst, length)):
        raise ValueError("execute_rounds: inputs on different devices")


def execute_rounds_ref(lit_rows: torch.Tensor, src: torch.Tensor,
                       dst: torch.Tensor, length: torch.Tensor,
                       round_caps) -> torch.Tensor:
    """Plain PyTorch execute: per round, every live byte of every piece is
    gathered from the arena as it stood at the round's start, then summed
    into place."""
    _check_inputs(lit_rows, src, dst, length)
    B, LR = lit_rows.shape[0], lit_rows.shape[1]
    dev = lit_rows.device
    if B == 0:
        return torch.empty((0, LR, 128), dtype=torch.uint8, device=dev)
    ab = 2 * LR * 128                                   # arena bytes
    arena = torch.zeros((B, ab), dtype=torch.int32, device=dev)
    arena[:, :LR * 128] = lit_rows.reshape(B, -1).to(torch.int32)
    arena = arena.view(-1)
    bounds = _round_bounds(round_caps, src.shape[0])
    blk = torch.arange(B, device=dev, dtype=torch.int64)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        s = src[lo:hi].to(torch.int64).T.reshape(-1)
        d = dst[lo:hi].to(torch.int64).T.reshape(-1)
        ln = length[lo:hi].to(torch.int64).T.reshape(-1)
        owner = blk.repeat_interleave(hi - lo)
        row = d >> 7
        n = torch.minimum(ln, 128 - (d & 127)).clamp(min=0)
        n = torch.where((row >= 0) & (row < 2 * LR), n, 0)
        piece = torch.repeat_interleave(
            torch.arange(n.numel(), device=dev), n)
        if piece.numel() == 0:
            continue
        start = torch.cumsum(n, 0) - n
        j = torch.arange(piece.numel(), device=dev) - start[piece]
        a = s[piece] + j
        a_row = (a >> 7).clamp(0, 2 * LR - 1)
        base = owner[piece] * ab
        vals = arena[base + a_row * 128 + (a & 127)]
        arena.index_put_((base + d[piece] + j,), vals, accumulate=True)
    out = arena.view(B, 2 * LR, 128)[:, LR:]
    return (out & 255).to(torch.uint8)


def execute_rounds(lit_rows: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor, length: torch.Tensor,
                   round_caps) -> torch.Tensor:
    """Run the planned rounds: lit_rows (B, 512 * M, 128) uint8; src, dst,
    length (total, B) int32, round-major per ``pack_plans``; round_caps
    the per-round slot counts.  Returns (B, 512 * M, 128) uint8 output
    rows."""
    if lit_rows.device.type == "cpu":
        return execute_rounds_ref(lit_rows, src, dst, length, round_caps)
    _check_inputs(lit_rows, src, dst, length)
    B, LR = lit_rows.shape[0], lit_rows.shape[1]
    total = src.shape[0]
    _cuda.require_cuda_input(lit_rows, "lit_rows", torch.uint8, (B, LR, 128))
    for name, t in (("src", src), ("dst", dst), ("length", length)):
        _cuda.require_cuda_input(t, name, torch.int32, (total, B))
    if lit_rows.data_ptr() % 16:
        raise ValueError("lit_rows: expected a 16-byte aligned tensor")
    dev = lit_rows.device
    out = torch.empty((B, LR, 128), dtype=torch.uint8, device=dev)
    if B == 0:
        return out
    bounds = torch.tensor(_round_bounds(round_caps, total), dtype=torch.int32,
                          device=dev)
    # a 128 KiB arena (M = 1) lives in shared memory; larger ones in a
    # global scratch, one per block
    scratch = (torch.empty((B, 2 * LR * 128), dtype=torch.uint8, device=dev)
               if LR > 512 else None)
    with torch.cuda.device(dev):
        rc = _cuda.library().ct_exec_rounds(
            lit_rows.data_ptr(), src.data_ptr(), dst.data_ptr(),
            length.data_ptr(), bounds.data_ptr(), bounds.numel() - 1, B, LR,
            None if scratch is None else scratch.data_ptr(), out.data_ptr(),
            _cuda.stream(dev))
    _cuda.check(rc, "execute_rounds")
    execute_rounds.launches += 1
    return out


execute_rounds.launches = 0
