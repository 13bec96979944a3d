"""LZ execute over a byte arena (counterpart of the JAX package's
``ops/exec_pallas.py`` ``execute_rounds_pallas``, and of the XLA round
graph ``ops/execute.execute_rounds`` it replaces, which is the same
function over an arena scaled by M).

Arena of block b: LR * 128 literal bytes (LR = lit_rows.shape[1] = 512 *
M), then LR * 128 output bytes, zero at the start.  A piece (src, dst,
len) of round r copies bytes j < min(len, 128 - (dst & 127)) from arena
byte src + j to arena byte dst + j, reading the arena as it stood at the
start of the round.  A source byte a outside the arena reads row
clip(a >> 7, 0, 2 * LR - 1), lane a & 127; a piece whose dst row lies
outside the arena writes nothing.  The result is the output rows
(B, LR, 128) uint8.

Two plan layouts:

- the **compact plan** (``execute.pack_pieces``), which the decode paths
  send to the card: pieces (P, 2) int32, word 0 the
  source byte and word 1 ``dst | (n - 1) << 24`` (n in 1..128), block-major
  and each block's pieces sorted by round; rstart (B, nr + 1) int32.
  Round r of block b runs pieces [lo, hi), lo = clip(rstart[b, r], 0, P),
  hi = clip(rstart[b, r + 1], lo, P); a piece writes only where its dst
  lies in the output half.  ``execute_pieces`` runs it;
- the reference's **padded plan** (``execute.pack_plans``): (total, B)
  slot tensors, round r the slots [sum(caps[:r]), sum(caps[:r+1]))
  clipped to the plan's rows, pad slots of length 0.  ``execute_rounds``
  runs it.

The reference sums each round's masked strips into the arena.  Plans
from the planner write every output byte at most once, nothing of the
literal half, and a round-r piece reads only bytes of earlier rounds, so
the sum equals a plain store: the store kernel (``csrc/exec.cu``,
``ct_exec_pieces``) stores, with a CTA-wide barrier between rounds.  The
plain versions keep the reference's sum.

``execute_pieces`` takes only such plans (the decode paths' planner makes
no other) and launches the store kernel on CUDA tensors.

``execute_rounds``, on no path of the decoders, takes every padded plan
the reference takes: on CUDA tensors it compacts the plan on the card
and launches the sum kernel (``ct_exec_sum``: an int32 arena in device
memory, each round's bytes gathered before any lands).  On CPU tensors
both run their plain versions.

``execute_blocks_hist`` runs the blocks of multi-block frames in order,
each with the frame's history (the function of the reference's XLA scan
``ops/execute.py`` ``execute_blocks_hist``): lit_rows (B, K, 512, 128),
frame b's block k in [b, k]; the compact plan of
``execute.pack_pieces_mb``, whose step (b, k) has a group of history
pieces and then a group per round.  A history piece (src = HIST_BASE + x)
reads byte x' of the last hist_rows * 128 output bytes of the frame
before the step, x' = row x >> 7 clipped to [0, hist_rows), lane x & 127;
bytes before the frame's start read 0.  Every step's whole output half
(zeros past the plan's end) counts as output, so the history equals the
reference's carried tensor, shifted by a step's 512 rows after every step
of a frame's plan.  The plain version sums as the reference does; the
kernel (``ct_exec_hist``: a thread-block cluster a frame, the step's
output half in the cluster's distributed shared memory, each group's
pieces split by index among the cluster's CTAs) stores, and takes the
planner's kind of plan, as ``execute_pieces``.
"""

from __future__ import annotations

import numpy as np
import torch

from compress_tpu_torch import _cuda

__all__ = ["execute_pieces", "execute_pieces_ref", "execute_rounds",
           "execute_rounds_ref", "execute_blocks_hist",
           "execute_blocks_hist_ref", "compact_pieces"]

HIST_BASE = 1024 * 128   # first history address (ops/execute.HIST_BASE)
HIST_CLUSTER = 8         # CTAs of a frame's cluster in the history kernel


def _round_bounds(caps, total: int) -> list[int]:
    """Slot bounds of each round, clipped to the plan's ``total`` rows."""
    return [min(int(x), total) for x in np.concatenate([[0], np.cumsum(
        np.asarray(caps, np.int64))])]


def _check_lit(lit_rows):
    if lit_rows.dim() != 3 or lit_rows.shape[2] != 128 \
            or lit_rows.shape[1] % 512:
        raise ValueError(f"lit_rows: expected (B, 512 * M, 128), got "
                         f"{tuple(lit_rows.shape)}")


def _check_inputs(lit_rows, src, dst, length):
    _check_lit(lit_rows)
    B = lit_rows.shape[0]
    if src.dim() != 2 or src.shape[1] != B or dst.shape != src.shape \
            or length.shape != src.shape:
        raise ValueError("src, dst, length: expected (total, B) each")
    if any(t.device != lit_rows.device for t in (src, dst, length)):
        raise ValueError("execute_rounds: inputs on different devices")


def _check_pieces(lit_rows, pieces, rstart):
    _check_lit(lit_rows)
    if lit_rows.shape[1] * 256 > 1 << 24:
        raise ValueError("lit_rows: an arena above 16 MiB does not fit the "
                         "compact plan's 24-bit dst")
    if pieces.dim() != 2 or pieces.shape[1] != 2:
        raise ValueError(f"pieces: expected (P, 2), got "
                         f"{tuple(pieces.shape)}")
    if rstart.dim() != 2 or rstart.shape[0] != lit_rows.shape[0] \
            or rstart.shape[1] < 1:
        raise ValueError(f"rstart: expected (B, nr + 1), got "
                         f"{tuple(rstart.shape)}")
    if pieces.device != lit_rows.device or rstart.device != lit_rows.device:
        raise ValueError("execute_pieces: inputs on different devices")


def _run_round(arena, owner, s, d, n, LR: int):
    """One round on the flat int32 arena of all blocks: every byte of
    every piece (owner block, src, dst, live length n) is gathered as the
    arena stands, then summed into place."""
    dev = arena.device
    piece = torch.repeat_interleave(torch.arange(n.numel(), device=dev), n)
    if piece.numel() == 0:
        return
    ab = 2 * LR * 128
    start = torch.cumsum(n, 0) - n
    j = torch.arange(piece.numel(), device=dev) - start[piece]
    a = s[piece] + j
    a_row = (a >> 7).clamp(0, 2 * LR - 1)
    base = owner[piece] * ab
    vals = arena[base + a_row * 128 + (a & 127)]
    arena.index_put_((base + d[piece] + j,), vals, accumulate=True)


def _arena(lit_rows):
    B, LR = lit_rows.shape[0], lit_rows.shape[1]
    arena = torch.zeros((B, 2 * LR * 128), dtype=torch.int32,
                        device=lit_rows.device)
    arena[:, :LR * 128] = lit_rows.reshape(B, -1).to(torch.int32)
    return arena


def _out_rows(arena, B: int, LR: int):
    return (arena.view(B, 2 * LR, 128)[:, LR:] & 255).to(torch.uint8)


def execute_rounds_ref(lit_rows: torch.Tensor, src: torch.Tensor,
                       dst: torch.Tensor, length: torch.Tensor,
                       round_caps) -> torch.Tensor:
    """Plain PyTorch execute of a padded plan, round by round."""
    _check_inputs(lit_rows, src, dst, length)
    B, LR = lit_rows.shape[0], lit_rows.shape[1]
    dev = lit_rows.device
    if B == 0:
        return torch.empty((0, LR, 128), dtype=torch.uint8, device=dev)
    arena = _arena(lit_rows)
    bounds = _round_bounds(round_caps, src.shape[0])
    blk = torch.arange(B, device=dev, dtype=torch.int64)
    for lo, hi in zip(bounds[:-1], bounds[1:]):
        if hi <= lo:
            continue
        s = src[lo:hi].to(torch.int64).T.reshape(-1)
        d = dst[lo:hi].to(torch.int64).T.reshape(-1)
        ln = length[lo:hi].to(torch.int64).T.reshape(-1)
        row = d >> 7
        n = torch.minimum(ln, 128 - (d & 127)).clamp(min=0)
        n = torch.where((row >= 0) & (row < 2 * LR), n, 0)
        _run_round(arena.view(-1), blk.repeat_interleave(hi - lo), s, d, n,
                   LR)
    return _out_rows(arena, B, LR)


def execute_pieces_ref(lit_rows: torch.Tensor, pieces: torch.Tensor,
                       rstart: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch execute of a compact plan, round by round over all
    blocks at once."""
    _check_pieces(lit_rows, pieces, rstart)
    B, LR = lit_rows.shape[0], lit_rows.shape[1]
    dev = lit_rows.device
    if B == 0:
        return torch.empty((0, LR, 128), dtype=torch.uint8, device=dev)
    arena = _arena(lit_rows)
    P = pieces.shape[0]
    half = LR * 128
    rs = rstart.to(torch.int64)
    blk = torch.arange(B, device=dev, dtype=torch.int64)
    for r in range(rs.shape[1] - 1):
        lo = rs[:, r].clamp(0, P)
        hi = torch.maximum(rs[:, r + 1].clamp(max=P), lo)
        cnt = hi - lo
        owner = blk.repeat_interleave(cnt)
        k = torch.arange(owner.numel(), device=dev)
        idx = lo[owner] + k - (torch.cumsum(cnt, 0) - cnt)[owner]
        w = pieces[idx].to(torch.int64)
        s, w1 = w[:, 0], w[:, 1] & 0xFFFFFFFF
        d = w1 & 0xFFFFFF
        n = torch.minimum(((w1 >> 24) & 127) + 1, 128 - (d & 127))
        n = torch.where((d >= half) & (d < 2 * half), n, 0)
        _run_round(arena.view(-1), owner, s, d, n, LR)
    return _out_rows(arena, B, LR)


def compact_pieces(blk: torch.Tensor, rnd: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor, length: torch.Tensor, B: int, nr: int,
                   rows: int, whole_arena: bool = False):
    """The compact plan of flattened pieces, on their device.

    blk, rnd, src, dst, length: (N,) int64 tensors, a piece's block in
    [0, B), round in [0, nr), source and destination arena bytes and
    length, for an arena of ``rows`` literal rows.  Returns (pieces (P, 2)
    int32, rstart (B, nr + 1) int32): the pieces that write something,
    ordered by block and round, stably.  The store kernel's plan
    (``whole_arena`` False) keeps the pieces that write the output half
    and raises ValueError on a piece that writes the literal half (the
    check reads a flag back from the device); the sum kernel's keeps every
    piece that writes the arena."""
    n = torch.minimum(length, 128 - (dst & 127))
    row = dst >> 7
    if whole_arena:
        live = (n > 0) & (row >= 0) & (row < 2 * rows)
    else:
        if bool(((n > 0) & (row >= 0) & (row < rows)).any()):
            raise ValueError("a piece writes the literal half of the arena")
        live = (n > 0) & (row >= rows) & (row < 2 * rows)
    key = (blk * nr + rnd)[live]
    order = torch.sort(key, stable=True).indices
    pieces = torch.stack([src, dst | (n - 1) << 24], dim=1)[live][order]
    dev = dst.device
    flat = torch.zeros(B * nr + 1, dtype=torch.int64, device=dev)
    flat[1:] = torch.bincount(key, minlength=B * nr).cumsum(0)
    at = (torch.arange(B, device=dev)[:, None] * nr
          + torch.arange(nr + 1, device=dev))
    return pieces.to(torch.int32).contiguous(), flat[at].to(torch.int32)


def _slots(src: torch.Tensor, dst: torch.Tensor, length: torch.Tensor,
           round_caps):
    """A padded plan's slots flattened block-major: (blk, rnd, src, dst,
    length) int64 and the number of rounds.  Raises ValueError on a
    negative cap."""
    total, B = src.shape
    bounds = _round_bounds(round_caps, total)
    counts = np.diff(bounds)
    if (counts < 0).any():
        raise ValueError(f"round caps must not be negative: {round_caps}")
    end, dev = bounds[-1], src.device
    rnd = torch.repeat_interleave(torch.arange(len(counts), device=dev),
                                  torch.from_numpy(counts).to(dev))
    blk = torch.arange(B, device=dev).repeat_interleave(end)
    s, d, ln = (t[:end].T.reshape(-1).to(torch.int64)
                for t in (src, dst, length))
    return (blk, rnd.repeat(B), s, d, ln), len(counts)


def _launch(lit_rows, pieces, rstart, sums: bool = False) -> torch.Tensor:
    """Launch ``csrc/exec.cu``'s store kernel (or, with ``sums``, its sum
    kernel) on checked CUDA inputs; returns the output rows."""
    B, LR = lit_rows.shape[0], lit_rows.shape[1]
    P, nr = pieces.shape[0], rstart.shape[1] - 1
    _cuda.require_cuda_input(lit_rows, "lit_rows", torch.uint8, (B, LR, 128))
    _cuda.require_cuda_input(pieces, "pieces", torch.int32, (P, 2))
    _cuda.require_cuda_input(rstart, "rstart", torch.int32, (B, nr + 1))
    lit_rows, pieces = _cuda.aligned(lit_rows), _cuda.aligned(pieces, 8)
    dev = lit_rows.device
    out = torch.empty((B, LR, 128), dtype=torch.uint8, device=dev)
    if B == 0:
        return out
    lib = _cuda.library()
    with torch.cuda.device(dev):
        if sums:
            arena = torch.empty((2, B, 2 * LR * 128), dtype=torch.int32,
                                device=dev)
            rc = lib.ct_exec_sum(
                lit_rows.data_ptr(), pieces.data_ptr(), rstart.data_ptr(), nr,
                P, B, LR, arena[0].data_ptr(), arena[1].data_ptr(),
                out.data_ptr(), _cuda.stream(dev))
        else:
            rc = lib.ct_exec_pieces(
                lit_rows.data_ptr(), pieces.data_ptr(), rstart.data_ptr(), nr,
                P, B, LR, out.data_ptr(), _cuda.stream(dev))
    _cuda.check(rc, "execute")
    return out


def execute_pieces(lit_rows: torch.Tensor, pieces: torch.Tensor,
                   rstart: torch.Tensor) -> torch.Tensor:
    """Run a compact plan: lit_rows (B, 512 * M, 128) uint8, pieces (P, 2)
    and rstart (B, nr + 1) int32 per ``execute.pack_pieces``.  Returns
    (B, 512 * M, 128) uint8 output rows.

    It takes the plans the decode paths' planner makes: each output byte
    written at most once, and a round reads only bytes that earlier rounds
    wrote (or none); on them the store kernel equals
    ``execute_pieces_ref``, the reference's sum."""
    if lit_rows.device.type == "cpu":
        return execute_pieces_ref(lit_rows, pieces, rstart)
    _check_pieces(lit_rows, pieces, rstart)
    out = _launch(lit_rows, pieces, rstart)
    execute_pieces.launches += 1
    return out


def execute_rounds(lit_rows: torch.Tensor, src: torch.Tensor,
                   dst: torch.Tensor, length: torch.Tensor,
                   round_caps) -> torch.Tensor:
    """Run a padded plan: lit_rows (B, 512 * M, 128) uint8; src, dst,
    length (total, B) int32, round-major per ``pack_plans``; round_caps
    the per-round slot counts.  Returns (B, 512 * M, 128) uint8 output
    rows.  Every plan ``execute_rounds_ref`` takes, through the sum
    kernel."""
    if lit_rows.device.type == "cpu":
        return execute_rounds_ref(lit_rows, src, dst, length, round_caps)
    _check_inputs(lit_rows, src, dst, length)
    B, rows = lit_rows.shape[0], lit_rows.shape[1]
    for name, t in (("src", src), ("dst", dst), ("length", length)):
        _cuda.require_cuda_input(t, name, torch.int32, (src.shape[0], B))
    flat, nr = _slots(src, dst, length, round_caps)
    out = _launch(lit_rows, *compact_pieces(*flat, B, nr, rows,
                                            whole_arena=True), sums=True)
    execute_rounds.launches += 1
    return out


def _check_hist(lit_rows, pieces, gstart, hist_rows: int):
    if lit_rows.dim() != 4 or tuple(lit_rows.shape[2:]) != (512, 128):
        raise ValueError(f"lit_rows: expected (B, K, 512, 128), got "
                         f"{tuple(lit_rows.shape)}")
    if pieces.dim() != 2 or pieces.shape[1] != 2:
        raise ValueError(f"pieces: expected (P, 2), got "
                         f"{tuple(pieces.shape)}")
    if gstart.dim() != 3 or tuple(gstart.shape[:2]) != tuple(
            lit_rows.shape[:2]) or gstart.shape[2] < 2:
        raise ValueError(f"gstart: expected (B, K, G + 1), G >= 1, got "
                         f"{tuple(gstart.shape)}")
    if not 512 <= hist_rows <= 128 * 512:
        raise ValueError(f"hist_rows: expected 512 .. 65536, got "
                         f"{hist_rows}")
    if pieces.device != lit_rows.device or gstart.device != lit_rows.device:
        raise ValueError("execute_blocks_hist: inputs on different devices")


def execute_blocks_hist_ref(lit_rows: torch.Tensor, pieces: torch.Tensor,
                            gstart: torch.Tensor,
                            hist_rows: int) -> torch.Tensor:
    """Plain PyTorch version of ``execute_blocks_hist``: step k of every
    frame at once, step after step, with the reference's sums."""
    _check_hist(lit_rows, pieces, gstart, hist_rows)
    B, K = lit_rows.shape[0], lit_rows.shape[1]
    dev = lit_rows.device
    half = 512 * 128
    hist_cap = hist_rows * 128
    # every frame's output so far, after hist_cap zero bytes
    done = torch.zeros((B, hist_cap + K * half), dtype=torch.int32,
                       device=dev)
    P = pieces.shape[0]
    gs = gstart.to(torch.int64)
    blk = torch.arange(B, device=dev, dtype=torch.int64)
    for k in range(K):
        arena = _arena(lit_rows[:, k])
        for g in range(gs.shape[2] - 1):
            lo = gs[:, k, g].clamp(0, P)
            hi = torch.maximum(gs[:, k, g + 1].clamp(max=P), lo)
            cnt = hi - lo
            owner = blk.repeat_interleave(cnt)
            idx = lo[owner] + torch.arange(owner.numel(), device=dev) \
                - (torch.cumsum(cnt, 0) - cnt)[owner]
            w = pieces[idx].to(torch.int64)
            s, w1 = w[:, 0], w[:, 1] & 0xFFFFFFFF
            d = w1 & 0xFFFFFF
            n = torch.minimum(((w1 >> 24) & 127) + 1, 128 - (d & 127))
            n = torch.where((d >= half) & (d < 2 * half), n, 0)
            if g:
                _run_round(arena.view(-1), owner, s, d, n, 512)
                continue
            # history: byte x of the last hist_cap output bytes of the
            # frame, which start at done[hist_cap + k * half - hist_cap]
            piece = torch.repeat_interleave(
                torch.arange(n.numel(), device=dev), n)
            j = torch.arange(piece.numel(), device=dev) \
                - (torch.cumsum(n, 0) - n)[piece]
            x = s[piece] - HIST_BASE + j
            x = (x >> 7).clamp(0, hist_rows - 1) * 128 + (x & 127)
            vals = done.view(-1)[owner[piece] * done.shape[1] + k * half + x]
            arena.view(-1).index_put_(
                (owner[piece] * 2 * half + d[piece] + j,), vals,
                accumulate=True)
        done[:, hist_cap + k * half:hist_cap + (k + 1) * half] = \
            arena[:, half:] & 255
    return done[:, hist_cap:].to(torch.uint8).view(B, K, 512, 128)


def execute_blocks_hist(lit_rows: torch.Tensor, pieces: torch.Tensor,
                        gstart: torch.Tensor, hist_rows: int, *,
                        cluster: int | None = None) -> torch.Tensor:
    """Run multi-block frames with their history: lit_rows (B, K, 512,
    128) uint8; pieces (P, 2) and gstart (B, K, G + 1) int32 per
    ``execute.pack_pieces_mb``; hist_rows the rows of history (512 per
    block the frames keep).  Returns (B, K, 512, 128) uint8 output rows,
    frame b's block k in [b, k].  On CUDA tensors a thread-block cluster
    of ``csrc/exec.cu``'s history kernel walks a frame's blocks in order
    (``cluster`` CTAs, a power of two up to 32, ``HIST_CLUSTER`` by
    default; the card refuses more than 16 and the call then raises); CPU
    tensors run ``execute_blocks_hist_ref``."""
    if lit_rows.device.type == "cpu":
        return execute_blocks_hist_ref(lit_rows, pieces, gstart, hist_rows)
    _check_hist(lit_rows, pieces, gstart, hist_rows)
    C = HIST_CLUSTER if cluster is None else int(cluster)
    if C < 1 or C > 32 or C & (C - 1):
        raise ValueError(f"cluster: expected a power of two up to 32, got "
                         f"{cluster}")
    B, K = lit_rows.shape[0], lit_rows.shape[1]
    P, G = pieces.shape[0], gstart.shape[2] - 1
    _cuda.require_cuda_input(lit_rows, "lit_rows", torch.uint8,
                             (B, K, 512, 128))
    _cuda.require_cuda_input(pieces, "pieces", torch.int32, (P, 2))
    _cuda.require_cuda_input(gstart, "gstart", torch.int32, (B, K, G + 1))
    lit_rows, pieces = _cuda.aligned(lit_rows), _cuda.aligned(pieces, 8)
    dev = lit_rows.device
    out = torch.empty((B, K, 512, 128), dtype=torch.uint8, device=dev)
    if B and K:
        with torch.cuda.device(dev):
            rc = _cuda.library().ct_exec_hist(
                lit_rows.data_ptr(), pieces.data_ptr(), gstart.data_ptr(),
                G, P, B, K, hist_rows, C, out.data_ptr(), _cuda.stream(dev))
        _cuda.check(rc, "execute_blocks_hist")
        execute_blocks_hist.launches += 1
    return out


execute_pieces.launches = 0
execute_rounds.launches = 0
execute_blocks_hist.launches = 0
