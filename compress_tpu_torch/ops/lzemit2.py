"""S2 parse+emit (counterpart of the JAX package's ``ops/lzemit2.py``).

From the finder's per-position (off, L), per 64 KiB block:

  A0. chain extension at the finder's suffix cap: where L == cap and the
      offset repeats every cap positions, L = cap * links + 4;
  A.  run probes at offsets 1, 2, 3, 4, 8, in that order: a run of
      r >= 4 equal-to-offset bytes (cut at the 512-position tile) replaces
      (off, L) when r > L;
  B.  greedy parse of each 512-position tile with L_t = min(L, 512 - r_t),
      an op where L_t >= 4, else a literal;
  C.  cross-tile chain merge: where a tile's first op continues the
      previous tile's op that ends at the boundary (same offset), it is
      absorbed into that op, through every following full-tile op, and the
      terminal tile's first-op length is added only if it was absorbed;
  D.  S2 tag bytes per position (literal runs cut at tiles; copy1/copy2
      up to 64 bytes plus a repeat tag for the rest) laid out in 256 slots
      per 128-position row, slots past the row's length 0.

``emit_blocks`` launches the CUDA kernel (``csrc/lzemit.cu``: the
finder's caps 10 and 6 have their own instantiations, any other positive
cap the run-time one, whose launches ``emit_blocks.any_cap_launches``
counts) on CUDA tensors and runs ``emit_blocks_ref``, the plain PyTorch
version, on CPU tensors.
"""

from __future__ import annotations

import torch

from compress_tpu_torch import _cuda
from compress_tpu_torch.ops.lzemit import (BS, LANES, NT, ROW_OUT, ROWS,
                                           TILE, assemble_bodies)

__all__ = ["emit_blocks", "emit_blocks_ref", "assemble_bodies"]

_PROBES = (1, 2, 3, 4, 8)


def _up(x: torch.Tensor, s: int) -> torch.Tensor:
    """y[:, g] = x[:, g + s] where g + s < BS, else 0."""
    y = torch.zeros_like(x)
    if s < BS:
        y[:, :BS - s] = x[:, s:]
    return y


def _runlen(m: torch.Tensor, r_t: torch.Tensor) -> torch.Tensor:
    """Consecutive ones of m from each position, cut at the tile end."""
    r = m
    for k in range(9):
        s = 1 << k
        nxt = torch.where(r_t + s < TILE, _up(r, s), 0)
        r = r + torch.where(r == s, nxt, 0)
    return r


def _rev_cum(x: torch.Tensor, op) -> torch.Tensor:
    """Suffix scan along dim 1 (op: torch.cummin or torch.cummax)."""
    return torch.flip(op(torch.flip(x, [1]), 1).values, [1])


def _shift_tiles(x: torch.Tensor, fill) -> torch.Tensor:
    """y[:, t] = x[:, t + 1], fill at the last tile."""
    return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)


def parse_stages(blk: torch.Tensor, off: torch.Tensor, L: torch.Tensor,
                 cap: int, zstd_gate: bool = False):
    """Stages A0-C on (NB, BS) int32 bytes and (off, L): returns (take,
    lit, L2, off), the ops after the merge (absorbed tile heads dropped),
    the literal positions, each op's merged length and its offset.
    ``zstd_gate`` applies the zstd cost gate between A and B: L = 0 where
    L < 6 + (off >= 1024) + (off >= 65536)."""
    nb = blk.shape[0]
    dev = blk.device
    i32 = torch.int32
    g = torch.arange(BS, device=dev, dtype=i32)
    r_t = g & (TILE - 1)

    # ---- A0. chain extension at the finder's suffix cap -------------------
    cont = ((L == cap) & (_up(off, cap) == off) & (off > 0)
            & (_up(L, cap) >= 4) & (g + cap < BS)).to(i32)
    r = cont
    for k in range(13):
        s = 1 << k
        r = r + torch.where(r == s, _up(r, cap * s), 0)
    L = torch.where((L == cap) & (r > 0), cap * r + 4, L)

    # ---- A. short-offset run probes ---------------------------------------
    for o in _PROBES:
        m = torch.zeros_like(blk)
        m[:, o:] = (blk[:, o:] == blk[:, :-o]).to(i32)
        Lr = _runlen(m, r_t)
        better = (Lr > L) & (Lr >= 4)
        L = torch.where(better, Lr, L)
        off = torch.where(better, o, off)

    if zstd_gate:
        min_l = 6 + (off >= 1024).to(i32) + (off >= 65536).to(i32)
        L = torch.where(L >= min_l, L, 0)

    # ---- B. greedy tile parse ---------------------------------------------
    L_t = torch.minimum(L, TILE - r_t)
    valid = L_t >= 4
    off = torch.where(valid, off, 0)
    vT = valid.view(nb, NT, TILE)
    LT = L_t.view(nb, NT, TILE)
    take = torch.zeros((nb, NT, TILE), dtype=torch.bool, device=dev)
    lit = torch.zeros_like(take)
    p = torch.zeros((nb, NT), dtype=i32, device=dev)
    for q in range(TILE):
        active = p == q
        tk = active & vT[:, :, q]
        take[:, :, q] = tk
        lit[:, :, q] = active & ~vT[:, :, q]
        p = torch.where(tk, q + LT[:, :, q], torch.where(active, p + 1, p))

    # ---- C. cross-tile chain merge (with the terminal gate on a_t) --------
    off3 = off.view(nb, NT, TILE)
    rt3 = torch.arange(TILE, device=dev, dtype=i32)
    ends = take & ((rt3 + LT) == TILE)
    eoff = torch.where(ends, off3, -1).amax(dim=2)
    epos = torch.where(ends, rt3, -1).amax(dim=2)
    op0 = take[:, :, 0]
    off0 = off3[:, :, 0]
    L0 = LT[:, :, 0]
    full = op0 & (L0 == TILE)
    tl = torch.arange(NT, device=dev, dtype=i32)
    prev_eoff = torch.cat([torch.full_like(eoff[:, :1], -1), eoff[:, :-1]],
                          dim=1)
    a_t = op0 & (off0 == prev_eoff) & (prev_eoff > 0)
    c_t = a_t & full
    k_term = _rev_cum(torch.where(~c_t, tl, NT), torch.cummin)
    packed = torch.where(
        ~c_t, ((NT - 1 - tl) << 10)
        | torch.where(a_t, torch.clamp(L0, max=1023), 0), -1)
    filled = _rev_cum(packed, torch.cummax)
    L_term = torch.where(filled >= 0, filled & 1023, 0)
    links = _shift_tiles(k_term, NT) - (tl + 1)
    W = links * TILE + _shift_tiles(L_term, 0)
    is_recv = _shift_tiles(a_t, False) & ~c_t
    receiver = ends & is_recv[:, :, None] & (rt3 == epos[:, :, None])
    absorbed = a_t[:, :, None] & (rt3 == 0)
    take = (take & ~absorbed).view(nb, BS)
    L2 = (LT + torch.where(receiver, W[:, :, None], 0)).view(nb, BS)
    return take, lit.view(nb, BS), L2, off


def emit_blocks_ref(blocks_u8: torch.Tensor, off: torch.Tensor,
                    L: torch.Tensor, cap: int = 10):
    """Plain PyTorch parse+emit: the stages in order, on (NB, BS) tensors."""
    nb = blocks_u8.shape[0]
    dev = blocks_u8.device
    i32 = torch.int32
    blk = blocks_u8.to(i32)
    g = torch.arange(BS, device=dev, dtype=i32)
    r_t = g & (TILE - 1)
    take, lit, L2, off = parse_stages(blk, off.to(i32), L.to(i32), cap)

    # ---- D. emission ------------------------------------------------------
    prev_lit = torch.zeros_like(lit)
    prev_lit[:, 1:] = lit[:, :-1]
    lit_start = lit & ~(prev_lit & (r_t > 0))
    run_len = torch.where(lit_start, _runlen(lit.to(i32), r_t), 0)

    x = run_len - 1
    lit_hl = torch.where(lit_start, 1 + (run_len > 60).to(i32)
                         + (run_len > 256).to(i32), 0)
    l1 = torch.where(L2 >= 68, 64, torch.where(L2 >= 65, L2 - 4, L2))
    l2 = L2 - l1
    c1 = (off < 2048) & (l1 <= 11)
    r_hl = torch.where(l2 == 0, 0, torch.where(
        l2 <= 8, 2, torch.where(l2 <= 263, 3, 4)))
    m_hl = torch.where(take, torch.where(c1, 2, 3) + r_hl, 0)
    hl = lit_hl + m_hl
    outb = hl + lit.to(i32)

    lh0 = torch.where(run_len <= 60, x << 2,
                      torch.where(run_len <= 256, 240, 244))
    mh0 = torch.where(c1, ((off >> 8) << 5) | ((l1 - 4) << 2) | 1,
                      ((l1 - 1) << 2) | 2)
    rb0 = torch.where(l2 <= 8, ((l2 - 4) << 2) | 1,
                      torch.where(l2 <= 263, (5 << 2) | 1, (6 << 2) | 1))
    rb2 = torch.where(l2 <= 263, l2 - 8, (l2 - 260) & 0xFF)
    rb3 = torch.clamp(l2 - 260, min=0) >> 8
    hasr = l2 > 0
    zero = torch.zeros_like(off)
    h = [
        torch.where(lit_start, lh0, torch.where(take, mh0, zero)),
        torch.where(lit_start & (lit_hl >= 2), x & 0xFF,
                    torch.where(take, off & 0xFF, zero)),
        torch.where(lit_start & (lit_hl >= 3), x >> 8,
                    torch.where(take, torch.where(
                        c1, torch.where(hasr, rb0, zero), off >> 8), zero)),
        torch.where(take & hasr, torch.where(c1, zero, rb0), zero),
        torch.where(take & hasr & c1 & (r_hl >= 3), rb2, zero),
        torch.where(take & hasr, torch.where(
            c1, torch.where(r_hl >= 4, rb3, zero),
            torch.where(r_hl >= 3, rb2, zero)), zero),
        torch.where(take & hasr & ~c1 & (r_hl >= 4), rb3, zero),
    ]

    # row-local placement: each position's bytes start at the exclusive
    # prefix sum of outb within its 128-position row
    outb3 = outb.view(nb, ROWS, LANES)
    lstart = (torch.cumsum(outb3, dim=2) - outb3).view(nb, BS)
    rowlen = outb3.sum(dim=2, dtype=i32)
    row_base = ((torch.arange(nb, device=dev)[:, None] * ROWS
                 + (g >> 7).to(torch.int64)) * (ROW_OUT + 1))
    out = torch.zeros(nb * ROWS * (ROW_OUT + 1), dtype=i32, device=dev)

    def put(mask, slot, val):  # slots >= ROW_OUT land in a discarded column
        slot = torch.where(mask, torch.clamp(slot, max=ROW_OUT), ROW_OUT)
        out.scatter_(0, (row_base + slot).view(-1),
                     torch.where(mask, val & 0xFF, 0).to(i32).view(-1))

    for k in range(7):
        put(k < hl, lstart + k, h[k])
    put(lit, lstart + hl, blk)
    rows = out.view(nb, ROWS, ROW_OUT + 1)[:, :, :ROW_OUT].to(torch.uint8)
    return (rows[:, :, :LANES].contiguous(), rows[:, :, LANES:].contiguous(),
            rowlen.view(nb, 4, LANES))


def emit_blocks(blocks_u8: torch.Tensor, off: torch.Tensor, L: torch.Tensor,
                cap: int = 10):
    """(NB,65536) u8 blocks + finder (off, L) -> (b0, b1, rowlens).

    b0, b1: (NB, 512, 128) u8, row-local slots 0-127 and 128-255;
    rowlens: (NB, 4, 128) int32, row r's length at [r >> 7, r & 127].
    Any positive cap.  A CUDA tensor goes through the CUDA kernel (an
    input that is not 16-byte aligned is copied first), a CPU tensor
    through the plain version."""
    if blocks_u8.dim() != 2 or blocks_u8.shape[1] != BS:
        raise ValueError(f"expected (NB, {BS}) blocks, got "
                         f"{tuple(blocks_u8.shape)}")
    if off.shape != blocks_u8.shape or L.shape != blocks_u8.shape:
        raise ValueError("off and L must have the blocks' shape")
    if off.device != blocks_u8.device or L.device != blocks_u8.device:
        raise ValueError("off and L must be on the blocks' device")
    if cap < 1:
        raise ValueError(f"cap must be positive, got {cap}")
    if blocks_u8.device.type == "cpu":
        return emit_blocks_ref(blocks_u8, off, L, cap)
    nb = blocks_u8.shape[0]
    _cuda.require_cuda_input(blocks_u8, "blocks", torch.uint8, (nb, BS))
    _cuda.require_cuda_input(off, "off", torch.int32, (nb, BS))
    _cuda.require_cuda_input(L, "L", torch.int32, (nb, BS))
    blocks_u8, off, L = (_cuda.aligned(t) for t in (blocks_u8, off, L))
    dev = blocks_u8.device
    b0 = torch.empty((nb, ROWS, LANES), dtype=torch.uint8, device=dev)
    b1 = torch.empty((nb, ROWS, LANES), dtype=torch.uint8, device=dev)
    rowlens = torch.empty((nb, 4, LANES), dtype=torch.int32, device=dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.ct_emit_blocks(
            blocks_u8.data_ptr(), off.data_ptr(), L.data_ptr(),
            b0.data_ptr(), b1.data_ptr(), rowlens.data_ptr(), nb,
            min(cap, BS), _cuda.stream(dev))  # a cap >= BS never continues
    _cuda.check(rc, "emit_blocks")
    emit_blocks.launches += 1
    emit_blocks.any_cap_launches += cap not in (10, 6)
    return b0, b1, rowlens


emit_blocks.launches = 0
emit_blocks.any_cap_launches = 0
