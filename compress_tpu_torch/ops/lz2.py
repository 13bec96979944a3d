"""Device S2 block encode (counterpart of the JAX package's ``ops/lz2.py``).

Two engines, as in the reference:

- the kernel path, ``s2_encode_blocks_kern``: 64 KiB blocks go through
  the match finder (``lzkern``), the parse+emit stage (``lzemit2``) and
  the row assembly (``lzemit.assemble_bodies``);
- the XLA engine, ``s2_encode_blocks(blocks, tile, level)``: a stable sort
  gives each position its nearest earlier equal 4-byte value and a match
  length from 12 carried suffix bytes; run probes at offsets 1, 2, 3, 4
  and 8; at level 2 chain extension and probes of the block's 8 most
  frequent offsets; a greedy parse of each tile (``tile_parse``); a merge
  of op chains across tile ends; and the S2 tags routed into
  ``tile + 64``-slot tile buffers and compacted.

The reference runs the XLA engine's routing and compaction as one-hot
matmuls and its parse as a ``lax.scan``; here they are integer scatters,
a prefix-sum compaction and ``tile_parse``, which launches its CUDA
kernel (``csrc/tileparse.cu``) on CUDA tensors and runs its plain version
``tile_parse_ref`` on CPU tensors.  Every value is the reference's.

``encode_blocks_np`` picks the engine by the device, as the reference
picks it by platform: the kernel path on CUDA (unless
``COMPRESS_TPU_S2_ENGINE=xla``), the XLA engine on the CPU.
"""

from __future__ import annotations

import os

import torch
import torch.nn.functional as F

from compress_tpu_torch import _cuda
from compress_tpu_torch._cuda import resolve_device
from compress_tpu_torch.ops import lzemit2, lzkern
from compress_tpu_torch.ops.common import compact, route_tiles

B = 1 << 16
TILE = 512
# blocks per launch: bounds the device memory of one chunk ((off, L)
# 512 KiB and output panels 66 KiB per block on the kernel path; the XLA
# engine's int64 planes, about 30 arrays of 512 KiB per block)
MAX_LAUNCH_BLOCKS = 256

_SUFFIX_WORDS = 3  # carried 4-byte words -> max match 4 + 12 = 16
L_CAP = 4 + 4 * _SUFFIX_WORDS
L_EMIT_CAP = 64    # one copy2 tag's worth
TOPK_OFFSETS = 8
_RLE_PROBES = (1, 2, 3, 4, 8)

_I32 = torch.int32
_I64 = torch.int64


def s2_encode_blocks_kern(blocks: torch.Tensor) -> list[bytes]:
    """(NB, 65536) uint8 on its device -> list of S2 block bodies."""
    off, L = lzkern.find_matches_blocks(blocks)
    b0, b1, rl = lzemit2.emit_blocks(blocks, off, L)
    return lzemit2.assemble_bodies(b0, b1, rl)


# ---------------------------------------------------------------------------
# XLA engine: match candidates
# ---------------------------------------------------------------------------


def _rev_cum(x: torch.Tensor, op, dim: int = 1) -> torch.Tensor:
    """Suffix scan along ``dim`` (op: torch.cummin or torch.cummax)."""
    return torch.flip(op(torch.flip(x, [dim]), dim).values, [dim])


def _values(blocks: torch.Tensor):
    """(NB, bs) uint8 -> (v32, words): the little-endian 4-byte value at
    each position (positions past bs - 4 get the unique sentinel
    pos ^ 0xDEADBEEF) and the three following 4-byte words, zero padded;
    uint32 values held in int64."""
    bs = blocks.shape[1]
    b = F.pad(blocks.to(_I64), (0, 4 + 4 * _SUFFIX_WORDS))

    def w(k):
        return (b[:, k:bs + k] | (b[:, k + 1:bs + k + 1] << 8)
                | (b[:, k + 2:bs + k + 2] << 16)
                | (b[:, k + 3:bs + k + 3] << 24))

    pos = torch.arange(bs, device=blocks.device, dtype=_I64)
    v32 = torch.where(pos > bs - 4, pos ^ 0xDEADBEEF, w(0))
    return v32, [w(4 * (k + 1)) for k in range(_SUFFIX_WORDS)]


def _tz_bytes(x: torch.Tensor) -> torch.Tensor:
    """Trailing zero bytes of a 4-byte xor (0..4)."""
    return (((x & 0xFF) == 0).to(_I64) + ((x & 0xFFFF) == 0).to(_I64)
            + ((x & 0xFFFFFF) == 0).to(_I64) + (x == 0).to(_I64))


def _candidates_lengths(v32: torch.Tensor, words):
    """(off, L) per position: the nearest earlier position with the same
    v32 (the adjacent row of a stable sort on v32; the rows are in
    position order, which is the reference's second sort key) and the
    match length from the carried words, up to L_CAP, 0 where below 4."""
    NB, bs = v32.shape
    dev = v32.device
    order = torch.sort(v32, dim=1, stable=True).indices
    v_s = torch.gather(v32, 1, order)
    same = torch.zeros_like(v_s, dtype=torch.bool)
    same[:, 1:] = v_s[:, 1:] == v_s[:, :-1]
    prev_p = torch.full_like(order, -1)
    prev_p[:, 1:] = order[:, :-1]
    cand_s = torch.where(same, prev_p, -1)
    ext = torch.zeros_like(order)
    alive = same
    for k, wk in enumerate(words):
        w_s = torch.gather(wk, 1, order)
        prev = torch.cat([w_s[:, :1], w_s[:, :-1]], dim=1)
        eq = _tz_bytes(w_s ^ prev)
        in_range = (order + 4 * (k + 1) + 4) <= bs
        eq = torch.where(in_range, eq, 0)
        ext = ext + torch.where(alive, eq, 0)
        alive = alive & (eq == 4) & in_range
    L_s = torch.where(same, 4 + ext, 0)
    # back to position order: the inverse permutation
    cand = torch.empty_like(cand_s).scatter_(1, order, cand_s)
    L = torch.empty_like(L_s).scatter_(1, order, L_s)
    pos = torch.arange(bs, device=dev, dtype=_I64)
    L = torch.minimum(L, bs - pos)
    L = torch.where(cand >= 0, L, 0)
    L = torch.where(L >= 4, L, 0)
    return torch.where(L > 0, pos - torch.clamp(cand, min=0), 0), L


def _run_lengths(m: torch.Tensor, idx: torch.Tensor, bs: int):
    """Length of the run of true ``m`` from each position (0 where false)."""
    next_mm = _rev_cum(torch.where(m, bs, idx), torch.cummin)
    return torch.where(m, next_mm - idx, 0)


def _rle_lengths(blocks: torch.Tensor):
    """(off, L): the longest byte agreement with the position o back, for
    o in 1, 2, 3, 4, 8 (ties keep the smaller o); L = 0 below 4 (the
    offset stays, as in the reference)."""
    NB, bs = blocks.shape
    bi = blocks.to(_I64)
    idx = torch.arange(bs, device=blocks.device, dtype=_I64)
    best_L = torch.zeros_like(bi)
    best_off = torch.zeros_like(bi)
    for o in _RLE_PROBES:
        m = torch.zeros_like(bi, dtype=torch.bool)
        m[:, o:] = bi[:, o:] == bi[:, :-o]
        L = _run_lengths(m, idx, bs)
        better = L > best_L
        best_L = torch.where(better, L, best_L)
        best_off = torch.where(better, o, best_off)
    return best_off, torch.where(best_L >= 4, best_L, 0)


def _chain_extend(off: torch.Tensor, L: torch.Tensor):
    """Where L == L_CAP and the offset repeats L_CAP positions on, extend
    to the full run: L = L_CAP * links + L of the chain's terminal, by
    suffix scans over the positions of each residue mod L_CAP."""
    NB, bs = off.shape
    nxt_off = torch.zeros_like(off)
    nxt_off[:, :bs - L_CAP] = off[:, L_CAP:]
    cont = (L == L_CAP) & (nxt_off == off) & (off > 0)
    K = bs // L_CAP
    c = cont.view(NB, K, L_CAP)
    Ls = L.view(NB, K, L_CAP)
    kk = torch.arange(K, device=off.device, dtype=_I64)[None, :, None]
    k_term = _rev_cum(torch.where(~c, kk, K), torch.cummin)
    packed = torch.where(~c, ((K - 1 - kk) << 10)
                         | torch.clamp(Ls, max=L_CAP), -1)
    L_term = _rev_cum(packed, torch.cummax) & 1023
    L_ext = (k_term - kk) * L_CAP + L_term
    return torch.where(cont, L_ext.reshape(NB, bs), L)


def _topk_offsets(off: torch.Tensor, L: torch.Tensor, k: int = TOPK_OFFSETS):
    """(NB, k): the k most frequent offsets among every 64th position with
    L >= 4, most frequent first, ties in ascending offset (a stable sort:
    the reference's ``lax.sort`` is not marked stable but ran so on the
    CPU); padded with 0 offsets."""
    sample = torch.where(L[:, ::64] >= 4, off[:, ::64], 0)
    s = torch.sort(sample, dim=1).values
    NB, n = s.shape
    idx = torch.arange(n, device=s.device, dtype=_I64)
    start = torch.ones_like(s, dtype=torch.bool)
    start[:, 1:] = s[:, 1:] != s[:, :-1]
    nxt = _rev_cum(torch.where(start, idx, n), torch.cummin)
    nxt_start = torch.cat([nxt[:, 1:], torch.full_like(nxt[:, :1], n)], 1)
    run = torch.where(start & (s > 0), nxt_start - idx, 0)
    order = torch.sort(-run, dim=1, stable=True).indices
    return torch.gather(s, 1, order)[:, :k]


def _probe_offsets(blocks: torch.Tensor, offs: torch.Tensor):
    """Exact match lengths at each row's probe offsets (NB, k); returns
    the best (off, L), L = 0 below 4.  The reference's ``jnp.roll`` by a
    traced offset is an index gather ``bi[(idx - o) mod bs]`` here, with
    a per-row ``o``."""
    NB, bs = blocks.shape
    bi = blocks.to(_I64)
    idx = torch.arange(bs, device=blocks.device, dtype=_I64)
    best_L = torch.zeros_like(bi)
    best_o = torch.zeros_like(bi)
    for j in range(offs.shape[1]):
        o = offs[:, j:j + 1]
        rolled = torch.gather(bi, 1, torch.remainder(idx[None, :] - o, bs))
        m = (bi == rolled) & (idx[None, :] >= o) & (o > 0)
        Lj = _run_lengths(m, idx, bs)
        better = Lj > best_L
        best_L = torch.where(better, Lj, best_L)
        best_o = torch.where(better, o, best_o)
    return best_o, torch.where(best_L >= 4, best_L, 0)


# ---------------------------------------------------------------------------
# XLA engine: the tile parse
# ---------------------------------------------------------------------------


def tile_parse_ref(L_t: torch.Tensor, tile: int):
    """Plain PyTorch greedy parse: a cursor walks each ``tile``-position
    tile from its start; at a position with L_t >= 4 it takes an op and
    jumps L_t, at any other it lands on it is a literal.  (NB, bs) ->
    (take, lit) bool, all tiles in step."""
    NB, bs = L_t.shape
    nt = bs // tile
    Lt = L_t.reshape(NB * nt, tile).to(_I64)
    valid = Lt >= 4
    take = torch.zeros_like(valid)
    lit = torch.zeros_like(valid)
    p = torch.zeros(NB * nt, dtype=_I64, device=L_t.device)
    for r in range(tile):
        active = p == r
        v = valid[:, r]
        take[:, r] = active & v
        lit[:, r] = active & ~v
        p = torch.where(active, torch.where(v, r + Lt[:, r], p + 1), p)
    return take.view(NB, bs), lit.view(NB, bs)


def tile_parse(L_t: torch.Tensor, tile: int, *,
               routes: torch.Tensor | None = None):
    """Greedy parse of each ``tile``-position tile of (NB, bs) int32 L_t
    (already capped to the tile end): (take, lit) bool of the same shape.
    The CUDA kernel on CUDA tensors (``csrc/tileparse.cu``, one launch: a
    warp a tile in three exact phases for tiles up to 2048 positions, a
    thread a tile in staged chunks above), ``tile_parse_ref`` on CPU
    tensors.  ``routes``, a (2,) int32 CUDA tensor, gets the kernel's
    count of tiles on the warp route and on the chunked route added to
    it."""
    if L_t.dim() != 2 or tile <= 0 or L_t.shape[1] % tile:
        raise ValueError(f"tile_parse: expected (NB, bs) with bs a multiple "
                         f"of the tile {tile}, got {tuple(L_t.shape)}")
    if L_t.device.type == "cpu":
        return tile_parse_ref(L_t, tile)
    _cuda.require_cuda_input(L_t, "L_t", _I32, L_t.shape)
    dev = L_t.device
    if routes is not None:
        _cuda.require_cuda_input(routes, "tile_parse: routes", _I32, (2,))
        if routes.device != dev:
            raise ValueError("tile_parse: routes on another device")
    NB, bs = L_t.shape
    out = torch.empty((2, NB, bs), dtype=torch.bool, device=dev)
    with torch.cuda.device(dev):
        rc = _cuda.library().ct_tile_parse(
            L_t.data_ptr(), NB * bs // tile, tile, out[0].data_ptr(),
            out[1].data_ptr(), None if routes is None else routes.data_ptr(),
            _cuda.stream(dev))
    _cuda.check(rc, "tile_parse")
    tile_parse.launches += 1
    return out[0], out[1]


tile_parse.launches = 0


def _parse(off: torch.Tensor, L: torch.Tensor, tile: int,
           cap: int = L_EMIT_CAP):
    """Greedy parse over per-position (off, L): (take, lit, L_t, off) with
    L_t = min(L, tile - r, cap) and off 0 where L_t < 4."""
    bs = L.shape[1]
    r = torch.arange(bs, device=L.device, dtype=_I64) % tile
    L_t = torch.clamp(torch.minimum(L, tile - r), max=cap)
    off = torch.where(L_t >= 4, off, 0)
    take, lit = tile_parse(L_t.to(_I32).contiguous(), tile)
    return take, lit, L_t, off


def _find_parse(blocks: torch.Tensor, tile: int, level: int = 1):
    """Level 1 ~ s2.Encode; level 2 adds chain extension and top-K offset
    probing (s2.EncodeBetter-grade search)."""
    v32, words = _values(blocks)
    off_s, L_s = _candidates_lengths(v32, words)
    if level >= 2:
        L_s = _chain_extend(off_s, L_s)
    off_r, L_r = _rle_lengths(blocks)
    use_r = L_r > L_s
    off = torch.where(use_r, off_r, off_s)
    L = torch.where(use_r, L_r, L_s)
    if level >= 2:
        off_t, L_t = _probe_offsets(blocks, _topk_offsets(off_s, L_s))
        use_t = L_t > L
        off = torch.where(use_t, off_t, off)
        L = torch.where(use_t, L_t, L)
    return _parse(off, L, tile, cap=tile)


# ---------------------------------------------------------------------------
# XLA engine: cross-tile merge and emission
# ---------------------------------------------------------------------------


def _merge_tile_chains(take, lit, L_t, off, tile: int):
    """An op ending exactly at a tile end absorbs the next tile's first op
    when the offsets match, transitively through full-tile ops, so a long
    run emits as one copy + repeat pair instead of one per tile."""
    nb, bs = take.shape
    nt = bs // tile
    dev = take.device
    r = torch.arange(bs, device=dev, dtype=_I64) % tile
    rr = r.expand(nb, bs)

    def t3(x):
        return x.reshape(nb, nt, tile)

    def nxt(x, fill):
        return torch.cat([x[:, 1:], torch.full_like(x[:, :1], fill)], dim=1)

    def per_pos(x):   # (nb, nt) -> (nb, bs), broadcast over a tile
        return x[:, :, None].expand(nb, nt, tile).reshape(nb, bs)

    ends_at_end = take & ((r[None, :] + L_t) == tile)
    eoff = torch.where(t3(ends_at_end), t3(off), -1).amax(dim=2)
    epos_r = torch.where(t3(ends_at_end), t3(rr), -1).amax(dim=2)
    op0 = t3(take)[:, :, 0]
    off0 = t3(off)[:, :, 0]
    L0 = t3(L_t)[:, :, 0]
    full = op0 & (L0 == tile)
    prev_eoff = torch.cat([torch.full_like(eoff[:, :1], -1), eoff[:, :-1]], 1)
    a = op0 & (off0 == prev_eoff) & (prev_eoff > 0)
    c = a & full                                   # chain middles

    tt = torch.arange(nt, device=dev, dtype=_I64)[None, :]
    k_term = _rev_cum(torch.where(~c, tt, nt), torch.cummin)
    # packed suffix fill of the terminal tile's absorbed length
    packed = torch.where(~c, ((nt - 1 - tt) << 10)
                         | torch.where(a, torch.clamp(L0, max=1023), 0), -1)
    filled = _rev_cum(packed, torch.cummax)
    L_term = torch.where(filled >= 0, filled & 1023, 0)

    links = nxt(k_term, nt) - (tt + 1)
    W = links * tile + nxt(L_term, 0)
    is_receiver_tile = nxt(a, False) & ~c
    receiver = (ends_at_end & per_pos(is_receiver_tile)
                & (rr == per_pos(epos_r)))
    addW = torch.where(receiver, per_pos(W), 0)
    absorbed = per_pos(a) & (rr == 0)
    return take & ~absorbed, lit, L_t + addW, off


def _tile_out(tile: int) -> int:
    """Per-tile output bound: worst case is one all-literal run (tile + 3
    header bytes), padded as the reference pads it."""
    return tile + 64


def _emit_batched(blocks, take, lit, L_t, off, tile: int):
    """S2 tags per position, routed into (tile + 64)-slot tile buffers
    (seven header and payload planes, plane k k slots right of the
    position's output start) and compacted: (out (nb, nt * (tile + 64))
    uint8, total (nb,) int32)."""
    nb, bs = blocks.shape
    nt = bs // tile
    to = _tile_out(tile)
    dev = blocks.device
    r = (torch.arange(bs, device=dev, dtype=_I64) % tile)[None, :]

    # literal run lengths at run starts (runs are tile-local)
    rr = torch.arange(tile, device=dev, dtype=_I64)
    next_nonlit = _rev_cum(torch.where(~lit.view(nb, nt, tile), rr, tile),
                           torch.cummin, dim=2)
    run_len_full = (next_nonlit - rr).reshape(nb, bs)
    prev_lit = torch.zeros_like(lit)
    prev_lit[:, 1:] = lit[:, :-1]
    lit_start = lit & ~(prev_lit & (r > 0))
    run_len = torch.where(lit_start, run_len_full, 0)

    # header lengths and output byte counts: a match is one copy tag
    # (<= 64) plus one repeat tag for the rest
    lit_hl = torch.where(lit_start, 1 + (run_len > 60).to(_I64)
                         + (run_len > 256).to(_I64), 0)
    l1 = torch.where(L_t >= 68, 64, torch.where(L_t >= 65, L_t - 4, L_t))
    l2 = L_t - l1
    c1 = (off < 2048) & (l1 <= 11)
    p1h = torch.where(c1, 2, 3)
    r_hl = torch.where(l2 == 0, 0, torch.where(
        l2 <= 8, 2, torch.where(l2 <= 263, 3, 4)))
    m_hl = torch.where(take, p1h + r_hl, 0)
    hl = lit_hl + m_hl
    outb = hl + lit.to(_I64)

    outb_t = outb.view(nb, nt, tile)
    ends_t = torch.cumsum(outb_t, dim=2)
    lstart = (ends_t - outb_t).reshape(nb * nt, tile)
    tile_total = ends_t[:, :, -1]
    total = tile_total.sum(dim=1)

    # header byte values (S2 tag encoding)
    x = run_len - 1
    lh0 = torch.where(run_len <= 60, x << 2,
                      torch.where(run_len <= 256, 240, 244))
    mh0 = torch.where(c1, ((off >> 8) << 5) | ((l1 - 4) << 2) | 1,
                      ((l1 - 1) << 2) | 2)
    rb0 = torch.where(l2 <= 8, ((l2 - 4) << 2) | 1,
                      torch.where(l2 <= 263, (5 << 2) | 1, (6 << 2) | 1))
    rb2 = torch.where(l2 <= 263, l2 - 8, (l2 - 260) & 0xFF)
    rb3 = torch.clamp(l2 - 260, min=0) >> 8
    hasr = l2 > 0

    h0 = torch.where(lit_start, lh0, torch.where(take, mh0, 0))
    h1 = torch.where(lit_start & (lit_hl >= 2), x & 0xFF,
                     torch.where(take, off & 0xFF, 0))
    h2 = torch.where(lit_start & (lit_hl >= 3), x >> 8, torch.where(
        take, torch.where(c1, torch.where(hasr, rb0, 0), off >> 8), 0))
    h3 = torch.where(take & hasr, torch.where(c1, 0, rb0), 0)
    h4 = torch.where(take & hasr & c1 & (r_hl >= 3), rb2, 0)
    h5 = torch.where(take & hasr, torch.where(
        c1, torch.where(r_hl >= 4, rb3, 0), torch.where(r_hl >= 3, rb2, 0)),
        0)
    h6 = torch.where(take & hasr & ~c1 & (r_hl >= 4), rb3, 0)

    is_op = lit_start | take
    pay = torch.where(lit, blocks.to(_I64), 0)
    first = lit_start & (hl == 1)
    planes = [
        torch.where(is_op, h0, pay),
        torch.where(hl >= 2, h1, 0) + torch.where(first, pay, 0),
        torch.where(hl >= 3, h2, 0) + torch.where(lit_start & (hl == 2),
                                                  pay, 0),
        torch.where(hl >= 4, h3, 0) + torch.where(lit_start & (hl == 3),
                                                  pay, 0),
        torch.where(hl >= 5, h4, 0),
        torch.where(hl >= 6, h5, 0),
        torch.where(hl >= 7, h6, 0),
    ]
    buf = route_tiles(lstart, [p.reshape(nb * nt, tile) for p in planes],
                      to, accumulate_shifts=len(planes) - 1)

    # tile-major order is the output order: a stable compaction finishes
    w = torch.arange(to, device=dev, dtype=_I64)[None, :]
    valid = (w < tile_total.reshape(nb * nt, 1)).view(nb, nt * to)
    alive, (bytes_,) = compact(valid, [buf.view(nb, nt * to)])
    out = torch.where(alive, bytes_ & 0xFF, 0).to(torch.uint8)
    return out, total.to(_I32)


def s2_encode_blocks(blocks: torch.Tensor, tile: int = TILE,
                     level: int = 1):
    """The XLA engine: (NB, bs) uint8 -> (out (NB, bs / tile * (tile + 64))
    uint8, lens (NB,) int32) on the blocks' device; row i's body is
    out[i, :lens[i]].  level 1 ~ s2.Encode, level 2 ~ s2.EncodeBetter."""
    if blocks.dim() != 2 or blocks.dtype != torch.uint8:
        raise ValueError("s2_encode_blocks: expected (NB, bs) uint8 blocks")
    bs = blocks.shape[1]
    if tile <= 0 or bs % tile or bs % L_CAP or level not in (1, 2):
        raise ValueError(f"s2_encode_blocks: block {bs} must be a multiple "
                         f"of the tile {tile} and of {L_CAP}; level 1 or 2")
    take, lit, L_t, off = _find_parse(blocks, tile, level)
    take, lit, L_t, off = _merge_tile_chains(take, lit, L_t, off, tile)
    return _emit_batched(blocks, take, lit, L_t, off, tile)


def _use_kernel_path(dev: torch.device) -> bool:
    """The kernel path on CUDA unless COMPRESS_TPU_S2_ENGINE=xla (read at
    call time, as the reference reads it); the XLA engine elsewhere."""
    if os.environ.get("COMPRESS_TPU_S2_ENGINE") == "xla":
        return False
    return dev.type == "cuda"


def encode_blocks_np(data: bytes, device=None) -> list[bytes]:
    """Encode ``data`` (a multiple of 64 KiB) block by block, in launches
    of at most MAX_LAUNCH_BLOCKS blocks.

    Runs on CUDA unless ``device`` names another device, and raises when
    no card is present and no device was given.  The engine follows the
    device as the reference's follows the platform: the kernel path on
    CUDA, the XLA engine (``s2_encode_blocks`` at level 1) on the CPU.  A
    kernel path that fails raises; it is not retried on the XLA engine."""
    dev = resolve_device(device)
    n = len(data)
    if n == 0 or n % B:
        raise ValueError(f"input length {n} is not a positive multiple of {B}")
    arr = torch.frombuffer(bytearray(data), dtype=torch.uint8).view(-1, B)
    use_kern = _use_kernel_path(dev)
    bodies = []
    for c in range(0, arr.shape[0], MAX_LAUNCH_BLOCKS):
        chunk = arr[c:c + MAX_LAUNCH_BLOCKS].to(dev)
        if use_kern:
            bodies += s2_encode_blocks_kern(chunk)
            continue
        out, lens = s2_encode_blocks(chunk)
        out, lens = out.cpu().numpy(), lens.cpu().tolist()
        bodies += [out[i, :lens[i]].tobytes() for i in range(len(lens))]
    return bodies
