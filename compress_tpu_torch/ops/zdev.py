"""The device zstd encoder's v1 engine and the entropy-stage helpers the
v2 encoder shares with it (counterpart of the JAX package's
``ops/zdev.py``).

``zstd_encode_jobs`` is the v1 engine (the reference's XLA-graph
pipeline): a job of ``JOB`` bytes (1 MiB) with its overlap prefix goes
through the S2 XLA engine's finder (``ops/lz2``: sort candidates, chain
extension, run and top-K offset probes, deeper by ``level``) and its tile
parse, and comes out as ``BLOCK``-byte (16 KiB) zstd blocks: sequences
with repeat codes (``zseqenc.rep_scan``), huff0 4-stream literal halves
with a Huffman table per block, and FSE sequence-stream halves over FSE
tables of logs 9/8/9 per job (``fse_scan``, the 3-stream state chain).

Plain PyTorch on whatever device the tensors are on, but for the serial
scans: ``lz2.tile_parse``, ``zseqenc.rep_scan``, ``fse_scan`` and the two
per-row table builds, ``_huff_build`` (the Huffman code lengths, also of
the v2 literal stage and the huff0 encoder) and ``_normalize_count`` (the
FSE normalised counts, also of the v2 codes stage and the FSE batch
encoder), launch their CUDA kernels on CUDA tensors and run their plain
versions on CPU tensors.  The reference runs table lookups, routing and
compaction as one-hot matmuls and its scans as ``lax.scan``; here they
are gathers, integer scatters, prefix sums and short Python loops, with
the same integer results.  Every sort that the reference's outputs depend on for
tie order is a stable ``torch.sort``.
"""

from __future__ import annotations

import numpy as np
import torch

from compress_tpu_torch import _cuda
from compress_tpu_torch.ops import lz2, zseqenc
from compress_tpu_torch.ops.common import (compact, floor_log2, route_tiles,
                                           wrap32)
from compress_tpu_torch.utils.histogram import byte_histograms

JOB = 1 << 20          # device job (window) size
BLOCK = 1 << 14        # zstd block size -> 64 blocks a job
TILE = 512
MINMATCH = 6           # parse-time minimum match (cost model floor)
# bit-pack capacities (halves = 16-bit units)
LIT_TO = 384           # per 512-item tile: <= 512 * 11 bits = 352 halves
SEQ_TO = 384           # per 256-item tile: <= ~85 seqs * 69 bits
FSE_LOGS = (9, 8, 9)   # ll, of, ml accuracy logs (RFC max 9/8/9)

NSYM = 64              # padded symbol alphabet (ll 36, of <= 32, ml 53)
FSE_SZ = 512           # padded state-table size (1 << max log)

_I32 = torch.int32
_I64 = torch.int64

# ll/ml small-code tables (zstd/seqs.py ll_code/ml_code, device form)
_LL_SMALL = np.array(
    [0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15,
     16, 16, 17, 17, 18, 18, 19, 19, 20, 20, 20, 20, 21, 21, 21, 21,
     22, 22, 22, 22, 22, 22, 22, 22, 23, 23, 23, 23, 23, 23, 23, 23] +
    [24] * 16, np.int64)
_ML_SMALL = np.array(
    list(range(32)) +
    [32, 32, 33, 33, 34, 34, 35, 35, 36, 36, 36, 36, 37, 37, 37, 37,
     38, 38, 38, 38, 38, 38, 38, 38, 39, 39, 39, 39, 39, 39, 39, 39],
    np.int64)


def _maxseq(block: int) -> int:
    """Hard bound on sequences per block (matches are >= MINMATCH long)."""
    return block // MINMATCH + 1


def _lut(table, idx: torch.Tensor) -> torch.Tensor:
    """table[idx] as int32, 0 where idx is out of range (as a one-hot
    lookup gives)."""
    if isinstance(table, torch.Tensor):
        t = table.to(device=idx.device, dtype=_I64)
    else:
        t = torch.as_tensor(np.asarray(table, np.int64), device=idx.device)
    n = t.shape[0]
    i = idx.to(_I64)
    ok = (i >= 0) & (i < n)
    return torch.where(ok, t[i.clamp(0, n - 1)], 0).to(_I32)


def _ll_code(ll: torch.Tensor) -> torch.Tensor:
    small = _lut(_LL_SMALL, torch.clamp(ll, max=63))
    return torch.where(ll >= 64, floor_log2(torch.clamp(ll, min=1)) + 19,
                       small).to(_I32)


def _ml_code(ml: torch.Tensor) -> torch.Tensor:
    v = ml - 3
    small = _lut(_ML_SMALL, torch.clamp(v, max=63))
    mid = torch.where(v < 80, 40, torch.where(v < 96, 41, 42))
    big = floor_log2(torch.clamp(v, min=1)) + 36
    return torch.where(v < 64, small, torch.where(v >= 128, big, mid)).to(_I32)


def _of_code(ofval: torch.Tensor) -> torch.Tensor:
    # the port's floor_log2 is exact for every value; the reference's
    # float one returns one too many from 2,097,150 (2^21 - 2) on, past
    # v1's largest offset value (job + prefix + 3 = 1,179,651)
    return floor_log2(torch.clamp(ofval, min=1)).to(_I32)


def _unsort(order: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Inverse of gathering ``values`` by ``order`` along dim 1."""
    return torch.empty_like(values).scatter_(1, order, values)


def _shl(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_left_shift(x, torch.clamp(s, min=0))


def _huff_build_ref(hist: torch.Tensor, maxlog: int = 11):
    """Plain version of ``_huff_build``: hist (J, 256) -> (nbits (J, 256)
    int32, max_bits (J,), ok (J,)).

    Code lengths l0 = ceil(log2(total / h)) clipped to [1, maxlog]; the
    Kraft deficit is spent, 12 times, by a greedy pass over the symbols
    in descending hist << l order that shortens a code by one level where
    its cost 2^(maxlog - l) still fits."""
    dev = hist.device
    h64 = hist.to(_I64)
    total = h64.sum(dim=1, keepdim=True)
    present = h64 > 0
    nz = present.sum(dim=1)
    h = torch.clamp(h64, min=1)
    ratio = (total + h - 1) // h
    l0 = torch.where(ratio > 1, floor_log2(torch.clamp(ratio - 1, min=1)) + 1,
                     1)
    l0 = torch.where(present, torch.clamp(l0, 1, maxlog), 0)
    one = torch.ones_like(l0)
    kraft = torch.where(present, _shl(one, maxlog - l0), 0).sum(dim=1)
    d = (1 << maxlog) - kraft
    ls = l0
    for _ in range(12):
        elig = (ls > 1) & present
        score = torch.where(elig, -_shl(h64, torch.clamp(ls, 0, maxlog)), 1)
        order = torch.sort(score, dim=1, stable=True).indices
        l_s = torch.gather(ls, 1, order)
        # only the eligible prefix can take a step: every other symbol costs
        # 2^30, more than any deficit (< 2^maxlog)
        n_elig = int(elig.sum(dim=1).max()) if ls.numel() else 0
        cols = []
        for i in range(n_elig):
            lcol = l_s[:, i]
            cost = torch.where(lcol > 1, _shl(torch.ones_like(lcol),
                                              maxlog - lcol), 1 << 30)
            take = cost <= d
            d = d - torch.where(take, cost, 0)
            cols.append(lcol - take.to(_I64))
        if cols:
            l_s = torch.cat([torch.stack(cols, dim=1), l_s[:, n_elig:]], dim=1)
        ls = _unsort(order, l_s)
    ok = (d == 0) & (nz >= 2)
    max_bits = ls.amax(dim=1) if ls.shape[1] else torch.zeros(
        ls.shape[0], dtype=_I64, device=dev)
    return ls.to(_I32), max_bits.to(_I32), ok


# the count dtypes the table-build kernels read, and their codes in the C
# entries
_COUNT_KINDS = {torch.int32: 3, torch.int64: 4}


def _table_input(hist: torch.Tensor, stats, what: str):
    """Check a table build's CUDA input; return its kind code."""
    if hist.device.type != "cuda":
        raise ValueError(f"{what}: expected a CUDA tensor, got {hist.device}")
    kind = _COUNT_KINDS.get(hist.dtype)
    if hist.dim() != 2 or kind is None:
        raise ValueError(f"{what}: expected (rows, symbols) int32 or int64 "
                         f"counts, got {tuple(hist.shape)} {hist.dtype}")
    if stats is not None:
        _cuda.require_cuda_input(stats, f"{what}: stats", _I64,
                                 (hist.shape[0], 2))
        if stats.device != hist.device:
            raise ValueError(f"{what}: stats on another device")
    return kind


def _huff_build(hist: torch.Tensor, maxlog: int = 11, *, stats=None):
    """hist (J, 256) counts -> (nbits (J, 256) int32, max_bits (J,) int32,
    ok (J,) bool): Huffman code lengths limited to ``maxlog`` bits.

    Code lengths l0 = ceil(log2(total / h)) clipped to [1, maxlog]; the
    Kraft deficit is spent, 12 times, by a greedy pass over the symbols
    in descending hist << l order that shortens a code by one level where
    its cost 2^(maxlog - l) still fits; ok where the deficit is spent
    and at least two symbols are present.  A CUDA tensor (int32 or int64
    counts, maxlog 1..15) goes through the kernel (``csrc/tablebuild.cu``:
    one launch, no host sync; a CTA a row ranks the symbols by warp-sorted
    runs and binary searches, and one thread walks their cost exponents
    32 at a time from registers, stopping at the end of the chunk where
    the deficit is 0), a CPU tensor through ``_huff_build_ref``.
    ``stats``, a (J, 2) int64 CUDA tensor, gets each row's walk steps and
    the SM cycles its walks took."""
    if hist.device.type == "cpu":
        return _huff_build_ref(hist, maxlog)
    kind = _table_input(hist, stats, "_huff_build")
    if hist.shape[1] != 256:
        raise ValueError(f"_huff_build: expected 256 symbols a row, got "
                         f"{hist.shape[1]}")
    if not 1 <= maxlog <= 15:
        raise ValueError(f"_huff_build: maxlog {maxlog} outside 1..15")
    dev = hist.device
    J = hist.shape[0]
    h = hist.contiguous()
    nbits = torch.empty((J, 256), dtype=_I32, device=dev)
    max_bits = torch.empty(J, dtype=_I32, device=dev)
    ok = torch.empty(J, dtype=torch.bool, device=dev)
    if J == 0:
        return nbits, max_bits, ok
    with torch.cuda.device(dev):
        rc = _cuda.library().ct_huff_build(
            h.data_ptr(), kind, J, maxlog, nbits.data_ptr(),
            max_bits.data_ptr(), ok.data_ptr(),
            None if stats is None else stats.data_ptr(), _cuda.stream(dev))
    _cuda.check(rc, "_huff_build")
    _huff_build.launches += 1
    return nbits, max_bits, ok


_huff_build.launches = 0


def _canonical_codes_dev(nbits: torch.Tensor, max_bits: torch.Tensor):
    """Canonical codes in the RFC decode layout: codes assigned by nbits
    descending, natural symbol order within a length."""
    nb = nbits.to(_I64)
    mb = max_bits.to(_I64)[:, None]
    present = nb > 0
    sh = mb - torch.clamp(nb, min=1)
    span = torch.where(present, _shl(torch.ones_like(nb), sh), 0)
    sym = torch.arange(nb.shape[1], device=nb.device, dtype=_I64)[None, :]
    key = torch.where(present, ((12 - nb) << 9) + sym, 1 << 22)
    order = torch.sort(key, dim=1, stable=True).indices
    span_s = torch.gather(span, 1, order)
    start = _unsort(order, torch.cumsum(span_s, dim=1) - span_s)
    code = torch.where(present, start >> torch.clamp(sh, min=0), 0)
    return code.to(_I32)


def _bitpack_rows(values, nbits, dest_bit, to: int, region_end, T: int,
                  max_item_bits: int = 26):
    """Pack (R, I) items (value, nbits, dest_bit), dest_bit non-decreasing
    per row, into little-endian 16-bit halves.

    Each T-item tile sums its items' <= 3 halves into ``to`` tile-local
    slots from the tile's first half; a half shared with the previous
    tile's last half is folded into slot 0; live tile t keeps the halves
    up to the next live tile's first (the last live tile up to
    ``region_end``, gap and slack halves staying 0); the kept slots are
    compacted to the row front.  Returns (halves (R, ntiles * to) int32,
    n_halves (R,) int32), the reference's exact arrays."""
    R, I = values.shape
    nt = I // T
    v = values.to(_I64) & 0xFFFFFFFF
    db = dest_bit.to(_I64)
    s = db & 15
    hidx = db >> 4
    live = nbits > 0
    planes = [(v << s) & 0xFFFF, (v >> (16 - s)) & 0xFFFF]
    if max_item_bits > 17:
        planes.append(torch.where(s > 0, (v >> (32 - torch.clamp(s, min=1)))
                                  & 0xFFFF, 0))
    planes = [torch.where(live, p, 0).view(R * nt, T) for p in planes]

    h3 = hidx.view(R, nt, T)
    tb = h3[:, :, 0]
    d0 = torch.clamp(h3 - tb[:, :, None], 0, to - 3).view(R * nt, T)
    buf = route_tiles(d0, planes, to,
                      accumulate_shifts=len(planes) - 1).view(R, nt, to)

    end_bit = db + torch.clamp(nbits.to(_I64), min=1) - 1
    maxh = torch.where(live, end_bit >> 4, -1).view(R, nt, T).amax(dim=2)
    tile_alive = live.view(R, nt, T).any(dim=2)
    maxlocal = torch.clamp(torch.where(tile_alive, maxh - tb, -1), -1, to - 1)

    if nt > 1:
        sh = tile_alive[:, :-1] & tile_alive[:, 1:] & (tb[:, 1:] == maxh[:, :-1])
        idx = torch.clamp(maxlocal[:, :-1], 0, to - 1)
        seam = torch.gather(buf[:, :-1], 2, idx[:, :, None])[:, :, 0]
        buf[:, 1:, 0] += torch.where(sh, seam, 0)

    region_end = region_end.to(_I64)
    if nt > 1:
        nxt_live = torch.cat([tile_alive[:, 1:],
                              torch.zeros_like(tile_alive[:, :1])], dim=1)
        nxt_tb = torch.cat([tb[:, 1:], torch.zeros_like(tb[:, :1])], dim=1)
        ub = torch.where(nxt_live, nxt_tb - 1, region_end[:, None] - 1)
    else:
        ub = region_end[:, None] - 1
    ub_local = torch.clamp(ub - tb, -1, to - 1)
    w = torch.arange(to, device=values.device)[None, None, :]
    valid = tile_alive[:, :, None] & (w <= ub_local[:, :, None])
    alive, (halves,) = compact(valid.view(R, nt * to), [buf.view(R, nt * to)])
    n_halves = alive.sum(dim=1)
    return torch.where(alive, halves, 0).to(_I32), n_halves.to(_I32)


def _normalize_count_ref(hist: torch.Tensor, log: int) -> torch.Tensor:
    """Plain version of ``_normalize_count``: (N, NSYM) counts ->
    normalized counts summing to exactly 2^log, every present symbol >= 1:
    floor shares, the surplus to the largest remainders, a deficit stolen
    from the largest counts in turn."""
    size = 1 << log
    h = hist.to(_I64)
    total = torch.clamp(h.sum(dim=1, keepdim=True), min=1)
    present = h > 0
    scaled = h * size
    base = scaled // total
    rem = scaled % total
    norm = torch.where(present, torch.clamp(base, min=1), 0)
    diff = size - norm.sum(dim=1)
    iota = torch.arange(h.shape[1], device=h.device, dtype=_I64)
    iota = iota.expand_as(h).contiguous()

    key = torch.where(present, -rem, 1 << 30)
    rank = _unsort(torch.sort(key, dim=1, stable=True).indices, iota)
    norm = norm + (present & (rank < torch.clamp(diff, min=0)[:, None])).to(_I64)

    deficit = torch.clamp(-diff, min=0)
    if int(deficit.max()) > 0:
        order = torch.sort(-norm, dim=1, stable=True).indices
        norm_s = torch.gather(norm, 1, order)
        d = deficit
        cols = []
        for i in range(h.shape[1]):
            col = norm_s[:, i]
            take = torch.minimum(torch.clamp(col - 1, min=0), d)
            d = d - take
            cols.append(col - take)
        norm2 = _unsort(order, torch.stack(cols, dim=1))
        norm = torch.where(deficit[:, None] > 0, norm2, norm)
    return norm.to(_I32)


def _normalize_count(hist: torch.Tensor, log: int, *,
                     stats=None) -> torch.Tensor:
    """(N, NSYM) counts -> (N, NSYM) int32 normalized counts summing to
    exactly 2^log, every present symbol >= 1: floor shares, the surplus to
    the largest remainders, a deficit stolen from the largest counts in
    turn (the lower symbol first on ties, as a stable sort gives).

    A CUDA tensor (int32 or int64 counts, NSYM 1..1024, log 1..30) goes
    through the kernel (``csrc/tablebuild.cu``: one launch, no host sync;
    a CTA a row, the surplus by the ranks of warp-sorted runs, the deficit
    by an exclusive scan of what each count has above 1 in rank order,
    which gives every take of the serial walk at once), a CPU tensor
    through ``_normalize_count_ref``.  ``stats``, an (N, 2) int64 CUDA
    tensor, gets each row's deficit-walk steps (those the serial walk
    would take) and the SM cycles of its scan (0 where a row has no
    deficit)."""
    if hist.device.type == "cpu":
        return _normalize_count_ref(hist, log)
    kind = _table_input(hist, stats, "_normalize_count")
    N, nsym = hist.shape
    if not 1 <= nsym <= 1024 or not 1 <= log <= 30:
        raise ValueError(f"_normalize_count: NSYM {nsym} outside 1..1024 or "
                         f"log {log} outside 1..30")
    dev = hist.device
    h = hist.contiguous()
    norm = torch.empty((N, nsym), dtype=_I32, device=dev)
    if N == 0:
        return norm
    with torch.cuda.device(dev):
        rc = _cuda.library().ct_normalize_count(
            h.data_ptr(), kind, N, nsym, log, norm.data_ptr(),
            None if stats is None else stats.data_ptr(), _cuda.stream(dev))
    _cuda.check(rc, "_normalize_count")
    _normalize_count.launches += 1
    return norm


_normalize_count.launches = 0


def _first_argmax(x: torch.Tensor) -> torch.Tensor:
    """argmax along dim 1, the first index on ties."""
    idx = torch.arange(x.shape[1], device=x.device)[None, :]
    hit = x == x.amax(dim=1, keepdim=True)
    return torch.where(hit, idx, x.shape[1]).amin(dim=1)


def _fse_build(codes: torch.Tensor, is_seq: torch.Tensor, nj: int, log: int):
    """Encode tables for one code kind, shared by the nj groups of R // nj
    rows: dict of st (nj, FSE_SZ), dnb, dfs, norm (nj, NSYM), log (nj,),
    rle (nj,), rle_sym (nj,)."""
    R, _ = codes.shape
    dev = codes.device
    size = 1 << log
    c = codes.to(_I64)
    inr = is_seq & (c >= 0) & (c < NSYM)
    hist = torch.zeros((R, NSYM), dtype=_I64, device=dev)
    hist.scatter_add_(1, torch.clamp(c, 0, NSYM - 1), inr.to(_I64))
    hist = hist.view(nj, R // nj, NSYM).sum(dim=1)
    rle = (hist > 0).sum(dim=1) <= 1
    rle_sym = _first_argmax(hist)

    norm = _normalize_count(hist, log).to(_I64)
    cumul = torch.cumsum(norm, dim=1) - norm
    cum_incl = cumul + norm
    kk = torch.arange(size, device=dev, dtype=_I64)
    step = (size >> 1) + (size >> 3) + 3
    pk = ((kk * step) % size).expand(nj, size)
    sym_of_k = (kk[None, :, None] >= cum_incl[:, None, :]).sum(dim=2)
    spread = route_tiles(pk, [sym_of_k], size)[:, 0]
    # rank of slot u among its symbol's slots, and that symbol's cumul
    oh = spread[:, :, None] == torch.arange(NSYM, device=dev)
    oh = oh.to(_I64)
    r_u = (oh * (torch.cumsum(oh, dim=1) - oh)).sum(dim=2)
    cumul_of_u = (oh * cumul[:, None, :]).sum(dim=2)
    dest = torch.clamp(cumul_of_u + r_u, 0, size - 1)
    state_table = route_tiles(dest, [(size + kk).expand(nj, size)], size)[:, 0]
    if size < FSE_SZ:
        state_table = torch.nn.functional.pad(state_table,
                                              (0, FSE_SZ - size))
    maxbits = log - floor_log2(torch.clamp(norm - 1, min=1))
    delta_nb = torch.where(norm > 1, (maxbits << 16) - _shl(norm, maxbits),
                           (log << 16) - size)
    delta_fs = cumul - norm
    log_arr = torch.where(rle, 0, log).to(_I32)
    return dict(st=state_table.to(_I32), dnb=delta_nb.to(_I32),
                dfs=delta_fs.to(_I32), norm=norm.to(_I32), log=log_arr,
                rle=rle, rle_sym=rle_sym.to(_I32))


# ---------------------------------------------------------------------------
# v1 engine: FSE state chain over per-job tables
# ---------------------------------------------------------------------------


def _lut64(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """table[..., idx] over the last axis of NSYM entries, 0 where idx is
    outside [0, NSYM) (as the reference's one-hot lookup gives)."""
    ok = (idx >= 0) & (idx < NSYM)
    got = torch.gather(table, -1, torch.clamp(idx, 0, NSYM - 1)[..., None])
    return torch.where(ok, got[..., 0], 0)


def fse_scan_ref(syms, n_seqs, st, dnb, dfs, logs, rle):
    """Plain PyTorch 3-stream FSE state chain, all blocks in step, walked
    backward from each block's sequence n_seqs - 1; int32 arithmetic as
    the reference's.  Arguments and results as ``fse_scan``."""
    R, _, MS = syms.shape
    dev = syms.device
    nj = st.shape[0]
    job = torch.arange(R, device=dev) // (R // nj)
    st_t, dnb_t, dfs_t = st[job], dnb[job], dfs[job]
    rle_t = rle[job].to(torch.bool)
    one = torch.ones((), dtype=_I32, device=dev)
    sizes = torch.where(rle_t, one, torch.bitwise_left_shift(
        one, torch.where(rle_t, 0, logs[job])))
    n = n_seqs.to(_I32)[:, None]                         # (R, 1)

    def lu512(lu):
        return torch.gather(st_t, 2, lu.to(_I64)[..., None])[..., 0]

    last = torch.clamp(n - 1, min=0).to(_I64)
    sym_last = torch.where(last < MS, torch.gather(
        syms, 2, torch.clamp(last, max=MS - 1)[:, :, None].expand(R, 3, 1))
        [..., 0], 0)
    dnb0, dfs0 = _lut64(dnb_t, sym_last), _lut64(dfs_t, sym_last)
    nb0 = (dnb0 + (1 << 15)) >> 16
    im = (nb0 << 16) - dnb0
    lu0 = torch.clamp((im >> torch.clamp(nb0, 0, 16)) + dfs0, 0, FSE_SZ - 1)
    st_init = torch.where(rle_t, 0, lu512(lu0) - sizes)

    st_cur = torch.zeros((R, 3), dtype=_I32, device=dev)
    val = torch.zeros((R, 3, MS), dtype=_I32, device=dev)
    nbs = torch.zeros((R, 3, MS), dtype=_I32, device=dev)
    top = min(int(n_seqs.max()) if R else 0, MS)
    for i in range(top - 1, -1, -1):
        is_init = n == i + 1
        is_live = n > i + 1
        sym = syms[:, :, i]
        d_nb, d_fs = _lut64(dnb_t, sym), _lut64(dfs_t, sym)
        x = st_cur + sizes
        nb = (x + d_nb) >> 16
        nbc = torch.clamp(nb, 0, 16)
        v = x & (torch.bitwise_left_shift(one, nbc) - 1)
        lu = torch.clamp((x >> nbc) + d_fs, 0, FSE_SZ - 1)
        st_enc = torch.where(rle_t, 0, lu512(lu) - sizes)
        st_cur = torch.where(is_init, st_init,
                             torch.where(is_live, st_enc, st_cur))
        emit = is_live & ~rle_t
        val[:, :, MS - 1 - i] = torch.where(emit, v, 0)
        nbs[:, :, MS - 1 - i] = torch.where(emit, nb, 0)
    return val, nbs, st_cur


def fse_scan(syms, n_seqs, st, dnb, dfs, logs, rle, *,
             routes: torch.Tensor | None = None):
    """Backward 3-stream FSE encode state chain over per-job tables.

    syms: (R, 3, MS) int32 ll / of / ml codes; n_seqs (R,) int32; the
    tables of nj jobs (R a multiple of nj, block r in job r // (R // nj)):
    st (nj, 3, FSE_SZ), dnb and dfs (nj, 3, NSYM), logs (nj, 3) int32 and
    rle (nj, 3) bool (an RLE stream has size 1, emits nothing and keeps
    state 0).  Returns (val, nb) (R, 3, MS) int32 in write order, the
    reference's layout: entry k is the state write of sequence MS - 1 - k
    (0 for sequences n_seqs - 1 and later), and the final states (R, 3)
    int32.  The CUDA kernel (``csrc/zdevfse.cu``, one launch: each job's
    compact next-state tables checked per symbol, a one-load step through
    the chunks whose symbols pass, the exact step through the others) on
    CUDA tensors, ``fse_scan_ref`` on CPU tensors.  ``routes``, a (2,)
    int32 CUDA tensor, gets the kernel's count of (block, stream) rows
    walked wholly on the one-load step and of rows with a chunk on the
    exact step added to it."""
    if syms.dim() != 3 or syms.shape[1] != 3 or st.dim() != 3:
        raise ValueError("fse_scan: expected (R, 3, MS) codes and "
                         "(nj, 3, FSE_SZ) tables")
    R, _, MS = syms.shape
    nj = st.shape[0]
    shapes = {"n_seqs": (R,), "st": (nj, 3, FSE_SZ), "dnb": (nj, 3, NSYM),
              "dfs": (nj, 3, NSYM), "logs": (nj, 3), "rle": (nj, 3)}
    args = {"n_seqs": n_seqs, "st": st, "dnb": dnb, "dfs": dfs,
            "logs": logs, "rle": rle}
    if nj <= 0 or R % nj or any(tuple(args[k].shape) != v
                                for k, v in shapes.items()):
        raise ValueError(f"fse_scan: expected shapes {shapes} with R = {R} "
                         f"a multiple of nj = {nj}")
    if any(t.device != syms.device for t in args.values()):
        raise ValueError("fse_scan: inputs on different devices")
    dev = syms.device
    if dev.type == "cpu":
        return fse_scan_ref(syms, n_seqs, st, dnb, dfs, logs, rle)
    _cuda.require_cuda_input(syms, "syms", _I32, (R, 3, MS))
    for k, v in shapes.items():
        _cuda.require_cuda_input(args[k], k, torch.bool if k == "rle"
                                 else _I32, v)
    if routes is not None:
        _cuda.require_cuda_input(routes, "fse_scan: routes", _I32, (2,))
        if routes.device != dev:
            raise ValueError("fse_scan: routes on another device")
    buf = torch.empty(2 * R * 3 * MS + 3 * R, dtype=_I32, device=dev)
    p = buf.data_ptr()
    with torch.cuda.device(dev):
        rc = _cuda.library().ct_zdev_fse(
            syms.data_ptr(), n_seqs.data_ptr(), st.data_ptr(),
            dnb.data_ptr(), dfs.data_ptr(), logs.data_ptr(), rle.data_ptr(),
            R, MS, nj, p, p + 4 * R * 3 * MS, p + 8 * R * 3 * MS,
            None if routes is None else routes.data_ptr(), _cuda.stream(dev))
    _cuda.check(rc, "fse_scan")
    fse_scan.launches += 1
    val, nb = buf[:2 * R * 3 * MS].view(2, R, 3, MS)
    return val, nb, buf[2 * R * 3 * MS:].view(R, 3)


fse_scan.launches = 0


def _fse_scan(ll_c, of_c, ml_c, n_seqs, tabs):
    """The reference's ``_fse_scan``: per-sequence state writes (value,
    nbits) of the 3 streams, the final states and each block's logs
    (R, 3), from the three ``_fse_build`` dicts (ll, of, ml)."""
    R = ll_c.shape[0]
    nj = tabs[0]["st"].shape[0]
    syms = torch.stack([ll_c, of_c, ml_c], dim=1).to(_I32).contiguous()
    st = torch.stack([t["st"] for t in tabs], dim=1).contiguous()
    dnb = torch.stack([t["dnb"] for t in tabs], dim=1).contiguous()
    dfs = torch.stack([t["dfs"] for t in tabs], dim=1).contiguous()
    logs = torch.stack([t["log"] for t in tabs], dim=1).contiguous()
    rle = torch.stack([t["rle"] for t in tabs], dim=1).contiguous()
    st_val, st_nb, st_fin = fse_scan(syms, n_seqs.to(_I32).contiguous(), st,
                                     dnb, dfs, logs, rle)
    return st_val, st_nb, st_fin, logs.repeat_interleave(R // nj, dim=0)


# ---------------------------------------------------------------------------
# v1 engine: the main device encoder
# ---------------------------------------------------------------------------


def _find_parse_jobs(full, has_prefix, pre: int, job: int, tile: int,
                     level: int):
    """LZ find (deeper by level), the zstd cost gate, the prefix rule and
    the tile parse of each job: (take, lit, L_t, off) (nj, job)."""
    v32, words = lz2._values(full)
    off_s, L_s = lz2._candidates_lengths(v32, words)
    if level >= 2:
        L_s = lz2._chain_extend(off_s, L_s)
    off_r, L_r = lz2._rle_lengths(full)
    use_r = L_r > L_s
    off = torch.where(use_r, off_r, off_s)
    L = torch.where(use_r, L_r, L_s)
    if level >= 2:
        off_t, L_t = lz2._probe_offsets(full, lz2._topk_offsets(off_s, L_s))
        use_t = L_t > L
        off = torch.where(use_t, off_t, off)
        L = torch.where(use_t, L_t, L)
    if level >= 3:
        # a second probe round over offsets popular among the positions
        # the first round left short
        resid = torch.where(L < 8, off_s, 0)
        off_t2, L_t2 = lz2._probe_offsets(full,
                                          lz2._topk_offsets(resid, L_s))
        use2 = L_t2 > L
        off = torch.where(use2, off_t2, off)
        L = torch.where(use2, L_t2, L)
    # a sequence costs ~2.5-3 bytes: short matches are net losses
    min_l = MINMATCH + (off >= 1024).to(_I64) + (off >= 65536).to(_I64)
    L = torch.where(L >= min_l, L, 0)
    if pre:
        # drop matches reaching into a prefix that is not real history
        p = torch.arange(full.shape[1], device=full.device, dtype=_I64)
        L = torch.where(~has_prefix[:, None] & (off > p - pre), 0, L)
        off, L = off[:, pre:], L[:, pre:]
    return lz2._parse(off, L, tile, cap=tile)


def zstd_encode_jobs(jobs, job: int = JOB, block: int = BLOCK,
                     tile: int = TILE, debug: bool = False, prefixes=None,
                     has_prefix=None, level: int = 2):
    """jobs: (NJ, job) uint8 -> dict of tensors on the jobs' device for
    the host assembly (``zstd/device.py``), the reference's keys and
    values.

    prefixes: optional (NJ, PRE) uint8 overlap history (the previous job's
    tail); matches may reach into it, nothing is emitted for it.
    has_prefix: (NJ,) bool; a job without real history must not match
    into its zero-filled prefix.  level 1 = nearest sort candidates only;
    2 = + chain extension and top-K offset probing; 3 = + a second probe
    round.  Sizes are non-increasing in level."""
    if jobs.dim() != 2 or jobs.shape[1] != job or jobs.dtype != torch.uint8:
        raise ValueError(f"zstd_encode_jobs: expected (NJ, {job}) uint8 jobs")
    if job % block or block % tile or level not in (1, 2, 3):
        raise ValueError(f"zstd_encode_jobs: job {job} must be a multiple "
                         f"of the block {block}, the block of the tile "
                         f"{tile}; level 1-3")
    # imported here: the zstd package imports this module (through fse)
    from compress_tpu_torch.zstd import seqs as S

    dev = jobs.device
    nj = jobs.shape[0]
    nblk = job // block
    maxseq = _maxseq(block)
    R = nj * nblk
    pre = 0 if prefixes is None else prefixes.shape[1]
    if pre % tile:
        raise ValueError(f"zstd_encode_jobs: prefix {pre} is not a multiple "
                         f"of the tile {tile}")
    if prefixes is not None:
        full = torch.cat([prefixes, jobs], dim=1)
        if has_prefix is None:
            has_prefix = torch.ones(nj, dtype=torch.bool, device=dev)
    else:
        full = jobs
        has_prefix = torch.zeros(nj, dtype=torch.bool, device=dev)

    # ---- LZ find + parse ---------------------------------------------------
    take, lit, L_t, off = _find_parse_jobs(full, has_prefix.to(torch.bool),
                                           pre, job, tile, level)

    # ---- per-block sequence fields ----------------------------------------
    pos_in_blk = (torch.arange(job, device=dev, dtype=_I64) % block)[None, :]
    end_mark = torch.where(take, pos_in_blk + L_t, -1).view(nj, nblk, block)
    prev_end = torch.cummax(end_mark, dim=2).values
    prev_end_excl = torch.cat([torch.full_like(prev_end[:, :, :1], -1),
                               prev_end[:, :, :-1]], dim=2)
    prev_end_excl = torch.clamp(prev_end_excl, min=0).view(nj, job)
    ll = torch.where(take, pos_in_blk - prev_end_excl, 0)
    ofval = torch.where(take, off, 0)    # raw offsets; repeat codes below

    take_b = take.view(R, block)
    n_seqs = take_b.sum(dim=1)
    lm = (ll << 10) | L_t
    _, (lm_c, of_c_) = compact(take_b, [lm.view(R, block),
                                        ofval.view(R, block)])
    ll_v = lm_c[:, :maxseq] >> 10
    ml_v = lm_c[:, :maxseq] & 1023
    of_v = of_c_[:, :maxseq]

    # ---- literals: compaction + histogram ---------------------------------
    lit_b = lit.view(R, block)
    byte_b = jobs.reshape(R, block).to(_I64)
    lit_cnt = lit_b.sum(dim=1)
    _, (lits,) = compact(lit_b, [torch.where(lit_b, byte_b, 0)])
    hist = byte_histograms(jobs.reshape(R, block), lit_b).to(_I64)

    nbits_t, max_bits, huff_ok = _huff_build(hist)       # per block
    codes_t = _canonical_codes_dev(nbits_t, max_bits)

    # ---- per-literal code lookup ------------------------------------------
    idx = torch.arange(block, device=dev, dtype=_I64)[None, :]
    is_lit = idx < lit_cnt[:, None]
    lcode = torch.where(is_lit, torch.gather(codes_t.to(_I64), 1, lits), 0)
    lnb = torch.where(is_lit, torch.gather(nbits_t.to(_I64), 1, lits), 0)

    # ---- stream split + bit destinations (device layout: streams 4..1) ----
    seg = (lit_cnt[:, None] + 3) >> 2                    # quarter size
    q = torch.clamp(idx // torch.clamp(seg, min=1), 0, 3)
    cs = torch.cumsum(lnb, dim=1)                        # inclusive
    bq = torch.zeros((R, 4), dtype=_I64, device=dev).scatter_add_(1, q, lnb)
    prev_bits = torch.cumsum(bq, dim=1) - bq
    c_in_q = cs - torch.gather(prev_bits, 1, q)
    sh = (bq + 16) >> 4                                  # (R, 4)
    sbase = torch.stack([sh[:, 1] + sh[:, 2] + sh[:, 3], sh[:, 2] + sh[:, 3],
                         sh[:, 3], torch.zeros_like(sh[:, 0])], dim=1)
    dest_bit = 16 * torch.gather(sbase, 1, q) + (torch.gather(bq, 1, q)
                                                 - c_in_q)
    dest_bit = torch.where(is_lit, dest_bit, 0)
    # flip to ascending order for the bit-pack
    lit_halves, lit_nh = _bitpack_rows(
        torch.flip(lcode, [1]), torch.flip(lnb, [1]),
        torch.flip(dest_bit, [1]), LIT_TO, sbase[:, 0] + sh[:, 0], T=512)

    # ---- sequence codes + extras ------------------------------------------
    si = torch.arange(maxseq, device=dev, dtype=_I64)[None, :]
    is_seq = si < n_seqs[:, None]
    of_v = zseqenc.rep_scan(of_v.to(_I32).contiguous(),
                            ll_v.to(_I32).contiguous(),
                            n_seqs.to(_I32).contiguous()).to(_I64)
    ll_c = torch.where(is_seq, _ll_code(ll_v), 0)
    ml_c = torch.where(is_seq, _ml_code(torch.clamp(ml_v, min=3)), 0)
    of_c = torch.where(is_seq, _of_code(torch.clamp(of_v, min=1)), 0)

    llx_v = ll_v - _lut(S.LL_BASELINE, torch.clamp(ll_c, max=35))
    llx_n = _lut(S.LL_BITS, torch.clamp(ll_c, max=35))
    mlx_v = ml_v - _lut(S.ML_BASELINE, torch.clamp(ml_c, max=52))
    mlx_n = _lut(S.ML_BITS, torch.clamp(ml_c, max=52))
    # int32 as in the reference: 1 << 30 at most, of_v below 2^31
    ofx_v = of_v.to(_I32) - torch.bitwise_left_shift(
        torch.ones_like(of_c, dtype=_I32), torch.clamp(of_c, 0, 30).to(_I32))
    ofx_n = of_c
    llx_v, llx_n = (torch.where(is_seq, t, 0) for t in (llx_v, llx_n))
    mlx_v, mlx_n = (torch.where(is_seq, t, 0) for t in (mlx_v, mlx_n))
    ofx_v, ofx_n = (torch.where(is_seq, t, 0) for t in (ofx_v, ofx_n))

    tabs = [_fse_build(c.to(_I32), is_seq, nj, lg)
            for c, lg in zip((ll_c, of_c, ml_c), FSE_LOGS)]
    st_val, st_nb, st_fin, logs = _fse_scan(ll_c, of_c, ml_c, n_seqs, tabs)

    # item layout per sequence (write order, sequence MS-1 first),
    # LSB-first: [of|ml|ll states (<= 26 bits), llx|mlx (<= 21), ofx
    # (<= 21)]: 3 bit-pack items a sequence
    def flipseq(x):
        return torch.flip(x.to(_I64), [1])

    sv = st_val.to(_I64)
    sn = st_nb.to(_I64)
    s_of_v, s_ml_v, s_ll_v = sv[:, 1], sv[:, 2], sv[:, 0]
    s_of_n, s_ml_n, s_ll_n = sn[:, 1], sn[:, 2], sn[:, 0]
    sh1 = torch.clamp(s_of_n, 0, 16)
    sh2 = torch.clamp(s_of_n + s_ml_n, 0, 26)
    states_v = wrap32(s_of_v | (s_ml_v << sh1) | (s_ll_v << sh2))
    states_n = s_of_n + s_ml_n + s_ll_n
    fx_llx_v, fx_llx_n = flipseq(llx_v), flipseq(llx_n)
    fx_mlx_v, fx_mlx_n = flipseq(mlx_v), flipseq(mlx_n)
    x2_v = wrap32(fx_llx_v | (fx_mlx_v << torch.clamp(fx_llx_n, 0, 16)))
    x2_n = fx_llx_n + fx_mlx_n
    items_v = torch.stack([states_v, x2_v, flipseq(ofx_v)], dim=2)
    items_n = torch.stack([states_n, x2_n, flipseq(ofx_n)], dim=2)
    items_v = items_v.reshape(R, maxseq * 3)
    items_n = items_n.reshape(R, maxseq * 3)
    # flush states (ml, of, ll packed) + pad to a 512 multiple
    has_seq = (n_seqs > 0)[:, None]
    lg = logs.to(_I64)
    fin = st_fin.to(_I64)
    fsh1 = torch.clamp(lg[:, 2], 0, 16)
    fsh2 = torch.clamp(lg[:, 2] + lg[:, 1], 0, 26)
    fl_v = wrap32(fin[:, 2] | (fin[:, 1] << fsh1) | (fin[:, 0] << fsh2))
    fl_n = torch.where(has_seq, (lg[:, 2] + lg[:, 1] + lg[:, 0])[:, None], 0)
    pad = (-(maxseq * 3 + 1)) % 512
    zpad = torch.zeros((R, pad), dtype=_I64, device=dev)
    items_v = torch.cat([items_v, torch.where(has_seq, fl_v[:, None], 0),
                         zpad], dim=1)
    items_n = torch.cat([items_n, fl_n, zpad], dim=1)
    seq_bits_cum = torch.cumsum(items_n, dim=1)
    seq_dest = seq_bits_cum - items_n
    seq_total_bits = seq_bits_cum[:, -1]
    seq_halves, seq_nh = _bitpack_rows(items_v, items_n, seq_dest, SEQ_TO,
                                       (seq_total_bits + 16) >> 4, T=256)

    def i32(x):
        return x.to(_I32)

    extra = {}
    if debug:
        extra = dict(dbg_items_v=i32(items_v), dbg_items_n=i32(items_n),
                     dbg_seq_dest=i32(seq_dest),
                     dbg_codes=i32(codes_t).view(nj, nblk, 256),
                     dbg_lits=i32(lits).view(nj, nblk, block),
                     dbg_lnb=i32(lnb).view(nj, nblk, block),
                     dbg_lcode=i32(lcode).view(nj, nblk, block))
    return dict(
        **extra,
        n_seqs=i32(n_seqs).view(nj, nblk),
        lit_cnt=i32(lit_cnt).view(nj, nblk),
        ll=i32(ll_v).view(nj, nblk, maxseq),
        ml=i32(ml_v).view(nj, nblk, maxseq),
        ofv=i32(of_v).view(nj, nblk, maxseq),
        nbits=i32(nbits_t).view(nj, nblk, 256),
        max_bits=i32(max_bits).view(nj, nblk),
        huff_ok=huff_ok.view(nj, nblk),
        stream_bits=i32(bq).view(nj, nblk, 4),
        lit_halves=lit_halves.view(nj, nblk, -1),
        lit_nh=lit_nh.view(nj, nblk),
        seq_halves=seq_halves.view(nj, nblk, -1),
        seq_nh=seq_nh.view(nj, nblk),
        seq_total_bits=i32(seq_total_bits).view(nj, nblk),
        fse_norm=torch.stack([t["norm"] for t in tabs], dim=1),
        fse_log=torch.stack([torch.where(t["rle"], 0, lg_)
                             for t, lg_ in zip(tabs, FSE_LOGS)],
                            dim=1).to(_I32),
        fse_rle=torch.stack([t["rle"] for t in tabs], dim=1),
        fse_rle_sym=torch.stack([t["rle_sym"] for t in tabs], dim=1),
    )
