"""Entropy-stage helpers of the device zstd encoder (counterpart of the
parts of the JAX package's ``ops/zdev.py`` that the v2 encoder uses).

Plain PyTorch on whatever device the tensors are on.  The reference runs
table lookups, routing and compaction as one-hot matmuls and its scans as
``lax.scan``; here they are gathers, integer scatters, prefix sums and
short Python loops, with the same integer results.  Every sort that the
reference's outputs depend on for tie order is a stable ``torch.sort``.
"""

from __future__ import annotations

import numpy as np
import torch

from compress_tpu_torch.ops.common import compact, floor_log2, route_tiles

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
    return floor_log2(torch.clamp(ofval, min=1)).to(_I32)


def _unsort(order: torch.Tensor, values: torch.Tensor) -> torch.Tensor:
    """Inverse of gathering ``values`` by ``order`` along dim 1."""
    return torch.empty_like(values).scatter_(1, order, values)


def _shl(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    return torch.bitwise_left_shift(x, torch.clamp(s, min=0))


def _huff_build(hist: torch.Tensor, maxlog: int = 11):
    """hist (J, 256) -> (nbits (J, 256) int32, max_bits (J,), ok (J,)).

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


def _normalize_count(hist: torch.Tensor, log: int) -> torch.Tensor:
    """(N, NSYM) counts -> normalized counts summing to exactly 2^log, every
    present symbol >= 1: floor shares, the surplus to the largest
    remainders, a deficit stolen from the largest counts in turn."""
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
