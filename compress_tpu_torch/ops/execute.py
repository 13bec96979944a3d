"""Device LZ execute, the decode-side core (counterpart of the JAX
package's ``ops/execute.py``: ``plan_block_ops``, ``pack_plans``,
``execute_rounds``).

Each block decodes inside an arena of bytes: rows 0..LR-1 (LR = 512 * M,
128 bytes a row) hold the block's literal bytes, rows LR..2*LR-1 receive
the output.  M is the arena class (1, 2 or 4 for blocks of up to 64, 128
and 256 KiB); a plan's addresses embed the output base M * OUT_BASE.

The host planner (``plan_ops``; ``plan_block_ops`` is its M = 1 form)
turns decode-order LZ ops into dst-row-aligned **pieces** of at most 128
bytes, each with an execution **round**: a round-r piece reads only bytes written in rounds
before r, and every output byte is covered by exactly one piece.
``pack_pieces`` packs per-block plans into the compact plan the decode
paths send to the card: live pieces only, block-major, each block's
pieces sorted by round, 8 bytes a piece, with per-block round offsets;
``execute_pieces`` runs it (the CUDA kernel ``csrc/exec.cu`` on CUDA
tensors, its plain PyTorch version on CPU tensors; ``ops/exec_kern.py``).
``pack_plans`` stacks per-block plans round-major into the reference's
padded (total, B) slot tensors with per-round capacities (pad slots have
length 0); ``execute_rounds`` runs those (on the card by compacting them
first), for the tests that hold the port against the JAX package.

Multi-block zstd frames (64 KiB blocks) decode block after block with a
history: a piece whose source is HIST_BASE + x reads byte x of the
frame's last ``hist_rows`` * 128 output bytes before the block (zeros
before the frame's start).  ``pack_plans_mb`` is the reference's padded
layout of such plans (the JAX ``execute_blocks_hist`` reads it);
``pack_pieces_mb`` the compact plan of ``exec_kern.execute_blocks_hist``,
which the decode path sends to the card.
"""

from __future__ import annotations

import numpy as np
import torch

from compress_tpu_torch.ops.exec_kern import (compact_pieces,
                                              execute_blocks_hist,
                                              execute_blocks_hist_ref,
                                              execute_pieces,
                                              execute_pieces_ref,
                                              execute_rounds,
                                              execute_rounds_ref)

ARENA_ROWS = 1024      # 512 literal rows + 512 output rows (M = 1)
OUT_BASE = 512 * 128   # arena byte where output begins (M = 1)
HIST_BASE = ARENA_ROWS * 128  # history address space (multi-block frames)
BLOCK = 1 << 16

__all__ = ["ARENA_ROWS", "OUT_BASE", "HIST_BASE", "BLOCK", "plan_ops",
           "plan_block_ops", "pack_plans", "pack_pieces", "pack_plans_mb",
           "pack_pieces_mb", "execute_pieces", "execute_pieces_ref",
           "execute_rounds", "execute_rounds_ref", "execute_blocks_hist",
           "execute_blocks_hist_ref"]


def _pieces(runs: np.ndarray):
    """(n, 4) runs (output position, source, length, round), each
    source-contiguous, in emission order -> piece (output position, src,
    len, round) arrays: every run cut at 128-byte output rows."""
    d, s, ln, r = (runs[:, c] for c in range(4))
    first = d >> 7
    n_rows = ((d + ln - 1) >> 7) - first + 1
    run = np.repeat(np.arange(len(d)), n_rows)
    k = np.arange(len(run)) - np.repeat(np.cumsum(n_rows) - n_rows, n_rows)
    row = first[run] + k
    lo = np.maximum(d[run], row << 7)
    hi = np.minimum(d[run] + ln[run], (row + 1) << 7)
    return lo, s[run] + (lo - d[run]), hi - lo, r[run]


def plan_ops(kinds, lens, offs, max_rounds: int = 4,
             out_base: int = OUT_BASE, hist_avail: int = 0,
             hist_cap: int = 0):
    """The planner, over Python sequences of ints (``plan_block_ops``, the
    S2 planner ``s2/plan.py`` and the zstd sidecar builder
    ``zstd/sidecar.py`` run it).

    kinds: 0 = literal run (the next ``len`` literal bytes), 1 = copy at
    offset ``off`` into the output written so far.  A copy reads its
    transitive sources while they form one run of one round; otherwise it
    reads the output bytes themselves one round later; past ``max_rounds``
    it is flattened through its transitive sources (more pieces instead of
    more depth).  ``hist_avail`` bytes of an earlier block's output lie
    before the block (multi-block frames): a source byte at block position
    sp < 0 is history, resolved before the block starts (round 0), at
    arena address HIST_BASE + hist_cap + sp, and keeps that address and
    round where a copy reads the output directly.  Returns (dst, src, len,
    round) int64 arrays in emission order, every piece inside one 128-byte
    output row (dst = out_base + output position), or None on an offset of
    0 or past the output and its history."""
    total = sum(lens)
    esrc = [0] * total      # per output byte: arena byte holding its value
    ernd = [0] * total      # ... and the round that writes it
    chunks = []             # (n, 4) run arrays, in emission order
    pend = []               # runs not yet in a chunk
    hist_top = HIST_BASE + hist_cap

    def flush():
        if pend:
            chunks.append(np.array(pend, np.int64).reshape(-1, 4))
            pend.clear()

    def runs(d0, sl, rl):
        # cut at non-contiguous sources and round changes
        n = len(sl)
        if n <= 64:
            a = 0
            for b in range(1, n + 1):
                if b == n or sl[b] != sl[b - 1] + 1 or rl[b] != rl[a]:
                    pend.append((d0 + a, sl[a], b - a, rl[a]))
                    a = b
            return
        sa = np.asarray(sl, np.int64)
        ra = np.asarray(rl, np.int64)
        starts = np.concatenate([[0], np.flatnonzero(
            (np.diff(sa) != 1) | (np.diff(ra) != 0)) + 1])
        ends = np.append(starts[1:], n)
        flush()
        chunks.append(np.stack([d0 + starts, sa[starts], ends - starts,
                                ra[starts]], axis=1))

    pos = 0
    lit_pos = 0
    for kind, L, off in zip(kinds, lens, offs):
        if kind == 0:
            if L > 0:
                pend.append((pos, lit_pos, L, 0))
                esrc[pos:pos + L] = range(lit_pos, lit_pos + L)
                ernd[pos:pos + L] = [0] * L
                lit_pos += L
                pos += L
            continue
        if off <= 0 or off > pos + hist_avail:
            return None
        h = off - pos       # history bytes before the source's block part
        hb = hist_top - h   # arena address of the first of them
        reps = -(-L // off)
        if h <= 0 and off >= L:
            sl = esrc[pos - off:pos - off + L]
            rl = ernd[pos - off:pos - off + L]
        elif h <= 0:
            sl = (esrc[pos - off:pos] * reps)[:L]
            rl = (ernd[pos - off:pos] * reps)[:L]
        else:               # a period: h history bytes, then the block's
            n_h = min(h, L)
            sl = (list(range(hb, hb + n_h)) + esrc[:min(pos, L - n_h)]) * reps
            rl = ([0] * n_h + ernd[:min(pos, L - n_h)]) * reps
            del sl[L:], rl[L:]
        rnd_direct = max(rl) + 1
        if rnd_direct > max_rounds:
            # too deep: flatten through the transitive sources
            runs(pos, sl, rl)
            esrc[pos:pos + L] = sl
            ernd[pos:pos + L] = rl
        elif (off >= L and rl.count(rl[0]) == L
              and sl == list(range(sl[0], sl[0] + L))):
            # the transitive read keeps the round low without fragmenting
            pend.append((pos, sl[0], L, rl[0]))
            esrc[pos:pos + L] = sl
            ernd[pos:pos + L] = rl
        elif h > 0:
            # read the output bytes themselves, one round later; history
            # bytes keep their round-0 address: per period a history run
            # and a run of the block's output
            q = np.arange(0, L, off, dtype=np.int64)
            q_h = np.minimum(h, L - q)
            q_o = np.minimum(pos, L - q - q_h)
            rows = [np.stack([pos + q, np.full_like(q, hb), q_h,
                              np.zeros_like(q)], axis=1)]
            if pos:
                rows.append(np.stack([pos + q + h, np.full_like(q, out_base),
                                      q_o, np.full_like(q, rnd_direct)],
                                     axis=1))
            r = np.stack(rows, axis=1).reshape(-1, 4)
            flush()
            chunks.append(r[r[:, 2] > 0])
            k = min(pos, L - n_h)
            esrc[pos:pos + L] = ((list(range(hb, hb + n_h))
                                  + list(range(out_base, out_base + k)))
                                 * reps)[:L]
            ernd[pos:pos + L] = (([0] * n_h + [rnd_direct] * k) * reps)[:L]
        else:
            # read the output bytes themselves, one round later: one run,
            # or one per period of an overlapping copy
            base = out_base + pos - off
            if off >= L:
                pend.append((pos, base, L, rnd_direct))
                esrc[pos:pos + L] = range(base, base + L)
            else:
                q = np.arange(0, L, off, dtype=np.int64)
                flush()
                chunks.append(np.stack([pos + q, np.full_like(q, base),
                                        np.minimum(off, L - q),
                                        np.full_like(q, rnd_direct)], axis=1))
                esrc[pos:pos + L] = (list(range(base, base + off))
                                     * reps)[:L]
            ernd[pos:pos + L] = [rnd_direct] * L
        pos += L
    flush()
    if not chunks:
        return (np.zeros(0, np.int64),) * 4
    d, s, ln, r = _pieces(np.concatenate(chunks))
    return out_base + d, s, ln, r


def plan_block_ops(kinds, lens, offs, max_rounds=4):
    """Plan the decode-order ops of one block of at most 64 KiB (arena
    class M = 1) with ``plan_ops``.  Returns dict of np int32 arrays: src
    (arena byte), dst (arena byte), len, round; plus n_rounds.  Raises
    ValueError on a block too large or a bad offset."""
    kinds, lens, offs = (np.asarray(a).astype(np.int64).tolist()
                         for a in (kinds, lens, offs))
    if sum(lens) > BLOCK:
        raise ValueError("block too large")
    planned = plan_ops(kinds, lens, offs, max_rounds, OUT_BASE)
    if planned is None:
        raise ValueError("bad offset")
    dst, src, ln, rnd = (a.astype(np.int32) for a in planned)
    return {"src": src, "dst": dst, "len": ln, "round": rnd,
            "n_rounds": int(rnd.max()) + 1 if len(rnd) else 1}


def default_round_caps(largest) -> list[int]:
    """``pack_plans``' capacity of each round from its largest per-block
    piece count: rounded up to a power of two, at least 64."""
    return [max(64, 1 << int(np.ceil(np.log2(max(int(c), 1)))))
            for c in largest]


def pack_plans(plans, round_caps=None):
    """Stack per-block plans into per-round padded tensors.

    Returns (src, dst, length) numpy int32 arrays of shape (total, B),
    round-major with per-round capacities, plus the caps tuple.  Without
    ``round_caps`` each round's cap is its largest per-block piece count,
    rounded up to a power of two and at least 64 (``default_round_caps``).
    Pad slots have length 0 (dst OUT_BASE, src 0)."""
    B = len(plans)
    n_rounds = max(p["n_rounds"] for p in plans)
    if round_caps is None:
        round_caps = default_round_caps(
            max(int((p["round"] == r).sum()) for p in plans)
            for r in range(n_rounds))
    total = sum(round_caps)
    src = np.zeros((total, B), np.int32)
    dst = np.full((total, B), OUT_BASE, np.int32)
    length = np.zeros((total, B), np.int32)
    caps_arr = np.asarray(round_caps, np.int64)
    bases = np.concatenate([[0], np.cumsum(caps_arr)])[:-1]
    for b, p in enumerate(plans):
        rnd = p["round"]
        order = np.argsort(rnd, kind="stable")
        rs = rnd[order]
        counts = np.bincount(rs, minlength=len(round_caps))
        if (counts > caps_arr).any():
            raise ValueError("round capacity overflow")
        starts = np.concatenate([[0], np.cumsum(counts)])[:-1]
        # slot of sorted piece i: bases[r] + (i - starts[r])
        idx = bases[rs] + np.arange(len(rs)) - starts[rs]
        src[idx, b] = p["src"][order]
        dst[idx, b] = p["dst"][order]
        length[idx, b] = p["len"][order]
    return src, dst, length, tuple(round_caps)


def pack_pieces(plans, rows: int = 512):
    """Pack per-block plans into the compact plan of ``execute_pieces``
    for an arena of ``rows`` literal rows (512 * M).

    Returns (pieces (P, 2) int32, rstart (B, nr + 1) int32) numpy arrays,
    nr the largest ``n_rounds``.  Piece k is (src, dst | (n - 1) << 24),
    n = min(len, 128 - (dst & 127)) in 1..128; pieces are block-major and
    each block's are sorted by round, stably (the order ``pack_plans``
    gives its slots); rstart[b, r] is where round r of block b starts.  A
    piece that writes nothing (n <= 0, or dst outside the arena) is left
    out; a piece that writes the literal half raises ValueError, as does
    a round outside [0, nr).  ``compact_pieces`` does the packing, as it
    does for a padded plan's slots (``exec_kern._slots``)."""
    if rows <= 0 or rows * 256 > 1 << 24:
        raise ValueError(f"rows: expected 1..65536, got {rows}")
    B = len(plans)
    nr = max((int(p["n_rounds"]) for p in plans), default=1)

    def cat(key):
        return (np.concatenate([np.asarray(p[key], np.int64) for p in plans])
                if B else np.zeros(0, np.int64))

    rnd = cat("round")
    if ((rnd < 0) | (rnd >= nr)).any():
        raise ValueError(f"a piece's round is outside [0, {nr})")
    blk = np.repeat(np.arange(B), [len(p["len"]) for p in plans])
    pieces, rstart = compact_pieces(
        *(torch.from_numpy(a) for a in (blk, rnd, cat("src"), cat("dst"),
                                        cat("len"))), B, nr, rows)
    return pieces.numpy(), rstart.numpy()


def _check_mb(plans_kb, hist_cap_bytes: int):
    """The reference's checks of multi-block plans: every history piece
    (src >= HIST_BASE) in round 0 and inside the history."""
    for pb in plans_kb:
        for p in pb:
            hist = p["src"] >= HIST_BASE
            if not hist.any():
                continue
            if int(p["round"][hist].max()) != 0:
                raise ValueError("history piece beyond round 0")
            hs = p["src"][hist].astype(np.int64) - HIST_BASE
            if hs.min() < 0 or int(
                    (hs + p["len"][hist]).max()) > hist_cap_bytes:
                raise ValueError("history source out of range")


def pack_plans_mb(plans_kb, hist_cap_bytes: int):
    """Stack per-frame lists of per-block plans into the padded layout of
    the reference's ``execute_blocks_hist`` (frames may have different
    block counts; shorter frames pad with steps that do not advance).
    Pieces with src >= HIST_BASE go to the round-0 history stage, their
    sources rebased into the history (0 .. hist_cap_bytes).

    Returns (hsrc, hdst, hlen, src, dst, length, advance, round_caps,
    hcap) numpy arrays: h* (K, hcap, B), src/dst/length (K, total, B)
    round-major, advance (K, B) float32.  Raises ValueError on a history
    piece beyond round 0 or outside the history."""
    Bn = len(plans_kb)
    K = max(len(pb) for pb in plans_kb)
    _check_mb(plans_kb, hist_cap_bytes)
    n_rounds, hmax = 1, 1
    for pb in plans_kb:
        for p in pb:
            n_rounds = max(n_rounds, p["n_rounds"])
            hmax = max(hmax, int((p["src"] >= HIST_BASE).sum()))
    hcap = max(64, 1 << int(np.ceil(np.log2(hmax))))
    round_caps = default_round_caps(
        max([1] + [int(((p["src"] < HIST_BASE) & (p["round"] == r)).sum())
                   for pb in plans_kb for p in pb])
        for r in range(n_rounds))
    total = sum(round_caps)
    hsrc = np.zeros((K, hcap, Bn), np.int32)
    hdst = np.full((K, hcap, Bn), OUT_BASE, np.int32)
    hlen = np.zeros((K, hcap, Bn), np.int32)
    src = np.zeros((K, total, Bn), np.int32)
    dst = np.full((K, total, Bn), OUT_BASE, np.int32)
    length = np.zeros((K, total, Bn), np.int32)
    advance = np.zeros((K, Bn), np.float32)
    for b, pb in enumerate(plans_kb):
        for k, p in enumerate(pb):
            advance[k, b] = 1.0
            hist = p["src"] >= HIST_BASE
            hn = int(hist.sum())
            hsrc[k, :hn, b] = p["src"][hist] - HIST_BASE
            hdst[k, :hn, b] = p["dst"][hist]
            hlen[k, :hn, b] = p["len"][hist]
            base = 0
            for r, cap in enumerate(round_caps):
                m = ~hist & (p["round"] == r)
                cnt = int(m.sum())
                src[k, base:base + cnt, b] = p["src"][m]
                dst[k, base:base + cnt, b] = p["dst"][m]
                length[k, base:base + cnt, b] = p["len"][m]
                base += cap
    return (hsrc, hdst, hlen, src, dst, length, advance, tuple(round_caps),
            hcap)


def pack_pieces_mb(plans_kb, hist_cap_bytes: int):
    """Pack per-frame lists of per-block plans (64 KiB blocks, arena class
    M = 1) into the compact plan of ``execute_blocks_hist``.

    Returns (pieces (P, 2) int32, gstart (B, K, nr + 2) int32) numpy
    arrays, K the most blocks of a frame and nr the largest
    ``n_rounds``.  Each step (a frame's block) has nr + 1 groups of
    pieces: group 0 its history pieces (src >= HIST_BASE, the sources
    kept), group r + 1 its other pieces of round r; pieces are frame-major,
    then step, then group, each step's in their plan's order within a
    group; gstart[b, k, g] is where group g of frame b's step k starts.
    Pieces are (src, dst | (n - 1) << 24) as ``pack_pieces`` packs them,
    live pieces only.  Raises ValueError where ``pack_plans_mb`` does, on
    a piece that writes the literal half and on a round outside
    [0, nr)."""
    _check_mb(plans_kb, hist_cap_bytes)
    B = len(plans_kb)
    K = max((len(pb) for pb in plans_kb), default=1)
    flat = [(b * K + k, p) for b, pb in enumerate(plans_kb)
            for k, p in enumerate(pb)]
    nr = max((int(p["n_rounds"]) for _s, p in flat), default=1)

    def cat(key):
        return (np.concatenate([np.asarray(p[key], np.int64)
                                for _s, p in flat])
                if flat else np.zeros(0, np.int64))

    src, rnd = cat("src"), cat("round")
    if ((rnd < 0) | (rnd >= nr)).any():
        raise ValueError(f"a piece's round is outside [0, {nr})")
    grp = np.where(src >= HIST_BASE, 0, rnd + 1)
    step = np.repeat([s for s, _p in flat], [len(p["len"]) for _s, p in flat])
    pieces, gstart = compact_pieces(
        *(torch.from_numpy(a) for a in (step, grp, src, cat("dst"),
                                        cat("len"))), B * K, nr + 1, 512)
    return pieces.numpy(), gstart.numpy().reshape(B, K, nr + 2)
