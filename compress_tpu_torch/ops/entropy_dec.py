"""Batched huff0, FSE and zstd sequence decode with one table per container
(counterpart of the JAX package's ``ops/entropy_dec.py``: ``WIN``,
``expand_table``, ``build_windows``, ``huff0_decode_chunks``;
``fse_decode_chunks``, with ``fse_table`` for ``expand_fse_table``; ``ZWIN``,
``ZSEQ_K``, ``zseq_decode_chunks`` and ``zseq_decode_chunks_rep``; the
table packing of ``expand_zseq_table`` is ``zseq_kern.state_row``).

The encoder's checkpoints (``ops/entropy.py`` ``ckpt``: the remaining-bit
offset of a stream every HUFF_CKPT_K symbols) cut each stream into chunks
that decode independently.  The host cuts each chunk's 52-byte window
(``build_windows``) and expands each container's table to 2048 int32
entries ``sym | nb << 8`` (``expand_table``: an 11-bit peek whatever its
max_bits; the reference packs float32 ``sym * 16 + nb`` as (64, 32) for
its lane gathers, which the kernel here does not need); the symbol loop
runs on the device, through the chunk kernel of ``ops/entropy_kern.py``
with a per-container table on CUDA tensors, and through
``huff0_decode_chunks_ref`` on CPU tensors.

The sequence decode works the same way on sequence checkpoints (bit
offset, 3 FSE states and 3 repeat offsets every ZSEQ_K sequences, from
``zstd/seqdev.seq_accel``): 96-byte windows and one table set per item in
the integer layout of ``ops/zseq_kern.py`` (the reference packs (16, 192)
float32 planes for its one-hot lookups), decoded by the kernel of
``csrc/zseqdec.cu`` with a table stride on CUDA tensors (one launch that
reads the (N, C) arrays in place: no stack, cast or copy) and by its
plain version on CPU tensors.  ``zseq_decode_chunks_rep`` also resolves
the repeat offsets in the carry.

The FSE decode takes the same 52-byte windows at (bit position, state 1,
state 2) checkpoints every HUFF_CKPT_K symbols (``fse.make_accel``) and
one 512-state table per container as int32 ``sym | nb << 8 | new_state <<
16`` (``fse_table``; nb is read as 4 bits; the reference packs (16, 96)
float32 planes for its one-hot lookups).  It runs through the kernel of ``csrc/fsedec.cu`` on
CUDA tensors and ``fse_decode_chunks_ref`` on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from compress_tpu_torch import _cuda
from compress_tpu_torch.ops.entropy import HUFF_CKPT_K
from compress_tpu_torch.ops import zseq_kern as ZK
from compress_tpu_torch.ops.entropy_kern import decode_chunks_plain, launch

WIN = 52          # window bytes per chunk (>= ceil(K*11/8) + peek slack)
ZWIN = 96         # sequence-chunk window bytes (8 seqs x <= 81 bits + slack)
ZSEQ_K = 8        # sequences per checkpoint chunk

FSE_STATES = 512  # the device FSE decode's table: log 9

__all__ = ["WIN", "expand_table", "build_windows", "huff0_decode_chunks",
           "huff0_decode_chunks_ref", "FSE_STATES", "fse_table",
           "fse_decode_chunks", "fse_decode_chunks_ref", "ZWIN", "ZSEQ_K", "zseq_decode_chunks",
           "zseq_decode_chunks_ref",
           "zseq_decode_chunks_rep", "zseq_decode_chunks_rep_ref"]


def expand_table(sym_t, nb_t, max_bits: int):
    """Host: expand a 2^max_bits dtable to (2048,) int32 entries
    sym | nbits << 8, one per 11-bit peek."""
    idx = np.arange(2048) >> (11 - max_bits)
    return (sym_t[idx].astype(np.int32)
            | (nb_t[idx].astype(np.int32) << 8))


def build_windows(stream: bytes, ckpt: np.ndarray, nchunks: int,
                  win: int = WIN):
    """Host: per-chunk byte windows + window-local bit offsets.

    ckpt[c] = remaining-bit offset at the start of chunk c (descending).
    Returns (windows (nchunks, win) uint8, lbit (nchunks,) int32)."""
    ck = ckpt[:nchunks].astype(np.int64)
    wtop = (np.maximum(ck, 1) - 1) >> 3           # byte holding top bit
    wlo = wtop - (win - 1)
    buf = np.frombuffer(stream, np.uint8)
    padded = np.concatenate([np.zeros(win, np.uint8), buf])
    idx = wlo[:, None] + np.arange(win)[None, :] + win
    windows = padded[np.clip(idx, 0, len(padded) - 1)]
    windows[idx >= len(padded)] = 0
    lbit = (ck - 8 * wlo).astype(np.int32)
    return windows, lbit


def _check(windows, lbit, nsym, tables):
    N, C = lbit.shape
    if windows.dim() != 3 or windows.shape[:2] != (N, C) \
            or nsym.shape != (N, C) or tables.shape != (N, 2048):
        raise ValueError("expected (N, C, win) windows, (N, C) lbit and "
                         "nsym, (N, 2048) tables")
    if any(t.device != windows.device for t in (lbit, nsym, tables)):
        raise ValueError("huff0_decode_chunks: inputs on different devices")


def huff0_decode_chunks_ref(windows, lbit, nsym, tables,
                            k: int = HUFF_CKPT_K):
    """Plain version of ``huff0_decode_chunks``."""
    _check(windows, lbit, nsym, tables)
    N, C, win = windows.shape
    syms, endl = decode_chunks_plain(
        windows.reshape(N * C, win), lbit.reshape(-1), nsym.reshape(-1),
        tables, C, k, 11)
    return syms.view(N, C, k), endl.view(N, C)


def huff0_decode_chunks(windows: torch.Tensor, lbit: torch.Tensor,
                        nsym: torch.Tensor, tables: torch.Tensor,
                        k: int = HUFF_CKPT_K):
    """Decode up to k symbols per chunk.

    windows (N, C, WIN) uint8; lbit, nsym (N, C) int32 (window-local
    cursor, symbols in the chunk, 0 for pad chunks); tables (N, 2048)
    int32 per ``expand_table``.  Returns (syms (N, C, k) uint8, end
    lbit (N, C) int32)."""
    if windows.device.type == "cpu":
        return huff0_decode_chunks_ref(windows, lbit, nsym, tables, k)
    _check(windows, lbit, nsym, tables)
    out = launch(windows, lbit, nsym, tables, windows.shape[1], k, 11)
    huff0_decode_chunks.launches += 1
    return out


huff0_decode_chunks.launches = 0


def fse_table(spread, nb, new_state) -> np.ndarray:
    """Host: a 512-state decode table (``fse.core.build_dtable`` at log 9)
    as (512,) int32 entries ``sym | nb << 8 | new_state << 16``."""
    return (np.asarray(spread, np.int32) | (np.asarray(nb, np.int32) << 8)
            | (np.asarray(new_state, np.int32) << 16))


def _fse_check(windows, lbit, st1, st2, npair, nore1, nore2, tables, k):
    N, C = lbit.shape
    if windows.dim() != 3 or windows.shape[:2] != (N, C) or any(
            t.shape != (N, C) for t in (st1, st2, npair, nore1, nore2)) \
            or tables.shape != (N, FSE_STATES):
        raise ValueError("expected (N, C, win) windows, (N, C) cursors, "
                         f"states and counts, (N, {FSE_STATES}) tables")
    if windows.shape[2] % 4 or not 4 <= windows.shape[2] <= 64:
        raise ValueError(f"fse_decode_chunks: window of {windows.shape[2]} "
                         "bytes (a multiple of 4 up to 64)")
    if k < 2 or k % 2 or k > 64:
        raise ValueError(f"fse_decode_chunks: k = {k} (even, 2..64)")
    if any(t.device != windows.device
           for t in (lbit, st1, st2, npair, nore1, nore2, tables)):
        raise ValueError("fse_decode_chunks: inputs on different devices")
    return N, C


def _window_bits(wbits, lo, n):
    """Bits [lo, lo + n) of each chunk's window, bit 0 lowest; bits below 0
    and past the window's end read 0.  wbits (M, 8 * win) int64 0/1."""
    span = wbits.shape[1]
    pos = lo[:, None] + torch.arange(15, device=lo.device)
    inside = (pos >= 0) & (pos < span) & (torch.arange(
        15, device=lo.device) < n[:, None])
    b = torch.gather(wbits, 1, pos.clamp(0, span - 1))
    weights = torch.bitwise_left_shift(
        torch.ones(15, dtype=torch.int64, device=lo.device),
        torch.arange(15, device=lo.device))
    return (torch.where(inside, b, 0) * weights).sum(dim=1)


def fse_decode_chunks_ref(windows, lbit, st1, st2, npair, nore1, nore2,
                          tables, k: int = HUFF_CKPT_K):
    """Plain version of ``fse_decode_chunks``."""
    N, C = _fse_check(windows, lbit, st1, st2, npair, nore1, nore2, tables,
                      k)
    win = windows.shape[2]
    dev = windows.device
    w = windows.reshape(N * C, win).to(torch.int64)
    wbits = ((w[:, :, None] >> torch.arange(8, device=dev)) & 1).reshape(
        N * C, 8 * win)
    row = torch.arange(N, device=dev).repeat_interleave(C)
    tab = tables.to(torch.int64)
    lbp, s1, s2, np_, n1, n2 = (t.reshape(-1).to(torch.int32)
                                for t in (lbit, st1, st2, npair, nore1,
                                          nore2))

    def look(s):
        ok = (s >= 0) & (s < FSE_STATES)
        e = tab[row, s.clamp(0, FSE_STATES - 1).to(torch.int64)]
        e = torch.where(ok, e, 0)
        return e & 255, (e >> 8) & 15, e >> 16

    syms = []
    for j in range(k // 2):
        sym1, nb1, ns1 = look(s1)
        sym2, nb2, ns2 = look(s2)
        act = j < np_
        re1 = act & (j < n1)
        lo = (lbp - nb1).to(torch.int64)
        s1 = torch.where(re1, (ns1 + _window_bits(wbits, lo, nb1)).to(
            torch.int32), s1)
        lbp = torch.where(re1, lbp - nb1.to(torch.int32), lbp)
        re2 = act & (j < n2)
        lo = (lbp - nb2).to(torch.int64)
        s2 = torch.where(re2, (ns2 + _window_bits(wbits, lo, nb2)).to(
            torch.int32), s2)
        lbp = torch.where(re2, lbp - nb2.to(torch.int32), lbp)
        syms += [torch.where(act, sym1, 0), torch.where(act, sym2, 0)]
    out = torch.stack(syms, dim=1).to(torch.uint8).view(N, C, k)
    return out, lbp.view(N, C)


def fse_decode_chunks(windows: torch.Tensor, lbit: torch.Tensor,
                      st1: torch.Tensor, st2: torch.Tensor,
                      npair: torch.Tensor, nore1: torch.Tensor,
                      nore2: torch.Tensor, tables: torch.Tensor,
                      k: int = HUFF_CKPT_K, *,
                      routes: torch.Tensor | None = None):
    """Chunked 2-state interleaved FSE decode.

    windows (N, C, win) uint8 (win a multiple of 4 up to 64; ``WIN``) with
    window-local cursors lbit (N, C) int32 as ``build_windows`` cuts them;
    st1, st2 (N, C) int32 entry states; npair (N, C) pairs to emit (<= k
    / 2); nore1, nore2 (N, C) the pair index from which state 1 / 2 stops
    reloading (the encoder's final emissions carry no transition); tables
    (N, 512) int32 per ``fse_table``.  Per pair j < k / 2: both symbols are
    looked up from the current states (a state outside 0..511 reads
    entry 0); state 1 then state 2 reload ``new_state`` plus the nb bits
    below the cursor (bits below window bit 0 read 0) while j < npair and
    j < its nore, and the cursor drops by nb; pairs from npair on give
    symbol 0 and move nothing.  Returns (syms (N, C, k) uint8, end cursors
    (N, C) int32).  A CUDA tensor goes through the kernel (one launch), a
    CPU tensor through ``fse_decode_chunks_ref``.  ``routes``, a (2,) int32
    CUDA tensor, gets the kernel's chunks added: [0] those of tiles with no
    pair to decode (written without a walk), [1] those walked."""
    if windows.device.type == "cpu":
        return fse_decode_chunks_ref(windows, lbit, st1, st2, npair, nore1,
                                     nore2, tables, k)
    N, C = _fse_check(windows, lbit, st1, st2, npair, nore1, nore2, tables,
                      k)
    dev = windows.device
    win = windows.shape[2]
    windows = _cuda.aligned(windows.contiguous(), 4)
    ins = [t.contiguous() for t in (lbit, st1, st2, npair, nore1, nore2)]
    for name, t in zip(("lbit", "st1", "st2", "npair", "nore1", "nore2"),
                       ins):
        _cuda.require_cuda_input(t, f"fse_decode_chunks: {name}",
                                 torch.int32, (N, C))
    _cuda.require_cuda_input(tables, "fse_decode_chunks: tables",
                             torch.int32, (N, FSE_STATES))
    if routes is not None:
        _cuda.require_cuda_input(routes, "fse_decode_chunks: routes",
                                 torch.int32, (2,))
        if routes.device != dev:
            raise ValueError("fse_decode_chunks: routes on another device")
    at = (N * C * k + 15) // 16 * 16       # the end cursors' offset
    out = torch.empty(at + 4 * N * C, dtype=torch.uint8, device=dev)
    syms = out[:N * C * k].view(N, C, k)
    endl = out[at:].view(torch.int32).view(N, C)
    with torch.cuda.device(dev):
        rc = _cuda.library().ct_fse_decode(
            windows.data_ptr(), *(t.data_ptr() for t in ins),
            tables.data_ptr(), N, C, win, k, syms.data_ptr(),
            endl.data_ptr(), None if routes is None else routes.data_ptr(),
            _cuda.stream(dev))
    _cuda.check(rc, "fse_decode_chunks")
    fse_decode_chunks.launches += 1
    return syms, endl


fse_decode_chunks.launches = 0


def _zseq_check(windows, lbit, sll, sof, sml, nseq, nore, reps, tables):
    N, C = lbit.shape
    if windows.dim() != 3 or windows.shape[:2] != (N, C) or any(
            t.shape != (N, C) for t in (sll, sof, sml, nseq, nore, *reps)) \
            or tables.shape != (N, ZK.ZTAB):
        raise ValueError("expected (N, C, win) windows, (N, C) cursors, "
                         f"states, counts and reps, (N, {ZK.ZTAB}) tables")
    if any(t.get_device() != windows.get_device()
           for t in (lbit, sll, sof, sml, nseq, nore, tables, *reps)):
        raise ValueError("zseq decode: inputs on different devices")
    return N, C


def _zseq_plain(windows, lbit, sll, sof, sml, nseq, nore, reps, tables, k):
    """``decode_plain`` on the per-item inputs: ((ll, ml, ofv, off) each
    (N, C, k), end cursors (N, C))."""
    N, C = _zseq_check(windows, lbit, sll, sof, sml, nseq, nore, reps,
                       tables)
    states = torch.stack([sll, sof, sml], -1).reshape(N * C, 3)
    reps = torch.stack(reps, -1).reshape(N * C, 3).to(torch.int32)
    out = ZK.decode_plain(
        windows.reshape(N * C, -1), lbit.reshape(-1), nseq.reshape(-1),
        nore.reshape(-1), states.to(torch.int32).contiguous(),
        reps.contiguous(), tables, C, k, True)
    return tuple(o.view(N, C, -1) for o in out[:4]), out[4].view(N, C)


def _zseq_launch(windows, lbit, sll, sof, sml, nseq, nore, reps, tables, k,
                 want_off: bool):
    """One launch of the sequence kernel on the per-item inputs as the
    callers hold them (no stack, cast or copy for contiguous int32
    arrays): ((ll, ml, ofv, off) each (N, C, k), off None unless
    ``want_off``; end cursors (N, C))."""
    N, C = _zseq_check(windows, lbit, sll, sof, sml, nseq, nore, reps or (),
                       tables)
    ll, ml, ofv, off, endl = ZK.launch(
        windows, lbit, nseq, nore, (sll, sof, sml), reps, tables, C, k,
        True, want_off=want_off)
    return (ll, ml, ofv, off), endl


def _initial_reps(lbit):
    return tuple(torch.full_like(lbit, v) for v in (1, 4, 8))


def zseq_decode_chunks_ref(windows, lbit, sll, sof, sml, nseq, nore, tables,
                           k: int = ZSEQ_K):
    """Plain version of ``zseq_decode_chunks``."""
    (ll, ml, ofv, _off), endl = _zseq_plain(
        windows, lbit, sll, sof, sml, nseq, nore, _initial_reps(lbit),
        tables, k)
    return (ll, ml, ofv), endl


def zseq_decode_chunks(windows: torch.Tensor, lbit: torch.Tensor,
                       sll: torch.Tensor, sof: torch.Tensor, sml: torch.Tensor,
                       nseq: torch.Tensor, nore: torch.Tensor,
                       tables: torch.Tensor, k: int = ZSEQ_K):
    """Chunked zstd sequence decode, offsets left in of_value form.

    windows (N, C, ZWIN) uint8; lbit, sll, sof, sml (N, C) int32 entry
    cursor and states; nseq (N, C) sequences in the chunk (0 for pad
    chunks); nore (N, C) the local index from which the states stop
    reloading (the block's last sequence); tables (N, ZTAB) int32, one
    table set per item (``zseq_kern.table_set``).  Returns ((ll, ml, ofv)
    each (N, C, k) int32, end cursors (N, C) int32)."""
    if windows.device.type == "cpu":
        return zseq_decode_chunks_ref(windows, lbit, sll, sof, sml, nseq,
                                      nore, tables, k)
    (ll, ml, ofv, _off), endl = _zseq_launch(
        windows, lbit, sll, sof, sml, nseq, nore, None, tables, k, False)
    zseq_decode_chunks.launches += 1
    return (ll, ml, ofv), endl


def zseq_decode_chunks_rep_ref(windows, lbit, sll, sof, sml, nseq, nore, r1,
                               r2, r3, tables, k: int = ZSEQ_K):
    """Plain version of ``zseq_decode_chunks_rep``."""
    return _zseq_plain(windows, lbit, sll, sof, sml, nseq, nore, (r1, r2, r3),
                       tables, k)


def zseq_decode_chunks_rep(windows: torch.Tensor, lbit: torch.Tensor,
                           sll: torch.Tensor, sof: torch.Tensor,
                           sml: torch.Tensor, nseq: torch.Tensor,
                           nore: torch.Tensor, r1: torch.Tensor,
                           r2: torch.Tensor, r3: torch.Tensor,
                           tables: torch.Tensor, k: int = ZSEQ_K):
    """``zseq_decode_chunks`` with the repeat offsets resolved in the
    carry: r1, r2, r3 (N, C) int32 are the repeat offsets at each chunk's
    entry.  Returns ((ll, ml, ofv, off) each (N, C, k) int32, end cursors
    (N, C)), off the absolute offset (RFC 8878 §3.1.1.5; repeat code 3 at
    r1 = 1 gives 1, as the reference's scan does).  On CUDA tensors one
    launch reads the arrays in place."""
    if windows.device.type == "cpu":
        return zseq_decode_chunks_rep_ref(windows, lbit, sll, sof, sml, nseq,
                                          nore, r1, r2, r3, tables, k)
    out = _zseq_launch(windows, lbit, sll, sof, sml, nseq, nore,
                       (r1, r2, r3), tables, k, True)
    zseq_decode_chunks_rep.launches += 1
    return out


zseq_decode_chunks.launches = 0
zseq_decode_chunks_rep.launches = 0
