"""The accel sidecar builder's plain version: a copy, in Python and
numpy, of the native ``ct_zstd_build_sidecar`` (``_native/src/zstd_dec.cpp``:
the frame walk :1848, ``side_block`` :1509, ``huf_walk_cks`` :1139 and the
planner with history, ``plan_ops`` :1225), which ``zstd/accel.build_sidecar``
calls through ``accel.sidecar_payload``, as the JAX package's does.

One walk of a frame's blocks writes the payload ``zstd/accel.py``
describes ('CTA3'): per block the huff0 stream checkpoints every 32
literals (``device_dec._hwalk``), optionally the sequence checkpoints every
8 sequences (``seqdev.seq_walk``), and the round-annotated execute plan
(``ops/execute.plan_ops``; a source before the block reads the frame's
history at ``HIST_BASE``).  The walk carries what RFC 8878 carries from
block to block: the repeat offsets, the FSE tables of repeat mode and the
Huffman table of treeless literals.  Raw and RLE blocks are an identity
plan of one piece a 128-byte row.

A frame is eligible only whole: every block must decode exactly (no
offset code above 23, no offset past the block's output and its history,
every stream read to its end), decode to at most 64 KiB, and every
non-final block to exactly 64 KiB; ``hist_blocks`` must lie in [0, 128]
and one block at least must be compressed.  Otherwise ``build_payload``
returns None, as the native builder returns 0.
"""

from __future__ import annotations

import numpy as np

from compress_tpu_torch.huff0.table import read_table
from compress_tpu_torch.ops.execute import OUT_BASE, plan_ops
from compress_tpu_torch.zstd import block as B
from compress_tpu_torch.zstd import seqdev

__all__ = ["build_payload"]

_LIT_K = 32      # literals a huff0 checkpoint (device_dec._LIT_K)
_SEQ_K = 8       # sequences a sequence checkpoint (entropy_dec.ZSEQ_K)
_BLOCK = 1 << 16


def _u16(v: int) -> bytes:
    return int(v).to_bytes(2, "little")


def _u32(v: int) -> bytes:
    return (int(v) & 0xFFFFFFFF).to_bytes(4, "little")


class _State:
    """What the frame carries from block to block."""

    def __init__(self):
        self.reps = (1, 4, 8)
        self.tables = [None, None, None]     # ll, of, ml (repeat mode)
        self.huf = None                      # (sym_t, nb_t, max_bits)


def _pieces_record(src, length, rnd) -> bytes:
    n_rounds = int(rnd.max()) + 1 if len(rnd) else 1
    return (_u32(len(src)) + bytes([n_rounds & 0xFF])
            + np.asarray(src, "<i4").tobytes()
            + np.asarray(length, np.uint8).tobytes()
            + np.asarray(rnd, np.uint8).tobytes())


def _raw_block(btype: int, regen: int, seq_cks: bool):
    """A raw or RLE block: the literal stage ships its bytes, the plan is
    the identity in round 0."""
    if regen > _BLOCK:
        return None
    rec = bytearray([1 | (2 if seq_cks else 0), 1 if btype == 0 else 2])
    rec += _u32(regen) + _u32(0) + _u32(regen)
    if seq_cks:
        rec += _u16(0)
    src = np.arange(0, regen, 128, dtype=np.int64)
    rec += _pieces_record(src, np.minimum(regen - src, 128),
                          np.zeros(len(src), np.int64))
    return rec, regen


def _lit_header(hdr: bytes):
    """(lit_type, regen, compressed size, header bytes, streams) of a
    literals section header (5 bytes, zero-padded)."""
    b0 = hdr[0]
    lit_type, sf = b0 & 3, (b0 >> 2) & 3
    if lit_type < 2:                   # raw or RLE
        if sf in (0, 2):
            regen, pos = b0 >> 3, 1
        elif sf == 1:
            regen, pos = (b0 >> 4) | (hdr[1] << 4), 2
        else:
            regen, pos = (b0 >> 4) | (hdr[1] << 4) | (hdr[2] << 12), 3
        return lit_type, regen, regen if lit_type == 0 else 1, pos, 0
    if sf < 2:
        v = int.from_bytes(hdr[:3], "little")
        return lit_type, (v >> 4) & 0x3FF, (v >> 14) & 0x3FF, 3, \
            1 if sf == 0 else 4
    if sf == 2:
        v = int.from_bytes(hdr[:4], "little")
        return lit_type, (v >> 4) & 0x3FFF, (v >> 18) & 0x3FFF, 4, 4
    v = int.from_bytes(hdr[:5], "little")
    return lit_type, (v >> 4) & 0x3FFFF, (v >> 22) & 0x3FFFF, 5, 4


def _huf_cks(stream: bytes, table, out_len: int):
    """One huff0 stream's checkpoint record: u16 count, u32 remaining bits
    before every 32 symbols; None where the stream is not decodable."""
    from compress_tpu_torch.zstd.device_dec import _hwalk

    if not stream or stream[-1] == 0:
        return None
    nch = -(-out_len // _LIT_K) if out_len > 0 else 1
    if nch > 0xFFFF:
        return None
    cks = _hwalk(stream, *table, out_len, _LIT_K, strict=True)
    if cks is None:
        return None
    return _u16(nch) + np.asarray(cks, "<u4").tobytes()


def _compressed_block(bp: bytes, st: _State, max_rounds: int,
                      seq_cks: bool, hist_avail: int, hist_cap: int):
    """The record of a compressed block and its decoded size, or None."""
    bsize = len(bp)
    if bsize < 1:
        return None
    lit_type, regen, comp, pos, n_streams = _lit_header(
        (bp[:5] + bytes(5))[:5])
    if lit_type == B.LIT_TREELESS and st.huf is None:
        return None
    lit_kind = {0: 1, 1: 2}.get(lit_type, 0 if n_streams == 4 else 3)
    if regen > _BLOCK or pos + comp > bsize:
        return None
    streams, lens = [], []
    if lit_kind in (0, 3):
        lp = bp[pos:pos + comp]
        if lit_type == B.LIT_COMPRESSED:
            try:
                sym_t, nb_t, max_bits, used = read_table(lp, 0)
            except (ValueError, IndexError):
                st.huf = None
                return None
            st.huf = (sym_t, nb_t, max_bits)
            lp = lp[used:]
        if lit_kind == 0:
            if len(lp) < 6:
                return None
            l1, l2, l3 = (int.from_bytes(lp[2 * q:2 * q + 2], "little")
                          for q in range(3))
            if len(lp) - 6 - l1 - l2 - l3 < 0:
                return None
            cut = np.cumsum([6, l1, l2, l3, len(lp)])
            streams = [lp[a:b] for a, b in zip(cut[:-1], cut[1:])]
            seg = (regen + 3) // 4
            lens = [seg, seg, seg, regen - 3 * seg]
        else:
            streams, lens = [lp], [regen]

    # the sequences section's header
    spos = pos + comp
    if spos >= bsize:
        return None
    nseq = bp[spos]
    spos += 1
    if nseq >= 128:
        if nseq == 255:
            if spos + 2 > bsize:
                return None
            nseq = int.from_bytes(bp[spos:spos + 2], "little") + 0x7F00
            spos += 2
        else:
            if spos + 1 > bsize:
                return None
            nseq = ((nseq - 128) << 8) | bp[spos]
            spos += 1
    if nseq > 0:
        if spos >= bsize:
            return None
        modes = bp[spos]
        spos += 1
        for t, which in enumerate(("ll", "of", "ml")):
            try:
                st.tables[t], spos = B._read_table(
                    bp, spos, (modes >> (6 - 2 * t)) & 3, which, None,
                    st.tables[t])
            except (ValueError, IndexError):
                return None
    if nseq > _BLOCK:
        return None

    rec = bytearray([1 | (2 if seq_cks else 0), lit_kind])
    rec += _u32(regen) + _u32(nseq)
    total_at = len(rec)
    rec += _u32(0)
    for stream, n in zip(streams, lens):
        cks = _huf_cks(stream, st.huf, n)
        if cks is None:
            return None
        rec += cks
    if nseq > 0:
        walk = seqdev.seq_walk(bp[spos:], nseq, *st.tables, st.reps,
                               k=_SEQ_K)
        if walk is None:
            return None
        cks, lls, mls, offs, st.reps = walk
    else:
        if spos != bsize:
            return None
        cks, lls, mls, offs = [], [], [], []
    if seq_cks:
        rec += _u16(len(cks))
        for bitpos, s_ll, s_of, s_ml, r1, r2, r3 in cks:
            rec += (_u32(bitpos) + _u16(s_ll) + _u16(s_of) + _u16(s_ml)
                    + _u32(r1) + _u32(r2) + _u32(r3))
    lit_used = sum(lls)
    if lit_used > regen:
        return None
    total_out = regen + sum(mls)
    if total_out > _BLOCK:
        return None
    rec[total_at:total_at + 4] = _u32(total_out)

    kinds, lengths, offsets = [], [], []
    for ll, ml, off in zip(lls, mls, offs):
        if ll:
            kinds.append(0)
            lengths.append(ll)
            offsets.append(0)
        kinds.append(1)
        lengths.append(ml)
        offsets.append(off)
    if regen > lit_used:
        kinds.append(0)
        lengths.append(regen - lit_used)
        offsets.append(0)
    planned = plan_ops(kinds, lengths, offsets, max_rounds, OUT_BASE,
                       hist_avail, hist_cap)
    if planned is None:
        return None
    _dst, src, ln, rnd = planned
    rec += _pieces_record(src, ln, rnd)
    return rec, total_out


def build_payload(body: bytes, max_rounds: int = 4, seq_cks: bool = False,
                  hist_blocks: int = 0) -> bytes | None:
    """The sidecar payload ('CTA3') of one frame's blocks (``body``: the
    frame after its header), or None where the frame is not eligible."""
    if hist_blocks < 0 or hist_blocks > 128:
        return None
    hist_cap = hist_blocks << 16
    st = _State()
    recs = []
    pos = decoded = 0
    any_compressed = False
    n = len(body)
    while True:
        if pos + 3 > n or len(recs) >= 0xFFFF:
            return None
        bh = int.from_bytes(body[pos:pos + 3], "little")
        pos += 3
        last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        raw = 1 if btype == B.BLOCK_RLE else bsize
        if btype == 3 or bsize > (1 << 17) or pos + raw > n:
            return None
        if btype == B.BLOCK_COMPRESSED:
            got = _compressed_block(body[pos:pos + bsize], st, max_rounds,
                                    seq_cks, min(decoded, hist_cap),
                                    hist_cap)
            any_compressed = True
        else:
            got = _raw_block(btype, bsize, seq_cks)
        if got is None:
            return None
        rec, t = got
        recs.append(rec)
        decoded += t
        pos += raw
        if last:
            break
        # the device shifts the history by a whole block: every block but
        # the last must decode to exactly 64 KiB
        if t != _BLOCK:
            return None
    if not any_compressed:
        return None
    return b"CTA3" + _u16(len(recs)) + _u16(hist_blocks) + b"".join(recs)
