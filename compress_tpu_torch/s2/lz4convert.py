"""A copy of the JAX package's ``s2/lz4convert.py``.

LZ4 -> S2/Snappy block transcoding, reusing LZ4's match structure.

Reference parity: s2/lz4convert.go (LZ4Converter: ConvertBlock) and
s2/lz4sconvert.go (LZ4s, the Intel QAT stream variant). The LZ4 sequences
are re-tagged as S2 ops without any new match search; repeat offsets are
applied when consecutive matches share an offset.

LZ4 block format (public spec): token byte = (lit_len:4 | match_len-4:4),
15 in a nibble extends with 255-terminated bytes; 2-byte LE offset;
the final sequence is literals-only. LZ4s differs: min match 3 (token low
nibble stores match_len-3... variant handled via min_match parameter) and a
0-match token is allowed mid-stream.
"""

from __future__ import annotations

from compress_tpu_torch.s2 import block as s2block
from compress_tpu_torch.utils.varint import put_uvarint


class LZ4Error(ValueError):
    """Reference: ErrCorrupt/ErrDstTooSmall analogues."""


def _parse_lz4_block(src: bytes, min_match: int = 4):
    """Yield (lit_bytes, match_len, offset); final op has match_len 0."""
    s = 0
    n = len(src)
    while s < n:
        token = src[s]
        s += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                if s >= n:
                    raise LZ4Error("literal length truncated")
                b = src[s]
                s += 1
                lit_len += b
                if b != 255:
                    break
        if s + lit_len > n:
            raise LZ4Error("literals truncated")
        lits = src[s : s + lit_len]
        s += lit_len
        if s >= n:
            yield lits, 0, 0
            return
        if s + 2 > n:
            raise LZ4Error("offset truncated")
        offset = int.from_bytes(src[s : s + 2], "little")
        s += 2
        if offset == 0:
            raise LZ4Error("zero offset")
        ml = (token & 0xF)
        if ml == 15:
            while True:
                if s >= n:
                    raise LZ4Error("match length truncated")
                b = src[s]
                s += 1
                ml += b
                if b != 255:
                    break
        ml += min_match
        yield lits, ml, offset
    # LZ4s streams may end exactly at a sequence boundary
    return


def lz4_decompressed_len(src: bytes, min_match: int = 4) -> int:
    total = 0
    for lits, ml, _ in _parse_lz4_block(src, min_match):
        total += len(lits) + ml
    return total


def convert_block(src: bytes, snappy: bool = False, min_match: int = 4) -> bytes:
    """LZ4 block -> S2 (or snappy) block. Returns the full block with the

    uvarint preamble. Reference: LZ4Converter.ConvertBlock."""
    ops = list(_parse_lz4_block(bytes(src), min_match))
    total = sum(len(l) + m for l, m, _ in ops)
    out = bytearray()
    put_uvarint(out, total)
    repeat = 0
    pos = 0
    for lits, ml, off in ops:
        if lits:
            s2block._emit_literal(out, lits)
            pos += len(lits)
        if ml:
            if off > pos:
                raise LZ4Error("offset before block start")
            if not snappy and off == repeat:
                s2block._emit_repeat(out, ml)
            elif snappy:
                s2block._emit_copy_snappy(out, off, ml)
            else:
                s2block._emit_copy_s2(out, off, ml)
            repeat = off
            pos += ml
    return bytes(out)


def convert_block_lz4s(src: bytes, snappy: bool = False) -> bytes:
    """LZ4s (QAT) variant: min match 3, zero-match tokens allowed.

    Reference: LZ4sConverter."""
    ops = []
    s = 0
    src = bytes(src)
    n = len(src)
    while s < n:
        token = src[s]
        s += 1
        lit_len = token >> 4
        if lit_len == 15:
            while True:
                b = src[s]
                s += 1
                lit_len += b
                if b != 255:
                    break
        lits = src[s : s + lit_len]
        if len(lits) != lit_len:
            raise LZ4Error("literals truncated")
        s += lit_len
        ml = token & 0xF
        if s >= n:
            ops.append((lits, 0, 0))
            break
        if ml == 0:
            # literals-only sequence mid-stream (no offset field in LZ4s
            # when match nibble is 0)
            ops.append((lits, 0, 0))
            continue
        offset = int.from_bytes(src[s : s + 2], "little")
        s += 2
        if ml == 15:
            while True:
                b = src[s]
                s += 1
                ml += b
                if b != 255:
                    break
        ml += 3
        ops.append((lits, ml, offset))
    total = sum(len(l) + m for l, m, _ in ops)
    out = bytearray()
    put_uvarint(out, total)
    repeat = 0
    pos = 0
    for lits, ml, off in ops:
        if lits:
            s2block._emit_literal(out, lits)
            pos += len(lits)
        if ml:
            if off == 0 or off > pos:
                raise LZ4Error("bad offset")
            if ml < 4:
                # a 3-byte match can't be a plain s2 copy tag minimum? copy
                # tags support length>=4 only for copy1; copy2 supports 1..64
                s2block._emit_copy_snappy(out, off, ml) if snappy else out.extend(
                    bytes([((ml - 1) << 2) | 2]) + off.to_bytes(2, "little"))
            elif not snappy and off == repeat:
                s2block._emit_repeat(out, ml)
            elif snappy:
                s2block._emit_copy_snappy(out, off, ml)
            else:
                s2block._emit_copy_s2(out, off, ml)
            repeat = off
            pos += ml
    return bytes(out)


__all__ = ["convert_block", "convert_block_lz4s", "lz4_decompressed_len", "LZ4Error"]
