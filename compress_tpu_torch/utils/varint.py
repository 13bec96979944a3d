"""Unsigned and zig-zag signed base-128 varints (Go encoding/binary
compatible).

The S2 block preamble (uncompressed length) and the S2 seek index use
them.  A copy of ``put_uvarint``, ``read_uvarint``, ``put_varint`` and
``read_varint`` from the JAX package's ``utils/varint.py``: the port
imports nothing of that package.
"""

from __future__ import annotations

_MAX_VARINT_LEN64 = 10


def put_uvarint(out: bytearray, x: int) -> int:
    """Append x as a uvarint; returns number of bytes written."""
    n = 0
    while x >= 0x80:
        out.append((x & 0x7F) | 0x80)
        x >>= 7
        n += 1
    out.append(x)
    return n + 1


def read_uvarint(buf, pos: int = 0) -> tuple[int, int]:
    """Decode a uvarint from buf[pos:]. Returns (value, new_pos).

    Raises ValueError on overflow or truncation (matching Go's
    binary.Uvarint's <=0 return conditions, which s2 treats as corrupt).
    """
    x = 0
    s = 0
    for i in range(_MAX_VARINT_LEN64):
        if pos + i >= len(buf):
            raise ValueError("uvarint: truncated")
        b = buf[pos + i]
        if b < 0x80:
            if i == _MAX_VARINT_LEN64 - 1 and b > 1:
                raise ValueError("uvarint: overflow")
            return x | (b << s), pos + i + 1
        x |= (b & 0x7F) << s
        s += 7
    raise ValueError("uvarint: overflow")


def put_varint(out: bytearray, x: int) -> int:
    """Zig-zag signed varint (Go binary.PutVarint)."""
    ux = (x << 1) ^ (x >> 63) if x < 0 else (x << 1)
    return put_uvarint(out, ux & ((1 << 64) - 1))


def read_varint(buf, pos: int = 0) -> tuple[int, int]:
    """Decode a zig-zag signed varint: (value, new_pos)."""
    ux, pos = read_uvarint(buf, pos)
    x = ux >> 1
    if ux & 1:
        x = ~x
    return x, pos
