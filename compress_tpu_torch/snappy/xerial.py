"""A copy of the JAX package's ``snappy/xerial.py``.

xerial — Kafka's snappy-java framing (snappy/xerial/xerial.go parity).

Layout: 8-byte magic {130,'SNAPPY',0} + version/compat (4+4 BE) followed by
[4-byte BE compressed length][snappy block] units of <=32 KiB input each.
Plain (unframed) snappy blocks are also accepted on decode, like the
reference's Decode fallback.
"""

from __future__ import annotations

from compress_tpu_torch.s2 import block as s2block

HEADER = bytes([130, 83, 78, 65, 80, 80, 89, 0])
VERSION_INFO = bytes([0, 0, 0, 1, 0, 0, 0, 1])
_BLOCK = 32 * 1024


class MalformedError(ValueError):
    """Reference: xerial.ErrMalformed."""


def _encode_with(src, block_fn) -> bytes:
    src = bytes(src)
    out = bytearray(HEADER + VERSION_INFO)
    for pos in range(0, max(len(src), 1), _BLOCK):
        chunk = src[pos : pos + _BLOCK]
        if not chunk and src:
            break
        enc = block_fn(chunk)
        out += len(enc).to_bytes(4, "big")
        out += enc
    return bytes(out)


def encode(src) -> bytes:
    return _encode_with(src, s2block.encode_snappy)


def encode_better(src) -> bytes:
    """Reference: xerial.EncodeBetter — same framing, two-table better
    search (s2block.encode_snappy_better)."""
    return _encode_with(src, s2block.encode_snappy_better)


def decode(blob) -> bytes:
    blob = bytes(blob)
    if len(blob) < 16 or blob[:8] != HEADER:
        # not xerial-framed: treat as a plain snappy block (reference behavior)
        return s2block.decode(blob, allow_repeat=False)
    pos = 16
    out = bytearray()
    while pos < len(blob):
        if pos + 4 > len(blob):
            raise MalformedError("truncated block length")
        n = int.from_bytes(blob[pos : pos + 4], "big")
        pos += 4
        if pos + n > len(blob):
            raise MalformedError("truncated block")
        try:
            out += s2block.decode(blob[pos : pos + n], allow_repeat=False)
        except s2block.CorruptError as e:
            raise MalformedError(str(e)) from e
        pos += n
    return bytes(out)


def decode_capped(blob, max_size: int) -> bytes:
    """Reference: xerial.DecodeCapped — bounded output size."""
    out = decode(blob)
    if len(out) > max_size:
        raise MalformedError("output exceeds cap")
    return out


__all__ = ["encode", "encode_better", "decode", "decode_capped",
           "MalformedError", "HEADER"]
