"""A copy of the JAX package's ``snappy/__init__.py``.

snappy — compatibility facade over the S2 codec (strict snappy output).

Reference parity: snappy/ package — Encode delegates to the S2 snappy mode,
Decode is strict (repeat offsets rejected), Reader/Writer are the S2 stream
types in snappy-compat mode (snappy/encode.go:20, decode.go:46).
"""

from __future__ import annotations

from compress_tpu_torch.s2 import block as s2block
from compress_tpu_torch.s2 import stream as s2stream

CorruptError = s2block.CorruptError
MAX_BLOCK_SIZE = s2stream.SNAPPY_BLOCK_SIZE


def encode(src) -> bytes:
    """Snappy-format block encode (reference: snappy.Encode -> s2 snappy)."""
    return s2block.encode_snappy(src)


def decode(block) -> bytes:
    """Strict snappy block decode: S2 repeat extensions are rejected."""
    return s2block.decode(block, allow_repeat=False)


def decoded_len(block) -> int:
    return s2block.decoded_len(block)


def max_encoded_len(n: int) -> int:
    return s2block.max_encoded_len(n)


def writer(dst, **opts):
    """Framed snappy stream writer (reference: snappy.NewBufferedWriter)."""
    opts.setdefault("block_size", s2stream.SNAPPY_BLOCK_SIZE)
    return s2stream.Writer(dst, snappy=True, **opts)


def reader(src, **opts):
    """Framed snappy stream reader (reference: snappy.NewReader)."""
    return s2stream.Reader(src, **opts)


__all__ = [
    "encode", "decode", "decoded_len", "max_encoded_len",
    "writer", "reader", "CorruptError", "MAX_BLOCK_SIZE",
]
