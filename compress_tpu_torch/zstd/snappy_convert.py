"""Snappy framed stream -> zstd frame conversion (a copy of the JAX
package's ``zstd/snappy_convert.py``, on the port's host codecs).

Reference parity: zstd/snappy.go SnappyConverter.Convert — re-tags snappy
LZ ops as zstd sequences without a new match search; literals go through the
normal huffman stage. Each snappy chunk (<=64 KiB, offsets intra-chunk)
becomes one zstd block; CRCs are verified on the way in.
"""

from __future__ import annotations

import numpy as np

from compress_tpu_torch.s2 import block as s2block
from compress_tpu_torch.s2 import stream as s2stream
from compress_tpu_torch.utils.crc import crc32c_masked
from compress_tpu_torch.utils.varint import read_uvarint
from compress_tpu_torch.utils.xxhash64 import xxh64
from compress_tpu_torch.zstd import frame as F
from compress_tpu_torch.zstd.encoder import (encode_literals,
                                             encode_sequences_section,
                                             offsets_to_values)


class SnappyConvertError(ValueError):
    pass


def _block_ops(body: bytes, dlen: int):
    """Parse a snappy block into (lls, mls, offs, literals, tail)."""
    s = 0
    n = len(body)
    pos = 0
    lls, mls, offs = [], [], []
    lits = bytearray()
    cur_lit = 0
    while s < n:
        tag = body[s]
        kind = tag & 3
        if kind == 0:
            x = tag >> 2
            if x < 60:
                s += 1
            else:
                nb = x - 59
                x = int.from_bytes(body[s + 1 : s + 1 + nb], "little")
                s += 1 + nb
            length = x + 1
            lits += body[s : s + length]
            cur_lit += length
            s += length
            pos += length
            continue
        if kind == 1:
            offset = ((tag & 0xE0) << 3) | body[s + 1]
            length = 4 + ((tag >> 2) & 7)
            s += 2
            if offset == 0:
                raise SnappyConvertError("repeat op in snappy stream")
        elif kind == 2:
            offset = int.from_bytes(body[s + 1 : s + 3], "little")
            length = 1 + (tag >> 2)
            s += 3
        else:
            offset = int.from_bytes(body[s + 1 : s + 5], "little")
            length = 1 + (tag >> 2)
            s += 5
        if offset == 0 or offset > pos:
            raise SnappyConvertError("bad offset")
        if length < 3:
            # zstd min match is 3: fold tiny copies into literals by
            # materializing them (rare: snappy emits >=4 except converters)
            start = pos - offset
            # materialize from decoded prefix: we don't track full output;
            # snappy itself never emits <4, treat as corrupt
            raise SnappyConvertError("match shorter than 3")
        lls.append(cur_lit)
        mls.append(length)
        offs.append(offset)
        cur_lit = 0
        pos += length
    if pos != dlen:
        raise SnappyConvertError("length mismatch")
    return (np.array(lls, np.int64), np.array(mls, np.int64),
            np.array(offs, np.int64), bytes(lits))


def convert(snappy_stream, checksum: bool = True) -> bytes:
    """Convert a framed snappy/S2-snappy stream to one zstd frame."""
    data = bytes(snappy_stream)
    pos = 0
    blocks = []  # (decoded_chunk, ops or None)
    total = 0
    while pos < len(data):
        if pos + 4 > len(data):
            raise SnappyConvertError("truncated chunk header")
        ctype = data[pos]
        clen = int.from_bytes(data[pos + 1 : pos + 4], "little")
        body = data[pos + 4 : pos + 4 + clen]
        pos += 4 + clen
        if ctype == s2stream.CHUNK_STREAM_ID:
            continue
        if ctype == s2stream.CHUNK_UNCOMPRESSED:
            chunk = body[4:]
            if crc32c_masked(chunk) != int.from_bytes(body[:4], "little"):
                raise SnappyConvertError("crc mismatch")
            blocks.append((chunk, None))
            total += len(chunk)
            continue
        if ctype == s2stream.CHUNK_COMPRESSED:
            payload = body[4:]
            dlen, p = read_uvarint(payload)
            chunk = s2block.decode(payload, allow_repeat=False)
            if crc32c_masked(chunk) != int.from_bytes(body[:4], "little"):
                raise SnappyConvertError("crc mismatch")
            ops = _block_ops(payload[p:], dlen)
            blocks.append((chunk, ops))
            total += dlen
            continue
        # skippable chunks dropped
    out = bytearray(F.write_frame_header(total, max(total, 1024), False, checksum))
    digest = bytearray()
    reps = (1, 4, 8)  # carried across blocks (raw blocks don't touch them)
    for bi, (chunk, ops) in enumerate(blocks):
        last = bi == len(blocks) - 1
        body = None
        cand_reps = reps
        if ops is not None and len(ops[0]):
            lls, mls, offs, lits = ops
            vals, cand_reps = offsets_to_values(lls, offs, reps)
            lit_sec = encode_literals(lits)
            seq_sec = encode_sequences_section(lls, mls, vals)
            body = lit_sec + seq_sec
        if body is None or len(body) >= len(chunk):
            bh = (1 if last else 0) | (0 << 1) | (len(chunk) << 3)
            out += bh.to_bytes(3, "little")
            out += chunk
        else:
            bh = (1 if last else 0) | (2 << 1) | (len(body) << 3)
            out += bh.to_bytes(3, "little")
            out += body
            reps = cand_reps
        digest += chunk
    if not blocks:
        out += (1).to_bytes(3, "little")  # empty raw last block
    if checksum:
        out += (xxh64(bytes(digest)) & 0xFFFFFFFF).to_bytes(4, "little")
    return bytes(out)


__all__ = ["convert", "SnappyConvertError"]
