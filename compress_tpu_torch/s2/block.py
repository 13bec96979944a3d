"""S2/Snappy block codec on the host.

The JAX package's host codec (``s2/block.py``): ``encode`` and ``decode``
run the host core (``ct_s2_encode_block``, ``ct_s2_decode_block``), as
the reference's do by default; the better and best tiers
(``encode_better``, ``encode_best``) and their snappy-mode twins run
``ct_s2_encode_block_level``.  The reference specifies its Python path and
its native core's fast tier to give the same bytes; its Python path is
copied here as their plain versions (``_encode_block_py`` in S2 and
snappy mode, ``_decode_block_py``).  The better and best tiers have no
Python version in the reference either.  Format: the reference's s2/s2.go
tag spec and its repeat-offset extension.
"""

from __future__ import annotations

import numpy as np

from compress_tpu_torch import _native
from compress_tpu_torch.utils.varint import put_uvarint, read_uvarint

MAX_BLOCK_SIZE = 4 << 20  # framed-stream max uncompressed block
_MODE_S2 = 0
_MODE_SNAPPY = 1


class CorruptError(ValueError):
    """Input is not a valid S2/snappy block (reference: ErrCorrupt)."""


def max_encoded_len(n: int) -> int:
    """Worst-case block-encoding size for n source bytes (incl. preamble)."""
    if n < 0 or n > 0xFFFFFFFF:
        raise ValueError("block too large")
    return 32 + n + n // 6


def _decode_block_py(dst_len: int, src: bytes, mode: int) -> bytes:
    dst = bytearray(dst_len)
    d = 0
    s = 0
    n = len(src)
    offset = 0
    allow_repeat = mode == _MODE_S2
    while s < n:
        tag = src[s]
        kind = tag & 3
        if kind == 0:  # literal
            x = tag >> 2
            if x < 60:
                s += 1
            else:
                nb = x - 59
                if s + 1 + nb > n:
                    raise CorruptError("literal length truncated")
                x = int.from_bytes(src[s + 1 : s + 1 + nb], "little")
                s += 1 + nb
            length = x + 1
            if length > dst_len - d or length > n - s:
                raise CorruptError("literal overruns")
            dst[d : d + length] = src[s : s + length]
            d += length
            s += length
            continue
        if kind == 1:  # copy1 / repeat
            if s + 2 > n:
                raise CorruptError("copy1 truncated")
            toff = ((tag & 0xE0) << 3) | src[s + 1]
            length = (tag >> 2) & 7
            s += 2
            if toff == 0:
                if not allow_repeat:
                    raise CorruptError("repeat in snappy stream")
                if length == 5:
                    if s + 1 > n:
                        raise CorruptError("repeat len truncated")
                    length = src[s] + 4
                    s += 1
                elif length == 6:
                    if s + 2 > n:
                        raise CorruptError("repeat len truncated")
                    length = int.from_bytes(src[s : s + 2], "little") + 256
                    s += 2
                elif length == 7:
                    if s + 3 > n:
                        raise CorruptError("repeat len truncated")
                    length = int.from_bytes(src[s : s + 3], "little") + 65536
                    s += 3
            else:
                offset = toff
            length += 4
        elif kind == 2:  # copy2
            if s + 3 > n:
                raise CorruptError("copy2 truncated")
            offset = int.from_bytes(src[s + 1 : s + 3], "little")
            length = 1 + (tag >> 2)
            s += 3
        else:  # copy4
            if s + 5 > n:
                raise CorruptError("copy4 truncated")
            offset = int.from_bytes(src[s + 1 : s + 5], "little")
            length = 1 + (tag >> 2)
            s += 5
        if offset == 0 or d < offset or length > dst_len - d:
            raise CorruptError("bad copy")
        if offset >= length:
            dst[d : d + length] = dst[d - offset : d - offset + length]
        else:
            for i in range(length):
                dst[d + i] = dst[d - offset + i]
        d += length
    if d != dst_len:
        raise CorruptError("short decode")
    return bytes(dst)


def decode(block, *, allow_repeat: bool = True) -> bytes:
    """Decode an S2 (or snappy) block. Reference: s2.Decode.

    allow_repeat=False gives strict-snappy validation (snappy.Decode).
    """
    block = bytes(block)
    dlen, pos = read_uvarint(block)
    if dlen > (1 << 32) - 1:
        raise CorruptError("decoded length too large")
    body = block[pos:]
    arr, dst = _native.out_buf(dlen)
    rc = _native.library().ct_s2_decode_block(dst, dlen, body, len(body),
                                              1 if allow_repeat else 0)
    if rc != 0:
        raise CorruptError("corrupt block")
    return arr.tobytes()


# ---------------------------------------------------------------------------
# Encoder: the host core's tiers; the reference's Python path below is the
# fast tier's plain version
# ---------------------------------------------------------------------------

_MUL = 0x9E3779B185EBCA87


def _emit_literal(out: bytearray, lit) -> None:
    n = len(lit)
    if n == 0:
        return
    x = n - 1
    if x < 60:
        out.append(x << 2)
    elif x < 1 << 8:
        out.append(60 << 2)
        out.append(x)
    elif x < 1 << 16:
        out.append(61 << 2)
        out += x.to_bytes(2, "little")
    elif x < 1 << 24:
        out.append(62 << 2)
        out += x.to_bytes(3, "little")
    else:
        out.append(63 << 2)
        out += x.to_bytes(4, "little")
    out += lit


def _emit_repeat(out: bytearray, length: int) -> None:
    while True:
        if length <= 8:
            out.append(((length - 4) << 2) | 1)
            out.append(0)
            return
        if length <= 263:
            out.append((5 << 2) | 1)
            out.append(0)
            out.append(length - 8)
            return
        if length <= 65795:
            out.append((6 << 2) | 1)
            out.append(0)
            out += (length - 260).to_bytes(2, "little")
            return
        maxl = 65539 + (1 << 24) - 1
        take = min(length, maxl)
        if length - take != 0 and length - take < 4:
            take = length - 4
        out.append((7 << 2) | 1)
        out.append(0)
        out += (take - 65540).to_bytes(3, "little")
        length -= take
        if length == 0:
            return


def _emit_copy_s2(out: bytearray, offset: int, length: int) -> None:
    if offset >= 65536:
        if length > 64:
            first = 64 if length - 64 >= 4 else 60
            out.append(((first - 1) << 2) | 3)
            out += offset.to_bytes(4, "little")
            _emit_repeat(out, length - first)
            return
        out.append(((length - 1) << 2) | 3)
        out += offset.to_bytes(4, "little")
        return
    if length > 64:
        first = 64 if length - 64 >= 4 else 60
        out.append(((first - 1) << 2) | 2)
        out += offset.to_bytes(2, "little")
        _emit_repeat(out, length - first)
        return
    if offset < 2048 and length <= 11:
        out.append(((offset >> 8) << 5) | ((length - 4) << 2) | 1)
        out.append(offset & 0xFF)
        return
    out.append(((length - 1) << 2) | 2)
    out += offset.to_bytes(2, "little")


def _emit_copy_snappy(out: bytearray, offset: int, length: int) -> None:
    tag = 3 if offset >= 65536 else 2
    ob = 4 if offset >= 65536 else 2
    while length > 68:
        out.append((63 << 2) | tag)
        out += offset.to_bytes(ob, "little")
        length -= 64
    if length > 64:
        out.append((59 << 2) | tag)
        out += offset.to_bytes(ob, "little")
        length -= 60
    if offset < 2048 and 4 <= length <= 11:
        out.append(((offset >> 8) << 5) | ((length - 4) << 2) | 1)
        out.append(offset & 0xFF)
        return
    out.append(((length - 1) << 2) | tag)
    out += offset.to_bytes(ob, "little")


def _table_bits(n: int) -> int:
    b = 8
    while (1 << b) < n and b < 16:
        b += 1
    return b


def match_len(buf: bytes, a: int, b: int, maxlen: int) -> int:
    """Length of the common prefix of buf[a:] and buf[b:], at most maxlen:
    slices compared in growing steps, the first differing byte found by
    halving the step that differs."""
    n, step = 0, 16
    while n < maxlen:
        m = min(step, maxlen - n)
        if buf[a + n:a + n + m] != buf[b + n:b + n + m]:
            while m > 1:   # the first difference lies in [n, n + m)
                h = m >> 1
                if buf[a + n:a + n + h] == buf[b + n:b + n + h]:
                    n += h
                    m -= h
                else:
                    m = h
            return n
        n += m
        step *= 4
    return max(maxlen, 0)


def _encode_block_py(src: bytes, mode: int = _MODE_S2) -> bytes:
    """The reference's repeat-aware greedy block encoder, S2 or snappy
    mode (its scan reads Python lists where the reference indexes numpy
    arrays; the values are the same)."""
    n = len(src)
    out = bytearray()
    if n == 0:
        return b""
    if n < 16:
        _emit_literal(out, src)
        return bytes(out)
    shift = 64 - _table_bits(n)
    table = [-1] * (1 << (64 - shift))
    buf = np.frombuffer(src, dtype=np.uint8)
    b8 = np.concatenate([buf, np.zeros(8, np.uint8)])
    v32_64 = (b8[:n].astype(np.uint64)
              | (b8[1:n + 1].astype(np.uint64) << np.uint64(8))
              | (b8[2:n + 2].astype(np.uint64) << np.uint64(16))
              | (b8[3:n + 3].astype(np.uint64) << np.uint64(24)))
    hashes = (((v32_64 << np.uint64(32)) * np.uint64(_MUL))
              >> np.uint64(shift)).tolist()
    v32 = v32_64.tolist()
    s = 1
    next_emit = 0
    repeat = 0
    snappy = mode == _MODE_SNAPPY
    mv = memoryview(src)
    while True:
        while True:   # probe
            if s + 16 > n:
                if next_emit < n:
                    _emit_literal(out, mv[next_emit:n])
                return bytes(out)
            h = hashes[s]
            c = table[h]
            table[h] = s
            if not snappy and repeat > 0 and v32[s] == v32[s - repeat]:
                cand = s - repeat
                is_rep = True
                break
            # c < s: after backward extension a short match can leave the
            # scan behind a stale table entry
            if 0 <= c < s and v32[c] == v32[s]:
                cand = c
                is_rep = False
                break
            s += 1 + ((s - next_emit) >> 6)
        while s > next_emit and cand > 0 and src[s - 1] == src[cand - 1]:
            s -= 1
            cand -= 1
        _emit_literal(out, mv[next_emit:s])
        offset = s - cand
        length = 4 + match_len(src, cand + 4, s + 4, n - s - 4)
        if is_rep:
            _emit_repeat(out, length)
        elif snappy:
            _emit_copy_snappy(out, offset, length)
        else:
            _emit_copy_s2(out, offset, length)
        repeat = offset
        s += length
        next_emit = s
        if s + 16 > n:
            if next_emit < n:
                _emit_literal(out, mv[next_emit:n])
            return bytes(out)
        for d in (1, 2, 3, 4):   # the native core's write order
            table[hashes[s - d]] = s - d


def _encode_body(src: bytes, mode: int, level: int = 1) -> bytes:
    """The block body of src without the length: the host core's fast
    tier (level 1 and below), better (2) or best (3 and above) search, in
    S2 or snappy mode."""
    src = bytes(src)
    n = len(src)
    arr, dst = _native.out_buf(max_encoded_len(n))
    lib = _native.library()
    if level <= 1:
        m = lib.ct_s2_encode_block(dst, src, n, mode)
    else:
        m = lib.ct_s2_encode_block_level(dst, src, n, mode, level)
    if m < 0:
        raise MemoryError("native s2 encode failed")
    return arr[:m].tobytes()


def encode_body(src) -> bytes:
    """The S2 block body of src, without the length (host core)."""
    return _encode_body(src, _MODE_S2)


def _wrap(src: bytes, mode: int, level: int = 1) -> bytes:
    out = bytearray()
    put_uvarint(out, len(src))
    return bytes(out) + _encode_body(src, mode, level)


def encode(src) -> bytes:
    """S2 block encode (repeat offsets allowed): the uvarint length, then
    the body.  Reference: s2.Encode."""
    return _wrap(bytes(src), _MODE_S2)


def encode_better(src) -> bytes:
    """S2 block encode, better tier (two-table greedy search).  Reference:
    s2.EncodeBetter."""
    return _wrap(bytes(src), _MODE_S2, 2)


def encode_best(src) -> bytes:
    """S2 block encode, best tier (hash-chain lazy search).  Reference:
    s2.EncodeBest."""
    return _wrap(bytes(src), _MODE_S2, 3)


def encode_snappy(src) -> bytes:
    """Snappy-compatible block encode.  Reference: s2.EncodeSnappy."""
    return _wrap(bytes(src), _MODE_SNAPPY)


def encode_snappy_better(src) -> bytes:
    """Snappy-compatible better-tier encode.  Reference:
    s2.EncodeSnappyBetter."""
    return _wrap(bytes(src), _MODE_SNAPPY, 2)


def encode_snappy_best(src) -> bytes:
    """Snappy-compatible best-tier encode.  Reference: s2.EncodeSnappyBest."""
    return _wrap(bytes(src), _MODE_SNAPPY, 3)


def decoded_len(block) -> int:
    """Uncompressed size of a block.  Reference: s2.DecodedLen."""
    v, _ = read_uvarint(block)
    return v


def concat_blocks(*blocks) -> bytes:
    """Concatenate S2 blocks into one valid block (reference:
    s2.ConcatBlocks): the op streams splice as they are, every copy offset
    staying within the combined decoded history."""
    total = 0
    bodies = []
    for b in blocks:
        b = bytes(b)
        n, pos = read_uvarint(b)
        total += n
        bodies.append(b[pos:])
    if total > MAX_BLOCK_SIZE:
        raise ValueError("concatenated block too large")
    out = bytearray()
    put_uvarint(out, total)
    for body in bodies:
        out += body
    return bytes(out)


def estimate_block_size(src) -> int:
    """An estimate of len(encode(src)) (reference: s2.EstimateBlockSize):
    the fast encoder on the input, or on a head and a middle sample of
    32 KiB each for a larger input, scaled."""
    src = bytes(src)
    n = len(src)
    if n == 0:
        return 1
    if n > MAX_BLOCK_SIZE:
        raise ValueError("block too large")
    sample = 32 << 10
    if n <= 2 * sample:
        return len(_encode_body(src, _MODE_S2)) + 8
    head = len(_encode_body(src[:sample], _MODE_S2))
    mid_at = (n - sample) // 2
    mid = len(_encode_body(src[mid_at:mid_at + sample], _MODE_S2))
    est = int(n * (head + mid) / (2 * sample)) + 32
    return min(est, max_encoded_len(n))
