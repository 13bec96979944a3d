"""Host planner of the S2/Snappy device decode, the plain version of the
native ``ct_s2_build_plan`` (``_native/src/zstd_dec.cpp``: the tag parse,
``plan_ops`` and ``plan_emit``) that ``s2.device_dec.native_plan`` calls:
a Python copy of it.

The tag stream of one block (s2/s2.go's tag spec with the repeat-offset
extension, or strict snappy) becomes decode-order ops (literal runs and
copies); the port's one planner, ``ops/execute.plan_ops``, plans them for
the arena execute (``ops/exec_kern.py``) with the arena class M = the
least power of two with M * 64 KiB >= the block's length: output base
M * OUT_BASE, output capacity M * 64 KiB.

``build_plan`` returns what ``s2.device_dec._parse_payload`` reads from
the native payload, or ``None`` exactly where the native call returns a
value <= 0 (block longer than 256 KiB, corrupt tag stream, wrong length).
"""

from __future__ import annotations

import numpy as np

from compress_tpu_torch.ops.execute import OUT_BASE, plan_ops

MAX_LEN = 1 << 18      # longest block the device decode plans


def arena_class(total: int) -> int:
    """Least power of two M with M * 64 KiB >= total."""
    m = 1
    while m * (1 << 16) < total:
        m <<= 1
    return m


def _parse_tags(src: bytes, dlen: int, allow_repeat: bool):
    """Tag stream -> (kinds, lens, offs, literal bytes): decode-order ops
    for ``plan_ops`` (kind 0 = literal run, consecutive literal tags merged
    into one; kind 1 = copy), or None if corrupt."""
    slen = len(src)
    ocap = 4 * dlen + 1024
    kinds, lens, offs = [], [], []
    n_copies = 0
    lits = []
    total = 0
    s = 0
    offset = 0
    while s < slen:
        tag = src[s]
        kind = tag & 3
        if kind == 0:
            x = tag >> 2
            if x < 60:
                s += 1
            else:
                nb = x - 59
                if s + 1 + nb > slen:
                    return None
                x = int.from_bytes(src[s + 1:s + 1 + nb], "little")
                s += 1 + nb
            length = x + 1
            if length > slen - s or total + length > dlen:
                return None
            lits.append(src[s:s + length])
            if kinds and kinds[-1] == 0:
                lens[-1] += length
            else:
                kinds.append(0)
                lens.append(length)
                offs.append(0)
            total += length
            s += length
            continue
        if kind == 1:
            if s + 2 > slen:
                return None
            toff = ((tag & 0xE0) << 3) | src[s + 1]
            length = (tag >> 2) & 7
            s += 2
            if toff == 0:
                if not allow_repeat:
                    return None
                if length == 5:
                    if s + 1 > slen:
                        return None
                    length = src[s] + 4
                    s += 1
                elif length == 6:
                    if s + 2 > slen:
                        return None
                    length = (src[s] | src[s + 1] << 8) + 256
                    s += 2
                elif length == 7:
                    if s + 3 > slen:
                        return None
                    length = (src[s] | src[s + 1] << 8
                              | src[s + 2] << 16) + 65536
                    s += 3
            else:
                offset = toff
            length += 4
        elif kind == 2:
            if s + 3 > slen:
                return None
            offset = src[s + 1] | src[s + 2] << 8
            length = 1 + (tag >> 2)
            s += 3
        else:
            if s + 5 > slen:
                return None
            offset = int.from_bytes(src[s + 1:s + 5], "little")
            length = 1 + (tag >> 2)
            s += 5
        if (offset == 0 or offset > total or total + length > dlen
                or n_copies >= ocap):
            return None
        kinds.append(1)
        lens.append(length)
        offs.append(offset)
        n_copies += 1
        total += length
    if total != dlen:
        return None
    return kinds, lens, offs, b"".join(lits)


def build_plan(body: bytes, dlen: int, allow_repeat: bool = True,
               max_rounds: int = 4):
    """Plan one block body (the bytes after the uvarint length) of decoded
    length ``dlen``.  Returns (total, lit bytes, src, len, round, n_rounds)
    with src/len/round int32 arrays in emission order (the native
    payload's fields; len and round are bytes there), or None where the
    native planner refuses the block."""
    if dlen > MAX_LEN or dlen < 0:
        return None
    parsed = _parse_tags(bytes(body), dlen, allow_repeat)
    if parsed is None:
        return None
    kinds, lens, offs, lit = parsed
    planned = plan_ops(kinds, lens, offs, max_rounds,
                       arena_class(dlen) * OUT_BASE)
    if planned is None:
        return None
    _, p_src, p_len, p_rnd = planned
    n_rounds = (int(p_rnd.max()) + 1 if len(p_rnd) else 1) & 0xFF
    return (dlen, lit, p_src.astype(np.int32),
            (p_len & 0xFF).astype(np.int32),
            (p_rnd & 0xFF).astype(np.int32), n_rounds)
