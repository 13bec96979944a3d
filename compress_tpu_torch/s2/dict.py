"""A copy of the JAX package's ``s2/dict.py``, whose encoder and decoder
are Python in the reference too (no native entry takes a dictionary).

S2 dictionaries: <=64 KiB content + initial repeat offset.

Reference parity: s2/dict.go (Dict, MakeDict, NewDict, Bytes, per-level
encode) and the "Dictionary Encoding" spec in s2/README.md: serialized as
``[uvarint initial-repeat-offset-into-content][content 16..65536 bytes]``;
decoders see the content as preceding the block; references must not cross
out of the dictionary; dict use stops after 64 KiB of output.
"""

from __future__ import annotations

import numpy as np

from compress_tpu_torch.s2 import block as s2block
from compress_tpu_torch.utils.varint import put_uvarint, read_uvarint

MIN_DICT_SIZE = 16
MAX_DICT_SIZE = 65536
MAX_DICT_SRC_OFFSET = 65535  # dict references only in the first 64KB


class Dict:
    def __init__(self, content: bytes, repeat_offset_into_content: int = 0):
        content = bytes(content)
        if not MIN_DICT_SIZE <= len(content) <= MAX_DICT_SIZE:
            raise ValueError("dict content must be 16..65536 bytes")
        if repeat_offset_into_content >= len(content) - 8:
            raise ValueError("repeat offset must be < len(dict)-8")
        self.content = content
        self.repeat_into = repeat_offset_into_content

    @property
    def initial_backref(self) -> int:
        """Back-reference distance at output position 0 for a repeat op."""
        return len(self.content) - self.repeat_into

    def bytes(self) -> bytes:
        out = bytearray()
        put_uvarint(out, self.repeat_into)
        return bytes(out) + self.content


def make_dict(content: bytes, first_bytes: bytes | None = None) -> Dict:
    """Reference: s2.MakeDict — optionally point the initial repeat at the

    first occurrence of `first_bytes` in the content."""
    off = 0
    if first_bytes:
        idx = bytes(content).find(bytes(first_bytes))
        if idx >= 0:
            off = idx
    return Dict(content, off)


def load_dict(blob: bytes) -> Dict:
    """Reference: s2.NewDict (parse serialized dictionary)."""
    off, pos = read_uvarint(blob)
    return Dict(blob[pos:], off)


def encode_with_dict(src: bytes, d: Dict) -> bytes:
    """S2 block encode using dictionary history (reference: Dict.Encode)."""
    src = bytes(src)
    n = len(src)
    out = bytearray()
    put_uvarint(out, n)
    if n == 0:
        return bytes(out)
    combined = d.content + src
    base = len(d.content)
    # encode with the python path over combined; shift op semantics:
    # we reuse the block encoder by running it over combined and dropping
    # everything before base. Offsets reaching into the dict are valid.
    body = _encode_with_prefix(combined, base, d)
    return bytes(out) + body


def _encode_with_prefix(combined: bytes, base: int, d: Dict) -> bytes:
    n = len(combined)
    out = bytearray()
    data_len = n - base
    if data_len < 16:
        s2block._emit_literal(out, combined[base:])
        return bytes(out)
    bits = s2block._table_bits(n)
    shift = 64 - bits
    table = np.full(1 << bits, -1, dtype=np.int64)
    buf = np.frombuffer(combined, dtype=np.uint8)
    b8 = np.concatenate([buf, np.zeros(8, np.uint8)])
    v32_64 = (
        b8[:n].astype(np.uint64)
        | (b8[1 : n + 1].astype(np.uint64) << np.uint64(8))
        | (b8[2 : n + 2].astype(np.uint64) << np.uint64(16))
        | (b8[3 : n + 3].astype(np.uint64) << np.uint64(24))
    )
    hashes = ((v32_64 << np.uint64(32)) * np.uint64(s2block._MUL)) >> np.uint64(shift)
    v32 = v32_64.astype(np.uint32)
    # seed with dictionary positions
    for i in range(0, base - 4):
        table[int(hashes[i])] = i
    s = base
    next_emit = base
    repeat = d.initial_backref  # the dict-provided initial repeat
    mv = memoryview(combined)
    while True:
        while True:
            if s + 16 > n:
                if next_emit < n:
                    s2block._emit_literal(out, mv[next_emit:n])
                return bytes(out)
            h = int(hashes[s])
            c = int(table[h])
            table[h] = s
            if repeat > 0 and s - repeat >= 0 and v32[s] == v32[s - repeat] and _dict_ok(s, repeat, base):
                cand = s - repeat
                is_rep = True
                break
            if c >= 0 and v32[c] == v32[s] and _dict_ok(s, s - c, base):
                cand = c
                is_rep = False
                break
            s += 1 + ((s - next_emit) >> 6)
        # back-extend; a source range must not cross the dict boundary
        ext_floor = 0 if cand < base else base
        while s > next_emit and cand > ext_floor and combined[s - 1] == combined[cand - 1]:
            s -= 1
            cand -= 1
        offset = s - cand
        length = 4 + s2block.match_len(combined, cand + 4, s + 4, n - s - 4)
        if cand < base:
            # spec: a copy may not cross from dict into decoded data
            length = min(length, base - cand)
            if length < 4:
                s += 1
                continue
        s2block._emit_literal(out, mv[next_emit:s])
        if is_rep:
            s2block._emit_repeat(out, length)
        else:
            s2block._emit_copy_s2(out, offset, length)
        repeat = offset
        s += length
        next_emit = s
        if s + 16 > n:
            if next_emit < n:
                s2block._emit_literal(out, mv[next_emit:n])
            return bytes(out)
        for dd in (1, 2, 3, 4):
            table[int(hashes[s - dd])] = s - dd


def _dict_ok(pos: int, offset: int, base: int) -> bool:
    """Dict references only while output position < 64KB."""
    if pos - offset >= base:
        return True
    return (pos - base) < MAX_DICT_SRC_OFFSET


def decode_with_dict(block: bytes, d: Dict) -> bytes:
    """S2 block decode with dictionary history (reference: Dict.Decode)."""
    block = bytes(block)
    dlen, pos = read_uvarint(block)
    src = block[pos:]
    prefix = d.content
    base = len(prefix)
    out = bytearray(prefix)  # decode into prefix+output, then strip
    s = 0
    n = len(src)
    offset = d.initial_backref
    while s < n:
        tag = src[s]
        kind = tag & 3
        if kind == 0:
            x = tag >> 2
            if x < 60:
                s += 1
            else:
                nb = x - 59
                if s + 1 + nb > n:
                    raise s2block.CorruptError("literal truncated")
                x = int.from_bytes(src[s + 1 : s + 1 + nb], "little")
                s += 1 + nb
            length = x + 1
            if length > base + dlen - len(out) or length > n - s:
                raise s2block.CorruptError("literal overruns")
            out += src[s : s + length]
            s += length
            continue
        if kind == 1:
            if s + 2 > n:
                raise s2block.CorruptError("copy1 truncated")
            toff = ((tag & 0xE0) << 3) | src[s + 1]
            length = (tag >> 2) & 7
            s += 2
            if toff == 0:
                if length == 5:
                    length = src[s] + 4
                    s += 1
                elif length == 6:
                    length = int.from_bytes(src[s : s + 2], "little") + 256
                    s += 2
                elif length == 7:
                    length = int.from_bytes(src[s : s + 3], "little") + 65536
                    s += 3
            else:
                offset = toff
            length += 4
        elif kind == 2:
            offset = int.from_bytes(src[s + 1 : s + 3], "little")
            length = 1 + (tag >> 2)
            s += 3
        else:
            offset = int.from_bytes(src[s + 1 : s + 5], "little")
            length = 1 + (tag >> 2)
            s += 5
        d_out = len(out)
        if offset == 0 or d_out < offset or length > base + dlen - d_out:
            raise s2block.CorruptError("bad copy")
        if offset >= length:
            out += out[d_out - offset : d_out - offset + length]
        else:
            for i in range(length):
                out.append(out[d_out - offset + i])
    if len(out) != base + dlen:
        raise s2block.CorruptError("short decode")
    return bytes(out[base:])
