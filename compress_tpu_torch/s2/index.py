"""A copy of the JAX package's ``s2/index.py``.

S2 seek index: uncompressed<->compressed offset pairs in a skippable

chunk (id 0x99), delta+zigzag-varint coded, readable from either end.
Reference parity: s2/index.go (Index, Find, Load, LoadStream, IndexStream,
RemoveIndexHeaders/RestoreIndexHeaders, JSON dump). Format per s2/README.md
"Index Format" — implemented from that spec.
"""

from __future__ import annotations

import json

from compress_tpu_torch.utils.varint import put_uvarint, put_varint, read_uvarint, read_varint

CHUNK_INDEX = 0x99
HEADER = b"s2idx\x00"
TRAILER = b"\x00xdi2s"
MAX_INDEX_ENTRIES = 1 << 16


class IndexError_(ValueError):
    pass


class Index:
    """Seekable-stream index. entries: ordered (uncompressed, compressed)."""

    def __init__(self, entries=None, total_uncompressed: int = -1,
                 total_compressed: int = -1, est_block_size: int | None = None):
        self.entries = list(entries or [])
        self.total_uncompressed = total_uncompressed
        self.total_compressed = total_compressed
        self.est_block_size = est_block_size

    # -- building ------------------------------------------------------------

    def reduce(self):
        """Cap entry count like the reference (keep <= 65536 by decimation)."""
        while len(self.entries) > MAX_INDEX_ENTRIES - 1:
            self.entries = self.entries[::2]

    def find(self, offset: int):
        """Largest entry with uncompressed offset <= offset.

        Returns (compressed_off, uncompressed_off). Reference: Index.Find."""
        if self.total_uncompressed >= 0 and offset > self.total_uncompressed:
            raise IndexError_("offset beyond stream")
        if offset < 0:
            if self.total_uncompressed < 0:
                raise IndexError_("negative offset on unknown-size stream")
            offset = self.total_uncompressed + offset
        best = (0, 0)
        for u, c in self.entries:
            if u > offset:
                break
            best = (c, u)
        return best

    # -- serialization --------------------------------------------------------

    def append_to(self) -> bytes:
        """Serialize as a skippable chunk (reference: Index.appendTo)."""
        self.reduce()
        ents = self.entries
        if self.est_block_size is None:
            # typical distance between entries
            if len(ents) > 1:
                self.est_block_size = ents[1][0] - ents[0][0]
            else:
                self.est_block_size = 1 << 20
        est = max(int(self.est_block_size), 0)

        body = bytearray(HEADER)
        put_varint(body, self.total_uncompressed)
        put_varint(body, self.total_compressed)
        put_varint(body, est)
        put_varint(body, len(ents))

        has_u = 0
        prev_u = 0
        for i, (u, c) in enumerate(ents):
            expect = 0 if i == 0 else prev_u + est
            if u != expect:
                has_u = 1
            prev_u = u
        body.append(has_u)
        if has_u:
            prev_u = 0
            for i, (u, c) in enumerate(ents):
                if i == 0:
                    put_varint(body, u)
                else:
                    put_varint(body, u - (prev_u + est))
                prev_u = u
        guess = est // 2
        prev_c = 0
        for i, (u, c) in enumerate(ents):
            if i == 0:
                put_varint(body, c)
            else:
                d = c - (prev_c + guess)
                put_varint(body, d)
                guess += _trunc_div2(d)  # spec: CompressGuess += cOff/2
            prev_c = c
        total_len = 4 + len(body) + 4 + 6
        body += total_len.to_bytes(4, "little")
        body += TRAILER
        out = bytes([CHUNK_INDEX]) + len(body).to_bytes(3, "little") + bytes(body)
        return out

    @classmethod
    def load(cls, chunk: bytes) -> tuple["Index", int]:
        """Parse an index chunk; returns (Index, bytes_consumed)."""
        if len(chunk) < 4 or chunk[0] != CHUNK_INDEX:
            raise IndexError_("not an index chunk")
        clen = int.from_bytes(chunk[1:4], "little")
        if 4 + clen > len(chunk):
            raise IndexError_("index chunk truncated")
        body = chunk[4 : 4 + clen]
        if not body.startswith(HEADER):
            raise IndexError_("bad index header")
        if not body.endswith(TRAILER):
            raise IndexError_("bad index trailer")
        pos = len(HEADER)
        tu, pos = read_varint(body, pos)
        tc, pos = read_varint(body, pos)
        est, pos = read_varint(body, pos)
        n, pos = read_varint(body, pos)
        if n < 0 or n >= MAX_INDEX_ENTRIES or est < 0:
            raise IndexError_("invalid index counts")
        has_u = body[pos]
        pos += 1
        if has_u not in (0, 1):
            raise IndexError_("invalid HasUncompressedOffsets")
        us = []
        prev_u = 0
        for i in range(n):
            u_off = 0
            if has_u:
                u_off, pos = read_varint(body, pos)
            if i == 0:
                us.append(u_off)
                prev_u = u_off
            else:
                prev_u = prev_u + est + u_off
                us.append(prev_u)
        cs = []
        guess = est // 2
        prev_c = 0
        for i in range(n):
            c_off, pos = read_varint(body, pos)
            if i == 0:
                cs.append(c_off)
                prev_c = c_off
            else:
                prev_c = prev_c + guess + c_off
                cs.append(prev_c)
                guess += _trunc_div2(c_off)
        idx = cls(list(zip(us, cs)), tu, tc, est)
        return idx, 4 + clen

    @classmethod
    def load_stream(cls, tail: bytes) -> "Index":
        """Load an index from the end of a stream (reference: LoadStream)."""
        if len(tail) < 10 or not tail.endswith(TRAILER):
            raise IndexError_("no index trailer at stream end")
        size = int.from_bytes(tail[-10:-6], "little")
        if size > len(tail):
            raise IndexError_("index larger than provided tail")
        idx, _ = cls.load(tail[-size:])
        return idx

    def to_json(self) -> str:
        return json.dumps({
            "total_uncompressed": self.total_uncompressed,
            "total_compressed": self.total_compressed,
            "est_block_size": self.est_block_size,
            "offsets": [
                {"compressed": c, "uncompressed": u} for u, c in self.entries
            ],
        }, indent=2)


def _trunc_div2(d: int) -> int:
    """Go-style truncating division by 2 (toward zero)."""
    return d // 2 if d >= 0 else -((-d) // 2)


def index_stream(stream: bytes) -> Index:
    """Build an index by scanning a framed stream (reference: IndexStream)."""
    from compress_tpu_torch.s2 import stream as S

    pos = 0
    upos = 0
    entries = []
    n = len(stream)
    while pos < n:
        if pos + 4 > n:
            raise IndexError_("truncated chunk header")
        ctype = stream[pos]
        clen = int.from_bytes(stream[pos + 1 : pos + 4], "little")
        if ctype == S.CHUNK_STREAM_ID:
            pos += 4 + clen
            continue
        if ctype in (S.CHUNK_COMPRESSED, S.CHUNK_UNCOMPRESSED):
            entries.append((upos, pos))
            if ctype == S.CHUNK_COMPRESSED:
                dlen, _ = read_uvarint(stream, pos + 8)
                upos += dlen
            else:
                upos += clen - 4
            pos += 4 + clen
            continue
        pos += 4 + clen
    idx = Index(entries, upos, n)
    if entries:
        idx.est_block_size = entries[1][0] - entries[0][0] if len(entries) > 1 else upos
    return idx


def remove_index_headers(chunk: bytes) -> bytes:
    """Strip chunk framing for external storage (reference: RemoveIndexHeaders)."""
    idx, used = Index.load(chunk)
    return chunk[4 + len(HEADER) : used - 10]


def restore_index_headers(stripped: bytes) -> bytes:
    """Inverse of remove_index_headers (reference: RestoreIndexHeaders)."""
    body = HEADER + stripped
    total_len = 4 + len(body) + 4 + 6
    body += total_len.to_bytes(4, "little") + TRAILER
    return bytes([CHUNK_INDEX]) + len(body).to_bytes(3, "little") + body
