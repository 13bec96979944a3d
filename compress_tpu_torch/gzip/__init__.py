"""gzip (RFC 1952) wrapper over the port's flate codec (the JAX package's
``gzip``, byte for byte).

``decompress`` always passes an ``eob_callback`` to find each member's
end, so the one-shot decode is the Python inflater, as in the JAX
package; the streaming ``Reader`` takes the host core's inflate.

Reference parity: gzip/gzip.go + gzip/gunzip.go — header fields (name,
comment, extra, mtime, OS), multistream reading, CRC-32 verification.
"""

from __future__ import annotations

import zlib as _zlib  # stdlib: crc32 only (C-speed IEEE CRC)

from dataclasses import dataclass

from compress_tpu_torch.flate import deflate, inflate

MAGIC = b"\x1f\x8b"
_DEFLATE_CM = 8
_FLG_TEXT, _FLG_HCRC, _FLG_EXTRA, _FLG_NAME, _FLG_COMMENT = 1, 2, 4, 8, 16


class GzipError(ValueError):
    pass


@dataclass
class Header:
    """Reference: gzip.Header{Comment, Extra, ModTime, Name, OS}."""

    name: str = ""
    comment: str = ""
    extra: bytes = b""
    mtime: int = 0
    os: int = 255


def _encode_header(h: Header, level: int) -> bytes:
    """Serialize the RFC 1952 member header (shared by compress() and
    the streaming Writer)."""
    flg = 0
    if h.extra:
        flg |= _FLG_EXTRA
    if h.name:
        flg |= _FLG_NAME
    if h.comment:
        flg |= _FLG_COMMENT
    out = bytearray(MAGIC)
    out.append(_DEFLATE_CM)
    out.append(flg)
    out += h.mtime.to_bytes(4, "little")
    out.append(2 if level >= 9 else (4 if level <= 2 else 0))  # XFL
    out.append(h.os)
    if h.extra:
        out += len(h.extra).to_bytes(2, "little") + h.extra
    if h.name:
        out += h.name.encode("latin-1") + b"\x00"
    if h.comment:
        out += h.comment.encode("latin-1") + b"\x00"
    return bytes(out)


def compress(data, level: int = 6, header: Header | None = None) -> bytes:
    data = bytes(data)
    h = header or Header()
    out = bytearray(_encode_header(h, level))
    out += deflate(data, level)
    out += (_zlib.crc32(data) & 0xFFFFFFFF).to_bytes(4, "little")
    out += (len(data) & 0xFFFFFFFF).to_bytes(4, "little")
    return bytes(out)


def decompress(blob, multistream: bool = True, max_size: int = 1 << 31):
    """Returns (data, Header of the first member)."""
    blob = bytes(blob)
    pos = 0
    out = bytearray()
    first_header = None
    while pos < len(blob):
        if blob[pos : pos + 2] != MAGIC:
            raise GzipError("bad magic")
        if blob[pos + 2] != _DEFLATE_CM:
            raise GzipError("unknown compression method")
        flg = blob[pos + 3]
        h = Header(mtime=int.from_bytes(blob[pos + 4 : pos + 8], "little"),
                   os=blob[pos + 9])
        p = pos + 10
        if flg & _FLG_EXTRA:
            xlen = int.from_bytes(blob[p : p + 2], "little")
            h.extra = blob[p + 2 : p + 2 + xlen]
            p += 2 + xlen
        if flg & _FLG_NAME:
            end = blob.index(0, p)
            h.name = blob[p:end].decode("latin-1")
            p = end + 1
        if flg & _FLG_COMMENT:
            end = blob.index(0, p)
            h.comment = blob[p:end].decode("latin-1")
            p = end + 1
        if flg & _FLG_HCRC:
            p += 2
        if first_header is None:
            first_header = h
        # decode the member; find its end by tracking consumed bits
        consumed = {}

        def cb(cp):
            consumed["end"] = (cp.compressed_offset, cp.bit_offset, cp.final)

        data = inflate(blob[p:], max_size=max_size - len(out), eob_callback=cb)
        endb, endbit, _ = consumed["end"]
        p += endb + (1 if endbit else 0)
        want_crc = int.from_bytes(blob[p : p + 4], "little")
        want_len = int.from_bytes(blob[p + 4 : p + 8], "little")
        if _zlib.crc32(data) & 0xFFFFFFFF != want_crc:
            raise GzipError("crc mismatch")
        if len(data) & 0xFFFFFFFF != want_len:
            raise GzipError("length mismatch")
        out += data
        pos = p + 8
        if not multistream:
            break
    return bytes(out), first_header


__all__ = ["compress", "decompress", "Header", "GzipError", "MAGIC"]


class Writer:
    """Streaming gzip writer with bounded memory (reference: gzip.Writer,
    gzip/gzip.go:36): header on first write, deflate blocks stream via
    flate.Writer's native continuation entry, CRC-32 and ISIZE trail at
    close()."""

    def __init__(self, dst, level: int = 6, header: Header | None = None):
        self.dst = dst
        self._hdr = header or Header()
        self._level = level
        self._fw = None
        self._crc = 0
        self._n = 0
        self._closed = False

    def _ensure(self):
        if self._fw is not None:
            return
        self.dst.write(_encode_header(self._hdr, self._level))
        from compress_tpu_torch.flate.deflate import Writer as _FW

        self._fw = _FW(self.dst, level=self._level)

    def write(self, data) -> int:
        if self._closed:
            raise GzipError("writer closed")
        data = bytes(data)
        self._ensure()
        self._crc = _zlib.crc32(data, self._crc)
        self._n += len(data)
        return self._fw.write(data)

    def flush(self):
        if self._closed:
            raise GzipError("writer closed")
        self._ensure()
        self._fw.flush()

    def close(self):
        if self._closed:
            return
        self._ensure()
        self._fw.close()
        self.dst.write((self._crc & 0xFFFFFFFF).to_bytes(4, "little"))
        self.dst.write((self._n & 0xFFFFFFFF).to_bytes(4, "little"))
        self._closed = True


class Reader:
    """Streaming gzip reader (reference: gzip.Reader, gzip/gunzip.go:75):
    incremental reads over a file-like source, per-member CRC-32/ISIZE
    verification, multistream concatenated members (disable to stop at
    the first member, leaving the tail unread — gunzip.go Multistream).

    `header` holds the current member's Header after the first read (or
    construction, which parses the first header eagerly like the
    reference's NewReader)."""

    def __init__(self, src, multistream: bool = True,
                 max_size: int = 1 << 40):
        import io

        if isinstance(src, (bytes, bytearray, memoryview)):
            src = io.BytesIO(bytes(src))
        self._src = src
        self._multistream = multistream
        self._max = max_size
        self._pending = b""     # source bytes read past the member
        self._fr = None         # current member's flate Reader
        self._crc = 0
        self._n = 0
        self._total = 0
        self._done = False
        self.header = None
        self._start_member(first=True)

    # -- member plumbing -----------------------------------------------------

    def _read_exact(self, n: int) -> bytes:
        out = bytearray(self._pending[:n])
        self._pending = self._pending[n:]
        while len(out) < n:
            chunk = self._src.read(n - len(out))
            if not chunk:
                raise GzipError("unexpected EOF in gzip header")
            out += chunk
        return bytes(out)

    def _read_until_nul(self) -> bytes:
        out = bytearray()
        while True:
            b = self._read_exact(1)
            if b == b"\x00":
                return bytes(out)
            out += b

    def _start_member(self, first: bool = False) -> bool:
        """Parse one member header; False at clean end of input."""
        probe = bytearray(self._pending[:2])
        self._pending = self._pending[2:]
        while len(probe) < 2:
            chunk = self._src.read(2 - len(probe))
            if not chunk:
                if first or len(probe):
                    raise GzipError("unexpected EOF in gzip header")
                self._done = True
                return False
            probe += chunk
        if bytes(probe) != MAGIC:
            raise GzipError("bad magic")
        rest = self._read_exact(8)
        if rest[0] != _DEFLATE_CM:
            raise GzipError("unknown compression method")
        flg = rest[1]
        h = Header(mtime=int.from_bytes(rest[2:6], "little"), os=rest[7])
        if flg & _FLG_EXTRA:
            xlen = int.from_bytes(self._read_exact(2), "little")
            h.extra = self._read_exact(xlen)
        if flg & _FLG_NAME:
            h.name = self._read_until_nul().decode("latin-1")
        if flg & _FLG_COMMENT:
            h.comment = self._read_until_nul().decode("latin-1")
        if flg & _FLG_HCRC:
            self._read_exact(2)
        if first or self.header is None:
            self.header = h
        import io

        from compress_tpu_torch.flate.inflate import Reader as _FlateReader

        class _Chain(io.RawIOBase):
            def __init__(c, pending, src):
                c._pending = pending
                c._src = src

            def read(c, n=-1):
                if c._pending:
                    if n is None or n < 0 or n >= len(c._pending):
                        out, c._pending = c._pending, b""
                        if n is not None and n >= 0 and len(out) < n:
                            more = c._src.read(n - len(out))
                            return out + (more or b"")
                        if n is None or n < 0:
                            rest = c._src.read()
                            return out + (rest or b"")
                        return out
                    out = c._pending[:n]
                    c._pending = c._pending[n:]
                    return out
                return c._src.read(n)

        self._chain = _Chain(self._pending, self._src)
        self._pending = b""
        self._fr = _FlateReader(self._chain)
        self._crc = 0
        self._n = 0
        return True

    def _finish_member(self):
        tail = self._fr.unused_tail
        self._pending = tail + getattr(self._chain, "_pending", b"")
        trailer = self._read_exact(8)
        want_crc = int.from_bytes(trailer[:4], "little")
        want_len = int.from_bytes(trailer[4:8], "little")
        if self._crc & 0xFFFFFFFF != want_crc:
            raise GzipError("crc mismatch")
        if self._n & 0xFFFFFFFF != want_len:
            raise GzipError("length mismatch")
        if not self._multistream:
            self._done = True
            return
        self._start_member()

    # -- public API ------------------------------------------------------------

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            parts = []
            while True:
                b = self.read(1 << 20)
                if not b:
                    break
                parts.append(b)
            return b"".join(parts)
        out = bytearray()
        while len(out) < n and not self._done:
            chunk = self._fr.read(n - len(out))
            if chunk:
                self._crc = _zlib.crc32(chunk, self._crc)
                self._n += len(chunk)
                self._total += len(chunk)
                if self._total > self._max:
                    raise GzipError("output exceeds max_size")
                out += chunk
            else:
                self._finish_member()
        return bytes(out)

    def __iter__(self):
        while True:
            b = self.read(1 << 16)
            if not b:
                return
            yield b

    def close(self):
        self._done = True
        self._fr = None


__all__ += ["Writer", "Reader"]
