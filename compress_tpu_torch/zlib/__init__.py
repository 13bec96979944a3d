"""zlib (RFC 1950) wrapper over the port's flate codec (the JAX package's
``zlib``, byte for byte).

Reference parity: zlib/writer.go + zlib/reader.go — 2-byte header, FDICT
dictionary support, adler32 trailer.
"""

from __future__ import annotations

import zlib as _zlib  # stdlib: adler32 only

from compress_tpu_torch.flate import deflate, inflate

_DEFLATE_CM = 8


class ZlibError(ValueError):
    pass


def _encode_header(level: int, fdict: bool = False) -> bytes:
    """RFC 1950 2-byte header (shared by compress() and the Writer)."""
    cmf = _DEFLATE_CM | (7 << 4)  # 32K window
    flevel = 0 if level < 2 else (1 if level < 6 else (2 if level < 8 else 3))
    flg = flevel << 6
    if fdict:
        flg |= 0x20
    # FCHECK: make (cmf*256 + flg) % 31 == 0
    rem = (cmf * 256 + flg) % 31
    if rem:
        flg += 31 - rem
    return bytes([cmf, flg])


def compress(data, level: int = 6, dictionary: bytes | None = None) -> bytes:
    data = bytes(data)
    out = bytearray(_encode_header(level, bool(dictionary)))
    if dictionary:
        out += (_zlib.adler32(dictionary) & 0xFFFFFFFF).to_bytes(4, "big")
        # the dictionary is pure history: tokenize dict+data, keep only ops
        # that emit data bytes, trimming across the boundary
        from compress_tpu_torch.flate.deflate import _tokens, _emit_block
        from compress_tpu_torch.flate import huffman as H

        combined = bytes(dictionary) + data
        dlen = len(dictionary)
        raw = _tokens(combined, level if level > 0 else 6)
        fixed_ops = []
        for (ls, ll, ml, md) in raw:
            if ls + ll + ml <= dlen:
                continue
            if ls < dlen:
                cut = dlen - ls
                if cut < ll:
                    ls, ll = dlen, ll - cut
                else:
                    # boundary inside the match: emit match part as literals
                    rest = ls + ll + ml - dlen
                    fixed_ops.append((dlen, rest, 0, 0))
                    continue
            fixed_ops.append((ls, ll, ml, md))
        bw = H.BitWriterLSB()
        _emit_block(bw, combined, fixed_ops or [(dlen, len(data), 0, 0)], True)
        bw.align_byte()
        out += bw.bytes()
    else:
        out += deflate(data, level)
    out += (_zlib.adler32(data) & 0xFFFFFFFF).to_bytes(4, "big")
    return bytes(out)


def decompress(blob, dictionary: bytes | None = None, max_size: int = 1 << 31) -> bytes:
    blob = bytes(blob)
    if len(blob) < 6:
        raise ZlibError("too short")
    cmf, flg = blob[0], blob[1]
    if cmf & 0x0F != _DEFLATE_CM:
        raise ZlibError("unknown compression method")
    if (cmf * 256 + flg) % 31 != 0:
        raise ZlibError("bad header check")
    pos = 2
    prefix = b""
    if flg & 0x20:
        if dictionary is None:
            raise ZlibError("dictionary required")
        want = int.from_bytes(blob[pos : pos + 4], "big")
        if _zlib.adler32(dictionary) & 0xFFFFFFFF != want:
            raise ZlibError("dictionary checksum mismatch")
        prefix = bytes(dictionary)
        pos += 4
    data = inflate(blob[pos:-4], max_size=max_size, prefix=prefix)
    want = int.from_bytes(blob[-4:], "big")
    if _zlib.adler32(data) & 0xFFFFFFFF != want:
        raise ZlibError("adler32 mismatch")
    return data


__all__ = ["compress", "decompress", "ZlibError"]


class Writer:
    """Streaming zlib writer (reference: zlib/writer.go): 2-byte header,
    streaming deflate blocks, adler32 trailer at close()."""

    def __init__(self, dst, level: int = 6):
        self.dst = dst
        self._level = level
        self._fw = None
        self._adler = 1
        self._closed = False

    def _ensure(self):
        if self._fw is not None:
            return
        self.dst.write(_encode_header(self._level))
        from compress_tpu_torch.flate.deflate import Writer as _FW

        self._fw = _FW(self.dst, level=self._level)

    def write(self, data) -> int:
        if self._closed:
            raise ZlibError("writer closed")
        data = bytes(data)
        self._ensure()
        self._adler = _zlib.adler32(data, self._adler)
        return self._fw.write(data)

    def flush(self):
        if self._closed:
            raise ZlibError("writer closed")
        self._ensure()
        self._fw.flush()

    def close(self):
        if self._closed:
            return
        self._ensure()
        self._fw.close()
        self.dst.write((self._adler & 0xFFFFFFFF).to_bytes(4, "big"))
        self._closed = True


class Reader:
    """Streaming zlib reader (reference: zlib.Reader, zlib/reader.go:51):
    incremental reads, FDICT dictionary support, adler32 verification at
    end of stream."""

    def __init__(self, src, dictionary: bytes | None = None,
                 max_size: int = 1 << 40):
        import io

        if isinstance(src, (bytes, bytearray, memoryview)):
            src = io.BytesIO(bytes(src))
        self._src = src
        self._max = max_size
        hdr = self._read_exact(2)
        cmf, flg = hdr[0], hdr[1]
        if cmf & 0x0F != _DEFLATE_CM:
            raise ZlibError("unknown compression method")
        if (cmf * 256 + flg) % 31 != 0:
            raise ZlibError("bad header check")
        prefix = None
        if flg & 0x20:
            if dictionary is None:
                raise ZlibError("dictionary required")
            want = int.from_bytes(self._read_exact(4), "big")
            if _zlib.adler32(dictionary) & 0xFFFFFFFF != want:
                raise ZlibError("dictionary checksum mismatch")
            prefix = bytes(dictionary)
        from compress_tpu_torch.flate.inflate import Reader as _FlateReader

        self._fr = _FlateReader(self._src, dictionary=prefix)
        self._adler = 1
        self._n = 0
        self._done = False

    def _read_exact(self, n: int) -> bytes:
        out = bytearray()
        while len(out) < n:
            chunk = self._src.read(n - len(out))
            if not chunk:
                raise ZlibError("unexpected EOF in zlib header")
            out += chunk
        return bytes(out)

    def _finish(self):
        tail = self._fr.unused_tail
        need = 4 - len(tail)
        trailer = tail[:4]
        while need > 0:
            chunk = self._src.read(need)
            if not chunk:
                raise ZlibError("unexpected EOF in zlib trailer")
            trailer += chunk
            need -= len(chunk)
        want = int.from_bytes(trailer[:4], "big")
        if self._adler & 0xFFFFFFFF != want:
            raise ZlibError("adler32 mismatch")
        self._done = True

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
                self._adler = _zlib.adler32(chunk, self._adler)
                self._n += len(chunk)
                if self._n > self._max:
                    raise ZlibError("output exceeds max_size")
                out += chunk
            else:
                self._finish()
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
