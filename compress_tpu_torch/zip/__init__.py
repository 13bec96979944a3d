"""zip — archive container with a pluggable codec registry.

Reference parity: zip/ (archive/zip fork with RegisterCompressor/
RegisterDecompressor, zip64, OpenRaw/CreateRaw) and zstd/zip.go (the
WinZip zstd method-93 plugin). Deflate entries use the port's flate
codec and zstd entries its host zstd codec; interop is tested against the
stdlib zipfile module both directions.  The JAX package's ``zip``, byte
for byte.
"""

from __future__ import annotations

import struct
import time
import zlib as _zlib
from dataclasses import dataclass, field

STORE = 0
DEFLATE = 8
ZSTD = 93  # ZipMethodWinZip (zstd/zip.go:14)

_LOCAL_SIG = 0x04034B50
_CENTRAL_SIG = 0x02014B50
_EOCD_SIG = 0x06054B50
_ZIP64_EOCD_SIG = 0x06064B50
_ZIP64_LOC_SIG = 0x07064B50
_ZIP64_EXTRA = 0x0001

_compressors = {}
_decompressors = {}


class ZipError(ValueError):
    pass


def register_compressor(method: int, fn):
    """fn(data: bytes) -> bytes. Reference: zip.RegisterCompressor."""
    _compressors[method] = fn


def register_decompressor(method: int, fn):
    """fn(blob: bytes, out_len: int) -> bytes. Reference: RegisterDecompressor."""
    _decompressors[method] = fn


def _deflate_c(data):
    from compress_tpu_torch.flate import deflate

    return deflate(data, 5)


def _deflate_d(blob, n):
    from compress_tpu_torch.flate import inflate

    return inflate(blob, max_size=max(n, 1) * 2 + 64)


def _zstd_c(data):
    from compress_tpu_torch import zstd

    return zstd.compress(data, level=2)


def _zstd_d(blob, n):
    from compress_tpu_torch import zstd

    return zstd.decompress(blob, max_size=max(n, 1) * 2 + 64)


register_compressor(STORE, lambda d: bytes(d))
register_decompressor(STORE, lambda b, n: bytes(b))
register_compressor(DEFLATE, _deflate_c)
register_decompressor(DEFLATE, _deflate_d)
register_compressor(ZSTD, _zstd_c)
register_decompressor(ZSTD, _zstd_d)


@dataclass
class FileHeader:
    """Reference: zip.FileHeader (subset with the load-bearing fields)."""

    name: str
    method: int = DEFLATE
    mtime: tuple = field(default_factory=lambda: time.localtime()[:6])
    comment: str = ""
    crc32: int = 0
    compressed_size: int = 0
    uncompressed_size: int = 0
    offset: int = 0
    flags: int = 0


def _dos_time(t):
    y, mo, d, h, mi, s = t
    return ((h << 11) | (mi << 5) | (s // 2), (((y - 1980) & 0x7F) << 9) | (mo << 5) | d)


class Writer:
    """Archive writer (reference: zip.NewWriter)."""

    def __init__(self, dst):
        self.dst = dst
        self.entries: list[FileHeader] = []
        self.pos = 0
        self.comment = b""

    def _emit(self, b: bytes):
        self.dst.write(b)
        self.pos += len(b)

    def create(self, name: str, data: bytes, method: int = DEFLATE,
               mtime=None) -> FileHeader:
        """Compress + add one file (reference: Writer.Create + io)."""
        comp = _compressors.get(method)
        if comp is None:
            raise ZipError(f"no compressor for method {method}")
        blob = comp(data)
        if len(blob) >= len(data) and method != STORE:
            method, blob = STORE, bytes(data)
        h = FileHeader(
            name=name, method=method,
            mtime=mtime or time.localtime()[:6],
            crc32=_zlib.crc32(data) & 0xFFFFFFFF,
            compressed_size=len(blob),
            uncompressed_size=len(data),
        )
        return self._write_entry(h, blob)

    def create_raw(self, h: FileHeader, raw: bytes) -> FileHeader:
        """Add pre-compressed content verbatim (reference: CreateRaw)."""
        h.compressed_size = len(raw)
        return self._write_entry(h, raw)

    def _write_entry(self, h: FileHeader, blob: bytes) -> FileHeader:
        h.offset = self.pos
        name_b = h.name.encode("utf-8")
        h.flags |= 0x800 if not h.name.isascii() else 0
        t, d = _dos_time(h.mtime)
        need64 = max(h.compressed_size, h.uncompressed_size) >= 0xFFFFFFFF
        extra = b""
        cs, us = h.compressed_size, h.uncompressed_size
        if need64:
            extra = struct.pack("<HHQQ", _ZIP64_EXTRA, 16, us, cs)
            cs = us = 0xFFFFFFFF
        self._emit(struct.pack(
            "<IHHHHHIIIHH", _LOCAL_SIG, 45 if need64 else 20, h.flags,
            h.method, t, d, h.crc32, cs, us, len(name_b), len(extra)))
        self._emit(name_b)
        self._emit(extra)
        self._emit(blob)
        self.entries.append(h)
        return h

    def close(self):
        cd_start = self.pos
        for h in self.entries:
            name_b = h.name.encode("utf-8")
            cmt = h.comment.encode("utf-8")
            t, d = _dos_time(h.mtime)
            need64 = (max(h.compressed_size, h.uncompressed_size) >= 0xFFFFFFFF
                      or h.offset >= 0xFFFFFFFF)
            extra = b""
            cs, us, off = h.compressed_size, h.uncompressed_size, h.offset
            if need64:
                extra = struct.pack("<HHQQQ", _ZIP64_EXTRA, 24, us, cs, off)
                cs = us = off = 0xFFFFFFFF
            self._emit(struct.pack(
                "<IHHHHHHIIIHHHHHII", _CENTRAL_SIG, 45, 45 if need64 else 20,
                h.flags, h.method, t, d, h.crc32, cs, us,
                len(name_b), len(extra), len(cmt), 0, 0, 0, off))
            self._emit(name_b)
            self._emit(extra)
            self._emit(cmt)
        cd_size = self.pos - cd_start
        n = len(self.entries)
        if n >= 0xFFFF or cd_start >= 0xFFFFFFFF:
            z64_off = self.pos
            self._emit(struct.pack("<IQHHIIQQQQ", _ZIP64_EOCD_SIG, 44, 45, 45,
                                   0, 0, n, n, cd_size, cd_start))
            self._emit(struct.pack("<IIQI", _ZIP64_LOC_SIG, 0, z64_off, 1))
            n_w = min(n, 0xFFFF)
            cd_start_w = min(cd_start, 0xFFFFFFFF)
        else:
            n_w, cd_start_w = n, cd_start
        self._emit(struct.pack("<IHHHHIIH", _EOCD_SIG, 0, 0, n_w, n_w,
                               cd_size, cd_start_w, len(self.comment)))
        self._emit(self.comment)


class Reader:
    """Archive reader (reference: zip.NewReader)."""

    def __init__(self, data: bytes, name_decoder=None):
        """name_decoder: callable bytes -> str for legacy (non-UTF-8)
        entry names (reference: zip ReaderOptions NameDecoder,
        zip/reader.go:124-134); default cp437, the zip legacy charset.
        Entries with the UTF-8 flag (bit 11) always decode as UTF-8."""
        self.data = bytes(data)
        self.name_decoder = name_decoder or (lambda b: b.decode("cp437"))
        self.entries = self._parse_central()

    def _parse_central(self):
        data = self.data
        eocd = data.rfind(struct.pack("<I", _EOCD_SIG))
        if eocd < 0:
            raise ZipError("no end-of-central-directory")
        (_, _, _, n, _, cd_size, cd_start, _) = struct.unpack(
            "<IHHHHIIH", data[eocd : eocd + 22])
        if n == 0xFFFF or cd_start == 0xFFFFFFFF:
            loc = data.rfind(struct.pack("<I", _ZIP64_LOC_SIG), 0, eocd)
            if loc >= 0:
                z64_off = struct.unpack("<Q", data[loc + 8 : loc + 16])[0]
                (_, _, _, _, _, _, n, _, cd_size, cd_start) = struct.unpack(
                    "<IQHHIIQQQQ", data[z64_off : z64_off + 56])
        entries = []
        pos = cd_start
        for _ in range(n):
            if struct.unpack("<I", data[pos : pos + 4])[0] != _CENTRAL_SIG:
                raise ZipError("bad central directory entry")
            (_, _, _, flags, method, t, d, crc, cs, us, nlen, xlen, clen,
             _, _, _, off) = struct.unpack("<IHHHHHHIIIHHHHHII", data[pos : pos + 46])
            name_b = data[pos + 46 : pos + 46 + nlen]
            extra = data[pos + 46 + nlen : pos + 46 + nlen + xlen]
            cmt_b = data[pos + 46 + nlen + xlen : pos + 46 + nlen + xlen + clen]
            if flags & 0x800:  # UTF-8 flag
                name = name_b.decode("utf-8")
                cmt = cmt_b.decode("utf-8")
            else:
                try:
                    name = name_b.decode("utf-8")
                    cmt = cmt_b.decode("utf-8")
                except UnicodeDecodeError:
                    name = self.name_decoder(name_b)
                    cmt = self.name_decoder(cmt_b)
            # zip64 extra
            ep = 0
            while ep + 4 <= len(extra):
                eid, esz = struct.unpack("<HH", extra[ep : ep + 4])
                if eid == _ZIP64_EXTRA:
                    vals = extra[ep + 4 : ep + 4 + esz]
                    vp = 0
                    if us == 0xFFFFFFFF:
                        us = struct.unpack("<Q", vals[vp : vp + 8])[0]
                        vp += 8
                    if cs == 0xFFFFFFFF:
                        cs = struct.unpack("<Q", vals[vp : vp + 8])[0]
                        vp += 8
                    if off == 0xFFFFFFFF:
                        off = struct.unpack("<Q", vals[vp : vp + 8])[0]
                ep += 4 + esz
            y = (d >> 9) + 1980
            h = FileHeader(name=name, method=method,
                           mtime=(y, (d >> 5) & 0xF, d & 0x1F,
                                  t >> 11, (t >> 5) & 0x3F, (t & 0x1F) * 2),
                           comment=cmt,
                           crc32=crc, compressed_size=cs,
                           uncompressed_size=us, offset=off, flags=flags)
            entries.append(h)
            pos += 46 + nlen + xlen + clen
        return entries

    def open_raw(self, h: FileHeader) -> bytes:
        """Raw compressed bytes of an entry (reference: File.OpenRaw)."""
        data = self.data
        pos = h.offset
        if struct.unpack("<I", data[pos : pos + 4])[0] != _LOCAL_SIG:
            raise ZipError("bad local header")
        nlen, xlen = struct.unpack("<HH", data[pos + 26 : pos + 30])
        start = pos + 30 + nlen + xlen
        return data[start : start + h.compressed_size]

    def read(self, h: FileHeader) -> bytes:
        dec = _decompressors.get(h.method)
        if dec is None:
            raise ZipError(f"no decompressor for method {h.method}")
        out = dec(self.open_raw(h), h.uncompressed_size)
        if len(out) != h.uncompressed_size:
            raise ZipError("size mismatch")
        if _zlib.crc32(out) & 0xFFFFFFFF != h.crc32:
            raise ZipError("crc mismatch")
        return out

    def namelist(self):
        return [h.name for h in self.entries]


__all__ = [
    "Writer", "Reader", "FileHeader", "ZipError",
    "register_compressor", "register_decompressor",
    "STORE", "DEFLATE", "ZSTD",
]
