"""INFLATE (RFC 1951) decoder with mid-stream checkpoints (the JAX
package's ``flate/inflate.py``).

``inflate`` takes the host core (``ct_inflate``) when no ``eob_callback``,
``resume_from`` or ``prefix`` is given; where the core refuses the input
(corrupt, or larger than ``max_size``) it re-runs ``inflate_py``, the
Python decoder, as the reference does: the caller gets that decoder's
``InflateError``, or its output where it reads on.  Checkpoints,
``eob_callback`` and ``resume_from`` are Python alone.  The streaming
``Reader`` advances a block at a time on ``ct_inflate_stream``;
``ReaderPy`` is its plain version (the whole-buffer Python decode).
"""

from __future__ import annotations

import ctypes
import io
from dataclasses import dataclass

import numpy as np

from compress_tpu_torch import _native
from compress_tpu_torch.flate import huffman as H
from compress_tpu_torch.flate.deflate import native_inflate


class InflateError(ValueError):
    pass


@dataclass
class Checkpoint:
    """Resumable mid-stream state at an end-of-block boundary.

    Reference: flate.InflateCheckpoint{UncompressedOffset, CompressedOffset,
    BitOffset, Final, Window}."""

    uncompressed_offset: int
    compressed_offset: int  # byte offset into the deflate stream
    bit_offset: int  # bits already consumed within that byte
    final: bool
    window: bytes  # last <=32 KiB of output


class _BitReader:
    __slots__ = ("data", "pos", "acc", "n")

    def __init__(self, data: bytes, pos: int = 0, bit: int = 0):
        self.data = data
        self.pos = pos
        self.acc = 0
        self.n = 0
        if bit:
            if pos >= len(data):
                raise InflateError("truncated")
            self.acc = data[pos] >> bit
            self.n = 8 - bit
            self.pos = pos + 1

    def need(self, n: int):
        while self.n < n:
            if self.pos >= len(self.data):
                raise InflateError("unexpected end of stream")
            self.acc |= self.data[self.pos] << self.n
            self.pos += 1
            self.n += 8

    def take(self, n: int) -> int:
        if n == 0:
            return 0
        self.need(n)
        v = self.acc & ((1 << n) - 1)
        self.acc >>= n
        self.n -= n
        return v

    def align_byte(self):
        drop = self.n & 7
        self.acc >>= drop
        self.n -= drop

    def bit_position(self) -> tuple[int, int]:
        """(byte_offset, bit_within_byte) of the next unread bit."""
        byte = self.pos - self.n // 8
        bit = (8 - self.n % 8) % 8
        if bit:
            byte -= 1
        return byte, bit


def _build_decode_table(lengths: np.ndarray):
    """Full 2^maxlen lookup: index by next maxlen bits (LSB-first reversed)."""
    maxlen = int(lengths.max())
    if maxlen == 0:
        return None, 0
    size = 1 << maxlen
    sym_t = np.full(size, -1, dtype=np.int32)
    len_t = np.zeros(size, dtype=np.int32)
    codes = H.canonical_codes_rfc1951(lengths)  # already bit-reversed
    for s in range(len(lengths)):
        l = int(lengths[s])
        if not l:
            continue
        c = int(codes[s])
        step = 1 << l
        for idx in range(c, size, step):
            sym_t[idx] = s
            len_t[idx] = l
    return (sym_t, len_t), maxlen


def _decode_sym(br: _BitReader, table, maxlen: int) -> int:
    sym_t, len_t = table
    # peek up to maxlen bits (zero-padded at stream end)
    while br.n < maxlen and br.pos < len(br.data):
        br.acc |= br.data[br.pos] << br.n
        br.pos += 1
        br.n += 8
    idx = br.acc & ((1 << maxlen) - 1)
    s = int(sym_t[idx])
    l = int(len_t[idx])
    if s < 0 or l > br.n:
        raise InflateError("invalid huffman code")
    br.acc >>= l
    br.n -= l
    return s


def _read_dynamic_tables(br: _BitReader):
    hlit = br.take(5) + 257
    hdist = br.take(5) + 1
    hclen = br.take(4) + 4
    clen = np.zeros(19, dtype=np.int32)
    for k in range(hclen):
        clen[H.CLEN_ORDER[k]] = br.take(3)
    ctab, cmax = _build_decode_table(clen)
    if ctab is None:
        raise InflateError("empty code-length table")
    lengths = np.zeros(hlit + hdist, dtype=np.int32)
    i = 0
    while i < hlit + hdist:
        s = _decode_sym(br, ctab, cmax)
        if s < 16:
            lengths[i] = s
            i += 1
        elif s == 16:
            if i == 0:
                raise InflateError("repeat with no previous length")
            r = 3 + br.take(2)
            lengths[i : i + r] = lengths[i - 1]
            i += r
        elif s == 17:
            i += 3 + br.take(3)
        else:
            i += 11 + br.take(7)
    if i > hlit + hdist:
        raise InflateError("code lengths overflow")
    lit_l = lengths[:hlit]
    dist_l = lengths[hlit:]
    if lit_l[256] == 0:
        raise InflateError("missing end-of-block code")
    return _build_decode_table(lit_l), _build_decode_table(dist_l)


_FIXED_LIT = None
_FIXED_DIST = None


def _fixed_tables():
    global _FIXED_LIT, _FIXED_DIST
    if _FIXED_LIT is None:
        _FIXED_LIT = _build_decode_table(H.fixed_lit_lengths())
        _FIXED_DIST = _build_decode_table(H.fixed_dist_lengths())
    return _FIXED_LIT, _FIXED_DIST


def inflate(data, max_size: int = 1 << 31, eob_callback=None,
            resume_from: Checkpoint | None = None,
            prefix: bytes = b"") -> bytes:
    """Decode a raw DEFLATE stream.

    eob_callback(Checkpoint) fires at every end-of-block (reference:
    WithEobCallback); resume_from continues from a checkpoint (reference:
    WithResumeFrom); prefix seeds the window (dictionary)."""
    data = bytes(data)
    if eob_callback is None and resume_from is None and not prefix:
        out = native_inflate(data, max_size)
        if out is not None:
            return out
    return inflate_py(data, max_size, eob_callback, resume_from, prefix)


def inflate_py(data, max_size: int = 1 << 31, eob_callback=None,
               resume_from: Checkpoint | None = None,
               prefix: bytes = b"") -> bytes:
    """``inflate`` in Python alone (the reference's Python decoder)."""
    data = bytes(data)
    if resume_from is not None:
        br = _BitReader(data, resume_from.compressed_offset, resume_from.bit_offset)
        out = bytearray()
        window = bytearray(resume_from.window)
        base_off = resume_from.uncompressed_offset
        if resume_from.final:
            return b""
    else:
        br = _BitReader(data)
        out = bytearray()
        window = bytearray(prefix[-32768:]) if prefix else bytearray()
        base_off = 0

    def backref(dist: int, length: int):
        if dist > len(out) + len(window):
            raise InflateError("distance too far back")
        for _ in range(length):
            if dist > len(out):
                b = window[len(window) - (dist - len(out))]
            else:
                b = out[-dist]
            out.append(b)
        if len(out) > max_size:
            raise InflateError("output exceeds limit")

    while True:
        final = br.take(1)
        btype = br.take(2)
        if btype == 0:
            br.align_byte()
            ln = br.take(16)
            nln = br.take(16)
            if ln != (~nln) & 0xFFFF:
                raise InflateError("stored length mismatch")
            start = br.pos - br.n // 8
            if start + ln > len(data):
                raise InflateError("stored block truncated")
            out += data[start : start + ln]
            br.pos = start + ln
            br.acc = 0
            br.n = 0
        elif btype in (1, 2):
            if btype == 1:
                (lit_tab, lit_max), (dist_tab, dist_max) = _fixed_tables()
            else:
                (lit_tab, lit_max), (dist_tab, dist_max) = _read_dynamic_tables(br)
            while True:
                s = _decode_sym(br, (lit_tab), lit_max)
                if s < 256:
                    out.append(s)
                    if len(out) > max_size:
                        raise InflateError("output exceeds limit")
                elif s == 256:
                    break
                else:
                    lc = s - 257
                    if lc >= 29:
                        raise InflateError("invalid length code")
                    length = int(H._LEN_BASE[lc]) + br.take(int(H._LEN_XBITS[lc]))
                    if dist_tab is None:
                        raise InflateError("match with empty distance table")
                    dc = _decode_sym(br, dist_tab, dist_max)
                    if dc >= 30:
                        raise InflateError("invalid distance code")
                    dist = int(H._DIST_BASE[dc]) + br.take(int(H._DIST_XBITS[dc]))
                    backref(dist, length)
        else:
            raise InflateError("reserved block type")
        if eob_callback is not None:
            byte, bit = br.bit_position()
            win = (bytes(window) + bytes(out))[-32768:]
            eob_callback(Checkpoint(base_off + len(out), byte, bit, bool(final), win))
        if final:
            return bytes(out)


# ---------------------------------------------------------------------------
# Streaming Reader (reference roles: flate.NewReader / the resumable step
# machine in flate/inflate.go, read-side; consumed by gzip.Reader
# (gzip/gunzip.go:75) and zlib.Reader (zlib/reader.go:51))
# ---------------------------------------------------------------------------


_READ_CHUNK = 1 << 16


class Reader:
    """Incremental DEFLATE decoder over a file-like object.

    read(n) returns up to n decompressed bytes (b"" at end of stream);
    decoding advances at deflate-block granularity on the host core's
    streaming entry (ct_inflate_stream). `dictionary` seeds the window.

    After the final block, any unconsumed input bytes the Reader
    over-read from the source are available as `.unused_tail` (gzip/zlib
    trailers, next multistream member)."""

    def __init__(self, src, dictionary: bytes | None = None,
                 max_block: int = 1 << 30):
        if isinstance(src, (bytes, bytearray, memoryview)):
            src = io.BytesIO(bytes(src))
        self._src = src
        self._buf = bytearray()       # compressed bytes not yet consumed
        self._bitpos = 0              # bit offset into _buf
        self._out = bytearray()       # decoded, not yet read
        self._window = bytearray(bytes(dictionary or b"")[-32768:])
        self._eos = False             # final deflate block decoded
        self._src_eof = False
        self._max_block = max_block
        self._cap = 1 << 18           # native output capacity (grows)

    # -- internals ----------------------------------------------------------

    def _fill_src(self) -> bool:
        chunk = self._src.read(_READ_CHUNK)
        if not chunk:
            self._src_eof = True
            return False
        self._buf += chunk
        return True

    def _advance_native(self, lib) -> bool:
        """One native call; returns True if progress was made."""
        # drop fully-consumed bytes (keep bit alignment)
        drop = self._bitpos >> 3
        if drop:
            del self._buf[:drop]
            self._bitpos &= 7
        wn = len(self._window)
        n = len(self._buf)
        src = bytes(self._buf) + b"\x00" * 8
        while True:
            arr, ptr = _native.out_buf(self._cap + 32768)
            arr[:wn] = np.frombuffer(bytes(self._window), np.uint8)
            bitp = ctypes.c_longlong(self._bitpos)
            st = ctypes.c_int(0)
            r = lib.ct_inflate_stream(src, n, ctypes.byref(bitp), ptr, wn,
                                      self._cap + 32768, ctypes.byref(st))
            if st.value == 2 and r == 0:
                # a single block larger than the capacity: grow and retry
                if self._cap >= self._max_block:
                    raise InflateError("deflate block exceeds max_block")
                self._cap *= 4
                continue
            break
        if st.value == -1:
            raise InflateError("corrupt deflate stream")
        produced = int(r)
        if produced > 0:
            out = arr[wn : wn + produced].tobytes()
            self._out += out
            w = (bytes(self._window) + out)[-32768:]
            self._window = bytearray(w)
        self._bitpos = int(bitp.value)
        if st.value == 1:
            self._eos = True
        return produced > 0 or st.value == 1

    def _advance_python(self) -> None:
        """The plain version: read ALL remaining input, decode once with
        the checkpointed whole-buffer inflate (the same output; the
        streaming memory profile needs the host core)."""
        rest = self._src.read()
        data = bytes(self._buf) + (rest or b"")
        self._buf.clear()
        self._bitpos = 0
        self._src_eof = True
        ends = []
        out = inflate(data, prefix=bytes(self._window),
                      eob_callback=lambda cp: ends.append(
                          (cp.compressed_offset, cp.bit_offset, cp.final)))
        self._out += out
        self._window = bytearray((bytes(self._window) + out)[-32768:])
        for off, bit, fin in ends:
            if fin:
                self._buf = bytearray(data[off + (1 if bit else 0):])
                break
        self._eos = True

    def _pump(self) -> None:
        """Make decode progress: buffer more output or reach end-of-stream."""
        if self._eos:
            return
        lib = _native.library()
        while True:
            made = self._advance_native(lib)
            if made or self._eos:
                return
            if not self._fill_src():
                raise InflateError("truncated deflate stream")

    # -- public API ----------------------------------------------------------

    def read(self, n: int = -1) -> bytes:
        if n is None or n < 0:
            parts = []
            while True:
                b = self.read(_READ_CHUNK * 4)
                if not b:
                    break
                parts.append(b)
            return b"".join(parts)
        while len(self._out) < n and not self._eos:
            self._pump()
            if not self._out and self._eos:
                break
        take = bytes(self._out[:n])
        del self._out[:n]
        return take

    def read1(self, n: int = _READ_CHUNK) -> bytes:
        if not self._out and not self._eos:
            self._pump()
        return self.read(min(n, max(len(self._out), 1)))

    @property
    def unused_tail(self) -> bytes:
        """Bytes read from the source past the end of the deflate stream
        (valid once the stream is finished)."""
        if not self._eos:
            return b""
        skip = (self._bitpos + 7) >> 3
        return bytes(self._buf[skip:])

    def __iter__(self):
        while True:
            b = self.read(_READ_CHUNK)
            if not b:
                return
            yield b

    def close(self):
        self._src = None


class ReaderPy(Reader):
    """``Reader`` on the whole-buffer Python decode (the plain version)."""

    def _pump(self) -> None:
        if not self._eos:
            self._advance_python()
