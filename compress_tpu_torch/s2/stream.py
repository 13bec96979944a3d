"""S2/Snappy framed streams: Writer and Reader.

A copy of the JAX package's ``s2/stream.py``, on the port's host codec
(``s2/block.py``) and checksum (``utils/crc.crc32c_masked``, the host
core's ``ct_crc32c``).  Reference parity: s2/writer.go (chunked framing, per-chunk CRC, uncompressed
fallback, padding via skippable chunks, snappy-compat mode, custom encoder
hook) and s2/reader.go (chunk parser, CRC verify, skippable callbacks, Skip).
Framing per the snappy framing_format.txt with the S2 extensions
(s2/s2.go:75-114): magic "S2sTwO", blocks up to 4 MiB, index chunk 0x99.

Concurrency: ``Writer(workers=N)`` encodes blocks on a thread pool (the
host core releases the GIL) and writes them in input order, so its bytes
equal the serial Writer's; the device path (``parallel.engine``) writes
the same framing.
"""

from __future__ import annotations

from compress_tpu_torch.s2 import block as s2block
from compress_tpu_torch.utils.crc import crc32c_masked
from compress_tpu_torch.utils.varint import put_uvarint, read_uvarint

MAGIC_CHUNK = b"\xff\x06\x00\x00S2sTwO"
MAGIC_CHUNK_SNAPPY = b"\xff\x06\x00\x00sNaPpY"

CHUNK_COMPRESSED = 0x00
CHUNK_UNCOMPRESSED = 0x01
CHUNK_INDEX = 0x99
CHUNK_PADDING = 0xFE
CHUNK_STREAM_ID = 0xFF

MAX_BLOCK_SIZE = 4 << 20
MIN_BLOCK_SIZE = 4 << 10
DEFAULT_BLOCK_SIZE = 1 << 20
SNAPPY_BLOCK_SIZE = 1 << 16
MAX_CHUNK_SIZE = (1 << 24) - 1


class StreamError(ValueError):
    pass


class Writer:
    """Framed S2 stream writer (reference: s2.NewWriter).

    Options mirror the reference's WriterOption set: block_size
    (WriterBlockSize), snappy (WriterSnappyCompat), padding (WriterPadding),
    uncompressed (WriterUncompressed), level via ``mode``, custom_encoder
    (WriterCustomEncoder), add_index (WriterAddIndex)."""

    def __init__(self, dst, block_size: int = DEFAULT_BLOCK_SIZE,
                 snappy: bool = False, padding: int = 0,
                 uncompressed: bool = False, custom_encoder=None,
                 add_index: bool = False, workers: int = 1,
                 level: int = 1):
        if not MIN_BLOCK_SIZE <= block_size <= MAX_BLOCK_SIZE:
            raise ValueError("invalid block size")
        if snappy:
            block_size = min(block_size, SNAPPY_BLOCK_SIZE)
        if padding and not 4 <= padding <= (4 << 20):
            raise ValueError("padding must be in [4, 4MB]")
        self.dst = dst
        self.block_size = block_size
        self.snappy = snappy
        self.padding = padding
        self.uncompressed_mode = uncompressed
        self.custom_encoder = custom_encoder
        self.add_index = add_index
        # level 1/2/3 = fast/better/best (reference WriterBetterCompression
        # / WriterBestCompression); workers>1 = fan-out block encode with
        # ordered emission (reference s2/writer.go:518-563 concurrency)
        self.level = level
        self.workers = max(1, int(workers))
        self._pool = None
        self._futs = None
        self._buf = bytearray()
        self._wrote_header = False
        self._written = 0
        self._uncomp_written = 0
        self._index = []  # (uncompressed_offset, compressed_offset)
        self._closed = False

    # -- io.Writer-ish API ---------------------------------------------------

    def write(self, data) -> int:
        if self._closed:
            raise StreamError("writer closed")
        self._buf += bytes(data)
        while len(self._buf) >= self.block_size:
            blk = bytes(self._buf[: self.block_size])
            del self._buf[: self.block_size]
            self._write_block(blk)
        return len(data)

    def _emit(self, chunk: bytes):
        self.dst.write(chunk)
        self._written += len(chunk)

    def _write_header(self):
        if not self._wrote_header:
            self._emit(MAGIC_CHUNK_SNAPPY if self.snappy else MAGIC_CHUNK)
            self._wrote_header = True

    def _encode_chunk(self, blk: bytes) -> tuple[bytes, int]:
        """Encode one block to its framed chunk (thread-safe: the native
        core releases the GIL, so worker threads overlap for real)."""
        crc = crc32c_masked(blk)
        body = None
        if not self.uncompressed_mode:
            if self.custom_encoder is not None:
                body = self.custom_encoder(blk)
            else:
                payload = bytearray()
                put_uvarint(payload, len(blk))
                payload += s2block._encode_body(
                    blk,
                    s2block._MODE_SNAPPY if self.snappy else s2block._MODE_S2,
                    self.level,
                )
                body = bytes(payload)
        if body is None or len(body) >= len(blk):
            chunk = bytes([CHUNK_UNCOMPRESSED]) + (len(blk) + 4).to_bytes(3, "little")
            chunk += crc.to_bytes(4, "little") + blk
        else:
            chunk = bytes([CHUNK_COMPRESSED]) + (len(body) + 4).to_bytes(3, "little")
            chunk += crc.to_bytes(4, "little") + body
        return chunk, len(blk)

    def _emit_chunk(self, chunk: bytes, blk_len: int):
        self._index.append((self._uncomp_written, self._written))
        self._emit(chunk)
        self._uncomp_written += blk_len

    def _drain(self, keep: int = 0):
        while self._futs and len(self._futs) > keep:
            chunk, blk_len = self._futs.popleft().result()
            self._emit_chunk(chunk, blk_len)

    def _write_block(self, blk: bytes):
        self._write_header()
        if self.workers > 1:
            if self._pool is None:
                from collections import deque
                from concurrent.futures import ThreadPoolExecutor

                self._pool = ThreadPoolExecutor(max_workers=self.workers)
                self._futs = deque()
            self._futs.append(self._pool.submit(self._encode_chunk, blk))
            # backpressure: bound in-flight blocks, draining in order
            self._drain(keep=2 * self.workers)
            return
        chunk, blk_len = self._encode_chunk(blk)
        self._emit_chunk(chunk, blk_len)

    def flush(self):
        """Compress and emit buffered data now (partial block)."""
        if self._buf:
            blk = bytes(self._buf)
            self._buf.clear()
            self._write_block(blk)
        self._drain()
        self._write_header()

    def read_from(self, src, chunk: int = DEFAULT_BLOCK_SIZE) -> int:
        """Compress everything from a file-like source (reference:
        Writer.ReadFrom — io.ReaderFrom); returns bytes consumed."""
        total = 0
        while True:
            data = src.read(chunk)
            if not data:
                return total
            self.write(data)
            total += len(data)

    def async_flush(self):
        """Reference: Writer.AsyncFlush — hand buffered data to the
        worker pool and return without waiting for the encodes; a later
        flush()/close() drains them in order. With workers == 1 this is
        a plain flush."""
        if self._buf:
            blk = bytes(self._buf)
            self._buf.clear()
            self._write_block(blk)
        if self.workers <= 1:
            self._drain()
        self._write_header()

    def add_skippable_block(self, chunk_id: int, data: bytes):
        """Reference: Writer.AddSkippableBlock — user skippable chunks."""
        if not 0x80 <= chunk_id <= 0xFD:
            raise ValueError("chunk id must be in [0x80, 0xFD]")
        if len(data) > MAX_CHUNK_SIZE:
            raise ValueError("chunk too large")
        self.flush()
        self._emit(bytes([chunk_id]) + len(data).to_bytes(3, "little") + data)

    def close(self):
        if self._closed:
            return
        self.flush()
        if self.add_index and not self.snappy:
            from compress_tpu_torch.s2.index import Index

            idx = Index(self._index, self._uncomp_written, self._written)
            self._emit(idx.append_to())
        if self.padding:
            pad = -self._written % self.padding
            if pad:
                if pad < 4:
                    pad += self.padding
                body_len = pad - 4
                self._emit(bytes([CHUNK_PADDING]) + body_len.to_bytes(3, "little")
                           + bytes(body_len))
        if self._pool is not None:
            self._pool.shutdown(wait=True)
            self._pool = None
        self._closed = True


class Reader:
    """Framed S2/snappy stream reader (reference: s2.NewReader)."""

    def __init__(self, src, max_block_size: int = MAX_BLOCK_SIZE,
                 skippable_cb=None, ignore_stream_id: bool = False):
        self.src = src
        self.max_block = max_block_size
        self.skippable_cb = skippable_cb
        self.ignore_stream_id = ignore_stream_id
        self._pending = b""
        self._pending_pos = 0
        self._seen_id = ignore_stream_id
        self._eof = False
        self.uncompressed_pos = 0  # total uncompressed bytes surfaced

    def _next_chunk(self) -> bool:
        hdr = self.src.read(4)
        if len(hdr) == 0:
            self._eof = True
            return False
        if len(hdr) < 4:
            raise StreamError("truncated chunk header")
        ctype = hdr[0]
        clen = int.from_bytes(hdr[1:4], "little")
        if ctype == CHUNK_STREAM_ID:
            body = self.src.read(clen)
            if len(body) != clen:
                raise StreamError("truncated stream id")
            if body not in (MAGIC_CHUNK[4:], MAGIC_CHUNK_SNAPPY[4:]):
                raise StreamError("bad stream identifier")
            self._seen_id = True
            return True
        if not self._seen_id:
            raise StreamError("stream does not start with an identifier")
        if ctype in (CHUNK_COMPRESSED, CHUNK_UNCOMPRESSED):
            body = self.src.read(clen)
            if len(body) != clen:
                raise StreamError("truncated chunk")
            if clen < 4:
                raise StreamError("chunk too small")
            want_crc = int.from_bytes(body[:4], "little")
            payload = body[4:]
            if ctype == CHUNK_COMPRESSED:
                dlen, pos = read_uvarint(payload)
                if dlen > self.max_block:
                    raise StreamError("block exceeds max size")
                data = s2block.decode(payload)
            else:
                if len(payload) > self.max_block:
                    raise StreamError("block exceeds max size")
                data = payload
            if crc32c_masked(data) != want_crc:
                raise StreamError("crc mismatch")
            self._pending = data
            self._pending_pos = 0
            return True
        if ctype == CHUNK_PADDING or (0x80 <= ctype <= 0xFD) or ctype == CHUNK_INDEX:
            body = self.src.read(clen)
            if len(body) != clen:
                raise StreamError("truncated skippable chunk")
            if self.skippable_cb is not None and 0x80 <= ctype <= 0xFD:
                self.skippable_cb(ctype, body)
            return True
        raise StreamError(f"unsupported chunk type 0x{ctype:02x}")

    def read(self, n: int = -1) -> bytes:
        out = bytearray()
        while n < 0 or len(out) < n:
            if self._pending_pos >= len(self._pending):
                if self._eof or not self._advance():
                    break
                continue
            avail = len(self._pending) - self._pending_pos
            take = avail if n < 0 else min(avail, n - len(out))
            out += self._pending[self._pending_pos : self._pending_pos + take]
            self._pending_pos += take
            self.uncompressed_pos += take
        return bytes(out)

    def _advance(self) -> bool:
        while True:
            if not self._next_chunk():
                return False
            if self._pending_pos < len(self._pending):
                return True

    def read_byte(self) -> int:
        """Reference: Reader.ReadByte."""
        b = self.read(1)
        if not b:
            raise EOFError
        return b[0]

    def skip(self, n: int) -> None:
        """Skip n uncompressed bytes without decoding whole blocks when

        possible (reference: Reader.Skip, s2/reader.go:674)."""
        while n > 0:
            avail = len(self._pending) - self._pending_pos
            if avail > 0:
                take = min(avail, n)
                self._pending_pos += take
                self.uncompressed_pos += take
                n -= take
                continue
            if not self._next_chunk():
                raise EOFError("skip past end of stream")


def decode_concurrent(data, workers: int = 4, max_block_size: int = MAX_BLOCK_SIZE) -> bytes:
    """Decode a whole framed stream with a worker pool over independent
    chunks (reference: s2.DecodeConcurrent, s2/reader.go:413).

    Chunks are fully independent in S2 streams (offsets reset per block),
    so parsing walks the chunk headers serially and the block decodes +
    CRC checks run on a thread pool — the native core releases the GIL,
    so this scales like the reference's goroutine fan-in."""
    from concurrent.futures import ThreadPoolExecutor

    data = bytes(data)
    pos = 0
    jobs = []  # (kind, payload) in stream order
    seen_id = False
    while pos < len(data):
        if pos + 4 > len(data):
            raise StreamError("truncated chunk header")
        ctype = data[pos]
        clen = int.from_bytes(data[pos + 1 : pos + 4], "little")
        body = data[pos + 4 : pos + 4 + clen]
        if len(body) != clen:
            raise StreamError("truncated chunk")
        pos += 4 + clen
        if ctype == CHUNK_STREAM_ID:
            if body not in (MAGIC_CHUNK[4:], MAGIC_CHUNK_SNAPPY[4:]):
                raise StreamError("bad stream identifier")
            seen_id = True
            continue
        if not seen_id:
            raise StreamError("stream does not start with an identifier")
        if ctype in (CHUNK_COMPRESSED, CHUNK_UNCOMPRESSED):
            if clen < 4:
                raise StreamError("chunk too small")
            jobs.append((ctype, body))
        elif 0x80 <= ctype <= 0xFD:
            continue  # skippable
        elif ctype == CHUNK_PADDING:
            continue
        else:
            raise StreamError(f"unknown unskippable chunk 0x{ctype:02x}")

    def work(job):
        ctype, body = job
        want_crc = int.from_bytes(body[:4], "little")
        payload = body[4:]
        if ctype == CHUNK_COMPRESSED:
            out = s2block.decode(payload)
            if len(out) > max_block_size:
                raise StreamError("block exceeds max block size")
        else:
            out = payload
        if crc32c_masked(out) != want_crc:
            raise StreamError("crc mismatch")
        return out

    if workers <= 1 or len(jobs) <= 1:
        return b"".join(work(j) for j in jobs)
    with ThreadPoolExecutor(max_workers=workers) as ex:
        return b"".join(ex.map(work, jobs))
