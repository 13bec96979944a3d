"""Random access over indexed S2 streams (a copy of the JAX package's
``s2/seek.py``).

Reference parity: s2/reader.go ReadSeeker (Seek/ReadAt over an index,
random or forward-only modes). The index is loaded from the stream tail or
supplied externally.
"""

from __future__ import annotations

import io

from compress_tpu_torch.s2 import stream as s2stream
from compress_tpu_torch.s2.index import Index


class ReadSeeker:
    """io.ReadSeeker/ReaderAt-style access to a framed S2 stream."""

    def __init__(self, src, index: Index | None = None):
        """src: seekable binary file object containing the full stream."""
        self.src = src
        if index is None:
            src.seek(0, io.SEEK_END)
            size = src.tell()
            tail_len = min(size, 64 << 10)
            src.seek(size - tail_len)
            index = Index.load_stream(src.read(tail_len))
        self.index = index
        self._pos = 0

    def size(self) -> int:
        return self.index.total_uncompressed

    def seek(self, offset: int, whence: int = io.SEEK_SET) -> int:
        if whence == io.SEEK_SET:
            pos = offset
        elif whence == io.SEEK_CUR:
            pos = self._pos + offset
        elif whence == io.SEEK_END:
            pos = self.index.total_uncompressed + offset
        else:
            raise ValueError("bad whence")
        if pos < 0:
            raise ValueError("negative position")
        self._pos = pos
        return pos

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = max(self.index.total_uncompressed - self._pos, 0)
        out = self.read_at(self._pos, n)
        self._pos += len(out)
        return out

    def read_at(self, offset: int, n: int) -> bytes:
        """io.ReaderAt semantics: n bytes at absolute offset."""
        if offset >= self.index.total_uncompressed:
            return b""
        c_off, u_off = self.index.find(offset)
        self.src.seek(c_off)
        r = s2stream.Reader(self.src, ignore_stream_id=(c_off != 0))
        if offset > u_off:
            r.skip(offset - u_off)
        return r.read(n)


__all__ = ["ReadSeeker"]
