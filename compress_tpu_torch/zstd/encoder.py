"""zstd host encoder (RFC 8878), as the JAX package's ``zstd/encoder.py``
encodes.  ``compress`` sends levels 1-4 (an input over 16 bytes) through
the host core's ladder (``ct_zstd_compress_level``: greedy, double-fast,
lazy and deep-lazy parses, ``zstd_enc.cpp``); with ``window_log`` an
input larger than the window goes as jobs of in-frame blocks whose
matches reach back into an overlap prefix (``ct_zstd_compress_blocks_level``,
``compress_blocks``), and with ``dict_`` the dictionary's content is that
prefix.  Everything else (and both options together) goes through the
greedy repeat-aware ``Matcher`` and the block assembly copied from the
reference's Python branch (``compress_matcher``, byte for byte the
reference's frames on that branch; a dictionary's content seeds its hash
table and its repeat offsets start the first block).  The device encoder
writes its sub-job tail with the ``Matcher`` too (``device.tail_bodies``).
``compress_frame_bs`` is the ladder's frame of 64 KiB blocks and a capped
window that the accel encode's multi-block mode needs
(``ct_zstd_compress_frame_bs``).  The concurrent job engine
(``compress_concurrent``) is not ported.

``predef_seq_tables()`` pins every sequence section to the predefined FSE
tables (mode 0), in the ladder (its ``ct_zstd_force_predef`` flag) and in
the ``Matcher`` path: the frames the shared-table sequence decoder
(``ops/zseq_kern.py``) reads.  The predefined alphabets cover every code,
so any parse stays encodable.
"""

from __future__ import annotations

import contextlib

import numpy as np

from compress_tpu_torch import _native
from compress_tpu_torch.fse import core as fse_core
from compress_tpu_torch.huff0 import table as HT
from compress_tpu_torch.huff0.batch import _encode_stream
from compress_tpu_torch.s2.block import match_len
from compress_tpu_torch.utils.debuglog import dbg
from compress_tpu_torch.utils.xxhash64 import xxh64
from compress_tpu_torch.zstd import frame as F
from compress_tpu_torch.zstd import seqs as S

_MUL = 0x9E3779B185EBCA87
BLOCK_SIZE = 1 << 17  # 128 KiB

_FORCE_PREDEF = False


@contextlib.contextmanager
def predef_seq_tables():
    """Within the scope, the ladder and ``_choose_table`` write the
    predefined table (mode 0) for every sequence section.  Process-global:
    do not interleave with encodes that must keep their own tables."""
    global _FORCE_PREDEF
    lib = _native.library()
    _FORCE_PREDEF = True
    lib.ct_zstd_force_predef(1)
    try:
        yield
    finally:
        _FORCE_PREDEF = False
        lib.ct_zstd_force_predef(0)


def _hashes(buf: np.ndarray, bits: int) -> tuple[np.ndarray, np.ndarray]:
    n = len(buf)
    b8 = np.concatenate([buf, np.zeros(8, np.uint8)])
    v32 = (b8[:n].astype(np.uint64)
           | (b8[1:n + 1].astype(np.uint64) << np.uint64(8))
           | (b8[2:n + 2].astype(np.uint64) << np.uint64(16))
           | (b8[3:n + 3].astype(np.uint64) << np.uint64(24)))
    h = ((v32 << np.uint64(32)) * np.uint64(_MUL)) >> np.uint64(64 - bits)
    return h.astype(np.int64), v32.astype(np.uint32)


_LEVEL_PARAMS = {
    1: dict(bits=16, insert=2),   # fastest
    2: dict(bits=17, insert=4),   # default
    3: dict(bits=18, insert=6),   # better
    4: dict(bits=19, insert=8),   # best
}


class Matcher:
    """Greedy repeat-aware matcher with its hash table shared across the
    blocks of a frame.  Sequences never span a block end (matches are
    capped at it); candidates may reference any earlier position of the
    input, or at most ``window`` bytes back.  The scan loop reads Python
    lists (the reference indexes numpy arrays; the values are the same)."""

    def __init__(self, src: bytes, level: int = 2,
                 window: int | None = None):
        self.src = src
        self.buf = np.frombuffer(src, dtype=np.uint8)
        p = _LEVEL_PARAMS.get(level, _LEVEL_PARAMS[2])
        n = len(src)
        bits = 8
        while (1 << bits) < n and bits < p["bits"]:
            bits += 1
        self.bits = bits
        self.insert = p["insert"]
        self.window = window  # None: the window covers the input
        if n >= 4:
            h, v = _hashes(self.buf, bits)
            self.hashes, self.v32 = h.tolist(), v.tolist()
        self.table = [-1] * (1 << bits)
        self.r1 = 0  # last emitted offset (repeat probe)

    def next_block(self, start: int, end: int):
        """Sequences covering src[start:end]: (lls, mls, offs, tail)."""
        src = self.src
        out_ll, out_ml, out_off = [], [], []
        if end - start < 16:
            return (np.array([], np.int64),) * 3 + (src[start:end],)
        hashes, v32, table = self.hashes, self.v32, self.table
        s = max(start, 1)
        next_emit = start
        r1 = self.r1

        def done():
            self.r1 = r1
            return (np.array(out_ll, np.int64), np.array(out_ml, np.int64),
                    np.array(out_off, np.int64), src[next_emit:end])

        while True:
            while True:
                if s + 16 > end:
                    return done()
                h = hashes[s]
                c = table[h]
                table[h] = s
                if r1 > 0 and s - r1 >= 0 and v32[s] == v32[s - r1]:
                    cand = s - r1
                    break
                # c < s: after backward extension a short match can leave
                # the scan behind a stale table entry
                if 0 <= c < s and v32[c] == v32[s] and (
                        self.window is None or s - c <= self.window):
                    cand = c
                    break
                s += 1 + ((s - next_emit) >> 6)
            while s > next_emit and cand > 0 and src[s - 1] == src[cand - 1]:
                s -= 1
                cand -= 1
            length = 4 + match_len(src, cand + 4, s + 4, end - s - 4)
            out_ll.append(s - next_emit)
            out_ml.append(length)
            out_off.append(s - cand)
            r1 = s - cand
            s += length
            next_emit = s
            if s + 16 > end:
                return done()
            for d in range(1, self.insert + 1):
                if s - d > 0:
                    table[hashes[s - d]] = s - d


def offsets_to_values(lls, offsets, reps=(1, 4, 8)):
    """Absolute offsets -> zstd offset values, preferring repeat codes
    (the decoder's repeat-offset updates, mirrored)."""
    r1, r2, r3 = reps
    vals = np.zeros(len(offsets), dtype=np.int64)
    for i in range(len(offsets)):
        off = int(offsets[i])
        if int(lls[i]) > 0:
            if off == r1:
                vals[i] = 1
            elif off == r2:
                vals[i] = 2
                r1, r2 = r2, r1
            elif off == r3:
                vals[i] = 3
                r1, r2, r3 = r3, r1, r2
            else:
                vals[i] = off + 3
                r1, r2, r3 = off, r1, r2
        else:
            if off == r2:
                vals[i] = 1
                r1, r2 = r2, r1
            elif off == r3:
                vals[i] = 2
                r1, r2, r3 = r3, r1, r2
            elif off == r1 - 1 and off > 0:
                vals[i] = 3
                r1, r2, r3 = off, r1, r2
            else:
                vals[i] = off + 3
                r1, r2, r3 = off, r1, r2
    return vals, (r1, r2, r3)


def _lit_header(lit_type: int, regen: int) -> bytes:
    """Header of a raw (0) or RLE (1) literals section."""
    if regen < 32:
        return bytes([lit_type | (regen << 3)])
    if regen < 4096:
        return (lit_type | (1 << 2) | (regen << 4)).to_bytes(2, "little")
    return (lit_type | (3 << 2) | (regen << 4)).to_bytes(3, "little")


def _lit_header_comp(lit_type: int, streams: int, regen: int,
                     comp: int) -> bytes:
    if streams == 1:
        if regen >= 1 << 10 or comp >= 1 << 10:
            raise ValueError("1-stream sizes out of range")
        return (lit_type | (regen << 4) | (comp << 14)).to_bytes(3, "little")
    if regen < 1 << 10 and comp < 1 << 10:
        v = lit_type | (1 << 2) | (regen << 4) | (comp << 14)
        return v.to_bytes(3, "little")
    if regen < 1 << 14 and comp < 1 << 14:
        v = lit_type | (2 << 2) | (regen << 4) | (comp << 18)
        return v.to_bytes(4, "little")
    v = lit_type | (3 << 2) | (regen << 4) | (comp << 22)
    return v.to_bytes(5, "little")


def encode_literals(literals: bytes) -> bytes:
    """The smallest of a raw, RLE or Huffman literals section."""
    n = len(literals)
    raw = _lit_header(0, n) + literals
    if n == 0:
        return raw
    if literals.count(literals[0]) == n:
        return _lit_header(1, n) + literals[:1]
    if n < 32:
        return raw
    buf = np.frombuffer(literals, dtype=np.uint8)
    hist = np.bincount(buf, minlength=256).astype(np.int64)
    try:
        nbits, max_bits = HT.build_nbits(hist, HT.MAX_TABLELOG)
    except ValueError:   # UseRLEError included
        return raw
    codes = HT.canonical_codes(nbits, max_bits)
    try:
        table = HT.write_table(nbits, max_bits)
    except HT.IncompressibleError:
        return raw
    if n >= 256:
        seg = (n + 3) // 4
        streams = [_encode_stream(buf[k * seg:min((k + 1) * seg, n)], codes,
                                  nbits) for k in range(4)]
        if max(len(x) for x in streams[:3]) > 0xFFFF:
            return raw
        body = (table + b"".join(len(x).to_bytes(2, "little")
                                 for x in streams[:3]) + b"".join(streams))
        streams_n = 4
    else:
        body = table + _encode_stream(buf, codes, nbits)
        streams_n = 1
    try:
        hdr = _lit_header_comp(2, streams_n, n, len(body))
    except (ValueError, OverflowError):
        return raw
    comp = hdr + body
    return comp if len(comp) < len(raw) else raw


def _choose_table(codes: np.ndarray, which: str):
    """Predefined vs RLE vs a new FSE table: the cheapest valid option
    (always the predefined one under ``predef_seq_tables``).  Returns
    (STable, mode, table header bytes)."""
    max_sym, max_log, predef_norm, predef_log = S.TABLE_PARAMS[which]
    if _FORCE_PREDEF:
        return (S.STable(predef_norm, predef_log, S.MODE_PREDEFINED),
                S.MODE_PREDEFINED, b"")
    hist = np.bincount(codes.astype(np.int64),
                       minlength=max_sym + 1).astype(np.int64)
    if int((hist > 0).sum()) == 1:
        sym = int(np.nonzero(hist)[0][0])
        return (S.STable(None, 0, S.MODE_RLE, rle_symbol=sym), S.MODE_RLE,
                bytes([sym]))
    max_code = int(codes.max())
    n = len(codes)

    def table_bits(norm, log):
        p = np.where(norm == -1, 0.5, norm.astype(np.float64)) / (1 << log)
        with np.errstate(divide="ignore"):
            bits = -np.log2(np.where(p > 0, p, 1.0))
        sel = hist[:len(norm)]
        return float((sel * bits[:len(sel)]).sum())

    best = None
    if max_code < len(predef_norm):
        best = (table_bits(predef_norm, predef_log) / 8, S.MODE_PREDEFINED,
                S.STable(predef_norm, predef_log, S.MODE_PREDEFINED), b"")
    if n >= 16:
        try:
            tl = fse_core.optimal_table_log(max_log, n, max_code,
                                            max_table_log=max_log)
            norm = fse_core.normalize_count(hist[:max_code + 1], tl, n,
                                            max_code)
            hdr = fse_core.write_ncount(norm, tl)
            cost = table_bits(norm, tl) / 8 + len(hdr)
            if best is None or cost < best[0]:
                best = (cost, S.MODE_FSE, S.STable(norm, tl, S.MODE_FSE), hdr)
        except ValueError:
            pass
    if best is None:
        raise ValueError("no valid sequence table")
    return best[2], best[1], best[3]


def _seq_count_header(n: int) -> bytes:
    """The sequences section's count (1-3 bytes)."""
    if n < 128:
        return bytes([n])
    if n < 0x7F00:
        return bytes([128 + (n >> 8), n & 0xFF])
    return b"\xff" + (n - 0x7F00).to_bytes(2, "little")


def encode_sequences_section(lls, mls, ofvals) -> bytes:
    out = bytearray(_seq_count_header(len(lls)))
    if not len(lls):
        return bytes(out)
    t_ll, m_ll, x_ll = _choose_table(S.ll_code(lls), "ll")
    t_of, m_of, x_of = _choose_table(S.of_code(ofvals), "of")
    t_ml, m_ml, x_ml = _choose_table(S.ml_code(mls), "ml")
    out.append((m_ll << 6) | (m_of << 4) | (m_ml << 2))
    out += x_ll + x_of + x_ml
    out += S.encode_sequences(lls, mls, ofvals, t_ll, t_of, t_ml)
    return bytes(out)


def _encode_blocks(data: bytes, level: int, window: int | None = None,
                   prefix: bytes = b"", reps=(1, 4, 8)) -> bytes:
    """The blocks of a frame of data (not empty): ``BLOCK_SIZE`` bytes each
    but the last, sequences from one ``Matcher`` over ``prefix + data``
    (the prefix only seeds its hash table), the repeat offsets starting at
    ``reps``."""
    n = len(data)
    base = len(prefix)
    view = bytes(prefix) + data if base else data
    matcher = Matcher(view, level, window)
    if base:
        matcher.next_block(0, base)   # seed the table; sequences dropped
    out = bytearray()
    pos = 0
    while pos < n:
        blk_start = base + pos
        blk_end = base + min(pos + BLOCK_SIZE, n)
        lls, mls, offs, tail = matcher.next_block(blk_start, blk_end)
        pos = blk_end - base
        last = pos >= n
        blk_regen = blk_end - blk_start
        body = None
        cand_reps = reps
        if len(lls):
            vals, cand_reps = offsets_to_values(lls, offs, reps)
            # literals: the per-sequence runs, then the tail
            lit_parts = []
            p = blk_start
            for ll, ml in zip(lls.tolist(), mls.tolist()):
                lit_parts.append(view[p:p + ll])
                p += ll + ml
            lit_parts.append(tail)
            body = (encode_literals(b"".join(lit_parts))
                    + encode_sequences_section(lls, mls, vals))
        if body is None or len(body) >= blk_regen:
            # raw blocks leave the repeat offsets as they are
            bh = (1 if last else 0) | (blk_regen << 3)
            out += bh.to_bytes(3, "little")
            out += view[blk_start:blk_end]
        else:
            bh = (1 if last else 0) | (2 << 1) | (len(body) << 3)
            out += bh.to_bytes(3, "little")
            out += body
            reps = cand_reps
    return bytes(out)


def _compress_level(data: bytes, checksum: bool, level: int) -> bytes:
    """One frame on the host core's ladder (levels 1-4)."""
    n = len(data)
    cap = n + n // 8 + 256
    arr, dst = _native.out_buf(cap)
    xx = (xxh64(data) & 0xFFFFFFFF) if checksum else 0
    r = _native.library().ct_zstd_compress_level(
        data, n, dst, cap, 1 if checksum else 0, xx, level)
    if r < 0:
        raise RuntimeError(f"ct_zstd_compress_level failed on {n} bytes")
    return arr[:r].tobytes()


def compress_blocks(seg: bytes, start: int, level: int) -> bytes:
    """``seg[start:]`` as in-frame blocks, none of them marked last, whose
    matches may reach back into ``seg[:start]`` (the host core's job entry
    ``ct_zstd_compress_blocks_level``).  No block uses a repeat code, so
    the bytes are valid whatever repeat offsets the decoder carries in."""
    seg = bytes(seg)
    n = len(seg) - start
    cap = n + n // 8 + 4096
    arr, dst = _native.out_buf(cap)
    r = _native.library().ct_zstd_compress_blocks_level(seg, len(seg), start,
                                                         dst, cap, level)
    if r < 0:
        raise RuntimeError(f"ct_zstd_compress_blocks_level failed on {n} "
                           "bytes")
    return arr[:r].tobytes()


def _compress_dict(data: bytes, checksum: bool, level: int, dict_) -> bytes:
    """A dictionary frame on the job entry: the dictionary's content is the
    overlap prefix; the blocks are not last and an empty raw block closes
    the frame."""
    content = bytes(dict_.content)
    n = len(data)
    out = bytearray(F.write_frame_header(n, max(n + len(content), 1024),
                                         False, checksum, dict_id=dict_.id))
    out += compress_blocks(content + data, len(content), level)
    out += (1).to_bytes(3, "little")  # empty raw last block
    if checksum:
        out += (xxh64(data) & 0xFFFFFFFF).to_bytes(4, "little")
    return bytes(out)


def _compress_windowed(data: bytes, checksum: bool, level: int,
                       window_log: int) -> bytes:
    """A frame whose match offsets stay within ``2^window_log``: jobs of
    (window - overlap) bytes, each with the overlap before it as its
    prefix (reference: WithWindowSize's jobSize and overlap)."""
    n = len(data)
    window = 1 << max(int(window_log), 10)
    overlap = window // 8
    job = window - overlap
    out = bytearray(F.write_frame_header(n, min(window, max(n, 1024)),
                                         False, checksum))
    pos = 0
    while pos < n:
        hi = min(pos + job, n)
        p = max(0, pos - overlap)
        out += compress_blocks(data[p:hi], pos - p, level)
        pos = hi
    out += (1).to_bytes(3, "little")  # empty raw last block
    if checksum:
        out += (xxh64(data) & 0xFFFFFFFF).to_bytes(4, "little")
    return bytes(out)


def compress(data, level: int = 2, checksum: bool = False,
             window_log: int | None = None, dict_=None) -> bytes:
    """Encode data as one zstd frame (reference: Encoder.EncodeAll).
    Levels up to 4 of an input over 16 bytes run on the host core (a
    level below 1 as level 1): the ladder, the windowed jobs where
    ``window_log`` is smaller than the input, or the dictionary's prefix
    job; the rest, and ``window_log`` with ``dict_``, through
    ``compress_matcher``.  ``dict_``: a ``zstd.dict.Dict``, whose id the
    frame carries."""
    data = bytes(data)
    n = len(data)
    if level <= 4 and n > 16:
        lv = max(level, 1)
        if dict_ is None and (window_log is None
                              or n <= 1 << max(int(window_log), 10)):
            out = _compress_level(data, checksum, lv)
            if window_log is None:
                dbg("zstd", "compress n=%d level=%d native -> %d bytes",
                    n, level, len(out))
            return out
        if dict_ is None:
            return _compress_windowed(data, checksum, lv, window_log)
        if window_log is None:
            return _compress_dict(data, checksum, lv, dict_)
    return compress_matcher(data, level, checksum, window_log, dict_)


def compress_matcher(data, level: int = 2, checksum: bool = False,
                     window_log: int | None = None, dict_=None) -> bytes:
    """Encode data as one zstd frame with the ``Matcher`` (levels 1-4
    differ in its hash width and insert depth): the reference's Python
    branch, with its window and dictionary."""
    data = bytes(data)
    n = len(data)
    single = n <= (1 << 20) and dict_ is None
    plen = len(dict_.content) if dict_ is not None else 0
    window = n if single else min(1 << (window_log or 23),
                                  max(n + plen, 1024))
    out = bytearray(F.write_frame_header(
        n, max(window, 1), single, checksum,
        dict_id=dict_.id if dict_ is not None else 0))
    if n == 0:
        out += (1).to_bytes(3, "little")  # empty raw last block
        if checksum:
            out += (xxh64(b"") & 0xFFFFFFFF).to_bytes(4, "little")
        return bytes(out)
    if dict_ is not None:
        out += _encode_blocks(data, level,
                              (1 << window_log) if window_log else None,
                              bytes(dict_.content), dict_.reps)
    else:
        out += _encode_blocks(data, level,
                              (1 << window_log) if window_log else None)
    if checksum:
        out += (xxh64(data) & 0xFFFFFFFF).to_bytes(4, "little")
    return bytes(out)


def compress_frame_bs(data, level: int, block_log: int,
                      max_window: int) -> bytes:
    """One frame of blocks of ``1 << block_log`` bytes (the last one
    shorter) whose matches reach back at most ``max_window`` bytes
    (``ct_zstd_compress_frame_bs``): no single segment, the window
    descriptor of min(input, 8 MiB, max_window), at least 1 KiB, a 4-byte
    content size, no checksum.  The input must hold more than 16 bytes
    and fewer than 2^32."""
    data = bytes(data)
    n = len(data)
    if n <= 16 or n >= 1 << 32:
        raise ValueError(f"compress_frame_bs: {n} bytes")
    cap = n + n // 2 + (1 << 16)
    arr, dst = _native.out_buf(cap)
    r = _native.library().ct_zstd_compress_frame_bs(
        data, n, dst, cap, 0, 0, int(level), int(block_log), int(max_window))
    if r <= 0:
        raise RuntimeError(f"ct_zstd_compress_frame_bs failed on {n} bytes")
    return arr[:r].tobytes()
