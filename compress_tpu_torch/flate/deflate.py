"""DEFLATE encoder (RFC 1951): levels -2..9, custom windows, stateless mode
(the JAX package's ``flate/deflate.py``, byte for byte).

The routing is the reference's: ``deflate`` takes the host core
(``ct_deflate_level``: greedy 1-3, lazy 4-9) for levels 1-9 with the full
32 KiB window on inputs over 32 bytes, and ``deflate_py`` (the plain
version: the Python greedy matcher and per-block dynamic/fixed/stored
choice) for the rest.  ``Writer`` encodes its chunks with
``ct_deflate_blocks`` and the carried 32 KiB tail; levels 0 and -2 take
the Python block path, which ``WriterPy`` takes at every level.
"""

from __future__ import annotations

import numpy as np

from compress_tpu_torch import _native
from compress_tpu_torch.flate import huffman as H

MAX_OFFSET = 32768
MAX_MATCH = 258
MIN_MATCH = 3
_MUL = 0x9E3779B185EBCA87

HUFFMAN_ONLY = -2
NO_COMPRESSION = 0
DEFAULT_COMPRESSION = 6
BEST_SPEED = 1
BEST_COMPRESSION = 9

_LEVELS = {
    1: dict(bits=13, insert=1),
    2: dict(bits=14, insert=2),
    3: dict(bits=14, insert=3),
    4: dict(bits=15, insert=3),
    5: dict(bits=15, insert=4),
    6: dict(bits=16, insert=4),
    7: dict(bits=16, insert=6),
    8: dict(bits=17, insert=8),
    9: dict(bits=17, insert=10),
}


def _tokens(src: bytes, level: int, max_offset: int = MAX_OFFSET):
    """Greedy tokenization -> (lits_mask, mlen, mdist) per op list.

    Returns list of ops: (lit_run_start, lit_run_len, match_len, match_dist),
    the trailing literal run included with match_len 0."""
    p = _LEVELS.get(level, _LEVELS[6])
    n = len(src)
    ops = []
    if n < 16:
        return [(0, n, 0, 0)]
    buf = np.frombuffer(src, dtype=np.uint8)
    bits = 8
    while (1 << bits) < n and bits < p["bits"]:
        bits += 1
    b8 = np.concatenate([buf, np.zeros(8, np.uint8)])
    v32 = (
        b8[:n].astype(np.uint64)
        | (b8[1 : n + 1].astype(np.uint64) << np.uint64(8))
        | (b8[2 : n + 2].astype(np.uint64) << np.uint64(16))
        | (b8[3 : n + 3].astype(np.uint64) << np.uint64(24))
    )
    hashes = ((v32 << np.uint64(32)) * np.uint64(_MUL)) >> np.uint64(64 - bits)
    hashes = hashes.astype(np.int64)
    v32 = v32.astype(np.uint32)
    table = np.full(1 << bits, -1, dtype=np.int64)
    s = 1
    next_emit = 0
    while True:
        while True:
            if s + 16 > n:
                if next_emit < n:
                    ops.append((next_emit, n - next_emit, 0, 0))
                return ops
            h = int(hashes[s])
            c = int(table[h])
            table[h] = s
            # c < s: backward extension + short match can move the scan
            # BEHIND a stale table entry; a candidate ahead of the scan
            # position would give a negative distance
            if 0 <= c < s and v32[c] == v32[s] and s - c <= max_offset:
                cand = c
                break
            s += 1 + ((s - next_emit) >> 6)
        while s > next_emit and cand > 0 and s - cand <= max_offset and src[s - 1] == src[cand - 1]:
            s -= 1
            cand -= 1
        maxl = min(n - s - 4, MAX_MATCH - 4)
        x = buf[cand + 4 : cand + 4 + maxl]
        y = buf[s + 4 : s + 4 + maxl]
        neq = np.nonzero(x != y)[0]
        length = 4 + (int(neq[0]) if neq.size else maxl)
        ops.append((next_emit, s - next_emit, length, s - cand))
        s += length
        next_emit = s
        if s + 16 > n:
            if next_emit < n:
                ops.append((next_emit, n - next_emit, 0, 0))
            return ops
        for d in range(1, p["insert"] + 1):
            if s - d > 0:
                table[int(hashes[s - d])] = s - d


def _emit_block(bw: H.BitWriterLSB, src: bytes, ops, final: bool,
                force_kind: str | None = None):
    """Choose stored/fixed/dynamic and emit one block of tokens."""
    # token symbol histograms
    lit_freq = np.zeros(286, dtype=np.int64)
    dist_freq = np.zeros(30, dtype=np.int64)
    blk_len = 0
    for (ls, ll, ml, md) in ops:
        if ll:
            lit_freq[: 256] += np.bincount(
                np.frombuffer(src[ls : ls + ll], np.uint8), minlength=256
            )
        blk_len += ll + ml
        if ml:
            lit_freq[257 + int(H.length_code(ml))] += 1
            dist_freq[int(H.dist_code(md))] += 1
    lit_freq[256] = 1  # end-of-block

    dyn_lit = H.build_lengths(lit_freq, H.MAX_BITS)
    dyn_dist = H.build_lengths(dist_freq, H.MAX_BITS) if dist_freq.any() else np.zeros(30, np.int32)

    def token_bits(lit_l, dist_l):
        bits = int((lit_freq * lit_l[: len(lit_freq)]).sum())
        bits += int((dist_freq * dist_l[: len(dist_freq)]).sum())
        for (_, _, ml, md) in ops:
            if ml:
                bits += int(H._LEN_XBITS[int(H.length_code(ml))])
                bits += int(H._DIST_XBITS[int(H.dist_code(md))])
        return bits

    fixed_lit = H.fixed_lit_lengths()
    fixed_dist = H.fixed_dist_lengths()
    fixed_cost = 3 + token_bits(fixed_lit, fixed_dist)
    # dynamic header cost: measure by writing to a scratch writer
    scratch = H.BitWriterLSB()
    H.write_dynamic_header(scratch, dyn_lit, dyn_dist)
    dyn_cost = 3 + len(scratch.out) * 8 + scratch.n + token_bits(dyn_lit, dyn_dist)
    stored_cost = 3 + 16 + 16 + blk_len * 8 + 7  # + alignment worst case

    kind = force_kind
    if kind is None:
        kind = "dynamic"
        best = dyn_cost
        if fixed_cost < best:
            kind, best = "fixed", fixed_cost
        if stored_cost < best and blk_len <= 65535:
            kind = "stored"

    bw.add(1 if final else 0, 1)
    if kind == "stored":
        # ops cover a contiguous src range; stored blocks carry it raw
        start = ops[0][0]
        bw.add(0, 2)
        bw.align_byte()
        bw.add(blk_len, 16)
        bw.add((~blk_len) & 0xFFFF, 16)
        bw.out += src[start : start + blk_len]
        return
    if kind == "fixed":
        bw.add(1, 2)
        lit_l, dist_l = fixed_lit, fixed_dist
    else:
        bw.add(2, 2)
        H.write_dynamic_header(bw, dyn_lit, dyn_dist)
        lit_l, dist_l = dyn_lit, dyn_dist
    lit_c = H.canonical_codes_rfc1951(lit_l)
    dist_c = H.canonical_codes_rfc1951(dist_l)
    for (ls, ll, ml, md) in ops:
        for b in src[ls : ls + ll]:
            bw.add(int(lit_c[b]), int(lit_l[b]))
        if ml:
            lc = int(H.length_code(ml))
            bw.add(int(lit_c[257 + lc]), int(lit_l[257 + lc]))
            bw.add(ml - int(H._LEN_BASE[lc]), int(H._LEN_XBITS[lc]))
            dc = int(H.dist_code(md))
            bw.add(int(dist_c[dc]), int(dist_l[dc]))
            bw.add(md - int(H._DIST_BASE[dc]), int(H._DIST_XBITS[dc]))
    bw.add(int(lit_c[256]), int(lit_l[256]))  # end of block


BLOCK_TOKENS = 1 << 16  # input bytes per emitted block


def _native_deflate(data: bytes, level: int = 6):
    """The host core's per-level path (greedy 1-3, lazy 4-9); bytes, or
    None where the core refuses the call."""
    cap = len(data) + len(data) // 8 + 2048
    arr, dst = _native.out_buf(cap)
    r = _native.library().ct_deflate_level(data, len(data), dst, cap, level)
    return arr[:r].tobytes() if r >= 0 else None


def native_inflate(data: bytes, max_size: int):
    """The host core's inflate; bytes, or None (the caller re-runs the
    Python decoder, which gives the precise error or reads on).

    ct_inflate returns -1 for corrupt input (never retried) and -2 when the
    output buffer was too small (retried with a larger buffer up to
    max_size)."""
    lib = _native.library()
    cap = min(max_size, max(1 << 20, len(data) * 40))
    while True:
        arr, dst = _native.out_buf(cap)
        r = lib.ct_inflate(data + b"\x00" * 8, len(data), dst, cap)
        if r >= 0:
            return arr[:r].tobytes()
        if r == -2 and cap < max_size:
            cap = min(max_size, cap * 8)  # output-capacity fail: retry bigger
            continue
        return None


def deflate(data, level: int = DEFAULT_COMPRESSION, window: int = MAX_OFFSET) -> bytes:
    """Raw DEFLATE stream (no zlib/gzip wrapper)."""
    data = bytes(data)
    if 1 <= level <= 9 and window >= MAX_OFFSET and len(data) > 32:
        out = _native_deflate(data, level)
        if out is not None:
            return out
    return deflate_py(data, level, window)


def deflate_py(data, level: int = DEFAULT_COMPRESSION,
               window: int = MAX_OFFSET) -> bytes:
    """``deflate`` in Python alone (the reference's Python encoder)."""
    data = bytes(data)
    n = len(data)
    bw = H.BitWriterLSB()
    if n == 0:
        bw.add(1, 1)
        bw.add(1, 2)  # final fixed block with just EOB
        fl = H.fixed_lit_lengths()
        fc = H.canonical_codes_rfc1951(fl)
        bw.add(int(fc[256]), int(fl[256]))
        bw.align_byte()
        return bw.bytes()
    if level == NO_COMPRESSION:
        pos = 0
        while pos < n or pos == 0:
            take = min(n - pos, 65535)
            bw.add(1 if pos + take >= n else 0, 1)
            bw.add(0, 2)
            bw.align_byte()
            bw.add(take, 16)
            bw.add((~take) & 0xFFFF, 16)
            bw.out += data[pos : pos + take]
            pos += take
            if pos >= n:
                break
        bw.align_byte()
        return bw.bytes()
    window = min(window, MAX_OFFSET)
    if level == HUFFMAN_ONLY:
        all_ops = [(0, n, 0, 0)]
    else:
        all_ops = _tokens(data, level, window)
    # group ops into blocks of ~BLOCK_TOKENS input bytes
    blocks = []
    cur = []
    cur_len = 0
    for op in all_ops:
        cur.append(op)
        cur_len += op[1] + op[2]
        if cur_len >= BLOCK_TOKENS:
            blocks.append(cur)
            cur = []
            cur_len = 0
    if cur:
        blocks.append(cur)
    for i, ops in enumerate(blocks):
        _emit_block(bw, data, ops, final=(i == len(blocks) - 1))
    bw.align_byte()
    return bw.bytes()


def stateless_deflate(data, dictionary: bytes | None = None) -> bytes:
    """One-shot deflate with no retained state (reference: StatelessDeflate).

    The optional dictionary seeds back-references like the reference's
    version (matches may point into the dictionary)."""
    if dictionary:
        # encode with the dict prefix, then strip: simplest correct approach
        # is to forbid pre-dict emission by tokenizing the concatenation and
        # dropping ops that start inside the dictionary.
        dlen = len(dictionary)
        combined = bytes(dictionary) + bytes(data)
        ops = _tokens(combined, 5)
        ops2 = []
        for (ls, ll, ml, md) in ops:
            if ls + ll + ml <= dlen:
                continue
            if ls < dlen:  # trim the literal part overlapping the dict
                cut = dlen - ls
                ls, ll = dlen, ll - cut
            ops2.append((ls, ll, ml, md))
        bw = H.BitWriterLSB()
        # shift op source positions: keep src=combined, emit directly
        _emit_block(bw, combined, ops2 if ops2 else [(dlen, len(data), 0, 0)], True)
        bw.align_byte()
        return bw.bytes()
    return deflate(bytes(data), 5)


class Writer:
    """Streaming raw-DEFLATE writer with bounded memory (reference:
    flate.NewWriter, flate/deflate.go:894).

    write() accumulates ~1 MiB then encodes it as deflate blocks via the
    host core's continuation entry (levels 1-9), carrying the previous
    32 KiB as match window; each chunk ends with a sync-flush empty
    stored block (byte alignment), so chunks concatenate into one valid
    stream. flush()
    encodes buffered bytes immediately (Z_SYNC_FLUSH semantics); close()
    marks the stream final."""

    CHUNK = 1 << 20

    def __init__(self, dst, level: int = DEFAULT_COMPRESSION):
        self.dst = dst
        level = int(level)
        if level == -1:
            level = DEFAULT_COMPRESSION
        if not (level == HUFFMAN_ONLY or 0 <= level <= 9):
            raise ValueError(f"unsupported deflate level {level}")
        self.level = level
        self._buf = bytearray()
        self._tail = b""          # carried 32 KiB window
        self._closed = False
        self.n_input = 0

    def _encode(self, chunk: bytes, last: bool) -> bytes:
        if 1 <= self.level <= 9:
            seg = self._tail + chunk
            cap = len(chunk) + len(chunk) // 8 + 4096
            arr, dstb = _native.out_buf(cap)
            r = _native.library().ct_deflate_blocks(
                seg, len(seg), len(self._tail), dstb, cap, self.level,
                1 if last else 0)
            if r >= 0:
                self._tail = seg[-MAX_OFFSET:]
                return arr[:r].tobytes()
        return self._encode_py(chunk, last)

    def _encode_py(self, chunk: bytes, last: bool) -> bytes:
        # python path: token blocks per chunk (no cross-chunk window;
        # ratio dips slightly at boundaries) + sync-flush tail. Also
        # serves levels 0 (stored) and -2 (huffman-only).
        bw = H.BitWriterLSB()
        if chunk and self.level == NO_COMPRESSION:
            pos = 0
            while pos < len(chunk):
                take = min(len(chunk) - pos, 65535)
                bw.add(0, 1)
                bw.add(0, 2)
                bw.align_byte()
                bw.add(take, 16)
                bw.add((~take) & 0xFFFF, 16)
                bw.out += chunk[pos : pos + take]
                pos += take
            bw.add(1 if last else 0, 1)
            bw.add(0, 2)
            bw.align_byte()
            bw.out += b"\x00\x00\xff\xff"
            self._tail = (self._tail + chunk)[-MAX_OFFSET:]
            return bw.bytes()
        if chunk:
            ops = ([(0, len(chunk), 0, 0)] if self.level == HUFFMAN_ONLY
                   else _tokens(chunk, self.level, MAX_OFFSET))
            blocks, cur, cur_len = [], [], 0
            for op in ops:
                cur.append(op)
                cur_len += op[1] + op[2]
                if cur_len >= BLOCK_TOKENS:
                    blocks.append(cur)
                    cur, cur_len = [], 0
            if cur:
                blocks.append(cur)
            for opsb in blocks:
                _emit_block(bw, chunk, opsb, final=False)
        bw.add(1 if last else 0, 1)
        bw.add(0, 2)
        bw.align_byte()
        bw.out += b"\x00\x00\xff\xff"
        self._tail = (self._tail + chunk)[-MAX_OFFSET:]
        return bw.bytes()

    def write(self, data) -> int:
        if self._closed:
            raise ValueError("writer closed")
        data = bytes(data)
        self._buf += data
        self.n_input += len(data)
        while len(self._buf) >= self.CHUNK:
            chunk = bytes(self._buf[: self.CHUNK])
            del self._buf[: self.CHUNK]
            self.dst.write(self._encode(chunk, False))
        return len(data)

    def flush(self):
        if self._closed:
            raise ValueError("writer closed")
        if self._buf:
            chunk = bytes(self._buf)
            self._buf.clear()
            self.dst.write(self._encode(chunk, False))

    def close(self):
        if self._closed:
            return
        chunk = bytes(self._buf)
        self._buf.clear()
        self.dst.write(self._encode(chunk, True))
        self._closed = True


class WriterPy(Writer):
    """``Writer`` on the Python block path at every level (the plain
    version; no window carried across chunks)."""

    def _encode(self, chunk: bytes, last: bool) -> bytes:
        return self._encode_py(chunk, last)
