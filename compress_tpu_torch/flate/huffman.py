"""RFC 1951 Huffman machinery: canonical codes, fixed tables, dynamic
headers, and the LSB-first bit writer (a copy of the JAX package's
``flate/huffman.py``).

Code lengths come from package-merge (``huff0.table.package_merge_lengths``:
the host core for alphabets of at most 256 symbols, the Python version for
the 286-symbol literal/length alphabet, as in the JAX package).
"""

from __future__ import annotations

import numpy as np

from compress_tpu_torch.huff0.table import package_merge_lengths

MAX_BITS = 15
MAX_CODELEN_BITS = 7

# order of code-length-code lengths in the dynamic header (RFC 1951 §3.2.7)
CLEN_ORDER = [16, 17, 18, 0, 8, 7, 9, 6, 10, 5, 11, 4, 12, 3, 13, 2, 14, 1, 15]

# length codes 257..285: (base, extra_bits)
LENGTH_CODES = [
    (3, 0), (4, 0), (5, 0), (6, 0), (7, 0), (8, 0), (9, 0), (10, 0),
    (11, 1), (13, 1), (15, 1), (17, 1), (19, 2), (23, 2), (27, 2), (31, 2),
    (35, 3), (43, 3), (51, 3), (59, 3), (67, 4), (83, 4), (99, 4), (115, 4),
    (131, 5), (163, 5), (195, 5), (227, 5), (258, 0),
]
# distance codes 0..29: (base, extra_bits)
DIST_CODES = [
    (1, 0), (2, 0), (3, 0), (4, 0), (5, 1), (7, 1), (9, 2), (13, 2),
    (17, 3), (25, 3), (33, 4), (49, 4), (65, 5), (97, 5), (129, 6), (193, 6),
    (257, 7), (385, 7), (513, 8), (769, 8), (1025, 9), (1537, 9),
    (2049, 10), (3073, 10), (4097, 11), (6145, 11), (8193, 12), (12289, 12),
    (16385, 13), (24577, 13),
]

_LEN_BASE = np.array([b for b, _ in LENGTH_CODES], dtype=np.int64)
_LEN_XBITS = np.array([x for _, x in LENGTH_CODES], dtype=np.int64)
_DIST_BASE = np.array([b for b, _ in DIST_CODES], dtype=np.int64)
_DIST_XBITS = np.array([x for _, x in DIST_CODES], dtype=np.int64)


def length_code(length: np.ndarray) -> np.ndarray:
    """match length (3..258) -> code index 0..28 (add 257 for the symbol)."""
    return np.searchsorted(_LEN_BASE, np.asarray(length, np.int64), side="right") - 1


def dist_code(dist: np.ndarray) -> np.ndarray:
    return np.searchsorted(_DIST_BASE, np.asarray(dist, np.int64), side="right") - 1


def _rev_bits(code: int, n: int) -> int:
    r = 0
    for _ in range(n):
        r = (r << 1) | (code & 1)
        code >>= 1
    return r


def canonical_codes_rfc1951(lengths: np.ndarray) -> np.ndarray:
    """RFC 1951 canonical code values (bit-REVERSED, ready for LSB-first

    emission). lengths[i] == 0 means unused."""
    max_len = int(lengths.max()) if len(lengths) else 0
    bl_count = np.bincount(lengths[lengths > 0], minlength=max_len + 1)
    next_code = np.zeros(max_len + 2, dtype=np.int64)
    code = 0
    for bits in range(1, max_len + 1):
        code = (code + int(bl_count[bits - 1])) << 1
        next_code[bits] = code
    out = np.zeros(len(lengths), dtype=np.int64)
    for s in range(len(lengths)):
        l = int(lengths[s])
        if l:
            out[s] = _rev_bits(int(next_code[l]), l)
            next_code[l] += 1
    return out


def build_lengths(freqs: np.ndarray, limit: int) -> np.ndarray:
    """Optimal length-limited code lengths; single-symbol alphabets get 1."""
    nz = int((freqs > 0).sum())
    if nz == 0:
        return np.zeros(len(freqs), dtype=np.int32)
    return package_merge_lengths(freqs, limit)


def fixed_lit_lengths() -> np.ndarray:
    l = np.zeros(288, dtype=np.int32)
    l[0:144] = 8
    l[144:256] = 9
    l[256:280] = 7
    l[280:288] = 8
    return l


def fixed_dist_lengths() -> np.ndarray:
    return np.full(30, 5, dtype=np.int32)


class BitWriterLSB:
    """RFC 1951 bit writer: bits fill bytes LSB-first."""

    __slots__ = ("acc", "n", "out")

    def __init__(self):
        self.acc = 0
        self.n = 0
        self.out = bytearray()

    def add(self, v: int, nbits: int):
        self.acc |= (v & ((1 << nbits) - 1)) << self.n
        self.n += nbits
        while self.n >= 8:
            self.out.append(self.acc & 0xFF)
            self.acc >>= 8
            self.n -= 8

    def align_byte(self):
        if self.n:
            self.out.append(self.acc & 0xFF)
            self.acc = 0
            self.n = 0

    def bytes(self) -> bytes:
        return bytes(self.out)


def write_dynamic_header(bw: BitWriterLSB, lit_lengths: np.ndarray,
                         dist_lengths: np.ndarray):
    """HLIT/HDIST/HCLEN + RLE-coded code lengths (RFC 1951 §3.2.7)."""
    hlit = max(257, int(np.nonzero(lit_lengths)[0][-1]) + 1) if lit_lengths.any() else 257
    nz_d = np.nonzero(dist_lengths)[0]
    hdist = int(nz_d[-1]) + 1 if len(nz_d) else 1
    seq = np.concatenate([lit_lengths[:hlit], dist_lengths[:hdist]]).astype(np.int64)

    # RLE the length sequence into codegen symbols
    cg = []  # (symbol, extra_value)
    i = 0
    while i < len(seq):
        v = int(seq[i])
        run = 1
        while i + run < len(seq) and int(seq[i + run]) == v:
            run += 1
        if v == 0:
            r = run
            while r >= 11:
                take = min(r, 138)
                cg.append((18, take - 11))
                r -= take
            while r >= 3:
                take = min(r, 10)
                cg.append((17, take - 3))
                r -= take
            for _ in range(r):
                cg.append((0, 0))
        else:
            cg.append((v, 0))
            r = run - 1
            while r >= 3:
                take = min(r, 6)
                cg.append((16, take - 3))
                r -= take
            for _ in range(r):
                cg.append((v, 0))
        i += run

    cfreq = np.zeros(19, dtype=np.int64)
    for s, _ in cg:
        cfreq[s] += 1
    clen = build_lengths(cfreq, MAX_CODELEN_BITS)
    if int((cfreq > 0).sum()) == 1:
        clen = np.zeros(19, dtype=np.int32)
        clen[int(np.nonzero(cfreq)[0][0])] = 1
    ccodes = canonical_codes_rfc1951(clen)

    # HCLEN: trailing zeros in the magic order may be omitted (min 4 kept)
    order_lens = [int(clen[s]) for s in CLEN_ORDER]
    hclen = 19
    while hclen > 4 and order_lens[hclen - 1] == 0:
        hclen -= 1

    bw.add(hlit - 257, 5)
    bw.add(hdist - 1, 5)
    bw.add(hclen - 4, 4)
    for k in range(hclen):
        bw.add(order_lens[k], 3)
    for s, extra in cg:
        bw.add(int(ccodes[s]), int(clen[s]))
        if s == 16:
            bw.add(extra, 2)
        elif s == 17:
            bw.add(extra, 3)
        elif s == 18:
            bw.add(extra, 7)
    return hlit, hdist
