"""xxHash64 (the zstd frame content checksum keeps its low 32 bits), as
the JAX package's ``utils/xxhash64.py`` computes it: ``xxh64`` runs the
host core's ``ct_xxh64``; ``xxh64_py``, a copy of the reference's Python
rounds, is its plain version.  The streaming digest ``Xxh64`` (the zstd
stream Writer's frame checksum) holds the host core's state
(``ct_xxh64_new`` / ``update`` / ``digest`` / ``free``); ``Xxh64Py``,
the reference's Python accumulators, is its plain version."""

from __future__ import annotations

from compress_tpu_torch import _native

_P1 = 0x9E3779B185EBCA87
_P2 = 0xC2B2AE3D27D4EB4F
_P3 = 0x165667B19E3779F9
_P4 = 0x85EBCA77C2B2AE63
_P5 = 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, inp: int) -> int:
    acc = (acc + inp * _P2) & _M64
    return (_rotl(acc, 31) * _P1) & _M64


def _merge_round(acc: int, val: int) -> int:
    acc ^= _round(0, val)
    return (acc * _P1 + _P4) & _M64


def xxh64(data, seed: int = 0) -> int:
    """xxHash64 digest of data (bytes-like; host core)."""
    b = bytes(data)
    return _native.library().ct_xxh64(b, len(b), seed & _M64)


def xxh64_py(data, seed: int = 0) -> int:
    """xxHash64 digest of data (bytes-like; Python rounds)."""
    data = bytes(data)
    n = len(data)
    if n >= 32:
        v1 = (seed + _P1 + _P2) & _M64
        v2 = (seed + _P2) & _M64
        v3 = seed & _M64
        v4 = (seed - _P1) & _M64
        i = 0
        limit = n - 32
        while i <= limit:
            v1 = _round(v1, int.from_bytes(data[i : i + 8], "little"))
            v2 = _round(v2, int.from_bytes(data[i + 8 : i + 16], "little"))
            v3 = _round(v3, int.from_bytes(data[i + 16 : i + 24], "little"))
            v4 = _round(v4, int.from_bytes(data[i + 24 : i + 32], "little"))
            i += 32
        h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12) + _rotl(v4, 18)) & _M64
        h = _merge_round(h, v1)
        h = _merge_round(h, v2)
        h = _merge_round(h, v3)
        h = _merge_round(h, v4)
    else:
        h = (seed + _P5) & _M64
        i = 0
    h = (h + n) & _M64
    while i + 8 <= n:
        k1 = _round(0, int.from_bytes(data[i : i + 8], "little"))
        h ^= k1
        h = (_rotl(h, 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        h ^= (int.from_bytes(data[i : i + 4], "little") * _P1) & _M64
        h = (_rotl(h, 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        h ^= (data[i] * _P5) & _M64
        h = (_rotl(h, 11) * _P1) & _M64
        i += 1
    h ^= h >> 33
    h = (h * _P2) & _M64
    h ^= h >> 29
    h = (h * _P3) & _M64
    h ^= h >> 32
    return h


class Xxh64:
    """Streaming xxHash64 (reference: xxhash.Digest Write/Sum64) in O(1)
    memory, on the host core's state; freed in ``__del__``."""

    def __init__(self, seed: int = 0):
        self._lib = _native.library()
        self._st = self._lib.ct_xxh64_new(seed & _M64)

    def update(self, data) -> None:
        b = bytes(data)
        self._lib.ct_xxh64_update(self._st, b, len(b))

    def digest(self) -> int:
        return self._lib.ct_xxh64_digest(self._st)

    def __del__(self):
        st, self._st = getattr(self, "_st", None), None
        if st:
            self._lib.ct_xxh64_free(st)


class Xxh64Py:
    """``Xxh64`` in Python: four accumulators and a carry of at most 31
    bytes."""

    def __init__(self, seed: int = 0):
        self._seed = seed
        self._v = [(seed + _P1 + _P2) & _M64, (seed + _P2) & _M64,
                   seed & _M64, (seed - _P1) & _M64]
        self._carry = b""
        self._total = 0

    def update(self, data) -> None:
        b = bytes(data)
        self._total += len(b)
        b = self._carry + b
        v1, v2, v3, v4 = self._v
        i = 0
        while i + 32 <= len(b):
            v1 = _round(v1, int.from_bytes(b[i:i + 8], "little"))
            v2 = _round(v2, int.from_bytes(b[i + 8:i + 16], "little"))
            v3 = _round(v3, int.from_bytes(b[i + 16:i + 24], "little"))
            v4 = _round(v4, int.from_bytes(b[i + 24:i + 32], "little"))
            i += 32
        self._v = [v1, v2, v3, v4]
        self._carry = b[i:]

    def digest(self) -> int:
        n = self._total
        tail = self._carry
        if n >= 32:
            v1, v2, v3, v4 = self._v
            h = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
                 + _rotl(v4, 18)) & _M64
            h = _merge_round(h, v1)
            h = _merge_round(h, v2)
            h = _merge_round(h, v3)
            h = _merge_round(h, v4)
        else:
            h = (self._seed + _P5) & _M64
        h = (h + n) & _M64
        i = 0
        while i + 8 <= len(tail):
            h ^= _round(0, int.from_bytes(tail[i:i + 8], "little"))
            h = (_rotl(h, 27) * _P1 + _P4) & _M64
            i += 8
        if i + 4 <= len(tail):
            h ^= (int.from_bytes(tail[i:i + 4], "little") * _P1) & _M64
            h = (_rotl(h, 23) * _P2 + _P3) & _M64
            i += 4
        while i < len(tail):
            h ^= (tail[i] * _P5) & _M64
            h = (_rotl(h, 11) * _P1) & _M64
            i += 1
        h ^= h >> 33
        h = (h * _P2) & _M64
        h ^= h >> 29
        h = (h * _P3) & _M64
        h ^= h >> 32
        return h
