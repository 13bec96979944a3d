"""CRC-32C (Castagnoli) and the snappy framing checksum, as the JAX
package's ``utils/crc.py`` computes them: ``crc32c`` runs the host core's
``ct_crc32c`` (SSE4.2 CRC32 instruction); ``crc32c_py``, a copy of the
reference's slicing-by-16 tables, is its plain version."""

from __future__ import annotations

import numpy as np

from compress_tpu_torch import _native

_CASTAGNOLI_POLY = 0x82F63B78  # reflected


def _make_tables(poly: int, n: int = 16) -> list:
    t = np.zeros((n, 256), dtype=np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ (poly if (c & 1) else 0)
        t[0, i] = c
    for k in range(1, n):
        t[k] = t[0][(t[k - 1] & 0xFF).astype(np.int64)] ^ (t[k - 1]
                                                           >> np.uint32(8))
    return t.tolist()


_TBL = _make_tables(_CASTAGNOLI_POLY)


def crc32c(data, crc: int = 0) -> int:
    """CRC-32C of data, continuing from ``crc`` (host core)."""
    buf = bytes(data)
    return _native.library().ct_crc32c(buf, len(buf), crc & 0xFFFFFFFF)


def crc32c_py(data, crc: int = 0) -> int:
    """CRC-32C of data, continuing from ``crc`` (slicing-by-16 in Python)."""
    buf = bytes(data)
    crc = (crc ^ 0xFFFFFFFF) & 0xFFFFFFFF
    t = _TBL
    nfast = len(buf) - len(buf) % 16
    for i in range(0, nfast, 16):
        b = buf[i:i + 16]
        b0 = int.from_bytes(b[:4], "little") ^ crc
        crc = (t[15][b0 & 0xFF] ^ t[14][(b0 >> 8) & 0xFF]
               ^ t[13][(b0 >> 16) & 0xFF] ^ t[12][b0 >> 24]
               ^ t[11][b[4]] ^ t[10][b[5]] ^ t[9][b[6]] ^ t[8][b[7]]
               ^ t[7][b[8]] ^ t[6][b[9]] ^ t[5][b[10]] ^ t[4][b[11]]
               ^ t[3][b[12]] ^ t[2][b[13]] ^ t[1][b[14]] ^ t[0][b[15]])
    t0 = t[0]
    for x in buf[nfast:]:
        crc = t0[(crc ^ x) & 0xFF] ^ (crc >> 8)
    return crc ^ 0xFFFFFFFF


def crc32c_masked(data) -> int:
    """The snappy framing-format checksum: masked CRC-32C."""
    c = crc32c(data)
    return ((((c >> 15) | ((c << 17) & 0xFFFFFFFF)) + 0xA282EAD8)
            & 0xFFFFFFFF)
