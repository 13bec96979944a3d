"""A numpy model of the CRC-32C kernel's design (``csrc/checksum.cu``,
``ct_crc32c_batch``) on the CPU, bit for bit (tolerance 0: integers).

The kernel cuts each row's first n bytes into 256 chunks of lc = max(1,
ceil(n / 256)) bytes aligned to the end, walks each chunk from state 0
with slicing-by-8 tables (a chunk's head bytes one at a time up to a
16-byte boundary of the row's address, then 16-byte words as two 8-byte
steps, then its tail bytes), multiplies chunk t's raw CRC by the host's
shift constant x^(8 lc (255 - t)) mod P (``checksum.crc_shifts``), XORs
the 256 products and applies the conditioning constant of n.  The model
does the same in numpy, with the kernel's table construction and lookup
order, and is held against ``crc32c_batch_ref`` (the plain version, which
joins the chunks by a tree instead), the host ``utils/crc.crc32c`` and the
JAX ``crc32c_batch`` at the lengths ``tests/test_torch_checksum.py`` runs
it at.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from compress_tpu.ops import checksum as jax_ck  # noqa: E402
from compress_tpu_torch.ops import checksum as ck  # noqa: E402
from compress_tpu_torch.utils import crc  # noqa: E402

NCHUNK = 256
POLY = 0x82F63B78


def _tables() -> np.ndarray:
    """The kernel's slicing-by-8 tables (``crc_tables`` in checksum.cu):
    t[0] the byte table, t[k][i] = (t[k-1][i] >> 8) ^ t[0][t[k-1][i] &
    255]."""
    t = np.zeros((8, 256), np.uint32)
    for i in range(256):
        c = i
        for _ in range(8):
            c = (c >> 1) ^ POLY if c & 1 else c >> 1
        t[0, i] = c
    for k in range(1, 8):
        t[k] = (t[k - 1] >> 8) ^ t[0][t[k - 1] & 255]
    return t


TAB = _tables()


def _step1(c, b):
    return TAB[0][(c ^ b) & 255] ^ (c >> 8)


def _step8(c, lo, hi):
    """``step8``: the CRC after 8 bytes given as two little-endian words,
    vectorized over chunks."""
    lo = lo ^ c
    return (TAB[7][lo & 255] ^ TAB[6][(lo >> 8) & 255]
            ^ TAB[5][(lo >> 16) & 255] ^ TAB[4][lo >> 24]
            ^ TAB[3][hi & 255] ^ TAB[2][(hi >> 8) & 255]
            ^ TAB[1][(hi >> 16) & 255] ^ TAB[0][hi >> 24])


def _mulmodp(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a * b mod P (reflected), elementwise over uint32 arrays: the
    kernel's bit-serial ``mulmodp``."""
    a = a.astype(np.uint64)
    b = b.astype(np.uint64)
    p = np.zeros_like(a)
    for k in range(31, -1, -1):
        p ^= np.where((a >> k) & 1 == 1, b, 0)
        b = np.where(b & 1 == 1, (b >> 1) ^ POLY, b >> 1)
    return p.astype(np.uint32)


def chunk_crcs(row: np.ndarray, n: int, phase: int = 0) -> np.ndarray:
    """Each thread's raw CRC of its chunk, walked as the kernel walks it
    for a row whose address is ``phase`` modulo 16."""
    lc = max(1, -(-n // NCHUNK))
    out = np.zeros(NCHUNK, np.uint32)
    for t in range(NCHUNK):
        e = n - (NCHUNK - 1 - t) * lc
        p = max(0, e - lc)
        a = min(e, p + (-(phase + p)) % 16)
        c = np.uint32(0)
        for q in range(p, a):
            c = _step1(c, row[q])
        nw = max(0, (e - a) // 16)
        if nw:
            words = row[a:a + 16 * nw].view("<u4").reshape(nw, 4)
            for w in words:
                c = _step8(_step8(c, w[0], w[1]), w[2], w[3])
        for q in range(a + 16 * nw, e):
            c = _step1(c, row[q])
        out[t] = c
    return out


def model_crc(row: np.ndarray, n: int, phase: int = 0) -> int:
    """The kernel's result: the XOR of the shifted chunk CRCs, then the
    conditioning constant of n."""
    shifts = np.array(ck.crc_shifts(n), np.uint32)
    raw = np.bitwise_xor.reduce(_mulmodp(chunk_crcs(row, n, phase), shifts))
    return int(raw) ^ ck._crc_consts(n)[2]


def test_tables_are_the_byte_table_and_its_zero_byte_shifts():
    """t[k][i] is byte i's CRC followed by k zero bytes: one slicing-by-8
    step of 8 bytes equals 8 byte steps."""
    rng = np.random.default_rng(0)
    for _ in range(64):
        b = rng.integers(0, 256, 8, dtype=np.uint8)
        c0 = np.uint32(rng.integers(0, 1 << 32))
        c = c0
        for x in b:
            c = _step1(c, x)
        w = b.view("<u4")
        assert _step8(c0, w[0], w[1]) == c
    assert [int(x) for x in TAB[0]] == ck._TABLE


def test_shift_constants_move_a_chunk_past_the_chunks_after_it():
    """Entry t is x^(8 lc (255 - t)): the last is 1 (bit 31), each the one
    after it times x^(8 lc), each equal to ``xpow8`` of its byte count."""
    for n in (0, 1, 257, 65536, 100000):
        lc = ck._crc_consts(n)[0]
        s = ck.crc_shifts(n)
        assert len(s) == NCHUNK and s[-1] == 1 << 31
        for t in (0, 1, 128, 254):
            assert s[t] == ck.xpow8(lc * (NCHUNK - 1 - t))


LENGTHS = [0, 1, 255, 256, 257, 256 * 3 - 1, 256 * 3 + 1, 256 * 40 - 1,
           256 * 40 + 1, 61439, 65536, 100000]


@pytest.mark.parametrize("n", LENGTHS)
def test_model_matches_plain_and_host(n):
    """The model's combine equals the plain version's tree and the host
    CRC, on random rows, a zeros row and a run row, at row addresses 0, 3
    and 8 modulo 16 (the head and tail splits of every chunk differ)."""
    rng = np.random.default_rng(n)
    rows = rng.integers(0, 256, (3, n + 5), dtype=np.uint8)
    rows[1] = 0
    rows[2, : n // 2] = 0xFF
    want = ck.crc32c_batch_ref(torch.from_numpy(rows), n).tolist()
    assert want == [crc.crc32c(r[:n].tobytes()) for r in rows]
    for phase in (0, 3, 8):
        assert [model_crc(r, n, phase) for r in rows] == want


@pytest.mark.parametrize("n", [512, 513, 1000, 4096, 65536, 100000])
def test_model_matches_jax(n):
    """The model equals the JAX ``crc32c_batch`` (GF(2) matrix products)
    at the lengths the checksum tests compare it at."""
    rows = np.random.default_rng(n + 1).integers(0, 256, (2, n),
                                                 dtype=np.uint8)
    want = np.asarray(jax_ck.crc32c_batch(rows)).astype(np.int64).tolist()
    assert [model_crc(r, n) for r in rows] == want


def test_chunks_cut_at_zero_are_leading_zeros():
    """Where 256 lc > n the first chunks start before byte 0; their bytes
    before 0 are leading zeros, which leave a raw CRC at 0: the model's
    chunks hold the bytes from 0 only, and a chunk wholly before 0 is 0."""
    n = 257                      # lc = 2: 512 bytes of chunks for 257
    row = np.random.default_rng(3).integers(0, 256, n, dtype=np.uint8)
    raw = chunk_crcs(row, n)
    assert (raw[:127] == 0).all()
    assert raw[127] == _step1(np.uint32(0), row[0])
