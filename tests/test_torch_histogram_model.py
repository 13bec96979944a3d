"""A numpy model of the histogram kernel's design (``csrc/histogram.cu``)
on the CPU, held against the plain versions bit for bit (tolerance 0:
integers).

The model does what the kernel does, step for step:

- per-row entry: a CTA of 256 threads (8 warps) a row; the head bytes up
  to the row's first 16-byte boundary and the tail bytes after its last
  whole 16-byte word are counted one a thread; warp w, lane l takes the
  16-byte words c0 + 32 u + l (u < 4) for c0 = 128 w + 1024 k;
- whole-input entry: a grid of min(ceil(words / 1024), SMs x CTAs an SM)
  CTAs, CTA b's warp w taking words c0 + 32 u + l for c0 = (8 b + w) 128
  + 1024 grid k; the head and tail elements on CTA 0;
- a lane makes one atomic a value (a masked-out byte or a value outside
  0..255 makes none) into its warp's 256 counters; the counters of the 8
  warps are summed once a CTA, and the whole-input CTAs' sums added into
  the result.

It checks that every byte is counted once and by the warp the kernel
gives it, on every ``corpus.py`` class, 64 KiB zeros rows (65,536 in one
bin), misaligned row starts, masks, and every dtype the whole-input entry
reads, on grids that loop over the input.
"""

import numpy as np
import pytest
import torch

from compress_tpu_torch import corpus
from compress_tpu_torch.utils import histogram as H

THREADS, WARPS, UNROLL = 256, 8, 4
NONE = 256


def row_partition(L: int, phase: int):
    """(head bytes, whole 16-byte words, first tail byte) of a row whose
    address is ``phase`` modulo 16."""
    head = min(L, (16 - phase) % 16)
    nw = (L - head) // 16
    return head, nw, head + 16 * nw


def word_owner(c: np.ndarray):
    """(warp, lane) of a row's words c: word c0 + 32 u + lane of warp w
    for c0 = 128 w + 1024 k."""
    r = c % (THREADS * UNROLL)
    return r // (32 * UNROLL), c % 32


def model_rows(rows: np.ndarray, mask=None, phase: int = 0):
    """The per-row kernel's counts (N, 256) for rows that all sit at
    ``phase`` modulo 16, and each warp's share of the counted bytes
    (N, 8)."""
    N, L = rows.shape
    head, nw, tail = row_partition(L, phase)
    out = np.zeros((N, 256), np.int64)
    shares = np.zeros((N, WARPS), np.int64)
    for r in range(N):
        v = rows[r].astype(np.int64)
        if mask is not None:
            v = np.where(mask[r], v, NONE)
        counters = np.zeros((WARPS, 257), np.int64)
        seen = np.zeros(L, np.int64)
        for i in list(range(head)) + list(range(tail, L)):
            counters[0, v[i]] += 1           # warp 0: one byte a thread
            seen[i] += 1
        if nw:
            words = v[head:tail].reshape(nw, 16)
            warp, _ = word_owner(np.arange(nw))
            for c in range(nw):
                np.add.at(counters[warp[c]], words[c], 1)
            seen[head:tail] += 1
        assert (seen == 1).all()
        out[r] = counters[:, :256].sum(axis=0)
        shares[r] = counters[:, :256].sum(axis=1)
    return out, shares


def model_whole(x: np.ndarray, phase: int, sms: int = 132,
                per_sm: int = 6) -> np.ndarray:
    """The whole-input kernel's (256,) counts of x (flattened, at an
    address ``phase`` modulo 16), value by value as the kernel reads
    them."""
    x = x.reshape(-1)
    size = x.itemsize
    V = 16 // size
    n = x.size
    head = min(n, ((16 - phase) % 16) // size)
    nw = (n - head) // V
    tail = head + nw * V
    need = -(-(nw * V * size // 16) // (THREADS * UNROLL))
    grid = max(1, min(need, sms * per_sm))
    vals = x.astype(np.int64)
    vals = np.where((vals >= 0) & (vals < 256), vals, NONE)
    total = np.zeros(257, np.int64)
    seen = np.zeros(n, np.int64)
    for i in list(range(head)) + list(range(tail, n)):   # CTA 0
        total[vals[i]] += 1
        seen[i] += 1
    step = grid * THREADS * UNROLL
    for b in range(grid):
        cta = np.zeros(257, np.int64)
        for w in range(WARPS):
            for c0 in range((b * WARPS + w) * 32 * UNROLL, nw, step):
                for u in range(UNROLL):
                    c = np.arange(c0 + 32 * u, min(c0 + 32 * u + 32, nw))
                    if not c.size:
                        continue
                    idx = head + (c[:, None] * V + np.arange(V)).reshape(-1)
                    np.add.at(cta, vals[idx], 1)
                    np.add.at(seen, idx, 1)
        total += cta
    assert (seen == 1).all()
    return total[:256]


@pytest.mark.parametrize("phase", [0, 1, 7, 15])
@pytest.mark.parametrize("L", [0, 1, 2, 15, 16, 17, 1000, 16383, 16384])
def test_row_partition_counts_every_byte_once(L, phase):
    rows = np.random.default_rng(L + phase).integers(0, 256, (3, L),
                                                     dtype=np.uint8)
    got, _ = model_rows(rows, phase=phase)
    np.testing.assert_array_equal(got, H.byte_histograms_ref(
        torch.from_numpy(rows)).numpy())


@pytest.mark.parametrize("cls", corpus.CLASSES)
def test_model_on_every_corpus_class(cls):
    """A 64 KiB block of each class as 4 rows of 16 KiB, unmasked and
    under a random mask, at a misaligned start."""
    rows = corpus.make_block(cls, np.random.default_rng(1)).reshape(
        4, -1).copy()
    mask = np.random.default_rng(2).random(rows.shape) < 0.7
    for m, phase in ((None, 0), (mask, 5)):
        got, _ = model_rows(rows, m, phase)
        want = H.byte_histograms_ref(torch.from_numpy(rows), None if m is None
                                     else torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got, want)


def test_model_on_64_kib_zeros_rows():
    """65,536 in one bin: the counters are int32 and a row's count never
    leaves its CTA's eight warps (8,192 a warp)."""
    rows = np.zeros((2, 1 << 16), np.uint8)
    rows[1, ::2] = 255
    got, _ = model_rows(rows, phase=3)
    assert got[0, 0] == 1 << 16 and got[1, 0] == got[1, 255] == 1 << 15


def test_warps_share_a_16_kib_row_evenly():
    """At 16 KiB a row is one pass of the CTA: each warp counts 128 whole
    words (2,048 bytes); in a row 9 bytes past a 16-byte boundary warp 0
    also counts the 7 head and 9 tail bytes and warp 7 one word less."""
    rows = np.full((1, 16384), 7, np.uint8)
    _, shares = model_rows(rows)
    assert shares.tolist() == [[2048] * WARPS]
    _, shares = model_rows(rows, phase=9)
    assert shares[0].tolist() == [2048 + 16] + [2048] * 6 + [2048 - 16]


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int16, np.int32,
                                   np.int64])
@pytest.mark.parametrize("phase_elems", [0, 1, 3])
def test_whole_input_partition_and_values(dtype, phase_elems):
    """Every element counted once across the grid-strided CTAs, the head
    and the tail; values outside 0..255 not counted; small grids (2 SMs)
    that loop over the input."""
    info = np.iinfo(dtype)
    rng = np.random.default_rng(info.bits)
    x = rng.integers(max(info.min, -300), min(info.max, 300) + 1,
                     20000 + 7).astype(dtype)
    x[:5000] = 0
    size = np.dtype(dtype).itemsize
    for sms in (132, 2):
        got = model_whole(x, (phase_elems * size) % 16, sms=sms)
        want = H.histogram256_torch_ref(torch.from_numpy(x)).numpy()
        np.testing.assert_array_equal(got, want)


def test_whole_input_empty_and_short():
    for n in (0, 1, 15, 16, 17):
        x = np.full(n, 9, np.uint8)
        assert model_whole(x, 7)[9] == n
