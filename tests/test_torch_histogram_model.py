"""A numpy model of the histogram kernel's design (``csrc/histogram.cu``)
on the CPU, held against the plain versions and the JAX package's
``histogram256_jax`` bit for bit (tolerance 0: integers).

The model does what the kernel does, step for step:

- per-row entry: a CTA of T threads a row, T from ``row_threads``: 128
  where the batch fits the CTAs the card holds at once (132 SMs times 6)
  and a CTA has two iterations of words, else 64;
  in iteration k warp w, lane l takes the row's 16-byte words
  k 4T + 128 w + 32 u + l (u < 4); the head bytes up to the row's first
  16-byte boundary and the tail bytes after its last whole word go to
  the totals, one a thread;
- whole-input entry: a grid of min(ceil(words / 1024), 132 x 3) CTAs of
  256 threads, CTA b's warp w taking in iteration k the words
  (k grid + b) 1024 + 128 w + 32 u + l; the head and tail elements to CTA
  0's totals;
- a thread counts into 256 counters of its own, 8 bits wide: bin b in
  byte b & 3 of shared word (b >> 2) T + tid (here a uint8 array, so a
  counter that overflowed would wrap as on the card);
- a pass is ``pass_iters(V)`` iterations (256 values a thread), whose
  first value (value 0 of the thread's word u = 0) goes to the totals, so
  that a counter holds at most 255; between passes the counters are
  merged and zeroed;
- the merge: thread t reads the 64 counter words from 64 t (bins
  4g..4g+3 of 64 threads, g = 64 t / T) 16 bytes at a time, rotated by
  lane, as two 16-bit pairs (bytes 0 and 2, bytes 1 and 3), into the
  totals; the whole input's CTAs add their totals into the result.

It checks that every byte is counted once and by the thread the kernel
gives it, that the lanes of a warp never meet on a bank, that no counter
passes 255 in a pass (and that without the diverted value a counter
would wrap), on every ``corpus.py`` class, rows of 16 KiB and 64 KiB of
one value, rows whose thread 0 reads 255, 256 and 257 equal bytes,
misaligned row starts, random and prefix masks, every layout, and every
dtype the whole-input entry reads, on grids that loop over the input.
"""

import numpy as np
import pytest
import torch

from compress_tpu_torch import corpus
from compress_tpu_torch.utils import histogram as H

UNROLL, SMS, NONE = 4, 132, 256
CTAS = {64: 12, 128: 6, 256: 3}   # CTAs an SM of each layout


def pass_iters(V: int) -> int:
    """Iterations of UNROLL words a pass, for V values a 16-byte word."""
    return 256 // (UNROLL * V)


def row_threads(N: int, L: int) -> int:
    """The kernel's threads a row for N rows of L bytes."""
    return 128 if N <= SMS * CTAS[128] and L // 16 >= 2 * 128 * UNROLL \
        else 64


def row_partition(L: int, phase: int):
    """(head bytes, whole 16-byte words, first tail byte) of a row whose
    address is ``phase`` modulo 16."""
    head = min(L, (16 - phase) % 16)
    nw = (L - head) // 16
    return head, nw, head + 16 * nw


def word_owner(c: np.ndarray, T: int):
    """(thread, iteration, whether it is the thread's word u = 0) of a
    row's words c on a CTA of T threads."""
    g, q = np.divmod(c, T * UNROLL)
    return (q // (32 * UNROLL)) * 32 + q % 32, g, q % (32 * UNROLL) < 32


def counter_index(tid, b, T: int):
    """The byte of shared memory that holds thread tid's counter of bin b."""
    return ((b >> 2) * T + tid) * 4 + (b & 3)


class Counters:
    """A CTA's counters and totals, and what a pass counted."""

    def __init__(self, T: int):
        self.T = T
        self.mem = np.zeros(64 * T * 4, np.uint8)
        self.tot = np.zeros(256, np.int64)
        self.in_pass = np.zeros(T, np.int64)
        self.most = 0        # the most values a thread counted in a pass
        self.merges = 0

    def bump(self, tid: np.ndarray, b: np.ndarray) -> None:
        """Thread tid[i] counts value b[i] (NONE: not counted)."""
        on = b != NONE
        np.add.at(self.mem, counter_index(tid[on], b[on], self.T), 1)  # wraps
        np.add.at(self.in_pass, tid[on], 1)

    def divert(self, b: np.ndarray) -> None:
        """Values b (NONE: not counted) added to the totals directly."""
        np.add.at(self.tot, b[b != NONE], 1)

    def merge(self, zero: bool) -> None:
        T = self.T
        words = self.mem.view("<u4").astype(np.int64)   # word g T + tid
        t = np.arange(T)
        # thread t's 16 loads of 4 words from 64 t, rotated by lane
        j = (np.arange(16)[None, :] + t[:, None] % 32) & 15
        idx = 64 * t[:, None, None] + 4 * j[:, :, None] + np.arange(4)
        read = np.zeros(words.shape, np.int64)
        np.add.at(read, idx, 1)
        assert (read == 1).all()
        w = words[idx]
        lo = (w & 0x00FF00FF).sum(axis=(1, 2))   # bytes 0 and 2
        hi = ((w >> 8) & 0x00FF00FF).sum(axis=(1, 2))   # bytes 1 and 3
        g = 64 * t // T
        for k, v in enumerate((lo & 0xFFFF, hi & 0xFFFF, lo >> 16, hi >> 16)):
            assert (v < 1 << 16).all()
            np.add.at(self.tot, 4 * g + k, v)
        self.most = max(self.most, int(self.in_pass.max()))
        self.in_pass[:] = 0
        self.merges += 1
        if zero:
            self.mem[:] = 0


def _sweep(counters: Counters, iters: int, words_of, P: int,
           divert: bool = True) -> None:
    """Count iterations 0..iters-1 (words_of(k): (thread, values, first
    value of the thread's word u = 0) arrays), the first value of each
    pass's first iteration into the totals (unless not ``divert``),
    merging and zeroing after every P-th iteration but the last."""
    for k in range(iters):
        tid, vals, lead = words_of(k)
        if divert and k % P == 0:
            counters.divert(vals[lead])
            vals = np.where(lead, NONE, vals)
        counters.bump(tid, vals)
        if (k + 1) % P == 0 and k + 1 < iters:
            counters.merge(zero=True)
    counters.merge(zero=False)


def model_rows(rows: np.ndarray, mask=None, phase: int = 0, T=None,
               P=None, divert: bool = True):
    """The per-row kernel's counts (N, 256) for rows that all sit at
    ``phase`` modulo 16, each warp's share of the bytes read (N, T / 32),
    the most values a thread counted in a pass and the merges a CTA.  T:
    the threads a row (default the kernel's); P, divert: the pass (default
    the kernel's)."""
    P = pass_iters(16) if P is None else P
    N, L = rows.shape
    T = row_threads(N, L) if T is None else T
    head, nw, tail = row_partition(L, phase)
    tid_of, g_of, lead_of = word_owner(np.arange(nw), T)
    iters = -(-nw // (T * UNROLL))
    out = np.zeros((N, 256), np.int64)
    shares = np.zeros((N, T // 32), np.int64)
    most = merges = 0
    for r in range(N):
        v = rows[r].astype(np.int64)
        if mask is not None:
            v = np.where(mask[r], v, NONE)
        seen = np.zeros(L, np.int64)
        c = Counters(T)
        # the head and tail bytes, one a thread
        edge = np.array(list(range(head)) + list(range(tail, L)), np.int64)
        c.divert(v[edge])
        seen[edge] += 1
        tid = np.concatenate([np.arange(head), np.arange(L - tail)])
        np.add.at(shares[r], tid[v[edge] != NONE] // 32, 1)

        def words_of(k):
            cs = np.nonzero(g_of == k)[0]
            idx = head + (cs[:, None] * 16 + np.arange(16)).reshape(-1)
            seen[idx] += 1
            tid = np.repeat(tid_of[cs], 16)
            vals = v[idx]
            lead = np.zeros((len(cs), 16), bool)
            lead[:, 0] = lead_of[cs]
            np.add.at(shares[r], tid[vals != NONE] // 32, 1)
            return tid, vals, lead.reshape(-1)

        _sweep(c, iters, words_of, P, divert)
        assert (seen == 1).all()
        out[r] = c.tot
        most, merges = max(most, c.most), max(merges, c.merges)
    return out, shares, most, merges


def model_whole(x: np.ndarray, phase: int, sms: int = SMS,
                per_sm: int = CTAS[256]) -> np.ndarray:
    """The whole-input kernel's (256,) counts of x (flattened, at an
    address ``phase`` modulo 16), value by value as the kernel reads
    them."""
    T = 256
    x = x.reshape(-1)
    size = x.itemsize
    V = 16 // size
    n = x.size
    head = min(n, ((16 - phase) % 16) // size)
    nw = (n - head) // V
    tail = head + nw * V
    per = T * UNROLL
    grid = max(1, min(-(-(n * size // 16) // per), sms * per_sm))
    vals = x.astype(np.int64)
    vals = np.where((vals >= 0) & (vals < 256), vals, NONE)
    total = np.zeros(256, np.int64)
    seen = np.zeros(n, np.int64)
    for b in range(grid):
        c = Counters(T)
        if b == 0:   # the head and tail elements, one a thread
            edge = np.array(list(range(head)) + list(range(tail, n)),
                            np.int64)
            c.divert(vals[edge])
            seen[edge] += 1
        first, step = b * per, grid * per
        iters = -(-(nw - first) // step) if first < nw else 0

        def words_of(k, first=first, step=step):
            cs = np.arange(first + k * step, min(first + k * step + per, nw))
            r = cs - first - k * step
            tid = (r // (32 * UNROLL)) * 32 + r % 32
            idx = head + (cs[:, None] * V + np.arange(V)).reshape(-1)
            np.add.at(seen, idx, 1)
            lead = np.zeros((len(cs), V), bool)
            lead[:, 0] = r % (32 * UNROLL) < 32
            return np.repeat(tid, V), vals[idx], lead.reshape(-1)

        _sweep(c, iters, words_of, pass_iters(V))
        assert c.most <= 255
        total += c.tot
    assert (seen == 1).all()
    return total


def _jax_hist(rows: np.ndarray) -> np.ndarray:
    from compress_tpu.utils import histogram as jax_hist
    return np.stack([np.asarray(jax_hist.histogram256_jax(r)) for r in rows])


@pytest.mark.parametrize("phase", [0, 1, 7, 15])
@pytest.mark.parametrize("L", [0, 1, 2, 15, 16, 17, 1000, 16383, 16384])
def test_row_partition_counts_every_byte_once(L, phase):
    rows = np.random.default_rng(L + phase).integers(0, 256, (3, L),
                                                     dtype=np.uint8)
    got, _, most, _ = model_rows(rows, phase=phase)
    assert most <= 255
    np.testing.assert_array_equal(got, H.byte_histograms_ref(
        torch.from_numpy(rows)).numpy())


@pytest.mark.parametrize("cls", corpus.CLASSES)
def test_model_on_every_corpus_class(cls):
    """A 64 KiB block of each class as 4 rows of 16 KiB, unmasked (also
    against ``histogram256_jax`` row by row) and under a random mask, at a
    misaligned start."""
    rows = corpus.make_block(cls, np.random.default_rng(1)).reshape(
        4, -1).copy()
    mask = np.random.default_rng(2).random(rows.shape) < 0.7
    for m, phase in ((None, 0), (mask, 5)):
        got, _, _, _ = model_rows(rows, m, phase)
        want = H.byte_histograms_ref(torch.from_numpy(rows), None if m is None
                                     else torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(model_rows(rows)[0], _jax_hist(rows))


def test_model_on_64_kib_zeros_rows():
    """65,536 in one bin: a 64 KiB row on 64 threads is 16 iterations, 4
    passes of 255 values a thread in its counters (3 merges that zero
    them, then the last), on 128 threads (the kernel's for 2 rows) 8
    iterations, 2 passes; the totals are 32-bit."""
    rows = np.zeros((2, 1 << 16), np.uint8)
    rows[1, ::2] = 255
    assert row_threads(2, 1 << 16) == 128
    for T, merges_a_cta in ((64, 4), (None, 2)):
        got, _, most, merges = model_rows(rows, phase=3, T=T)
        assert got[0, 0] == 1 << 16 and got[1, 0] == got[1, 255] == 1 << 15
        assert most == 255 and merges == merges_a_cta


def test_warps_share_a_16_kib_row_evenly():
    """At 16 KiB a row on 64 threads (the kernel's for 1024 rows) is four
    iterations, one pass: each of the 2 warps reads 512 whole words (8,192
    bytes); on 128 threads (the kernel's for one row) two iterations, 256
    words a warp.  In a row 9 bytes past a 16-byte boundary warp 0 also
    reads the 7 head and 9 tail bytes and the last warp one word less."""
    rows = np.full((1, 16384), 7, np.uint8)
    assert row_threads(1024, 16384) == 64 and row_threads(1, 16384) == 128
    for T, share in ((64, 8192), (None, 4096)):
        _, shares, _, merges = model_rows(rows, T=T)
        warps = len(shares[0])
        assert shares.tolist() == [[share] * warps] and merges == 1
        _, shares, _, _ = model_rows(rows, phase=9, T=T)
        assert shares[0].tolist() == ([share + 16] + [share] * (warps - 2)
                                      + [share - 16])


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


def test_counter_layout_meets_no_bank_twice():
    """The 32 lanes of a warp count into 32 banks whatever bytes they
    read (bin b's counter of lane l is in bank l), and the merge's 16-byte
    reads, eight lanes at a time, meet each 16-byte slot of a 128-byte
    row of banks once."""
    rng = np.random.default_rng(3)
    for T in CTAS:
        for w in range(T // 32):
            tid = w * 32 + np.arange(32)
            for _ in range(64):
                b = rng.integers(0, 256, 32)
                banks = counter_index(tid, b, T) // 4 % 32
                assert sorted(banks) == list(range(32))
        for t0 in range(0, T, 8):
            for i in range(16):
                t = np.arange(t0, t0 + 8)
                word = 64 * t + 4 * ((i + t % 32) & 15)
                assert sorted(word // 4 % 8) == list(range(8))


@pytest.mark.parametrize("V", [16, 8, 4, 2])
def test_pass_is_the_most_an_8_bit_counter_holds(V):
    """A pass of pass_iters(V) iterations reads 256 values a thread, one
    of which goes to the totals: 255 in its counters, and one iteration
    more could pass 255."""
    P = pass_iters(V)
    assert P * UNROLL * V - 1 == 255 < (P + 1) * UNROLL * V - 1
    assert {16: 4, 8: 8, 4: 16, 2: 32}[V] == P


@pytest.mark.parametrize("n", [255, 256, 257])
def test_one_thread_counts_255_256_257_equal_bytes(n):
    """A 64 KiB row whose thread 0 of 64 (the kernel's layout for a batch
    of 1024 such rows) reads n bytes of 7 first (``corpus
    .hist_thread_row``; 256 are its whole first pass): right, with no
    counter past 255 in a pass, on 64 threads and on the kernel's 128 for
    the row alone; without the pass's first byte sent to the totals
    thread 0's counter wraps from 256 on."""
    row = corpus.hist_thread_row(n)[None, :]
    want = H.byte_histograms_ref(torch.from_numpy(row)).numpy()
    assert want[0, 7] == n and row_threads(1024, row.shape[1]) == 64
    for T in (64, None):
        got, _, most, _ = model_rows(row, T=T)
        np.testing.assert_array_equal(got, want)
        assert most <= 255
    got, _, most, merges = model_rows(row, T=64, divert=False)
    assert merges == 4 and most == 256   # every thread's 16 words a pass
    assert (got[0, 7] == n) == (n < 256)


@pytest.mark.parametrize("T", [64, None])
@pytest.mark.parametrize("L", [16384, 65536])
@pytest.mark.parametrize("phase", [0, 3])
def test_single_value_rows(L, phase, T):
    """Rows of one value (0, 7, 255) of 16 KiB and 64 KiB, unmasked and
    under a prefix mask, on 64 threads and on the kernel's layout for 3
    rows, against the plain version and ``histogram256_jax``."""
    rows = np.stack([np.full(L, v, np.uint8) for v in (0, 7, 255)])
    got, _, most, _ = model_rows(rows, phase=phase, T=T)
    assert most <= 255
    np.testing.assert_array_equal(got, _jax_hist(rows))
    assert got[0, 0] == L
    cut = np.array([[L], [L - 1], [L // 2 + 5]])
    m = np.arange(L)[None, :] < cut
    got, _, _, _ = model_rows(rows, m, phase, T=T)
    np.testing.assert_array_equal(got, H.byte_histograms_ref(
        torch.from_numpy(rows), torch.from_numpy(m)).numpy())


@pytest.mark.parametrize("kind", ["random", "prefix"])
@pytest.mark.parametrize("phase", [0, 1, 9])
def test_masks_on_unaligned_rows(kind, phase):
    """Random and prefix masks (the literal stages') on corpus rows of
    16 KiB + 5 and 64 KiB at misaligned starts."""
    rng = np.random.default_rng(phase)
    for L in (16389, 65536):
        rows = np.resize(corpus.corpus_blocks(3, phase).reshape(-1),
                         (3, L))
        m = (rng.random(rows.shape) < 0.5 if kind == "random"
             else np.arange(L)[None, :] < rng.integers(0, L + 1, (3, 1)))
        got, _, most, _ = model_rows(rows, m, phase)
        assert most <= 255
        np.testing.assert_array_equal(got, H.byte_histograms_ref(
            torch.from_numpy(rows), torch.from_numpy(m)).numpy())


@pytest.mark.parametrize("dtype", [np.uint8, np.int8, np.int16, np.int32,
                                   np.int64])
def test_whole_input_passes_of_one_value(dtype):
    """One value over a grid of 2 CTAs, so that each CTA runs two passes
    of every width: the counts equal ``histogram256_jax``'s."""
    from compress_tpu.utils import histogram as jax_hist
    x = np.full(2 * 256 * UNROLL * 16 * 2 * 4 + 3, 100, dtype)
    got = model_whole(x, 0, sms=1, per_sm=2)
    np.testing.assert_array_equal(got, np.asarray(jax_hist.histogram256_jax(
        x.astype(np.int32))))
    assert got[100] == x.size
