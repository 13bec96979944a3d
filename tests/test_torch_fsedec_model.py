"""A numpy model of the FSE chunk decode as ``csrc/fsedec.cu`` runs it,
held against the plain PyTorch version (``ops/entropy_dec.
fse_decode_chunks_ref``) and, on a batch made the way ``fse.
decompress_batch`` makes it, against the JAX ``fse_decode_chunks``.

The kernel takes a tile of T = 256 consecutive chunks of one row a CTA.
A tile whose chunks all have npair 0 takes the dead route: its span of
the output, bytes [first * k, (first + n) * k), is written with zeros
and its end cursors are its lbit, with no staging and no walk.  A live
tile walks each chunk with a 64-bit bit container of window bits [32 (q
- 1), 32 (q + 1)) and rem = lbp - 32 (q - 1): before each pair, rem <
30 shifts the next word in (q drops by one, rem grows by 32; words
outside the window read 0); a read of nb bits is rem -= nb, then
(container >> rem) & (2^nb - 1).  The end cursor is int32 arithmetic
with the wrap.  The symbols go to a stage laid out as the tile's span of
the output, starting at byte first * k & 15, as 4-byte words where k %
4 == 0 and as 2-byte pairs otherwise; the span leaves as 16-byte stores
between its first and last 16-byte boundaries and 2-byte stores for the
head and tail.  The model checks every step's assumptions (the
container's bounds, the stores' alignment, each output byte written
once) and counts the chunks on each route.  Tolerance 0: every output
is an integer or a byte."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from compress_tpu.ops import entropy_dec as jax_ed  # noqa: E402
from compress_tpu_torch import corpus, fse  # noqa: E402
from compress_tpu_torch.fse import core  # noqa: E402
from compress_tpu_torch.ops import entropy_dec as ED  # noqa: E402

T = 256                   # chunks a CTA (FSED_THREADS)
STATES = 512
KEYS = ("windows", "lbit", "st1", "st2", "npair", "nore1", "nore2",
        "tables")


def _i32(x):
    return (np.asarray(x, np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)


def smem_bytes(win: int, k: int) -> int:
    """The kernel's dynamic shared memory: table, windows, stage."""
    return 4 * STATES + T * win + T * k + 16


def store_span(out, written, stage, g0: int, g1: int):
    """The kernel's store of a tile's span [g0, g1) from the stage (None:
    zeros), with the alignment each store needs checked."""
    base = g0 & ~15
    a0 = min((g0 + 15) & ~15, g1)
    a1 = max(g1 & ~15, a0)
    assert g0 % 2 == 0 and g1 % 2 == 0
    for i in range(a0, a1, 16):          # 16-byte streaming stores
        assert i % 16 == 0 and (i - base) % 16 == 0
        out[i:i + 16] = 0 if stage is None else stage[i - base:i - base + 16]
        written[i:i + 16] += 1
    head, tail = (a0 - g0) // 2, (g1 - a1) // 2
    assert head + tail <= T
    for i in [g0 + 2 * t for t in range(head)] + [a1 + 2 * t
                                                  for t in range(tail)]:
        out[i:i + 2] = 0 if stage is None else stage[i - base:i - base + 2]
        written[i:i + 2] += 1


def walk_tile(words, lbit, st1, st2, npair, nore1, nore2, tab, k, stage,
              off):
    """Walk a live tile's n chunks (vectors over the chunks) into the
    stage; return the end cursors."""
    n, nw = words.shape
    lanes = np.arange(n)

    def word(i):
        inside = (i >= 0) & (i < nw)
        return np.where(inside, words[lanes, np.clip(i, 0, nw - 1)],
                        0).astype(np.uint64)

    lbp = lbit.astype(np.int64)
    q = lbp >> 5
    cont = word(q) << np.uint64(32) | word(q - 1)
    rem = (lbp & 31) + 32
    nxt = word(q - 2)
    s1, s2 = st1.astype(np.int64), st2.astype(np.int64)
    tab = tab.astype(np.int64)
    words_out = k % 4 == 0
    if words_out:
        assert off % 4 == 0
    packed = np.zeros(n, np.int64)
    for j in range(k // 2):
        e1 = np.where((s1 >= 0) & (s1 < STATES), tab[np.clip(s1, 0, 511)], 0)
        e2 = np.where((s2 >= 0) & (s2 < STATES), tab[np.clip(s2, 0, 511)], 0)
        refill = rem < 30
        cont = np.where(refill, cont << np.uint64(32) | nxt, cont)
        rem = np.where(refill, rem + 32, rem)
        q = np.where(refill, q - 1, q)
        nxt = np.where(refill, word(q - 2), nxt)
        assert (rem >= 30).all() and (rem <= 63).all()
        act = j < npair
        for e, which, nore in ((e1, 1, nore1), (e2, 2, nore2)):
            go = act & (j < nore)
            nb = (e >> 8) & 15
            rem = np.where(go, rem - nb, rem)
            bits = (cont >> rem.clip(0).astype(np.uint64)) & (
                (np.uint64(1) << nb.astype(np.uint64)) - np.uint64(1))
            ns = _i32((e >> 16) + bits.astype(np.int64))
            if which == 1:
                s1 = np.where(go, ns, s1)
            else:
                s2 = np.where(go, ns, s2)
            lbp = np.where(go, _i32(lbp - nb), lbp)
        assert (rem >= 0).all()
        pair = np.where(act, (e1 & 255) | (e2 & 255) << 8, 0)
        at = off + lanes * k + 2 * j
        if not words_out:
            assert (at % 2 == 0).all()
        elif j & 1:
            word_at = at - 2
            assert (word_at % 4 == 0).all()
            val = packed | pair << 16
            for b in range(4):
                stage[word_at + b] = (val >> (8 * b)) & 255
            continue
        else:
            packed = pair
            continue
        stage[at] = pair & 255
        stage[at + 1] = pair >> 8
    return lbp


def model_decode(windows, lbit, st1, st2, npair, nore1, nore2, tables,
                 k: int = 32):
    """(syms (N, C, k) uint8, end cursors (N, C) int32, routes [dead,
    walked] in chunks)."""
    N, C, win = windows.shape
    assert win % 4 == 0 and 4 <= win <= 64 and 2 <= k <= 64 and k % 2 == 0
    assert smem_bytes(win, k) <= 48 * 1024
    words = np.ascontiguousarray(windows).view("<u4").reshape(N, C, win // 4)
    out = np.zeros(N * C * k, np.uint8)
    written = np.zeros(N * C * k, np.int64)
    endl = np.zeros((N, C), np.int64)
    routes = [0, 0]
    for r in range(N):
        for c0 in range(0, C, T):
            n = min(T, C - c0)
            sl = slice(c0, c0 + n)
            first = r * C + c0
            g0, g1 = first * k, (first + n) * k
            if not (npair[r, sl] > 0).any():
                routes[0] += n
                endl[r, sl] = lbit[r, sl]
                store_span(out, written, None, g0, g1)
                continue
            routes[1] += n
            stage = np.full(T * k + 16, 0xA5, np.int64)  # stale bytes
            endl[r, sl] = walk_tile(
                words[r, sl], lbit[r, sl], st1[r, sl], st2[r, sl],
                npair[r, sl], nore1[r, sl], nore2[r, sl], tables[r], k,
                stage, g0 & 15)
            store_span(out, written, stage.astype(np.uint8), g0, g1)
    assert (written == 1).all()          # every output byte, once
    return out.reshape(N, C, k), endl.astype(np.int32), routes


def _plain(d, k=32):
    got = ED.fse_decode_chunks(*(torch.from_numpy(np.ascontiguousarray(d[n]))
                                 for n in KEYS), k=k)
    return [g.numpy() for g in got]


def _hold(d, k=32):
    syms, endl, routes = model_decode(*(d[n] for n in KEYS), k=k)
    want = _plain(d, k)
    np.testing.assert_array_equal(syms, want[0])
    np.testing.assert_array_equal(endl, want[1])
    return routes


@pytest.mark.parametrize("k", [2, 6, 32, 64])
@pytest.mark.parametrize("kind", corpus.FSE_DEC_CLASSES
                         + (corpus.FSE_DEC_WILD,))
def test_model_matches_plain_on_hostile_chunks(kind, k):
    """Every hostile class (the wild tables: any int32 entry, cursors at
    both ends of int32) at k = 2, 6, 32 and 64."""
    d = corpus.fse_dec_inputs(kind)
    d["npair"] = np.minimum(d["npair"], k // 2)
    routes = _hold(d, k)
    dead = sum(int(c.sum() == 0) * len(c) for c in d["npair"])
    assert routes[0] == dead


def _tiled(C: int, seed: int):
    """Rows of C chunks (C not a multiple of the tile) from the nb_zero
    class, with dead and live tiles mixed."""
    rng = np.random.default_rng(seed)
    d = corpus.fse_dec_inputs("nb_zero")
    out = {}
    for n in KEYS:
        a = d[n]
        out[n] = a if n == "tables" else np.resize(
            np.moveaxis(a, 1, 0), (C,) + a.shape[:1] + a.shape[2:]).swapaxes(
                0, 1).copy()
    out["lbit"] = rng.integers(-40, 500, out["lbit"].shape).astype(np.int32)
    out["npair"][0] = 0                       # a dead row
    out["npair"][1, T:] = 0                   # live first tile, dead rest
    out["npair"][2, :T] = 0                   # a dead tile, then live ones
    out["npair"][2, T + 3:T + 4] = 0
    return out


@pytest.mark.parametrize("C", [1, 255, 257, 600])
@pytest.mark.parametrize("k", [6, 32])
def test_model_tiles_mix_dead_and_live_chunks(C, k):
    d = _tiled(C, C + k)
    routes = _hold(d, k)
    tiles = [(r, c0, min(T, C - c0)) for r in range(3)
             for c0 in range(0, C, T)]
    dead = sum(n for r, c0, n in tiles
               if not (d["npair"][r, c0:c0 + n] > 0).any())
    assert routes == [dead, 3 * C - dead]
    if C > T:
        assert dead >= C and routes[1] > 0


def test_span_stores_cover_each_byte_once():
    """The tile's span cut into head, 16-byte middle and tail, for spans
    of every start mod 16 and lengths 2 to 96."""
    for g0 in range(0, 64, 2):
        for length in range(2, 98, 2):
            out = np.zeros(256, np.uint8)
            written = np.zeros(256, np.int64)
            stage = np.arange(512, dtype=np.int64).astype(np.uint8)
            store_span(out, written, stage, g0, g0 + length)
            assert (written[g0:g0 + length] == 1).all()
            assert written.sum() == length
            np.testing.assert_array_equal(
                out[g0:g0 + length],
                stage[(g0 & 15):(g0 & 15) + length])


def test_smem_fits_the_default_limit():
    assert max(smem_bytes(w, k) for w in range(4, 65, 4)
               for k in range(2, 65, 2)) <= 48 * 1024


@pytest.fixture(scope="module")
def batch():
    """A small batch made as ``decompress_batch`` makes it: 12 corpus rows
    of 16 KiB (rand256 and zeros rows give None), an odd-length log-9
    container and a log-11 one (host-routed), and a None entry."""
    rows = corpus.corpus_blocks(3, 5).reshape(-1, 16384)[:12]
    conts = fse.compress_batch(rows, device="cpu")
    text = corpus.make_block("text", np.random.default_rng(8))
    conts += [fse.compress(text[:5001].tobytes(), table_log=9),
              fse.compress(text[:9000].tobytes(), table_log=11), None]
    accel = fse.make_accel(conts)
    metas, arrays = fse.prep_decode_batch(conts, accel)
    return conts, metas, dict(zip(KEYS, arrays))


def test_model_matches_plain_on_a_batch(batch):
    conts, metas, d = batch
    assert sum(m is None for m in metas) >= 3
    routes = _hold(d)
    dead_rows = [i for i, m in enumerate(metas) if m is None]
    C = d["lbit"].shape[1]
    assert routes[0] >= len(dead_rows) * C
    assert routes[0] + routes[1] == d["lbit"].size


def test_plain_matches_jax_on_a_batch(batch):
    """The plain version equals the JAX ``fse_decode_chunks`` on the same
    batch, every row (the dead rows' tables are zeros on both sides)."""
    conts, metas, d = batch
    planes = np.zeros((len(conts), 16, 96), np.float32)
    for i, (blob, m) in enumerate(zip(conts, metas)):
        if m is not None:
            norm, tl, _ = core.read_ncount(blob, fse.read_uvarint(blob)[1],
                                           255)
            planes[i] = jax_ed.expand_fse_table(*core.build_dtable(norm, tl))
    want = jax_ed.fse_decode_chunks(*(jnp.asarray(d[n]) for n in KEYS[:-1]),
                                    jnp.asarray(planes))
    got = _plain(d)
    np.testing.assert_array_equal(got[0], np.asarray(want[0]))
    np.testing.assert_array_equal(got[1], np.asarray(want[1]))
    for i, m in enumerate(metas):
        # an odd-length container's last symbol is not in the chunks (the
        # reference's rule, pinned in tests/test_torch_fse.py)
        if m is not None and m[0] % 2 == 0:
            assert got[0][i].reshape(-1)[:m[0]].tobytes() == \
                fse.decompress(conts[i])
