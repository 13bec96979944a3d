"""A numpy model of the FSE batch encode chain as ``csrc/fseenc.cu`` runs
it, held against the plain PyTorch version (``ops/entropy.
fse_encode_chain_ref``).

The kernel walks each row with a one-load step where the row's tables
allow it: for byte x let k = c at s = size (c = clip((s + dnb[x]) >> 16,
0, 16)); where (s >> c) is a function of u = s >> k on [size, 2 size), a
compact table T[base_x + u - (size >> k)] holds the next state, and the
step is s = T[(kb >> 5) + (s >> (kb & 31))] with kb = (base_x - (size >>
k)) * 32 + k.  The row's warp builds T and checks it: every st entry in
[size, 2 size), and on each group u of every byte the exact step's table
index is one value, found from the index at the group's ends and on both
sides of the one state where (s + dnb) >> 16 changes; a row that fails,
or whose table passes 2 size + 256 entries, walks the exact step.  The
walker records each step's two states; the items come from the states and
the symbols with the exact arithmetic.  The model does the same on the
CPU, and counts the rows on each route.

Beside it: the check is exact (a row passes iff the one-load step equals
the exact step at every state and byte, its state table lies in [size,
2 size) and its table fits), and the finding that made the kernel cut the
step's latency rather than speculate: with counts that are powers of two
(rand4) a byte's step sends the classes s >> k one to one onto its own
states, so two trajectories meet only through states that share s >> k,
and segments of phase 23's rand4 and period7 rows started from the
first-state rule mostly never meet the true walk.  Tolerance 0: every
output is an integer."""

import numpy as np
import pytest
import torch

from compress_tpu_torch import corpus
from compress_tpu_torch.ops import entropy as E

I32_MAX = (1 << 31) - 1


def _w32(x):
    """int64 values as int32 arithmetic leaves them."""
    return ((np.asarray(x, np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def _step_index(s, d, f, size):
    """The exact step's state-table index (the reference's clips)."""
    c = np.clip(_w32(s + d) >> 16, 0, 16)
    return np.clip(_w32((s >> c) + f), 0, size - 1)


def _first(st, dnb, dfs, size, x):
    d = dnb[x]
    nb = _w32(d + (1 << 15)) >> 16
    im = _w32((nb << 16) - d)
    return st[np.clip(_w32((im >> np.clip(nb, 0, 16)) + dfs[x]), 0,
                      size - 1)]


def compact_table(st, dnb, dfs, log):
    """One row's tables for the one-load step as the kernel builds them:
    (passes, kb (256,), T or None when it does not fit)."""
    st, dnb, dfs = (np.asarray(t, np.int64) for t in (st, dnb, dfs))
    size = 1 << log
    k = np.clip(_w32(size + dnb) >> 16, 0, 16)
    u0, u1 = size >> k, (2 * size - 1) >> k
    cnt = u1 - u0 + 1
    base = np.cumsum(cnt) - cnt
    kb = (base - u0) * 32 + k
    total = int(cnt.sum())
    if total > 2 * size + 256:
        return False, kb, None
    x = np.repeat(np.arange(256), cnt)
    u = u0[x] + np.arange(total) - base[x]
    kx, d, f = k[x], dnb[x], dfs[x]
    lo = np.maximum(size, u << kx)
    hi = np.minimum(2 * size - 1, ((u + 1) << kx) - 1)
    i = _step_index(lo, d, f, size)
    same = _step_index(hi, d, f, size) == i
    # the one state past size where (s + d) >> 16 changes
    m = (((size + d) >> 16) + 1) * 65536 - d
    inside = (m > lo) & (m <= hi)
    mm = np.where(inside, m, lo + 1)
    same &= ~inside | ((_step_index(mm - 1, d, f, size) == i)
                       & (_step_index(mm, d, f, size) == i))
    ok = bool(((st >= size) & (st < 2 * size)).all() and same.all())
    return ok, kb, st[i]


def model_chain(blocks, st, dnb, dfs, log):
    """(vals, nbs, fast) of ``fse_encode_chain`` as the kernel computes
    them, ``fast`` the rows on the one-load step."""
    blocks = np.asarray(blocks)
    N, L = blocks.shape
    size = 1 << log
    W = E._chain_width(L)
    vals = np.zeros((N, W), np.int64)
    nbs = np.zeros((N, W), np.int64)
    fast = np.zeros(N, bool)
    steps = L // 2 - 1
    for r in range(N):
        t_st, t_dnb, t_dfs = (np.asarray(t[r], np.int64)
                              for t in (st, dnb, dfs))
        ok, kb, T = compact_table(t_st, t_dnb, t_dfs, log)
        fast[r] = ok
        b = blocks[r].astype(np.int64)
        s2 = int(_first(t_st, t_dnb, t_dfs, size, b[L - 1]))
        s1 = int(_first(t_st, t_dnb, t_dfs, size, b[L - 2]))
        rec = np.zeros((steps, 2), np.int64)
        st_l, dnb_l, dfs_l = t_st.tolist(), t_dnb.tolist(), t_dfs.tolist()
        T_l, kb_l = (T.tolist() if ok else None), kb.tolist()
        for j in range(steps):
            m = steps - 1 - j
            x2, x1 = int(b[2 * m + 1]), int(b[2 * m])
            rec[j] = (s2, s1)
            if ok:
                s2 = T_l[(kb_l[x2] >> 5) + (s2 >> (kb_l[x2] & 31))]
                s1 = T_l[(kb_l[x1] >> 5) + (s1 >> (kb_l[x1] & 31))]
            else:
                s2 = st_l[int(_step_index(s2, dnb_l[x2], dfs_l[x2], size))]
                s1 = st_l[int(_step_index(s1, dnb_l[x1], dfs_l[x1], size))]
        m = steps - 1 - np.arange(steps)
        x2, x1 = b[2 * m + 1], b[2 * m]
        nb2 = _w32(rec[:, 0] + t_dnb[x2]) >> 16
        nb1 = _w32(rec[:, 1] + t_dnb[x1]) >> 16
        c2, c1 = np.clip(nb2, 0, 16), np.clip(nb1, 0, 16)
        v2 = (rec[:, 0] & 0xFFFFFFFF) & ((1 << c2) - 1)
        v1 = (rec[:, 1] & 0xFFFFFFFF) & ((1 << c1) - 1)
        vals[r, :steps] = _w32(v2 | (v1 << c2))
        nbs[r, :steps] = _w32(nb1 + nb2)
        vals[r, steps] = _w32(((s2 - size) & 0xFFFFFFFF)
                              | (((s1 - size) << log) & 0xFFFFFFFF))
        nbs[r, steps] = 2 * log
    return vals.astype(np.int32), nbs.astype(np.int32), fast


def brute_force_passes(st, dnb, dfs, log) -> bool:
    """Whether the one-load step may serve the row, by evaluating both
    steps at every state of [size, 2 size) and every byte: the state table
    lies in [size, 2 size), the compact table fits, and the next state of
    every state is that of the first state of its group."""
    st, dnb, dfs = (np.asarray(t, np.int64) for t in (st, dnb, dfs))
    size = 1 << log
    if not ((st >= size) & (st < 2 * size)).all():
        return False
    if compact_table(st, dnb, dfs, log)[2] is None:
        return False
    s = np.arange(size, 2 * size)[None, :]
    k = np.clip(_w32(size + dnb) >> 16, 0, 16)[:, None]
    rep = np.maximum(size, (s >> k) << k)
    d, f = dnb[:, None], dfs[:, None]
    return bool((st[_step_index(s, d, f, size)]
                 == st[_step_index(rep, d, f, size)]).all())


def _tables(rows, log):
    t = torch.from_numpy(np.array(rows))
    return [a.numpy() for a in E._fse_tables_bytes(E.byte_histograms(t),
                                                    log)[:3]]


def _hold(blocks, st, dnb, dfs, log=9):
    vals, nbs, fast = model_chain(blocks, st, dnb, dfs, log)
    want = E.fse_encode_chain_ref(
        *(torch.from_numpy(np.array(a)) for a in (blocks, st, dnb, dfs)),
        log)
    np.testing.assert_array_equal(vals, want[0].numpy())
    np.testing.assert_array_equal(nbs, want[1].numpy())
    return fast


def _phase23_rows(per_class: int = 1):
    """Rows of 16 KiB of phase 23's corpus (``corpus_blocks(256, 0)``),
    ``per_class`` of each class in ``corpus.CLASSES`` order."""
    rows = corpus.corpus_blocks(2 * per_class * len(corpus.CLASSES),
                                0).reshape(-1, 16384)
    cls = np.repeat(np.arange(len(rows) // 4) % len(corpus.CLASSES), 4)
    return np.concatenate([rows[cls == c][:per_class]
                           for c in range(len(corpus.CLASSES))])


def test_model_matches_plain_on_phase23_classes():
    """One 16 KiB row of each corpus class at log 9: every row takes the
    one-load step (its tables are well formed)."""
    rows = _phase23_rows()
    assert _hold(rows, *_tables(rows, 9)).all()


@pytest.mark.parametrize("kind", corpus.FSE_ENC_CLASSES + ("int32",))
def test_model_matches_plain_on_hostile_inputs(kind):
    """The hostile classes of the card tests: real tables take the
    one-load step, random and clip-edge tables the exact one."""
    if kind == "int32":
        rng = np.random.default_rng(5)
        big = np.iinfo(np.int32)
        ins = (rng.integers(0, 256, (5, 2050), dtype=np.uint8),
               *(rng.integers(big.min, big.max, (5, w), dtype=np.int32)
                 for w in (512, 256, 256)))
    else:
        ins = corpus.fse_enc_inputs(kind)
    fast = _hold(*ins)
    real = kind in ("corpus", "nb_zero", "short")
    assert fast.all() if real else not fast.any()


@pytest.mark.parametrize("log", [1, 5, 9, 12])
def test_model_matches_plain_at_logs(log):
    rng = np.random.default_rng(log)
    rows = np.stack([corpus.make_block(c, rng)[:4098]
                     for c in ("text", "rand4", "zeros", "rand256",
                               "period7")])
    fast = _hold(rows, *_tables(rows, log), log=log)
    assert fast.tolist() == [brute_force_passes(*(t[r] for t in _tables(
        rows, log)), log) for r in range(len(rows))]


def _perturbed_tables():
    """Real log-9 tables of a text row, each changed in one way: a width
    switch that is not at a multiple of 2^k, s + dnb wrapping past
    INT32_MAX, a state outside [size, 2 size) and every byte at k = 0 (the
    table does not fit) break the one-load step; (s >> c) + dfs wrapping
    (constant on each group all the same) and dfs pushed so far that the
    clip holds one index do not."""
    row = corpus.make_block("text", np.random.default_rng(3))[:4096][None]
    st, dnb, dfs = (a[0].astype(np.int64) for a in _tables(row, 9))
    x = int(np.argmax(np.bincount(row[0], minlength=256)))
    out = []
    for name in ("switch", "wrap_nb", "wrap_index", "state", "k0", "clip"):
        s, d, f = st.copy(), dnb.copy(), dfs.copy()
        if name == "switch":
            d[x] += 1
        elif name == "wrap_nb":
            d[x] = I32_MAX - 700
        elif name == "wrap_index":
            f[x] = I32_MAX - 100
        elif name == "state":
            s[7] = 3
        elif name == "k0":
            d[:] = -(1 << 16) + 1
        else:
            f[x] = -(1 << 20)
        out.append((name, s, d, f))
    return out


@pytest.mark.parametrize("case", range(6))
def test_check_is_exact_on_broken_tables(case):
    name, st, dnb, dfs = _perturbed_tables()[case]
    ok = compact_table(st, dnb, dfs, 9)[0]
    assert ok == brute_force_passes(st, dnb, dfs, 9)
    assert ok == (name in ("wrap_index", "clip"))
    row = corpus.make_block("text", np.random.default_rng(3))[:4096][None]
    _hold(row, st[None].astype(np.int32), dnb[None].astype(np.int32),
          dfs[None].astype(np.int32))


def test_check_is_exact_on_every_class():
    """Rows that fail the check are exactly those on which the one-load
    step would differ from the exact step (or leave [size, 2 size), or
    not fit)."""
    sets = [(_phase23_rows(), 9)] + [
        (corpus.fse_enc_inputs(k)[0], 9) for k in corpus.FSE_ENC_CLASSES]
    for rows, log in sets:
        tabs = _tables(rows, log)
        for r in range(len(rows)):
            t = [a[r] for a in tabs]
            assert compact_table(*t, log)[0] == brute_force_passes(*t, log)
    for kind in ("hostile", "clip_edges"):
        _b, *tabs = corpus.fse_enc_inputs(kind)
        for r in range(len(_b)):
            t = [a[r] for a in tabs]
            assert compact_table(*t, 9)[0] == brute_force_passes(*t, 9)


def test_power_of_two_counts_permute_the_classes():
    """With four bytes of 4096 each (norm 128 at log 9) every state
    spends 2 bits, and each byte's step sends the 128 classes s >> 2 one
    to one onto its own 128 states: trajectories in different classes
    move to different states, so they meet only through states that share
    s >> 2."""
    rng = np.random.default_rng(0)
    row = rng.permutation(np.repeat(np.arange(4, dtype=np.uint8),
                                    4096))[None]
    t = torch.from_numpy(row)
    st, dnb, dfs, norm = (a[0].numpy().astype(np.int64) for a in
                          E._fse_tables_bytes(E.byte_histograms(t), 9))
    size = 512
    s = np.arange(size, 2 * size)
    cumul = np.cumsum(norm) - norm
    for x in range(4):
        assert norm[x] == 128
        assert (np.clip(_w32(s + dnb[x]) >> 16, 0, 16) == 2).all()
        nxt = st[_step_index(s, dnb[x], dfs[x], size)]
        by_class = nxt.reshape(128, 4)
        assert (by_class == by_class[:, :1]).all()
        assert sorted(by_class[:, 0]) == sorted(st[cumul[x]:cumul[x] + 128])


def _speculate(rows, log=9, segs=32):
    """Segmented speculation of chain s2 on 16 KiB rows: segment q >= 1
    starts at step q * S from the first-state rule at the step before it
    and walks S steps.  Returns (steps walked before meeting the true
    trajectory, S where it never met) per row and segment."""
    N, L = rows.shape
    size = 1 << log
    st, dnb, dfs = (a.astype(np.int64) for a in _tables(rows, log))
    steps = L // 2 - 1
    S = -(-steps // segs)
    b = rows.astype(np.int64)
    xs = b[:, L - 3 - 2 * np.arange(steps)]
    n = np.arange(N)[:, None]
    t = np.empty((N, steps + 1), np.int64)
    t[:, 0] = st[n[:, 0], _first_idx(dnb, dfs, size, b[:, L - 1])]
    for j in range(steps):
        x = xs[:, j]
        t[:, j + 1] = st[n[:, 0], _step_index(
            t[:, j], dnb[n[:, 0], x], dfs[n[:, 0], x], size)]
    q = np.arange(1, segs)
    g = st[n, _first_idx(dnb[n, xs[:, q * S - 1]], dfs[n, xs[:, q * S - 1]],
                         size, None)]
    walked = np.full((N, len(q)), -1)
    for a in range(S):
        j = np.minimum(q * S + a, steps)
        hit = (walked < 0) & (q * S + a <= steps) & (g == t[n, j])
        walked[hit] = a
        jj = np.minimum(j, steps - 1)
        x = xs[n, jj]
        g = st[n, _step_index(g, dnb[n, x], dfs[n, x], size)]
    return np.where(walked < 0, S, walked), walked < 0


def _first_idx(dnb, dfs, size, x):
    """The first-state rule's table index (of byte x, or of the given
    delta words when x is None)."""
    if x is not None:
        n = np.arange(len(x))
        dnb, dfs = dnb[n, x], dfs[n, x]
    nb = _w32(dnb + (1 << 15)) >> 16
    im = _w32((nb << 16) - dnb)
    return np.clip(_w32((im >> np.clip(nb, 0, 16)) + dfs), 0, size - 1)


def test_speculation_leaves_rand4_and_period7_segments_unmet():
    """The finding: 32 speculated segments a row meet the true walk on
    rand256 and zeros rows at once, but on phase 23's rand4 and period7
    rows most of them never do, so a speculating launch would take as
    long as a serial walk of its slowest rows."""
    rows = _phase23_rows(2)
    names = np.repeat(corpus.CLASSES, 2)
    walked, never = _speculate(rows)
    per = {c: never[names == c].sum(1) for c in corpus.CLASSES}
    assert per["zeros"].max() == 0 and per["rand256"].max() == 0
    assert walked[names == "rand256"].max() <= 32
    assert per["rand4"].min() >= 24 and per["period7"].min() >= 16
    assert per["text"].max() <= 4
