"""A numpy model of the zstd v1 engine's FSE scan as ``csrc/zdevfse.cu``
runs it, held against the plain PyTorch version (``ops/zdev.
fse_scan_ref``).

The kernel walks the state y = s + size, which lies in [size, 2 size)
on a well-formed table, with a one-load step where it may: for symbol x
let k = clip((size + dnb[x]) >> 16, 0, 16); where the step's table
index is one value on each group u = y >> k, a compact table of the
job's stream holds the next y at T[base_x + u - (size >> k)], and the
step is y = T[(kb >> 5) + (y >> (kb & 31))] with kb = (base_x - (size >>
k)) * 32 + k.  A CTA builds each of its job's three tables once and
checks every symbol exactly (``csrc/fseenc.cu``'s check with y for s and
64 symbols): its group's index is one value, found from the index at the
group's ends and on both sides of the one y where (y + dnb) >> 16 changes, its
entries' states lie in [size, 2 size), and its entries fit the table's
room (2 * 512 + 64).  Lanes 0-2 of a walker warp walk one block's three
rows in chunks of 64 sequences from the block's longest live run down; a
chunk of a row takes the one-load step when every symbol it walks passed
the check and its first y lies in [size, 2 size), else the exact step
(the reference's arithmetic).  A row is counted on the one-load route
when every chunk took it.  The walkers record each step's y; the block's
writer warp turns them into (val, nb) with the exact arithmetic.  Zeros
fill every entry before a row's live run.

Beside it, the finding that made the kernel cut the step's latency
rather than speculate as row 7 does: on the v1 engine's own rows most
of 32 speculated segments never meet the true walk.  Tolerance 0: every
output is an integer."""

import numpy as np
import pytest
import torch

from compress_tpu_torch import corpus
from compress_tpu_torch.ops import lz2, zdev

SZ, NSYM = zdev.FSE_SZ, zdev.NSYM
TCAP = 2 * SZ + NSYM      # a stream's compact-table room
CH = 64                   # sequences a chunk
I32_MAX = (1 << 31) - 1


def _w32(x):
    """int64 values as int32 arithmetic leaves them."""
    return ((np.asarray(x, np.int64) + (1 << 31)) % (1 << 32)) - (1 << 31)


def _index(y, d, f):
    """The exact step's state-table index at state y (the reference's
    clips, to the padded table)."""
    c = np.clip(_w32(y + d) >> 16, 0, 16)
    return np.clip(_w32((y >> c) + f), 0, SZ - 1)


def _first_index(d, f):
    nb = _w32(d + (1 << 15)) >> 16
    im = _w32((nb << 16) - d)
    return np.clip(_w32((im >> np.clip(nb, 0, 16)) + f), 0, SZ - 1)


def compact_table(st, dnb, dfs, size):
    """One (job, stream)'s compact table as the kernel builds it: (ok
    (64,) bool, kb (64,), T (TCAP,)); kb relative to the stream's T."""
    st, dnb, dfs = (np.asarray(t, np.int64) for t in (st, dnb, dfs))
    k = np.clip(_w32(size + dnb) >> 16, 0, 16)
    u0, u1 = size >> k, (2 * size - 1) >> k
    cnt = u1 - u0 + 1
    base = np.cumsum(cnt) - cnt
    kb = (base - u0) * 32 + k
    ok = base + cnt <= TCAP
    total = int(min(cnt.sum(), TCAP))
    j = np.arange(total)
    x = np.searchsorted(base, j, side="right") - 1
    u = u0[x] + j - base[x]
    kx, d, f = k[x], dnb[x], dfs[x]
    lo = np.maximum(size, u << kx)
    hi = np.minimum(2 * size - 1, ((u + 1) << kx) - 1)
    i = _index(lo, d, f)
    same = _index(hi, d, f) == i
    m = (((size + d) >> 16) + 1) * 65536 - d
    inside = (m > lo) & (m <= hi)
    mm = np.where(inside, m, lo + 1)
    same &= ~inside | ((_index(mm - 1, d, f) == i) & (_index(mm, d, f) == i))
    T = np.zeros(TCAP, np.int64)
    T[:total] = st[i]
    good = same & (st[i] >= size) & (st[i] < 2 * size)
    ok[np.unique(x[~good])] = False
    return ok, kb, T


def model_scan(syms, n_seqs, st, dnb, dfs, logs, rle):
    """(val, nb, fin, routes) of ``fse_scan`` as the kernel computes them:
    routes = (rows walked wholly on the one-load step, rows with a chunk
    on the exact step); rows with no step are on neither."""
    syms, n_seqs, st, dnb, dfs, logs = (np.asarray(a, np.int64) for a in (
        syms, n_seqs, st, dnb, dfs, logs))
    rle = np.asarray(rle, bool)
    R, _, MS = syms.shape
    nj = st.shape[0]
    val = np.zeros((R, 3, MS), np.int64)
    nbo = np.zeros((R, 3, MS), np.int64)
    fin = np.zeros((R, 3), np.int64)
    routes = [0, 0]
    tabs = {}
    for j in range(nj):
        for k in range(3):
            if not rle[j, k] and 0 <= logs[j, k] <= 9:
                tabs[j, k] = compact_table(st[j, k], dnb[j, k], dfs[j, k],
                                           1 << int(logs[j, k]))
    for r in range(R):
        j = r // (R // nj)
        n = int(n_seqs[r])
        lives = [0 if rle[j, k] or n < 1 else (n - 1 if n <= MS else MS)
                 for k in range(3)]
        top = max(lives)
        for k in range(3):
            if rle[j, k]:
                continue
            size = 1 << int(logs[j, k])
            t_st, t_dnb, t_dfs = st[j, k], dnb[j, k], dfs[j, k]
            ok, kb, T = tabs.get((j, k), (np.zeros(NSYM, bool), None, None))
            x_all = syms[r, k]
            inr = (x_all >= 0) & (x_all < NSYM)
            xm = np.where(inr, x_all, 0)
            d_all = np.where(inr, t_dnb[xm], 0)
            f_all = np.where(inr, t_dfs[xm], 0)
            good = inr & ok[xm]
            y = size
            if 1 <= n <= MS:
                y = int(t_st[_first_index(d_all[n - 1], f_all[n - 1])])
            live = lives[k]
            rec = np.zeros(MS, np.int64)
            all_fast = True
            for hi in range(top - 1, -1, -CH):
                lo = max(hi - CH + 1, 0)
                if live <= lo:
                    continue
                rhi = min(hi, live - 1)
                fast = bool(good[lo:rhi + 1].all()) and size <= y < 2 * size
                all_fast &= fast
                for i in range(rhi, lo - 1, -1):
                    rec[i] = y
                    if fast:
                        w = int(kb[xm[i]])
                        y = int(T[(w >> 5) + (y >> (w & 31))])
                    else:
                        y = int(t_st[_index(y, d_all[i], f_all[i])])
            if live:
                routes[0 if all_fast else 1] += 1
                i = np.arange(live)
                nb = _w32(rec[i] + d_all[i]) >> 16
                c = np.clip(nb, 0, 16)
                val[r, k, MS - 1 - i] = _w32((rec[i] & 0xFFFFFFFF)
                                             & ((1 << c) - 1))
                nbo[r, k, MS - 1 - i] = nb
            fin[r, k] = _w32(y - size)
    return (val.astype(np.int32), nbo.astype(np.int32),
            fin.astype(np.int32), tuple(routes))


def scan_inputs(seed: int, nj: int = 3, nblk: int = 4, ms: int = 2731,
                rle=(), hot_of: bool = False, n_seqs=None):
    """The card tests' FSE scan inputs at v1's 16 KiB block: skewed random
    codes, per-job tables of logs 9/8/9 from ``zdev._fse_build``; ``rle``
    lists (job, stream) pairs made RLE; ``hot_of`` moves the of deltas so
    that clamped indices pass 255 (the padded zeros)."""
    rng = np.random.default_rng(seed)
    R = nj * nblk
    n = (rng.integers(0, ms + 1, R) if n_seqs is None
         else np.resize(np.asarray(n_seqs), R)).astype(np.int32)
    n_t = torch.from_numpy(n)
    is_seq = torch.arange(ms)[None, :] < n_t[:, None]
    codes = []
    for hi in (36, 21, 53):
        c = np.minimum(rng.geometric(rng.uniform(0.05, 0.5), (R, ms)) - 1,
                       hi - 1)
        codes.append(torch.where(is_seq, torch.from_numpy(c), 0)
                     .to(torch.int32))
    tabs = [zdev._fse_build(c, is_seq, nj, lg)
            for c, lg in zip(codes, zdev.FSE_LOGS)]
    st, dnb, dfs, logs, rle_t = (torch.stack([t[k] for t in tabs], dim=1)
                                 .contiguous()
                                 for k in ("st", "dnb", "dfs", "log", "rle"))
    for j, k in rle:
        rle_t[j, k] = True
        logs[j, k] = 0
    if hot_of:
        dfs[:, 1] += 200
    syms = torch.stack(codes, dim=1).contiguous()
    return [syms, n_t, st, dnb, dfs, logs, rle_t]


def _hold(args):
    val, nb, fin, routes = model_scan(*(a.numpy() for a in args))
    want = zdev.fse_scan_ref(*args)
    for got, w in zip((val, nb, fin), want):
        np.testing.assert_array_equal(got, w.numpy())
    return routes


def _walked_rows(args):
    """Rows the kernel walks: not RLE and with at least one enc step."""
    n, rle = args[1].numpy(), args[6].numpy()
    R, nj = len(n), rle.shape[0]
    job = np.arange(R) // (R // nj)
    return int(((n >= 2)[:, None] & ~rle[job]).sum())


CASES = {
    "n_seqs_0_1_ms": dict(n_seqs=[0, 1, 2731, 2, 3, 2730]),
    "random_n": dict(),
    "one_rle_stream": dict(rle=[(0, 1)]),
    "two_rle_streams": dict(rle=[(1, 0), (1, 2)]),
    "three_rle_streams": dict(rle=[(2, 0), (2, 1), (2, 2)]),
    "of_index_past_255": dict(hot_of=True),
    "past_ms": dict(n_seqs=[2731 + 5, 2731, 7]),
}


@pytest.mark.parametrize("case", list(CASES))
def test_model_matches_plain_on_card_test_cases(case):
    """The card tests' cases.  Real tables walk on the one-load step; the
    of stream whose deltas push indices past 255 fails the check and its
    rows take the exact step."""
    args = scan_inputs(list(CASES).index(case) + 40, **CASES[case])
    routes = _hold(args)
    assert sum(routes) == _walked_rows(args)
    if case == "of_index_past_255":
        of_rows = int((args[1].numpy() >= 2).sum())
        assert routes[1] == of_rows and routes[0] == sum(routes) - of_rows
    else:
        assert routes[1] == 0


def _broken(name: str):
    """Real tables of a 2 x 3 launch, one symbol of job 0's ll table
    broken: a width switch not at a multiple of 2^k (dnb + 1), a state
    outside [size, 2 size), s + dnb wrapping past INT32_MAX, and every
    symbol at k = 0 (the table does not fit)."""
    args = scan_inputs(7, nj=2, nblk=3)
    syms, n, st, dnb, dfs = args[:5]
    hot = int(torch.mode(syms[:3, 0, :int(n[:3].min())].flatten())[0])
    if name == "switch":
        dnb[0, 0, hot] += 1
    elif name == "state":
        st[0, 0, :] = torch.where(st[0, 0] > 0, 3, 0)
    elif name == "wrap_nb":
        dnb[0, 0, hot] = I32_MAX - 700
    else:
        dnb[0, 0, :] = -(1 << 16) + 1
    return args


@pytest.mark.parametrize("name", ["switch", "state", "wrap_nb", "k0"])
def test_model_takes_the_exact_step_on_broken_tables(name):
    """A table built to fail the compact check sends job 0's ll rows that
    walk a failing symbol to the exact step (all of them where every
    symbol fails); every other row stays on the one-load step."""
    args = _broken(name)
    routes = _hold(args)
    job0_ll = int((args[1].numpy()[:3] >= 2).sum())
    assert 1 <= routes[1] <= job0_ll
    if name in ("state", "k0"):
        assert routes[1] == job0_ll
    assert routes[0] == _walked_rows(args) - routes[1]


def test_check_is_exact_against_a_brute_force():
    """A symbol passes iff the one-load step equals the exact step at
    every y of [size, 2 size) and lands in [size, 2 size) (and its
    entries fit), on real and broken tables."""
    sets = [scan_inputs(3, nj=2, nblk=2, hot_of=True)] + [
        _broken(b) for b in ("switch", "state", "wrap_nb", "k0")]
    y = np.arange(SZ)
    for args in sets:
        st, dnb, dfs, logs = (a.numpy().astype(np.int64) for a in args[2:6])
        for j in range(st.shape[0]):
            for k in range(3):
                size = 1 << int(logs[j, k])
                ok, kb, T = compact_table(st[j, k], dnb[j, k], dfs[j, k],
                                          size)
                yy = size + y[:size]
                for x in range(NSYM):
                    nxt = st[j, k][_index(yy, dnb[j, k, x], dfs[j, k, x])]
                    fits = (kb[x] >> 5) + ((2 * size - 1) >> (kb[x] & 31)) \
                        < TCAP
                    brute = bool(fits and ((nxt >= size) & (nxt < 2 * size)
                                           ).all())
                    if brute:
                        got = T[(kb[x] >> 5) + (yy >> (kb[x] & 31))]
                        brute = bool((got == nxt).all())
                    assert ok[x] == brute, (j, k, x)


def test_model_switches_route_chunk_by_chunk():
    """A symbol broken in one row's middle sends only the chunks that walk
    it to the exact step: the row ends where the plain version does."""
    args = scan_inputs(11, nj=1, nblk=2, n_seqs=[2000, 1500])
    syms, dnb, dfs = args[0], args[3], args[4]
    syms[:, 2, :] = torch.where(syms[:, 2] == 40, 39, syms[:, 2])
    syms[0, 2, 1000] = 40
    dnb[0, 2, 40] = I32_MAX - 700  # y + dnb wraps inside [size, 2 size)
    dfs[0, 2, 40] = 0
    routes = _hold(args)
    assert routes == (5, 1)


@pytest.fixture(scope="module")
def v1_inputs():
    """The v1 engine's own FSE scan inputs (and tile parse input) for 2
    jobs of 128 KiB of ``corpus.replica_jobs`` at level 2, captured on the
    CPU."""
    caps = {}
    f_scan, f_parse = zdev.fse_scan, lz2.tile_parse

    def scan(*a):
        caps["scan"] = a
        return f_scan(*a)

    def parse(L, tile, **kw):
        caps["parse"] = (L, tile)
        return f_parse(L, tile, **kw)

    job = 128 << 10
    jobs = torch.from_numpy(np.ascontiguousarray(
        corpus.replica_jobs(2, job, 0).reshape(2, job)))
    zdev.fse_scan, lz2.tile_parse = scan, parse
    try:
        zdev.zstd_encode_jobs(jobs, job=job, block=16 << 10, level=2)
    finally:
        zdev.fse_scan, lz2.tile_parse = f_scan, f_parse
    return caps


def test_model_matches_plain_on_v1_engine_inputs(v1_inputs):
    """Every walked row of the engine's own tables takes the one-load
    step."""
    args = list(v1_inputs["scan"])
    routes = _hold(args)
    assert routes == (_walked_rows(args), 0)


def test_speculated_segments_mostly_never_meet(v1_inputs):
    """The finding: 32 speculated segments a row (segment q >= 1 starts at
    step q * S from the first-state rule on the symbol before it and walks
    S steps, as row 7 does) mostly never meet the true walk on the v1
    engine's rows, so a speculating launch would walk about as long as
    the serial chain."""
    syms, n, st, dnb, dfs, logs, rle = (a.numpy().astype(np.int64)
                                        for a in v1_inputs["scan"])
    R, _, MS = syms.shape
    unmet = []
    for r in range(R):
        j = r // (R // st.shape[0])
        live = int(n[r]) - 1
        if live < 32 * 16:
            continue
        for k in range(3):
            if rle[j, k]:
                continue
            t_st, d, f = st[j, k], dnb[j, k], dfs[j, k]
            xs = syms[r, k, live - 1 - np.arange(live)]
            t = np.empty(live + 1, np.int64)
            t[0] = t_st[_first_index(d[syms[r, k, live]],
                                     f[syms[r, k, live]])]
            for a in range(live):
                t[a + 1] = t_st[_index(t[a], d[xs[a]], f[xs[a]])]
            S = -(-live // 32)
            never = 0
            for q in range(1, 32):
                j0 = q * S
                if j0 >= live:
                    break
                g = t_st[_first_index(d[xs[j0 - 1]], f[xs[j0 - 1]])]
                met = False
                for a in range(min(S, live - j0)):
                    if g == t[j0 + a]:
                        met = True
                        break
                    g = t_st[_index(g, d[xs[j0 + a]], f[xs[j0 + a]])]
                never += not met
            unmet.append(never)
    unmet = np.array(unmet)
    assert len(unmet) >= 30
    assert unmet.max() >= 16 and unmet.mean() >= 12
