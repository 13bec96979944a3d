"""A numpy model of the two table-build kernels' design
(``csrc/tablebuild.cu``) on the CPU, held against their plain versions
(``ops/zdev._huff_build_ref`` and ``_normalize_count_ref``) bit for bit
(tolerance 0: integers).

The models do what the kernels do, step for step:

- the stable rank both kernels share (``sorted_rank``): each warp's 32
  (key, tag) pairs sorted by the bitonic network of shuffles (the key
  descending, the tag ascending; a dead pair's tag has its top bit set and
  its key is 0, so it sorts after every live one), then each pair's rank
  as its place in its run plus, for each other run, the count of that
  run's live pairs before it by binary lifting (steps 16, 8, 4, 2, 1 and
  one more load), on the exact route (the key and the tag compared in
  turn) or, where every key of the row is below 2^(32 - TB) or
  2^(64 - TB), a packed one (key << TB | ~tag, one word of 32 or 64
  bits); the ranks of the live pairs must be the places a stable sort
  gives them, on every route;
- the Huffman build (a CTA a row, a thread a symbol): l0 as the least
  l >= 1 with h << l >= total, from the two counts' floor_log2 (the plain
  version's floor division past 2^62); the Kraft deficit d; then up to
  12 passes, each of which ranks the symbols that can step (present,
  l > 1) by h << l on the 32-bit packed route where every such key of
  the row is below 2^19, the 64-bit one below 2^51 and the exact one
  elsewhere,
  writes their cost exponents maxlog - l in rank order, 8 to a word, and
  walks them 32 at a time (``chunk_walk``): exponent 15 past the ranked
  symbols, a step d = min(d - cost, d) in unsigned 32-bit arithmetic,
  the steps gathered into a mask a chunk, the stop checked at a chunk's
  end; each symbol reads its step from the masks at its rank; the passes
  stop when a pass starts with d <= 0 or takes no step;
- the normalisation (a CTA a row of NSYM symbols): floor shares and
  remainders in 64 bits; the 32-bit packed route where every remainder
  and count of the row is below 2^21, the 64-bit one below 2^53, else
  the exact one;
  a surplus to the present symbols ranked below it by remainder; a
  deficit by the counts' ranks and an exclusive scan (``deficit_scan``):
  a_i = max(c_i - 1, 0) in rank order, P_i the sum of a_j over j < i, the
  take at rank i min(a_i, max(d - P_i, 0)).

The chunked walk must equal the serial walk it replaces (stopped where d
reaches 0) take for take and step for step, and the scan the serial steal
walk, unpayable deficits included.  The models' results must equal the
plain versions' on every ``corpus.py`` class of both builds
(``huff_build_hists``, ``normalize_hists``) at maxlog 8 and 11, NSYM 64
and 256 and logs 5-12, on the wide-key rows (``huff_build_wide_hists``,
``normalize_wide_hists``: keys and remainders past 2^54) at every maxlog
1-15 and NSYM 1 to 1024.  A CPU tensor takes the plain version: the
wrappers launch nothing there.
"""

import numpy as np
import pytest
import torch

from compress_tpu_torch import corpus
from compress_tpu_torch.ops import zdev

PASSES = 12
ONES = 0xFFFFFFFF
HB_TB, NC_TB = 13, 11      # the kernels' tag widths: dead bit, symbol, ...


def _before(ak, at, bk, bt):
    """Whether (ak, at) sorts before (bk, bt): the larger key, then the
    lower tag."""
    return (ak > bk) | ((ak == bk) & (at < bt))


def warp_sort(key: np.ndarray, tag: np.ndarray):
    """The bitonic network of shuffles on (W, 32) pairs: every lane
    compares with lane ^ j and keeps the pair that sorts first or after."""
    lane = np.arange(32)
    k = 2
    while k <= 32:
        j = k >> 1
        while j:
            pk, pt = key[:, lane ^ j], tag[:, lane ^ j]
            first = ((lane & j) == 0) == ((lane & k) == 0)
            take = _before(pk, pt, key, tag) == first[None, :]
            key, tag = np.where(take, pk, key), np.where(take, pt, tag)
            j >>= 1
        k <<= 1
    return key, tag


def sorted_rank(key: np.ndarray, tag: np.ndarray, tb: int, packed: int = 0):
    """The kernels' ``sorted_rank`` on T = 32 W threads' (key, tag) pairs
    (key uint64, tag int64 of tb bits, its top bit set where the pair
    takes no rank), on the exact route (packed 0) or a packed one (key <<
    tb | ~tag in one word of ``packed`` bits, 32 or 64, every key below
    2^(packed - tb)): (keys and tags as the lanes hold them after the
    warps' sorts, each lane's rank, the live pairs' count)."""
    T = len(key)
    W = T // 32
    dead = (tag >> (tb - 1)) & 1
    key = np.where(dead, 0, key).astype(np.uint64)
    mask = (1 << tb) - 1
    if packed:
        assert int(key.max()) < 1 << (packed - tb)
        word = key << np.uint64(tb) | (~tag & mask).astype(np.uint64)
        rk, rt = warp_sort(word.reshape(W, 32), np.zeros((W, 32), np.int64))
        live = ((rk >> np.uint64(tb - 1)) & np.uint64(1)) == 1
    else:
        rk, rt = warp_sort(key.reshape(W, 32), tag.reshape(W, 32))
        live = ((rt >> (tb - 1)) & 1) == 0
    m = live.sum(axis=1)
    rank = np.tile(np.arange(32), (W, 1))
    for v in range(W):
        if m[v] == 0:
            continue
        pos = np.zeros((W, 32), np.int64)
        st = 16
        while st:
            i = pos + st - 1
            c = np.minimum(i, 31)
            pos += st * ((i < m[v]) & _before(rk[v][c], rt[v][c], rk, rt))
            st >>= 1
        c = np.minimum(pos, 31)
        pos += (pos < m[v]) & _before(rk[v][c], rt[v][c], rk, rt)
        rank += np.where(np.arange(W)[:, None] == v, 0, pos)
    if packed:
        rt = ~rk.astype(np.int64) & mask
        rk = rk >> np.uint64(tb)
    return rk.ravel(), rt.ravel(), rank.ravel(), int(live.sum())


def stable_places(key: np.ndarray, tag: np.ndarray, tb: int) -> dict:
    """tag -> place in a stable sort of the live pairs (key descending,
    tag ascending)."""
    live = [(-int(k), int(t)) for k, t in zip(key, tag)
            if not (t >> (tb - 1)) & 1]
    return {t: i for i, (_, t) in enumerate(sorted(live))}


def serial_walk(exps: list, d: int):
    """PR 21's walk: the costs 2^e in rank order, a step where the cost
    fits d, stopped where d reaches 0.  (takes, steps, d)."""
    takes, i = [], 0
    while i < len(exps):
        c = 1 << exps[i]
        takes.append(c <= d)
        d -= c if c <= d else 0
        i += 1
        if d == 0:
            break
    return takes, i, d


def chunk_walk(expw: list, n: int, d: int):
    """The kernel's walk: 4 words of 8 exponents a chunk of 32 ranks,
    exponent 15 from rank n on, a step d = min(d - cost, d) in 32-bit
    unsigned arithmetic (a cost that does not fit wraps above d), a mask
    a chunk, the stop checked at a chunk's end.  (masks, steps, d)."""
    masks, stop = [], n
    for c in range((n + 31) // 32):
        mask = 0
        for k in range(4):
            wd = expw[4 * c + k]
            v = n - 32 * c - 8 * k
            if v < 8:
                wd |= ONES if v <= 0 else (ONES << (4 * v)) & ONES
            for b in range(8):
                t = (d - (1 << ((wd >> (4 * b)) & 15))) & ONES
                mask |= int(t <= d) << (8 * k + b)
                d = min(t, d)
        masks.append(mask)
        if d == 0:
            stop = 32 * c + mask.bit_length()
            break
    return masks, stop, d


def _l0(h: np.ndarray, maxlog: int):
    """The kernel's l0: floor_log2(total) - floor_log2(h), one more where
    h << l < total, at least 1 (below total 2^62, which every row here
    keeps); 0 for an absent symbol."""
    present = h > 0
    total = int(h.sum())
    assert total < 1 << 62
    l = []
    for x in np.where(present, h, 1):
        k = total.bit_length() - int(x).bit_length()
        k += (int(x) << max(k, 0)) < total
        l.append(max(k, 1))
    return np.where(present, np.minimum(np.array(l, np.int64), maxlog), 0)


def _route(widest: int, tb: int) -> int:
    """The kernels' route for a row whose widest key is ``widest``: 32 or
    64 (packed in a word of that many bits), 0 (exact)."""
    bits = widest.bit_length()
    return 32 if bits <= 32 - tb else 64 if bits <= 64 - tb else 0


def model_huff_build(hist: np.ndarray, maxlog: int):
    """(nbits, max_bits, ok, steps, passes) as the kernel computes them;
    steps and passes are each row's walk steps and passes run."""
    J = hist.shape[0]
    nbits = np.zeros((J, 256), np.int32)
    max_bits = np.zeros(J, np.int32)
    ok = np.zeros(J, bool)
    steps = np.zeros(J, np.int64)
    passes = np.zeros(J, np.int64)
    sym = np.arange(256, dtype=np.int64)
    for j in range(J):
        h = hist[j].astype(np.int64)
        present = h > 0
        l = _l0(h, maxlog)
        d = (1 << maxlog) - int(np.where(present, 1 << (maxlog - l),
                                         0).sum())
        more = d > 0
        # the route from the widest key that can step (later passes only
        # shorten keys)
        route = _route(max([int(x) << int(y) for x, y in zip(h, l)
                            if x > 0 and y > 1], default=0), HB_TB)
        for _ in range(PASSES):
            if not more:
                break
            passes[j] += 1
            elig = present & (l > 1)
            key = np.array([int(x) << int(y) if e else 0
                            for x, y, e in zip(h, l, elig)], np.uint64)
            tag = (np.where(elig, 0, 1) << (HB_TB - 1) | sym << 4
                   | ((maxlog - l) & 15))
            rk, rt, rank, n = sorted_rank(key, tag, HB_TB, route)
            live = ((rt >> (HB_TB - 1)) & 1) == 0
            places = stable_places(key, tag, HB_TB)
            assert n == int(elig.sum())
            assert all(places[int(t)] == int(r)
                       for t, r in zip(rt[live], rank[live]))
            rank_of = np.zeros(256, np.int64)
            rank_of[(rt[live] >> 4) & 255] = rank[live]
            expw = [0] * 32
            for t, r in zip(rt[live], rank[live]):
                expw[r >> 3] |= int(t & 15) << (4 * (r & 7))
            masks, stop, d = chunk_walk(expw, n, d)
            steps[j] += stop
            more = d > 0 and any(masks)
            ch = rank_of >> 5
            moved = elig & (ch < len(masks))
            bits = np.array([(masks[c] >> (r & 31)) & 1 if c < len(masks)
                             else 0 for c, r in zip(ch, rank_of)])
            l = l - np.where(moved, bits, 0)
        nbits[j] = l
        max_bits[j] = l.max()
        ok[j] = d == 0 and int(present.sum()) >= 2
    return nbits, max_bits, ok, steps, passes


def deficit_scan(vals: np.ndarray, d: int):
    """The kernel's deficit: the counts in rank order -> (the counts after
    the steal, the steps the serial walk takes)."""
    a = np.maximum(vals - 1, 0)
    P = np.cumsum(a) - a
    take = np.minimum(a, np.maximum(d - P, 0))
    hit = np.flatnonzero(P + a >= d)
    return vals - take, int(hit[0]) + 1 if len(hit) else len(vals)


def serial_steal(vals: np.ndarray, d: int):
    """PR 21's steal walk over the counts in rank order, stopped where the
    deficit is paid: (the counts after it, steps, the deficit left)."""
    out, i = vals.copy(), 0
    while i < len(out):
        tk = min(max(int(out[i]) - 1, 0), d)
        d -= tk
        out[i] -= tk
        i += 1
        if d == 0:
            break
    return out, i, d


def model_normalize_count(hist: np.ndarray, log: int):
    """(norm, steps) as the kernel computes them; steps are the deficit
    walk's steps the scan reports (0 without a deficit)."""
    N, nsym = hist.shape
    T = (nsym + 31) // 32 * 32
    size = 1 << log
    s = np.arange(T, dtype=np.int64)
    inside = s < nsym
    out = np.zeros((N, nsym), np.int32)
    steps = np.zeros(N, np.int64)
    for r in range(N):
        h = np.zeros(T, np.int64)
        h[:nsym] = hist[r]
        total = max(int(h.sum()), 1)
        present = h > 0
        scaled = h * size
        base = scaled // total
        rem = scaled - base * total
        norm = np.where(present, np.maximum(base, 1), 0)
        diff = size - int(norm.sum())
        packed = _route(int(np.where(present, rem, 0).max())
                        | int(norm.max()), NC_TB)
        if diff > 0:
            key = np.where(present, rem, 0).astype(np.uint64)
            tag = np.where(present, 0, 1) << (NC_TB - 1) | s
            rk, rt, rank, n = sorted_rank(key, tag, NC_TB, packed)
            live = ((rt >> (NC_TB - 1)) & 1) == 0
            places = stable_places(key, tag, NC_TB)
            assert all(places[int(t)] == int(k)
                       for t, k in zip(rt[live], rank[live]))
            at = np.zeros(T, np.int64)
            at[rt[live]] = rank[live]
            norm = norm + (present & (at < diff))
        elif diff < 0:
            key = np.where(inside, norm, 0).astype(np.uint64)
            tag = np.where(inside, 0, 1) << (NC_TB - 1) | s
            rk, rt, rank, n = sorted_rank(key, tag, NC_TB, packed)
            live = ((rt >> (NC_TB - 1)) & 1) == 0
            assert n == nsym and sorted(rank[live]) == list(range(nsym))
            vals = np.zeros(nsym, np.int64)
            at = np.zeros(nsym, np.int64)
            vals[rank[live]] = rk[live].astype(np.int64)
            at[rank[live]] = rt[live]
            got, steps[r] = deficit_scan(vals, -diff)
            norm = norm.copy()
            norm[at] = got
        out[r] = norm[:nsym]
    return out, steps


def _huff_rows() -> np.ndarray:
    return np.concatenate([corpus.huff_build_hists(k)
                           for k in corpus.HUFF_BUILD_CLASSES])


def _hold_huff(hist: np.ndarray, maxlog: int):
    nbits, max_bits, ok, steps, passes = model_huff_build(hist, maxlog)
    want = zdev._huff_build_ref(torch.from_numpy(hist), maxlog)
    assert np.array_equal(nbits, want[0].numpy())
    assert np.array_equal(max_bits, want[1].numpy())
    assert np.array_equal(ok, want[2].numpy())
    # the walk never reads past the symbols that can step, 12 times
    assert (steps <= PASSES * 255).all() and (passes <= PASSES).all()
    return steps, passes


@pytest.mark.parametrize("maxlog", [8, 11])
@pytest.mark.parametrize("kind", corpus.HUFF_BUILD_CLASSES)
def test_huff_model_matches_plain(kind, maxlog):
    _hold_huff(corpus.huff_build_hists(kind), maxlog)


@pytest.mark.parametrize("maxlog", list(range(1, 16)))
def test_huff_model_wide_keys(maxlog):
    """Keys h << l of 2^54 and more (int64 rows), rows with no symbol that
    can step, maxlog 1 (no symbol ever steps) to 15."""
    rows = corpus.huff_build_wide_hists()
    keys = [int(x) << int(l) for r in rows
            for x, l in zip(r, _l0(r, maxlog)) if x]
    if maxlog >= 11:
        assert max(keys) >= 1 << 54
    steps, passes = _hold_huff(rows, maxlog)
    if maxlog == 1:
        assert (steps == 0).all()


def test_huff_model_walks_stop_early():
    """The early stops are what the kernel saves over the plain version's
    12 walks of every symbol that can step: most hostile and corpus rows
    run one or two passes (the hostile ones up to 12), and on the corpus
    rows the walks take under a tenth of the steps of 12 walks of the
    symbols that can step at the start."""
    hist = _huff_rows()
    _, _, _, steps, passes = model_huff_build(hist, 11)
    assert (passes <= 2).mean() > 0.7
    assert passes.max() > 2
    rows = corpus.huff_build_hists("corpus")
    _, _, _, steps, _ = model_huff_build(rows, 11)
    l0_steps = 0
    for r in rows.astype(np.int64):
        h = np.maximum(r, 1)
        ratio = (r.sum() + h - 1) // h
        l0_steps += PASSES * int(((r > 0) & (ratio > 2)).sum())
    assert steps.sum() * 10 < l0_steps


@pytest.mark.parametrize("T", [32, 64, 256, 1024])
def test_sorted_rank_is_the_stable_sort(T):
    """The sorted runs' ranks are a stable sort's places on keys that tie
    often, differ only in their low bits or pass 2^54, with a random share
    of dead pairs (whole dead runs too); the dead pairs sort last in each
    run and the live count is exact."""
    rng = np.random.default_rng(T)
    for trial in range(8):
        # keys for every route (small), for the 64-bit and exact ones (low
        # bits on 2^40), for the exact one alone (low bits on 2^60, and
        # any width up to 2^63)
        kind = trial % 4
        if kind == 0:
            key = rng.integers(0, 5, T).astype(np.uint64)
        elif kind in (1, 2):
            key = (np.uint64(1 << (40, 60)[kind - 1])
                   + rng.integers(0, 3, T).astype(np.uint64))
        else:
            key = rng.integers(0, 1 << 62, T, dtype=np.int64).astype(
                np.uint64) << np.uint64(1)
        dead = rng.random(T) < (0.0, 0.3, 0.9)[trial % 3]
        if T >= 64:
            dead[32:64] = True
        tag = np.where(dead, 1, 0) << (NC_TB - 1) | rng.permutation(T)
        routes = ((0, 32, 64), (0, 64), (0,), (0,))[kind]
        got = []
        for packed in routes:
            rk, rt, rank, n = sorted_rank(key, tag, NC_TB, packed)
            live = ((rt >> (NC_TB - 1)) & 1) == 0
            assert n == int((~dead).sum())
            places = stable_places(key, tag, NC_TB)
            assert sorted(rank[live]) == list(range(n))
            assert all(places[int(t)] == int(r)
                       for t, r in zip(rt[live], rank[live]))
            # in each run the live pairs come first
            for w in range(T // 32):
                lv = live[32 * w:32 * w + 32]
                assert not (lv[1:] & ~lv[:-1]).any()
            got.append((rt[live], rank[live]))
        # both routes hold the same pairs in the same places
        assert all(np.array_equal(a, b) for a, b in zip(got[0], got[-1]))


@pytest.mark.parametrize("n", [1, 31, 32, 33, 100, 255, 256])
def test_chunk_walk_equals_serial_walk(n):
    """The chunked walk takes what the serial walk takes, rank for rank,
    reports its steps (the step that paid d, + 1, or n) and leaves the same
    deficit, for deficits paid early, late, exactly at a chunk's end and
    never."""
    rng = np.random.default_rng(n)
    for maxlog in (2, 8, 11, 15):
        for _ in range(8):
            exps = list(rng.integers(0, maxlog - 1, n))
            total = sum(1 << e for e in exps)
            for d in {1, int(rng.integers(1, 1 << maxlog)),
                      min(total, (1 << maxlog) - 1),
                      sum(1 << e for e in exps[:32]) if n > 32 else 1}:
                if not 0 < d < 1 << 15:
                    continue
                expw = [0] * 32
                for r, e in enumerate(exps):
                    expw[r >> 3] |= int(e) << (4 * (r & 7))
                masks, steps, left = chunk_walk(expw, n, d)
                takes, want_steps, want_left = serial_walk(exps, d)
                got = [bool((masks[r >> 5] >> (r & 31)) & 1)
                       if (r >> 5) < len(masks) else False
                       for r in range(n)]
                assert got == takes + [False] * (n - len(takes))
                assert (steps, left) == (want_steps, want_left)


@pytest.mark.parametrize("nsym", [1, 2, 63, 64, 256, 1000, 1024])
def test_deficit_scan_equals_serial_steal(nsym):
    """The exclusive scan's takes equal the serial steal walk's, count for
    count, with its steps, on deficits paid at once, late and never (more
    singletons than the table holds), on counts in descending order as
    the rank gives them."""
    rng = np.random.default_rng(nsym)
    for _ in range(10):
        vals = np.sort(rng.choice([1, 1, 2, 3, 50, 1 << 20], nsym))[::-1]
        vals = vals.astype(np.int64)
        room = int(np.maximum(vals - 1, 0).sum())
        for d in {1, max(room // 2, 1), room, room + 1, room + 1000}:
            got, steps = deficit_scan(vals, d)
            want, want_steps, _ = serial_steal(vals, d)
            assert np.array_equal(got, want)
            assert steps == want_steps


@pytest.mark.parametrize("log", [5, 6, 7, 8, 9, 10, 11, 12])
@pytest.mark.parametrize("nsym", [64, 256])
def test_normalize_model_matches_plain(nsym, log):
    for kind in corpus.NORMALIZE_CLASSES:
        hist = corpus.normalize_hists(kind, nsym, log)
        norm, steps = model_normalize_count(hist, log)
        want = zdev._normalize_count_ref(torch.from_numpy(hist), log)
        assert np.array_equal(norm, want.numpy()), kind
        assert (steps <= nsym).all()
        if kind == "deficit":
            assert (steps > 0).any() and (steps[steps > 0] < nsym).any()


@pytest.mark.parametrize("log", [1, 5, 7, 9, 20, 30])
@pytest.mark.parametrize("nsym", [1, 33, 255, 1000, 1024])
def test_normalize_model_wide_and_widths(nsym, log):
    """Counts whose totals and remainders pass 2^54 (below log 8), NSYM 1
    to 1024, int64 rows; and the small counts of ``normalize_hists``'
    deficit and ties classes at these widths."""
    rows = [corpus.normalize_wide_hists(nsym, log)]
    if nsym >= 2:
        rows += [corpus.normalize_hists(k, nsym, min(log, 12)).astype(
            np.int64) for k in ("deficit", "ties")]
    for hist in rows:
        lg = log if hist is rows[0] else min(log, 12)
        if hist is rows[0] and log < 8:
            assert int(hist.sum(axis=1).max()) > 1 << 54
        norm, steps = model_normalize_count(hist, lg)
        want = zdev._normalize_count_ref(torch.from_numpy(hist), lg)
        assert np.array_equal(norm, want.numpy())
        assert (steps <= nsym).all()


def test_cpu_tensors_take_the_plain_versions():
    hist = torch.from_numpy(_huff_rows())
    before = zdev._huff_build.launches
    got = zdev._huff_build(hist, 11)
    assert zdev._huff_build.launches == before
    for a, b in zip(got, zdev._huff_build_ref(hist, 11)):
        assert torch.equal(a, b)
    counts = torch.from_numpy(corpus.normalize_hists("deficit", 64, 9))
    before = zdev._normalize_count.launches
    assert torch.equal(zdev._normalize_count(counts, 9),
                       zdev._normalize_count_ref(counts, 9))
    assert zdev._normalize_count.launches == before
    # another device is neither the kernel's nor the plain version's
    with pytest.raises(ValueError, match="CUDA tensor"):
        zdev._huff_build(torch.zeros((2, 256), dtype=torch.int64,
                                     device="meta"))
    with pytest.raises(ValueError, match="CUDA tensor"):
        zdev._normalize_count(torch.zeros((2, 64), dtype=torch.int64,
                                          device="meta"), 9)


def test_ab_tool_sends_the_calls_to_the_plain_versions():
    """``tools/tablebuild_ab.py``'s plain arm: inside ``plain_builds``
    every module the encoders look the two builds up in holds the plain
    versions, and the kernels' wrappers are back on exit."""
    from compress_tpu_torch.ops import entropy, zenc2
    from compress_tpu_torch.tools import tablebuild_ab

    wrappers = (zdev._huff_build, zdev._normalize_count)
    with tablebuild_ab.plain_builds():
        for m in (zdev, zenc2, entropy):
            assert m._huff_build is zdev._huff_build_ref
        for m in (zdev, entropy):
            assert m._normalize_count is zdev._normalize_count_ref
    for m in (zdev, zenc2, entropy):
        assert m._huff_build is wrappers[0]
    for m in (zdev, entropy):
        assert m._normalize_count is wrappers[1]
