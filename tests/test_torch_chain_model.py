"""A numpy model of the two sequence-encode chain kernels as
``csrc/zseqenc.cu`` runs them, held against the plain PyTorch versions
(``ops/zseqenc.rep_scan_ref``, ``fse_chain_ref``).

The kernels compute the reference's function with other steps, which no
CPU test can run; the model runs those steps on the CPU:

- repeat scan: in chunks of REP_CHUNK sequences with the state (r1, r2,
  r3) carried between chunks.  Where every live offset of a chunk is
  >= 1, every step sets r1 to its offset, so r1_t = off_{t-1}; a step
  keeps r2 and r3 (KEEP: t >= 3, ll != 0, off == r1) or swaps r1 and r2
  (SWAP: t >= 3, not KEEP, off == r2), else it pushes.  r2_t is r1 at the
  last non-KEEP step before t and r3_t is r2 at the last step before t
  that is neither: two prefix-maximum scans of step indices.  A chunk
  that holds a live offset <= 0 or within 3 of INT32_MAX (off + 3 wraps
  negative there and the step moves no state) is walked serially from
  the carried state;
- FSE chain: each stream is walked backward in chunks of FSE_CHUNK
  sequences, each chunk cut into FSE_LANES segments, one a lane.  Pass 1:
  each segment walks from a guessed entry state (the init rule at the
  step before it in chain order; the top segment's entry is exact) and
  records every state.  Pass 2, in rounds until nothing changes: a
  segment whose recorded entry differs from the exit of the segment
  before it re-walks from that exit and stops at the first state equal to
  the record.  Then every step's (value, nbits) comes from its state.

The model also counts pass 2's rounds and the lock-step steps of a warp
(pass 1's segment plus each round's longest re-walk), the numbers that
chose the segment count.  The kernel walks a chunk without the step's
clamps where they bind for no state (tables in [SIZE, 2 * SIZE), every
delta clamp-free); a test holds that route's step equal to the step.

Inputs: the sequences that the port's plain zparse and codes stage give
one seeded block per corpus class and one replica job (long-range
matches); hostile inputs: offsets from alphabets of 1-7 values with runs
of ll = 0, n_seqs of 0-4, MS and out of range, live offsets of 0, -5 and
near the int32 limits (the serial route), doped RLE streams, and a table
under which every trajectory is a permutation (no two ever merge, so pass
2 goes fully serial).  Tolerance 0: every output is an integer."""

import numpy as np
import pytest
import torch

from compress_tpu_torch import corpus
from compress_tpu_torch.ops import lzkern, zenc2, zparse, zseqenc
from compress_tpu_torch.zstd import device as zdevice

MS = zparse.MAXSEQ
SIZE = zseqenc.SIZE
REP_CHUNK = 2048     # the kernels' chunk lengths and lanes a stream
FSE_CHUNK = 2048
FSE_LANES = 32
I32_MAX = (1 << 31) - 1


# ---- repeat scan ------------------------------------------------------------

def _wrap32(x):
    """int64 values as int32 arithmetic leaves them."""
    return (x + (1 << 31)) % (1 << 32) - (1 << 31)


def _rep_val(off, ll0, r1, r2, r3, t):
    """The state machine's value of a step (int64 arrays holding int32
    values; off + 3 and r1 - 1 wrap as in int32)."""
    off3 = _wrap32(off + 3)
    val = np.where(~ll0,
                   np.where(off == r1, 1, np.where(
                       off == r2, 2, np.where(off == r3, 3, off3))),
                   np.where(off == r2, 1, np.where(
                       off == r3, 2, np.where(
                           (off == _wrap32(r1 - 1)) & (off > 0), 3, off3))))
    return np.where(t < 3, off3, val)


def _rep_serial(off, ll, c0, r):
    """One chunk walked step by step from state r: (values, state)."""
    r1, r2, r3 = r
    vals = np.zeros(len(off), np.int64)
    for j in range(len(off)):
        o, ll0, t = int(off[j]), ll[j] == 0, c0 + j
        v = int(_rep_val(np.int64(o), np.bool_(ll0), r1, r2, r3, t))
        swap = (not ll0 and v == 2) or (ll0 and v == 1)
        rot = (not ll0 and v == 3) or (ll0 and v == 2)
        push = v > 3 or (ll0 and v == 3)
        r1, r2, r3 = (r2 if swap else r3 if rot else o if push else r1,
                      r1 if (swap or rot or push) else r2,
                      r2 if (rot or push) else r3)
        vals[j] = v
    return vals, (r1, r2, r3)


def _excl_max(x):
    """Exclusive prefix maximum of step indices (-1 before any)."""
    inc = np.maximum.accumulate(x)
    return np.concatenate([[-1], inc[:-1]]), inc[-1]


def _rep_scan_chunk(off, ll, c0, r):
    """One chunk by the scan form (every live offset >= 1)."""
    r1c, r2c, r3c = r
    m = len(off)
    j = np.arange(m)
    t = c0 + j
    r1 = np.concatenate([[r1c], off[:-1]])               # r1_t = off_{t-1}
    keep = (t >= 3) & (ll != 0) & (off == r1)
    p, p_end = _excl_max(np.where(keep, -1, j))
    r2 = np.where(p >= 0, r1[np.maximum(p, 0)], r2c)
    swap = (t >= 3) & ~keep & (off == r2)
    q, q_end = _excl_max(np.where(keep | swap, -1, j))
    r3 = np.where(q >= 0, r2[np.maximum(q, 0)], r3c)
    vals = _rep_val(off, ll == 0, r1, r2, r3, t)
    # the state after the chunk: the same rules one step past its end
    r2e = r1[p_end] if p_end >= 0 else r2c
    r3e = r2[q_end] if q_end >= 0 else r3c
    return vals, (int(off[-1]), int(r2e), int(r3e))


def rep_model(of_v, ll_v, n_seqs, chunk=REP_CHUNK):
    """(R, MS) int32 values and the number of chunks walked serially."""
    of_v, ll_v = of_v.astype(np.int64), ll_v.astype(np.int64)
    R, ms = of_v.shape
    out = np.zeros((R, ms), np.int64)
    serial = 0
    for b in range(R):
        n = max(0, min(int(n_seqs[b]), ms))
        r = (1, 4, 8)
        for c0 in range(0, n, chunk):
            end = min(c0 + chunk, n)
            off, ll = of_v[b, c0:end], ll_v[b, c0:end]
            # the block-wide vote: the scan form needs off + 3 > 3
            if ((off <= 0) | (off > I32_MAX - 3)).any():
                vals, r = _rep_serial(off, ll, c0, r)
                serial += 1
            else:
                vals, r = _rep_scan_chunk(off, ll, c0, r)
            out[b, c0:c0 + len(off)] = vals
    return out.astype(np.int32), serial


# ---- FSE chain --------------------------------------------------------------

def _unpack(pk):
    return (pk >> 9) - 128, (pk & 511) - 128          # dnb, dfs


def _fse_next(st, pk, tab):
    dnb, dfs = _unpack(pk)
    nbc = np.clip((st + SIZE + dnb) >> 16, 0, 16)
    return tab[np.clip(((st + SIZE) >> nbc) + dfs, 0, SIZE - 1)] - SIZE


def _fse_init(pk, tab):
    dnb, dfs = _unpack(pk)
    nb0 = np.clip((dnb + (1 << 15)) >> 16, 0, 16)
    return tab[np.clip((((nb0 << 16) - dnb) >> nb0) + dfs, 0,
                       SIZE - 1)] - SIZE


def _fse_bits(st, pk):
    """(value, nbits) a step writes from state st."""
    dnb, _ = _unpack(pk)
    nb = (st + SIZE + dnb) >> 16
    nbc = np.clip(nb, 0, 16)
    return (st + SIZE) & ((1 << nbc) - 1), nb


def _walk_chunk(pk, tab, T, lo_c, top, n, above, lanes, stats):
    """Passes 1 and 2 of one stream over chunk [lo_c, top): T[i] for i in
    it, the state after step i.  ``above`` is T[top] (None for the chunk
    that holds n - 1)."""
    seg = -(-(top - lo_c) // lanes)
    k = np.arange(lanes)
    hi = top - k * seg
    lo = np.maximum(hi - seg, lo_c)
    live = hi > lo
    # ---- pass 1: the top lane starts exact, the others from a guess -----
    ent = np.where(live, _fse_init(pk[np.minimum(hi, n - 1)], tab), 0)
    start = hi - 1
    if above is None:                   # the top lane starts at n - 1
        T[n - 1] = _fse_init(pk[n - 1], tab)
        ent[0] = T[n - 1]
        start[0] = n - 2
    else:
        ent[0] = above
    cur = ent.copy()
    steps = int(seg)
    for s in range(seg):
        i = start - s
        act = live & (i >= lo)
        cur = np.where(act, _fse_next(cur, pk[np.maximum(i, 0)], tab), cur)
        T[i[act]] = cur[act]
    # ---- pass 2: re-walk from the exit before, stop where it meets ------
    rounds = 0
    while True:
        ex = np.concatenate([[0], T[np.maximum(lo[:-1], 0)]])
        need = live & (k > 0) & (ent != ex)
        if not need.any():
            break
        rounds += 1
        ent = np.where(need, ex, ent)
        cur = ent.copy()
        i = hi - 1
        go = need.copy()
        walked = 0
        while go.any():
            nxt = _fse_next(cur, pk[np.maximum(i, 0)], tab)
            met = go & (nxt == T[np.maximum(i, 0)])
            wr = go & ~met
            T[i[wr]] = nxt[wr]
            cur = np.where(wr, nxt, cur)
            i = np.where(go, i - 1, i)
            go = wr & (i >= lo)
            walked += 1
        steps += walked
    stats["rounds"].append(rounds)
    stats["steps"].append(steps)


def fse_model(pk_ll, pk_of, pk_ml, n_seqs, tables, lanes=FSE_LANES,
              chunk=FSE_CHUNK):
    """(val, nb, fin) int32 as ``fse_chain_ref``, and the counts: per
    block, stream and chunk the rounds of pass 2 and the lock-step steps
    (pass 1's segment plus each round's longest re-walk)."""
    pks = [np.asarray(p, np.int64) for p in (pk_ll, pk_of, pk_ml)]
    tabs = np.asarray(tables, np.int64)
    R, ms = pks[0].shape
    val = np.zeros((R, ms), np.int64)
    nbs = np.zeros((R, ms), np.int64)
    fin = np.zeros((R, 3), np.int64)
    stats = {"rounds": [], "steps": [], "block_steps": []}
    for b in range(R):
        n = max(0, min(int(n_seqs[b]), ms))
        if n == 0:
            continue
        # n_seqs past ms: every step is live, from state 0 (no init step)
        over = int(n_seqs[b]) > ms
        T = np.zeros((3, n + 1), np.int64)      # T[:, n]: the entry state
        above = [0] * 3 if over else [None] * 3
        last = n if over else n - 1             # steps that write bits
        top, steps = n, 0
        while top > 0:
            lo_c = max(0, top - chunk)
            st = {"rounds": [], "steps": []}
            for s in range(3):
                _walk_chunk(pks[s][b], tabs[s], T[s], lo_c, top, n, above[s],
                            lanes, st)
            stats["rounds"] += st["rounds"]
            stats["steps"] += st["steps"]
            steps += max(st["steps"])          # the three warps run at once
            # the output pass: step i writes from T[i + 1]
            i = np.arange(lo_c, min(top, last))
            if len(i):
                bits = [_fse_bits(T[s][i + 1], pks[s][b][i]) for s in range(3)]
                (v_ll, n_ll), (v_of, n_of), (v_ml, n_ml) = bits
                vv = (v_of | (v_ml << np.clip(n_of, 0, 16))
                      | (v_ll << np.clip(n_of + n_ml, 0, 26))) & 0xFFFFFFFF
                val[b, i] = vv
                nbs[b, i] = n_of + n_ml + n_ll
            above = [T[s][lo_c] for s in range(3)]
            top = lo_c
        fin[b] = T[:, 0]
        stats["block_steps"].append(steps)
    wrap = lambda x: ((x + (1 << 31)) % (1 << 32) - (1 << 31)).astype(
        np.int32)
    return wrap(val), wrap(nbs), wrap(fin), stats


# ---- inputs -----------------------------------------------------------------

def _parsed(blocks, off, L):
    ll, ml, of, _, n, _ = zparse.parse_blocks_ref(blocks, off, L)
    rep = zseqenc.rep_scan_ref(of, ll, n)
    pk_ll, pk_of, pk_ml, tables, *_ = zenc2._codes_stage(ll, ml, rep, n)
    return dict(ll=ll, of=of, n=n, rep=rep, chain=(pk_ll, pk_of, pk_ml, n,
                                                   tables))


@pytest.fixture(scope="module")
def corpus_seqs():
    """One seeded block per corpus class through the plain finder, zparse
    and codes stage."""
    blocks = torch.from_numpy(corpus.corpus_blocks(len(corpus.CLASSES), 0))
    off, L = lzkern.find_matches_blocks_ref(blocks)
    return _parsed(blocks, off, L)


@pytest.fixture(scope="module")
def replica_seqs():
    """One 256 KiB replica job (four blocks, long-range matches) as the
    encoder's parse sees it."""
    job = 256 << 10
    src = torch.from_numpy(corpus.replica_jobs(1, job, seed=3))
    jobs, pre, hp = zdevice.launch_inputs(src, 0, 1, job)
    blocks, off, L, _ = zenc2._merged_matches(jobs, pre, hp)
    return _parsed(blocks, off, L)


def _np(t):
    return t.numpy() if isinstance(t, torch.Tensor) else np.asarray(t)


def _hold_rep(of, ll, n, chunk=REP_CHUNK):
    want = zseqenc.rep_scan_ref(*(torch.from_numpy(np.asarray(a)) for a in (
        of, ll, n))).numpy()
    got, serial = rep_model(np.asarray(of), np.asarray(ll), np.asarray(n),
                            chunk)
    assert np.array_equal(got, want)
    return serial


def _hold_fse(chain, lanes=FSE_LANES, chunk=FSE_CHUNK):
    want = zseqenc.fse_chain_ref(*(torch.as_tensor(_np(a)) for a in chain))
    got = fse_model(*(_np(a) for a in chain), lanes=lanes, chunk=chunk)
    for a, b in zip(got[:3], want):
        assert np.array_equal(a, b.numpy())
    return got[3]


# ---- repeat scan against the plain version ----------------------------------

@pytest.mark.parametrize("chunk", [REP_CHUNK, 37])
def test_rep_model_on_corpus_classes(corpus_seqs, chunk):
    s = corpus_seqs
    assert _hold_rep(s["of"], s["ll"], s["n"], chunk) == 0


def test_rep_model_on_replica_job(replica_seqs):
    s = replica_seqs
    assert _hold_rep(s["of"], s["ll"], s["n"]) == 0


@pytest.mark.parametrize("kind,serial", [("alphabets", 0), ("n_seqs_edges", 0),
                                         ("serial_route", 6)])
def test_rep_model_hostile(kind, serial):
    """Small offset alphabets with runs of ll = 0; n_seqs 0-4, MS and out
    of range; chunks with a live offset of 0, -5, INT32_MIN or within 3 of
    INT32_MAX walk serially (six chunks), and INT32_MAX - 3, the largest
    offset the scan form takes, stays on it (``corpus.rep_inputs``)."""
    assert _hold_rep(*corpus.rep_inputs(kind)) == serial


# ---- FSE chain against the plain version ------------------------------------

def test_fse_model_on_corpus_classes(corpus_seqs):
    stats = _hold_fse(corpus_seqs["chain"])
    assert max(stats["rounds"]) < FSE_LANES


def test_fse_model_on_replica_job(replica_seqs):
    _hold_fse(replica_seqs["chain"])


@pytest.mark.parametrize("lanes,chunk", [(1, FSE_CHUNK), (7, 100), (32, 64)])
def test_fse_model_other_cuts(corpus_seqs, lanes, chunk):
    """The segmentation changes the steps, not the result."""
    _hold_fse(corpus_seqs["chain"], lanes, chunk)


def _clamp_free(pk):
    """The kernel's check (vectorised): for every state x = st + SIZE in
    [SIZE, 2 * SIZE), nb = (x + dnb) >> 16 lies in [0, 16] and (x >> nb) +
    dfs in [0, SIZE), so the step's clamps bind nowhere."""
    dnb, dfs = _unpack(np.asarray(pk, np.int64))
    x = np.arange(SIZE, 2 * SIZE)[:, None]
    nb = (x + dnb) >> 16
    lu = (x >> np.clip(nb, 0, 16)) + dfs
    return ((nb >= 0) & (nb <= 16) & (lu >= 0) & (lu < SIZE)).all(axis=0)


def _clamp_free_ends(pk):
    """The same check as the kernel computes it: nb takes at most two
    values over the 128 states, and the ends of each one's range of x
    decide."""
    dnb, dfs = _unpack(int(pk))
    lo, hi = (SIZE + dnb) >> 16, (2 * SIZE - 1 + dnb) >> 16
    if lo < 0 or hi > 16:
        return False
    edge = (hi << 16) - dnb if hi > lo else SIZE
    top_lo = edge - 1 if hi > lo else 2 * SIZE - 1
    return ((SIZE >> lo) + dfs >= 0 and (top_lo >> lo) + dfs <= SIZE - 1
            and (edge >> hi) + dfs >= 0
            and ((2 * SIZE - 1) >> hi) + dfs <= SIZE - 1)


def test_fse_fast_step_is_exact_where_clamp_free(corpus_seqs):
    """The kernel walks a chunk without the step's clamps where its tables
    lie in [SIZE, 2 * SIZE) and every delta is clamp-free: there the
    unclamped step equals the step, for every state.  The corpus's chains
    take that route throughout; the random deltas of the hostile inputs
    mostly do not (the clamped route)."""
    pk_ll, pk_of, pk_ml, n, tables = (_np(a) for a in corpus_seqs["chain"])
    tables = np.asarray(tables, np.int64)
    assert ((tables >= SIZE) & (tables < 2 * SIZE)).all()
    rnd = corpus.fse_inputs("random_edges")
    for s, pk in enumerate((pk_ll, pk_of, pk_ml)):
        live = np.concatenate([pk[b, :max(0, min(int(k), MS))]
                               for b, k in enumerate(n)])
        edge = zseqenc.pack_deltas(np.arange(-128, 1 << 17, 997)[:, None],
                                   np.arange(-128, 384, 37)[None, :])
        vals = np.unique(np.concatenate([live, [128 << 9],
                                         np.unique(rnd[s])[:200],
                                         edge.reshape(-1)]))
        ok = _clamp_free(vals)
        assert all(ok[i] == _clamp_free_ends(v) for i, v in enumerate(vals))
        assert _clamp_free(np.unique(live)).all()
        assert not ok.all()
        dnb, dfs = _unpack(vals[ok].astype(np.int64))
        x = np.arange(SIZE, 2 * SIZE)[:, None]
        fast = tables[s][(x >> ((x + dnb) >> 16)) + dfs]
        assert np.array_equal(fast - SIZE, _fse_next(x - SIZE, vals[ok],
                                                     tables[s]))


def test_fse_model_random_edges():
    """Random deltas and tables at n_seqs 0-4, MS, past MS (every step
    live, from state 0) and negative."""
    _hold_fse(corpus.fse_inputs("random_edges"))


def test_fse_model_doped_rle_stream():
    """A doped stream (dnb = dfs = -128, table all 128) stays at state 0
    and writes no bits; its lanes never re-walk."""
    stats = _hold_fse(corpus.fse_inputs("doped_rle"))
    assert max(stats["rounds"][1::3]) == 0


def test_fse_model_permutation_goes_serial():
    """Every step maps the 128 states by one permutation, so no two
    trajectories ever meet: pass 2 fixes one segment a round, the serial
    walk's work."""
    stats = _hold_fse(corpus.fse_inputs("permutation"))
    assert max(stats["rounds"]) >= FSE_LANES - 3
    assert max(stats["block_steps"]) >= MS // 2


def main() -> None:
    """Print the model's re-walk counts on one 4 MiB replica job (seed 0,
    64 blocks, the zstd encoder's parse): per segmentation, pass 2's mean
    and largest rounds, and the lock-step steps of the slowest block
    against its sequences and all blocks' against all sequences (the
    serial walk's work).  ``PYTHONPATH=. python
    tests/test_torch_chain_model.py`` from the repository root, about
    three minutes on a CPU."""
    job = 4 << 20
    src = torch.from_numpy(corpus.replica_jobs(1, job, seed=0))
    jobs, pre, hp = zdevice.launch_inputs(src, 0, 1, job)
    s = _parsed(*zenc2._merged_matches(jobs, pre, hp)[:3])
    n = s["n"].numpy()
    live = n[n > 0]
    for lanes, chunk in ((FSE_LANES, FSE_CHUNK), (FSE_LANES, 2 * FSE_CHUNK),
                         (2 * FSE_LANES, FSE_CHUNK), (FSE_LANES // 2,
                                                      FSE_CHUNK)):
        st = _hold_fse(s["chain"], lanes, chunk)
        steps = np.array(st["block_steps"])
        print(f"{lanes} lanes, chunk {chunk}: rounds mean "
              f"{np.mean(st['rounds']):.2f} max {max(st['rounds'])}; "
              f"slowest block {steps.max()} steps for "
              f"{live[steps.argmax()]} sequences; all blocks "
              f"{steps.sum()} steps for {live.sum()} sequences")
    print(f"repeat scan: {_hold_rep(s['of'], s['ll'], s['n'])} chunks "
          f"walked serially")


if __name__ == "__main__":
    main()
