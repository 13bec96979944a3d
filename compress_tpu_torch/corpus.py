"""Seeded 64 KiB test blocks for the device encoders.

Every block is generated from a numpy seed, so the tests and
``chip_smoke.py`` need no external files.  The classes cover what the
encoder's stages react to:

- ``text``: Zipf-distributed words from a word list kept in this file
  (matches at many offsets, literal runs);
- ``rand4``: 4-symbol random bytes (short matches everywhere);
- ``zeros``: one run (offset-1 probes, chain extension across tiles);
- ``rand256``: incompressible bytes (literals only);
- ``period7``: a period-7 pattern (chain extension, cross-tile merge);
- ``period3``: period-3 runs between random stretches (offset-3 probes
  that start and stop inside tiles);
- ``gate``: a period-3 run that ends exactly at a 512-position tile
  boundary, followed by an offset-5 copy: the cross-tile merge must not
  absorb the next tile's length (the terminal gate);
- ``boundary``: many runs of assorted periods that end exactly on tile
  boundaries, some crossing whole tiles, each followed by a short copy at
  the same offset (the merge absorbs it) or another one (the gate holds).
"""

from __future__ import annotations

import numpy as np

BS = 1 << 16
TILE = 512

_WORDS = (
    "the of and to a in that is was he for it with as his on be at by had "
    "not are but from or have an they which one you were her all she there "
    "would their we him been has when who will more no if out so said what "
    "up its about into than them can only other new some could time these "
    "two may then do first any my now such like our over man me even most "
    "made after also did many before must through back years where much "
    "your way well down should because each just those people how too "
    "little state good very make world still own see men work long get "
    "here between both life being under never day same another know while "
    "last might us great old year off come since against go came right "
    "used take three Tom Sawyer Huck Becky Aunt Polly river cave island "
    "village fence whitewash treasure"
).split()

CLASSES = ("text", "rand4", "zeros", "rand256", "period7", "period3", "gate",
           "boundary")


def _text(rng: np.random.Generator) -> np.ndarray:
    words = [w.encode() for w in _WORDS]
    p = 1.0 / np.arange(1, len(words) + 1) ** 1.1
    p /= p.sum()
    seps = (b" ", b" ", b" ", b" ", b", ", b".\n")
    out = bytearray()
    while len(out) < BS:
        idx = rng.choice(len(words), size=4096, p=p)
        sep = rng.integers(0, len(seps), size=4096)
        out += b"".join(words[i] + seps[s] for i, s in zip(idx, sep))
    return np.frombuffer(bytes(out[:BS]), np.uint8)


def _period(rng: np.random.Generator, k: int) -> np.ndarray:
    pat = rng.integers(0, 9, k, np.uint8).tobytes()
    return np.frombuffer((pat * (BS // k + 1))[:BS], np.uint8)


def _period3_runs(rng: np.random.Generator) -> np.ndarray:
    blk = rng.integers(0, 256, BS, dtype=np.uint8)
    p = 0
    while p < BS:
        rand_len = int(rng.integers(16, 1024))
        run_len = int(rng.integers(64, 2048))
        q = min(p + rand_len, BS)
        e = min(q + run_len, BS)
        pat = rng.integers(0, 256, 3, dtype=np.uint8)
        blk[q:e] = pat[np.arange(e - q) % 3]
        p = e
    return blk


def _gate(rng: np.random.Generator) -> np.ndarray:
    # with rng = default_rng(0) this is tests/test_lzemit.py's crafted block
    blk = rng.integers(0, 256, BS, dtype=np.uint8)
    p0 = 100
    pat = np.array([65, 66, 67], np.uint8)
    idx = np.arange(p0, 1024)
    blk[idx] = pat[(idx - p0) % 3]
    for i in range(1024, 1032):
        blk[i] = blk[i - 5]
    return blk


def _tile_boundaries(rng: np.random.Generator) -> np.ndarray:
    blk = rng.integers(0, 256, BS, dtype=np.uint8)
    t = 1
    while True:
        p = int(rng.choice((1, 2, 3, 4, 5, 7, 8, 11)))
        span = int(rng.integers(0, 4))  # whole tiles the run crosses
        start = t * TILE - int(rng.integers(8, 400))
        end = (t + span) * TILE
        tail = int(rng.integers(4, 40))
        if end + tail > BS - 64:
            return blk
        pat = rng.integers(0, 256, p, dtype=np.uint8)
        blk[start:end] = pat[np.arange(end - start) % p]
        q = p if rng.random() < 0.3 else int(rng.choice((2, 3, 5, 6, 9, 17)))
        for i in range(end, end + tail):
            blk[i] = blk[i - q]
        t += span + 2


def make_block(kind: str, rng: np.random.Generator) -> np.ndarray:
    """One (65536,) uint8 block of the given class."""
    if kind == "text":
        return _text(rng)
    if kind == "rand4":
        return rng.integers(0, 4, BS).astype(np.uint8)
    if kind == "zeros":
        return np.zeros(BS, np.uint8)
    if kind == "rand256":
        return rng.integers(0, 256, BS).astype(np.uint8)
    if kind == "period7":
        return _period(rng, 7)
    if kind == "period3":
        return _period3_runs(rng)
    if kind == "gate":
        return _gate(rng)
    if kind == "boundary":
        return _tile_boundaries(rng)
    raise ValueError(f"unknown block class {kind!r}")


FINDER_CLASSES = ("zeros", "unique", "far_pair", "wrap", "one_bin")


def _de_bruijn_bytes() -> np.ndarray:
    """The least de Bruijn sequence B(256, 2), 65536 bytes: every byte pair
    occurs once, cyclically, so no 4-byte word repeats, wrapped or not."""
    parts = []
    for a in range(256):
        b = np.arange(a + 1, 256)
        parts += [[a], np.stack([np.full_like(b, a), b], 1).ravel()]
    return np.concatenate(parts).astype(np.uint8)


def finder_block(kind: str) -> np.ndarray:
    """One (65536,) uint8 block that stresses the match finder's sort:

    - ``zeros``: one chain of offset 1;
    - ``unique``: no 4-byte word repeats (a de Bruijn sequence);
    - ``far_pair``: ``unique`` with the word at 0 repeated at 65532, the
      largest offset that can match;
    - ``wrap``: random bytes whose last 16 repeat an earlier stretch, and
      whose first 16 repeat the stretch after it, so suffix compares near
      the end read equal bytes past the block end;
    - ``one_bin``: zeros but for one byte, so every byte-digit pass of a
      radix sort puts all positions but one in one bin."""
    if kind == "zeros":
        return np.zeros(BS, np.uint8)
    if kind in ("unique", "far_pair"):
        blk = _de_bruijn_bytes()
        if kind == "far_pair":
            blk[BS - 4:] = blk[:4]
        return blk
    if kind == "wrap":
        blk = np.random.default_rng(5).integers(0, 256, BS, dtype=np.uint8)
        blk[BS - 16:] = blk[1000:1016]
        blk[:16] = blk[1016:1032]
        return blk
    if kind == "one_bin":
        blk = np.zeros(BS, np.uint8)
        blk[40000] = 1
        return blk
    raise ValueError(f"unknown finder block {kind!r}")


def corpus_blocks(n_blocks: int, seed: int = 0) -> np.ndarray:
    """(n_blocks, 65536) uint8: block i is of class
    CLASSES[i % len(CLASSES)], made from its own generator seeded by
    (seed, i)."""
    out = np.empty((n_blocks, BS), np.uint8)
    for i in range(n_blocks):
        rng = np.random.default_rng([seed, i])
        out[i] = make_block(CLASSES[i % len(CLASSES)], rng)
    return out


def replica_jobs(n_jobs: int, job: int, seed: int = 0) -> np.ndarray:
    """(n_jobs * job,) uint8 for the zstd encoder's long-range channel:
    each job is job / 2 bytes of corpus blocks (the classes in turn)
    followed by a copy of them that starts an odd number of bytes in, so
    the copy lies at offsets near job / 2 that are not a multiple of 16."""
    half = job // 2
    if half % BS:
        raise ValueError(f"job / 2 must be a multiple of {BS}, got {half}")
    out = np.empty((n_jobs, 2, half), np.uint8)
    for j in range(n_jobs):
        out[j, 0] = corpus_blocks(half // BS, seed * 1009 + j).reshape(-1)
        shift = 2 * int(np.random.default_rng([seed, j]).integers(0, BS)) + 1
        out[j, 1] = np.roll(out[j, 0], -shift)
    return out.reshape(-1)


def exec_hostile_plans(M: int) -> list:
    """Execute plans (``ops/execute`` plan dicts) for an arena of class M
    that stress the LZ execute: one block of hand pieces that read below
    the arena (row 0) and past it (its last output row), write dst rows
    below and past it (they write nothing) and run past their row end
    (cut there); and three planner blocks of overlapping copies at periods
    1, 2 and 3 (one piece per period, each reading the round before)."""
    from compress_tpu_torch.ops.execute import OUT_BASE, plan_block_ops

    base = M * OUT_BASE
    top = 2 * M * OUT_BASE            # first byte past the arena
    hand = dict(
        src=np.array([-300, -5, top + 900, top - 3, 7, 9, 11, base + 4],
                     np.int32),
        dst=np.array([base, base + 130, base + 300, base + 500, -128,
                      top, top + 4000, base + 1000], np.int32),
        len=np.array([20, 40, 10, 12, 30, 30, 30, 200], np.int32),
        round=np.array([0, 0, 0, 1, 0, 1, 0, 1], np.int32), n_rounds=2)
    plans = [hand]
    for period in (1, 2, 3):
        p = plan_block_ops([0, 1, 0, 1], [period, 700, 5, 300],
                           [0, period, 0, period], max_rounds=2)
        shift = (M - 1) * OUT_BASE     # the output half starts M times later
        plans.append(dict(p, dst=(p["dst"] + shift).astype(np.int32),
                          src=np.where(p["src"] >= OUT_BASE,
                                       p["src"] + shift,
                                       p["src"]).astype(np.int32)))
    return plans


EXEC_SUM_CLASSES = ("literal_half", "double_write", "same_round_read")


def exec_sum_plans() -> dict:
    """Execute plans (``ops/execute`` plan dicts, arena class M = 1) on
    which a plain store differs from the reference's sum of each round's
    strips: a piece that writes the literal half (round 1, read back by
    round 2); a byte written twice in one round and again in a later
    round (whose other piece reads bytes of its own round); pieces that
    read bytes their own round writes."""
    from compress_tpu_torch.ops.execute import OUT_BASE as out

    def plan(src, dst, length, rnd):
        return dict(src=np.array(src, np.int32), dst=np.array(dst, np.int32),
                    len=np.array(length, np.int32),
                    round=np.array(rnd, np.int32), n_rounds=max(rnd) + 1)

    return {
        "literal_half": plan([3, out + 5, 2], [out, 7, out + 40], [9, 4, 12],
                             [0, 1, 2]),
        "double_write": plan([10, 20, 30, out + 2],
                             [out, out + 4, out + 2, out + 60], [8, 8, 4, 8],
                             [0, 0, 1, 1]),
        "same_round_read": plan([5, out, out + 100], [out, out + 3, out + 130],
                                [16, 20, 40], [0, 0, 0]),
    }


PARSE_CLASSES = ("all_zeros", "chains", "most_seqs", "no_match")


def parse_inputs(kind: str, cap: int = 10):
    """(block (65536,) uint8, off, L (65536,) int32): a block and a
    finder channel that stress the parse stages of the S2 emit and zstd
    parse kernels at the chain extension's ``cap`` (the finder's 10 by
    default):

    - ``all_zeros``: all zeros, offset 1 and L = cap everywhere: every
      position chains (a cap of 4 or more) and the offset-1 probe covers
      every tile;
    - ``chains``: random bytes (no probe fires) with offset 7 and L = cap,
      chains broken at 300 random positions (L = cap - 1 there);
    - ``most_seqs``: random bytes, L = 6 and offsets below 1024 everywhere:
      the zstd gate passes every match, so the greedy parse takes one every
      6 positions, 85 a tile, the most sequences a block can hold;
    - ``no_match``: random bytes and no match: literals only.
    The last 3 positions never match, as from the finder."""
    rng = np.random.default_rng(PARSE_CLASSES.index(kind) + 17)
    g = np.arange(BS)
    if kind == "all_zeros":
        blk = np.zeros(BS, np.uint8)
        off = np.where(g >= 1, 1, 0)
        L = np.where(g >= 1, cap, 0)
    elif kind == "chains":
        blk = rng.integers(0, 256, BS, dtype=np.uint8)
        off = np.where(g >= 7, 7, 0)
        L = np.where(g >= 7, cap, 0)
        L[rng.integers(0, BS, 300)] = cap - 1
    elif kind == "most_seqs":
        blk = rng.integers(0, 256, BS, dtype=np.uint8)
        off = np.minimum(rng.integers(1, 1024, BS), g)
        L = np.where(off > 0, 6, 0)
    elif kind == "no_match":
        blk = rng.integers(0, 256, BS, dtype=np.uint8)
        off = np.zeros(BS, np.int64)
        L = np.zeros(BS, np.int64)
    else:
        raise ValueError(f"unknown parse input {kind!r}")
    L[BS - 3:] = 0
    off = np.where(L > 0, off, 0)
    return blk, off.astype(np.int32), L.astype(np.int32)


_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1
REP_CLASSES = ("alphabets", "n_seqs_edges", "serial_route")


def rep_inputs(kind: str):
    """(of, ll (R, MAXSEQ) int32, n_seqs (R,) int32): repeat-offset scan
    inputs that stress the scan form and its serial route:

    - ``alphabets``: 12 blocks whose offsets come from an alphabet of 1-7
      values, with ll = 0 in runs of 8 at a random rate, n_seqs up to 600
      and one block of MAXSEQ (the zstd parse's sequence slots);
    - ``n_seqs_edges``: such blocks with n_seqs 0, 1, 2, 3, 4, MAXSEQ, past
      it and negative;
    - ``serial_route``: such blocks with a live offset of 0, of -5, of 0
      in a second 2048-sequence chunk, of INT32_MIN, and within 3 of
      INT32_MAX (off + 3 wraps negative in int32 and the step moves no
      state): chunks the scan form does not hold for; and one of
      INT32_MAX - 3, the largest the scan form takes, among ordinary
      ones."""
    from compress_tpu_torch.ops.zparse import MAXSEQ

    seed = REP_CLASSES.index(kind) + 31
    rng = np.random.default_rng(seed)
    R = {"alphabets": 12, "n_seqs_edges": 8, "serial_route": 7}[kind]
    of = np.zeros((R, MAXSEQ), np.int32)
    ll = np.zeros((R, MAXSEQ), np.int32)
    for b in range(R):
        alpha = rng.choice(np.arange(1, 12), rng.integers(1, 8), replace=False)
        of[b] = rng.choice(alpha, MAXSEQ)
        zero = rng.random(MAXSEQ // 8 + 1) < rng.uniform(0, 0.9)
        ll[b] = np.where(np.repeat(zero, 8)[:MAXSEQ], 0,
                         rng.integers(1, 50, MAXSEQ))
    if kind == "alphabets":
        n = rng.integers(0, 600, R)
        n[0] = MAXSEQ
    elif kind == "n_seqs_edges":
        n = np.array([0, 1, 2, 3, 4, MAXSEQ, MAXSEQ + 5, -3])
    else:
        n = np.array([300, 300, 2500, 300, 300, 40, 700])
        of[0, 120] = 0
        of[1, 7] = -5
        of[2, 2100] = 0
        of[3, 50:60] = _I32_MIN
        of[4, 10:200:3] = _I32_MAX
        of[4, 11:200:3] = _I32_MAX - 1
        of[5, :40] = _I32_MAX - np.arange(40) % 3
        of[6, 100:110] = _I32_MAX - 3
    return of, ll, n.astype(np.int32)


FSE_CLASSES = ("random_edges", "doped_rle", "permutation")


def fse_inputs(kind: str):
    """(pk_ll, pk_of, pk_ml (R, MAXSEQ) int32, n_seqs (R,) int32, tables
    (3, 128) int32): FSE chain inputs, deltas packed as
    (dnb + 128) << 9 | (dfs + 128):

    - ``random_edges``: random deltas and tables, n_seqs 0, 1, 2, 3, 4,
      MAXSEQ, past it (every step live, from state 0) and negative;
    - ``doped_rle``: the offset stream doped as an RLE stream (dnb = dfs =
      -128, table all 128: state 0, no bits), the others random, on
      blocks of 5000 and 300 sequences;
    - ``permutation``: every stream maps the 128 states by one random
      permutation at every step (dnb = 0, dfs = -128: no bits, the lookup
      at the state itself), so no two trajectories ever meet, on blocks
      of MAXSEQ and 3000 sequences."""
    from compress_tpu_torch.ops.zparse import MAXSEQ

    rng = np.random.default_rng(FSE_CLASSES.index(kind) + 53)

    def pack(dnb, dfs):
        return (((dnb + 128) << 9) | (dfs + 128)).astype(np.int32)

    if kind == "permutation":
        n = np.array([MAXSEQ, 3000])
        tables = np.stack([rng.permutation(128) + 128 for _ in range(3)])
        pk = np.full((len(n), MAXSEQ), pack(np.int64(0), np.int64(-128)))
        return pk, pk.copy(), pk.copy(), n.astype(np.int32), \
            tables.astype(np.int32)
    n = (np.array([0, 1, 2, 3, 4, MAXSEQ, MAXSEQ + 7, -1])
         if kind == "random_edges" else np.array([5000, 300]))
    pks = [pack(rng.integers(-128, 8 << 16, (len(n), MAXSEQ)),
                rng.integers(-128, 128, (len(n), MAXSEQ))) for _ in range(3)]
    tables = rng.integers(0, 256, (3, 128))
    if kind == "doped_rle":
        pks[1][:] = pack(np.int64(-128), np.int64(-128))
        tables[1] = 128
    return (*pks, n.astype(np.int32), tables.astype(np.int32))
