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


def history_streams(n: int, size: int = 1 << 20, seed: int = 0) -> list:
    """n streams of ``size`` bytes (a whole number of 64 KiB blocks) for
    the multi-block accel route: each block is seeded text in which, from
    the second block on, stretches of 512 bytes to 8 KiB repeat the stream
    1 to 7 blocks back (as far as the stream reaches) at odd shifts, so
    the matches of a frame that keeps 8 blocks of history reach every
    distance it holds, from before and across block boundaries."""
    if size % BS:
        raise ValueError(f"size must be a multiple of {BS}, got {size}")
    out = []
    for j in range(n):
        rng = np.random.default_rng([seed, 21, j])
        buf = np.empty(size, np.uint8)
        for i in range(size // BS):
            lo = i * BS
            buf[lo:lo + BS] = _text(rng)
            for _ in range(6 if i else 0):
                back = int(rng.integers(1, min(7, i) + 1))
                n_rep = int(rng.integers(512, 8192))
                at = lo + int(rng.integers(0, BS - n_rep))
                src = at - back * BS + 2 * int(rng.integers(0, 64)) + 1
                buf[at:at + n_rep] = buf[src:src + n_rep]
        out.append(buf.tobytes())
    return out


def hist_plans(hb: int) -> list:
    """Per-frame lists of execute plans (``ops/execute`` plan dicts) of
    64 KiB blocks with a history of ``hb`` blocks that stress the history
    executor: history pieces that read before the frame's first byte
    (zeros), across it, at the history's first and last bytes and into
    the zero tail of a short non-final block (its whole 512-row output
    shifts into the history), beside literal pieces and output reads of
    later rounds; frames of 3, 2 and 1 blocks."""
    from compress_tpu_torch.ops.execute import HIST_BASE, OUT_BASE

    top = HIST_BASE + (hb << 16)    # block position 0 of the history

    def plan(*pieces):              # (src, output position, len, round)
        src, pos, ln, rnd = (np.array(c, np.int64) for c in zip(*pieces))
        return dict(src=src.astype(np.int32),
                    dst=(OUT_BASE + pos).astype(np.int32),
                    len=ln.astype(np.int32), round=rnd.astype(np.int32),
                    n_rounds=int(rnd.max()) + 1)

    deep = [(top - 2 * BS + 256, 5120, 100, 0)] if hb >= 2 else []
    three = [
        plan((top - 1000, 0, 100, 0), (HIST_BASE, 128, 128, 0),
             (5, 256, 100, 0), (OUT_BASE + 256, 512, 50, 1),
             (OUT_BASE + 512, 640, 20, 2)),
        plan((top - BS + 300, 0, 60, 0), (top - BS - 20, 1024, 40, 0),
             (top - 1, 2000, 1, 0), (7, 3072, 128, 0),
             (OUT_BASE + 3072, 3200, 100, 1)),
        plan((top - BS + 2000, 4000, 1, 0), (top - BS + 1024, 4096, 40, 0),
             (HIST_BASE, 4224, 16, 0), (11, 4352, 64, 0), *deep),
    ]
    short = [
        plan((0, 0, 128, 0), (128, 128, 128, 0), (OUT_BASE, 1000, 24, 1)),
        plan((top - BS + 900, 0, 100, 0), (top - BS + 1000, 128, 100, 0),
             (3, 256, 8, 0)),
    ]
    one = [plan((top - 64, 64, 64, 0), (9, 0, 64, 0),
                (OUT_BASE + 64, 128, 64, 1))]
    return [three, short, one]


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


def v1_rep_inputs(ms: int, seed: int = 0):
    """(of, ll (8, ms) int32, n_seqs (8,) int32): repeat-offset scan inputs
    at the zstd v1 engine's sequence slots (ms = 2,731 for its 16 KiB
    blocks, 1,366 for 8 KiB): offsets from alphabets of 1-7 values (every
    repeat rule fires), ll = 0 in runs of 8, n_seqs 0, 1, 3, 4, ms and
    random; block 5's live offsets are within 3 of INT32_MAX (off + 3
    wraps negative in int32) and block 6's are INT32_MAX - 3 and below."""
    rng = np.random.default_rng([seed, ms])
    R = 8
    of = np.zeros((R, ms), np.int32)
    ll = np.zeros((R, ms), np.int32)
    for b in range(R):
        alpha = rng.choice(np.arange(1, 1 << 20), rng.integers(1, 8),
                           replace=False)
        of[b] = rng.choice(alpha, ms)
        zero = rng.random(ms // 8 + 1) < rng.uniform(0, 0.9)
        ll[b] = np.where(np.repeat(zero, 8)[:ms], 0,
                         rng.integers(1, 50, ms))
    of[5] = _I32_MAX - rng.integers(0, 4, ms)
    of[6] = _I32_MAX - 3 - rng.integers(0, 3, ms)
    n = np.array([0, 1, 3, 4, ms, ms, ms, rng.integers(5, ms)], np.int32)
    return of, ll, n


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


HUFF0_CLASSES = ("cursor_edges", "nsym_edges", "mb1", "all_11bit",
                 "all_1bit", "nb_zero", "random_table", "wide_entries",
                 "k20", "per_row_3", "per_row_100", "per_row_256",
                 "per_row_300", "k7", "k64")


def prefix_table(rng: np.random.Generator, mb: int, split: float = 0.6,
                 nb0: float = 0.0) -> np.ndarray:
    """A (2^mb,) int32 table sym | nb << 8 of a random prefix code of at
    most mb bits, as ``expand_table`` lays out a Huffman table: the space
    cut into aligned blocks by random halvings (each block halves with
    probability ``split``), a block of 2^s entries holding one symbol of
    mb - s bits; a share ``nb0`` of the blocks gets nb = 0."""
    size = 1 << mb
    tab = np.zeros(size, np.int64)
    stack = [(0, size)]
    while stack:
        lo, n = stack.pop()
        if n > 1 and (n == size or rng.random() < split):
            stack += [(lo, n // 2), (lo + n // 2, n // 2)]
            continue
        nb = 0 if rng.random() < nb0 else mb - (n.bit_length() - 1)
        tab[lo:lo + n] = int(rng.integers(0, 256)) | nb << 8
    return tab.astype(np.int32)


def huff0_inputs(kind: str) -> dict:
    """Chunk-decode inputs that stress the huff0 chunk kernel's steps (the
    bit container, the tile and table-row staging, the symbol stores), as a
    dict: windows (NC, win) uint8, lbit and nsym (NC,) int32, tables
    (rows, 2^max_bits) int32, per_row (0: one shared table), k, max_bits.

    - ``cursor_edges``: cursors 0, 1, below and at the peek width, at the
      window's top, just past it and far past it, and negative;
    - ``nsym_edges``: nsym 0, 1, odd, k, above k and negative;
    - ``mb1``: a 1-bit table; ``all_11bit``: every code 11 bits;
      ``all_1bit``: two 1-bit codes in an 11-bit table; ``nb_zero``:
      prefix tables with nb = 0 blocks;
    - ``random_table``: random symbols and nb from 0 to 20 with no prefix
      structure;
    - ``wide_entries``: a prefix table with entries of 2^16 and more (nb
      above 255);
    - ``k20``: k = 20, not a multiple of 16; ``k7``: k = 7, not a
      multiple of 4 (the symbols leave the kernel as bytes); ``k64``: k =
      64, above what the kernel stages (symbols go straight to device
      memory);
    - ``per_row_C``: one 11-bit prefix table per row of C chunks, C below,
      at and above a 256-chunk tile (several rows a tile at C = 3 and
      100).  The per-row classes keep the cursors inside the 52-byte
      window, as the reference's per-container scan reads them."""
    rng = np.random.default_rng(HUFF0_CLASSES.index(kind) + 71)
    win, k, mb, per_row, rows = 52, 32, 11, 0, 1
    nc = 1500
    if kind.startswith("per_row_"):
        per_row = int(kind[len("per_row_"):])
        rows = max(3, -(-1200 // per_row))
        nc = rows * per_row
    windows = rng.integers(0, 256, (nc, win)).astype(np.uint8)
    lbit = rng.integers(8 * win - 7, 8 * win + 1, nc)
    low = rng.random(nc) < 0.3
    lbit[low] = rng.integers(0, 8 * win + 1, int(low.sum()))
    nsym = rng.integers(0, k + 1, nc)
    tabs = None
    if kind == "cursor_edges":
        edges = [0, 1, 5, mb - 1, mb, mb + 1, 8 * win - 1, 8 * win,
                 8 * win + 1, 8 * win + 5, 8 * win + 40, 1 << 20, -1, -7,
                 -200]
        lbit[:len(edges) * 20] = np.repeat(edges, 20)
    elif kind == "nsym_edges":
        mb = 8
        edges = [0, 1, 2, 3, 15, 17, 31, 32, 33, 1000, -1, -5]
        nsym[:len(edges) * 20] = np.repeat(edges, 20)
    elif kind == "mb1":
        mb = 1
        tabs = np.array([[int(rng.integers(0, 256)) | 1 << 8,
                          int(rng.integers(0, 256)) | 1 << 8]], np.int32)
    elif kind == "all_11bit":
        tabs = (rng.integers(0, 256, (1, 2048)) | 11 << 8).astype(np.int32)
    elif kind == "all_1bit":
        tabs = np.repeat([[0x141, 0x1aa]], 1024, axis=1).astype(np.int32)
    elif kind == "nb_zero":
        mb = 9
        tabs = prefix_table(rng, mb, nb0=0.15)[None]
    elif kind == "random_table":
        tabs = (rng.integers(0, 256, (1, 2048))
                | rng.integers(0, 21, (1, 2048)) << 8).astype(np.int32)
        tabs[0, 512:1024] = tabs[0, 512]          # a constant stretch
    elif kind == "wide_entries":
        mb = 10
        tabs = prefix_table(rng, mb)[None].astype(np.int64)
        tabs[0, rng.integers(0, 1 << mb, 20)] = (
            rng.integers(0, 256, 20) | rng.integers(256, 5000, 20) << 8)
        tabs = tabs.astype(np.int32)
    elif kind == "k20":
        k, mb = 20, 8
        nsym = rng.integers(0, k + 1, nc)
    elif kind in ("k7", "k64"):
        k = int(kind[1:])
        nsym = rng.integers(0, k + 1, nc)
    if tabs is None:
        tabs = np.stack([prefix_table(rng, mb) for _ in range(rows)])
    return dict(windows=windows, lbit=lbit.astype(np.int32),
                nsym=nsym.astype(np.int32), tables=tabs, per_row=per_row,
                k=k, max_bits=mb)


ZSEQ_CLASSES = ("cursor_edges", "shared_random", "nsym_edges", "of31_ones",
                "rep3_r0_1", "carried_nonpositive", "per_row_3",
                "per_row_100", "per_row_256", "per_row_300")
_ZSEQ_SHARED = ("cursor_edges", "shared_random")


def fse_table_set(rng: np.random.Generator, logs=(9, 8, 9),
                  max_syms=(35, 31, 52)) -> np.ndarray:
    """A (ZTAB,) int32 table set of FSE tables normalised from random
    histograms (``zseq_kern.table_set``)."""
    from compress_tpu_torch.fse import core as fse_core
    from compress_tpu_torch.ops import zseq_kern

    rows = []
    for max_sym, log in zip(max_syms, logs):
        hist = rng.integers(1, 50, max_sym + 1)
        norm = fse_core.normalize_count(hist, log, int(hist.sum()), max_sym)
        rows.append(zseq_kern.state_row(*fse_core.build_dtable(norm, log)))
    return zseq_kern.table_set(*rows)


def _raw_table_set(rng: np.random.Generator, syms, log: int = 9,
                   nb_max: int = 15) -> np.ndarray:
    """A table set of random state rows (sym from ``syms`` per stream, nb
    up to nb_max, a new state from which every nb-bit read stays below
    2^log, as in an FSE table)."""
    from compress_tpu_torch.ops import zseq_kern

    rows = []
    for sy in syms:
        nb = rng.integers(0, nb_max + 1, 1 << log)
        rows.append(zseq_kern.state_row(
            rng.choice(sy, 1 << log), nb,
            rng.integers(0, (1 << log) - (1 << nb) + 1)))
    return zseq_kern.table_set(*rows)


def zseq_inputs(kind: str) -> dict:
    """Sequence-decode inputs that stress the sequence kernel's steps (the
    bit container, the 32-bit carry and its exact comparisons, the tile
    and table-row staging), as a dict: windows (NC, win) uint8; lbit,
    nsym (NC,) int32; nore (NC,) int32 (per-item mode) or last (NC,)
    int32 (shared mode, ``shared`` True: win 80, k 8, one predefined-log
    table set); states, reps (NC, 3) int32; tables (rows, ZTAB) int32;
    per_row (0 in shared mode); k.

    - ``cursor_edges`` (shared): cursors 0, small, at the window's top,
      just and far past it, and negative;
    - ``shared_random``: random predefined-log tables and states;
    - ``nsym_edges``: nsym and nore 0, odd, 8, above 8 and negative;
    - ``of31_ones``: offset codes 30, 31 and above (up to 63) with windows
      of all ones (offset code 31 with its extra bits all ones: of_val
      2^32 - 1), beside repeat codes;
    - ``rep3_r0_1``: one-state tables (offset code 1, literal length 0)
      whose every sequence is repeat code 2 or 3, at r0 = 1, 0, 2, -5,
      INT32_MIN and INT32_MAX (the floor of repeat code 3 matters at 1
      and below);
    - ``carried_nonpositive``: carried offsets <= 0, INT32_MIN and
      INT32_MAX under tables rich in repeat codes;
    - ``per_row_C``: FSE table sets per row of C chunks, C below, at and
      above a 256-chunk tile (several rows a tile at C = 3 and 100).
    The per-item classes keep the cursors inside the 96-byte window."""
    rng = np.random.default_rng(ZSEQ_CLASSES.index(kind) + 97)
    shared = kind in _ZSEQ_SHARED
    win, k = (80, 8) if shared else (96, 8)
    per_row = 0 if shared else 256
    if kind.startswith("per_row_"):
        per_row = int(kind[len("per_row_"):])
    rows = 1 if shared else max(3, -(-1000 // per_row))
    nc = 1500 if shared else rows * per_row
    windows = rng.integers(0, 256, (nc, win)).astype(np.uint8)
    lbit = rng.integers(8 * win - 7, 8 * win + 1, nc)
    nsym = rng.integers(0, k + 1, nc)
    nsym[rng.random(nc) < 0.5] = k
    logs = (6, 5, 6) if shared else (9, 8, 9)
    states = np.stack([rng.integers(0, 1 << lg, nc) for lg in logs], 1)
    reps = rng.integers(1, 1 << 17, (nc, 3))
    reps[rng.random(nc) < 0.3, 0] = 1
    tabs = None
    if kind == "cursor_edges":
        edges = [0, 1, 5, 31, 32, 33, 8 * win - 1, 8 * win, 8 * win + 1,
                 8 * win + 30, 1 << 20, -1, -40]
        lbit[:len(edges) * 20] = np.repeat(edges, 20)
    elif kind == "nsym_edges":
        edges = [0, 1, 3, 5, 7, 8, 9, 100, -1]
        nsym[:len(edges) * 30] = np.repeat(edges, 30)
    elif kind == "of31_ones":
        tabs = np.stack([_raw_table_set(
            rng, (np.arange(36), [0, 1, 2, 3, 30, 31, 31, 31, 40, 63],
                  np.arange(53)), nb_max=9) for _ in range(rows)])
        ones = rng.random(nc) < 0.5
        windows[ones] = 255
    elif kind == "rep3_r0_1":
        from compress_tpu_torch.ops import zseq_kern

        one = [zseq_kern.state_row([s], [0], [0]) for s in (0, 1, 0)]
        tabs = np.stack([zseq_kern.table_set(*one)] * rows)
        states[:] = 0
        reps[:, 0] = rng.choice([1, 0, 2, -5, -(1 << 31), (1 << 31) - 1],
                                nc)
    elif kind == "carried_nonpositive":
        tabs = np.stack([_raw_table_set(
            rng, ([0, 0, 0, 1, 5], [0, 1, 1, 2, 3, 7], [0, 3, 9]), nb_max=9)
            for _ in range(rows)])
        reps = rng.choice([-3, -1, 0, 1, 2, -(1 << 31), (1 << 31) - 1],
                          (nc, 3))
    if tabs is None:
        tabs = np.stack([fse_table_set(rng, logs, (35, 23, 52))
                         for _ in range(rows)])
    out = dict(windows=windows, lbit=lbit.astype(np.int32),
               nsym=nsym.astype(np.int32), states=states.astype(np.int32),
               reps=reps.astype(np.int32), tables=tabs.astype(np.int32),
               per_row=per_row, k=k, shared=shared)
    if shared:
        out["last"] = (rng.random(nc) < 0.3).astype(np.int32)
    else:
        nore = np.minimum(nsym, rng.integers(0, k + 1, nc))
        last = rng.random(nc) < 0.5
        nore[last] = np.maximum(nsym - 1, 0)[last]
        if kind == "nsym_edges":
            nore[:len(edges) * 30] = rng.choice([0, 1, 8, 9, -2, 100],
                                                len(edges) * 30)
        out["nore"] = nore.astype(np.int32)
    return out


FSE_ENC_CLASSES = ("corpus", "nb_zero", "hostile", "clip_edges", "short")


def fse_enc_inputs(kind: str):
    """(blocks (N, L) uint8, st (N, 512), dnb (N, 256), dfs (N, 256)
    int32): inputs of the FSE batch encode's chain at log 9.

    - ``corpus``: real tables (``ops/entropy._fse_tables_bytes``) of text,
      rand4 and period3 rows of 6146 bytes (a chain over 4 chunks of the
      kernel, the last partial);
    - ``nb_zero``: real tables of 4096-byte rows where one byte has
      probability 1/2 or more (state writes of 0 bits);
    - ``hostile``: random tables of values below 2^24 in magnitude (the
      reference's float32 lookups are exact there): states, shifts and
      table indexes far outside their ranges, so its clips decide every
      step;
    - ``clip_edges``: tables whose widths land on -1, 0, 16 and 17 and
      whose indexes land just inside and outside 0..511;
    - ``short``: the smallest chain (L = 2: the first states and the
      flush alone) with real tables."""
    import torch

    from compress_tpu_torch.ops import entropy as E

    rng = np.random.default_rng(FSE_ENC_CLASSES.index(kind) + 71)

    def real(blocks):
        t = torch.from_numpy(blocks)
        st, dnb, dfs, _ = E._fse_tables_bytes(E.byte_histograms(t), 9)
        return blocks, st.numpy(), dnb.numpy(), dfs.numpy()

    if kind == "corpus":
        rows = [make_block(c, rng)[:6146] for c in ("text", "rand4",
                                                    "period3")]
        return real(np.stack(rows))
    if kind == "short":
        return real(rng.integers(0, 4, (3, 2), dtype=np.uint8))
    if kind == "nb_zero":
        L = 4096
        b = np.where(rng.random((3, L)) < 0.7, 65,
                     rng.integers(0, 256, (3, L))).astype(np.uint8)
        return real(b)
    N, L = 4, 1030
    blocks = rng.integers(0, 256, (N, L), dtype=np.uint8)
    if kind == "hostile":
        st, dnb, dfs = (rng.integers(-(1 << 24), 1 << 24, (N, w),
                                     dtype=np.int32) for w in (512, 256, 256))
        return blocks, st, dnb, dfs
    # states 0..1535: nb = (s + dnb) >> 16 from -1 to 17; s >> c + dfs
    # around 0 and 511
    st = rng.integers(0, 1536, (N, 512)).astype(np.int32)
    widths = rng.choice([-1, 0, 16, 17], (N, 256))
    dnb = ((widths << 16) - rng.integers(0, 1536, (N, 256))).astype(np.int32)
    dfs = rng.choice([-3, -1, 0, 500, 511, 512, 600], (N, 256)).astype(
        np.int32)
    return blocks, st, dnb, dfs


FSE_DEC_CLASSES = ("cursor_edges", "npair_nore_edges", "state_edges",
                   "nb_zero")


def _fse_dtable(rng: np.random.Generator, skew: float = 0.0):
    """A log-9 decode table (spread, nb, new_state) of a random
    histogram; with ``skew`` one symbol takes that share."""
    from compress_tpu_torch.fse import core

    hist = rng.integers(0, 40, 256)
    hist[rng.random(256) < 0.5] = 0
    hist[7] += int(skew * hist.sum() / max(1e-9, 1 - skew))
    total = int(hist.sum())
    mx = int(np.nonzero(hist)[0][-1])
    norm = core.normalize_count(hist.astype(np.int64), 9, total, mx)
    return core.build_dtable(norm, 9)


def fse_dec_inputs(kind: str) -> dict:
    """Chunk-decode inputs of the FSE batch decode (k = 32, 52-byte
    windows) as a dict: windows (N, C, 52) uint8; lbit, st1, st2, npair,
    nore1, nore2 (N, C) int32; dtables, each row's (spread, nb,
    new_state); tables (N, 512) int32 (``entropy_dec.fse_table``).

    - ``cursor_edges``: cursors 0, 1, 8, 9, 10, 100, 288, 415 and 416 (the
      window's top), with 16 and 3 live pairs: reads below window bit 0;
    - ``npair_nore_edges``: npair 0, 1, 7 and 16, nore 0, 1, 8, 16, -1 and
      20, in every combination;
    - ``state_edges``: entry states 0, 1, 255, 256, 511, and 512, 1000 and
      -1 (outside the table: entry 0);
    - ``nb_zero``: a table where one symbol has probability 1/2 or more
      (states of 0 bits)."""
    from compress_tpu_torch.ops.entropy_dec import WIN, fse_table

    rng = np.random.default_rng(FSE_DEC_CLASSES.index(kind) + 89)
    N, C = 3, 96
    dts = [_fse_dtable(rng, 0.6 if kind == "nb_zero" else 0.0)
           for _ in range(N)]
    windows = rng.integers(0, 256, (N, C, WIN), dtype=np.uint8)
    lbit = np.full((N, C), 8 * WIN, np.int64)
    st1 = rng.integers(0, 512, (N, C))
    st2 = rng.integers(0, 512, (N, C))
    npair = np.full((N, C), 16)
    nore1 = np.full((N, C), 16)
    nore2 = np.full((N, C), 16)
    if kind == "cursor_edges":
        edges = np.array([0, 1, 8, 9, 10, 100, 288, 415, 416])
        lbit[:] = np.resize(edges, N * C).reshape(N, C)
        npair[:] = np.resize([16, 16, 3], N * C).reshape(N, C)
    elif kind == "npair_nore_edges":
        combos = np.array([(p, a, b) for p in (0, 1, 7, 16)
                           for a in (0, 1, 8, 16, -1, 20)
                           for b in (0, 1, 8, 16, -1, 20)])
        pick = np.resize(np.arange(len(combos)), N * C)
        npair[:], nore1[:], nore2[:] = (combos[pick, i].reshape(N, C)
                                        for i in range(3))
    elif kind == "state_edges":
        edges = np.array([0, 1, 255, 256, 511, 512, 1000, -1])
        st1[:] = np.resize(edges, N * C).reshape(N, C)
        st2[:] = np.roll(st1, 3)
    as32 = [a.astype(np.int32) for a in (lbit, st1, st2, npair, nore1,
                                        nore2)]
    return dict(windows=windows, lbit=as32[0], st1=as32[1], st2=as32[2],
                npair=as32[3], nore1=as32[4], nore2=as32[5], dtables=dts,
                tables=np.stack([fse_table(*d) for d in dts]))
