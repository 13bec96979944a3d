"""A numpy model of the xxHash64 kernel's stage schedule as
``csrc/checksum.cu`` runs it, held against the plain PyTorch version
(``ops/checksum.xxh64_batch_ref``), the host ``utils/xxhash64.xxh64`` and
the JAX ``xxh64_batch``.

A CTA holds a loader warp and a fold warp; lane 4 i + q of each serves
lane q of row i.  The row goes through a ring of STAGES slots of SS
stripes in shared memory: stage t (stripes [t SS, (t + 1) SS), the last
stage partial when n / 32 is not a multiple of SS) goes to slot t %
STAGES.  The loader loads stage t + 1's words while it stores stage t's
words times P2 into the slot, waits on named barrier EMPTY(t) before
stage t >= STAGES and arrives on FULL(t) after it.  The fold reads each
word of a stage two rounds before its round; it waits on FULL(t + 1) and
reads stage t + 1's first two words before stage t's last two rounds,
and arrives on EMPTY(t) after stage t's rounds only where the loader
will refill that slot (t + STAGES < stages).  The model runs the two warps as two agents,
each going on until a barrier holds it, with barriers that complete when
both warps have reached them (arrive or wait) in order; it checks that
every read sees its own stage, that no slot is overwritten before it was
read, that every barrier phase is reached by both warps (none left
pending, no deadlock), and that the stages partition the row.  The digest
uses wrapping 64-bit arithmetic as the kernel does: the fold carries a =
acc + in * P2, so a round is a = rotl(a, 31) * P1 + in' * P2, starting
from a = rotr(acc0 * P1^-1, 31) and ending with acc = rotl(a, 31) * P1.
Tolerance 0: digests are integers."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import torch  # noqa: E402

from compress_tpu.ops import checksum as jax_ck  # noqa: E402
from compress_tpu_torch.ops import checksum as ck  # noqa: E402
from compress_tpu_torch.utils.xxhash64 import xxh64  # noqa: E402

SS = 48        # stripes a stage (XXH_SS)
STAGES = 3     # slots of a row's ring (XXH_STAGES)
P1 = np.uint64(0x9E3779B185EBCA87)
P2 = np.uint64(0xC2B2AE3D27D4EB4F)
P3 = np.uint64(0x165667B19E3779F9)
P4 = np.uint64(0x85EBCA77C2B2AE63)
P1_INV = np.uint64(0x0887493432BADB37)   # P1 * P1_INV = 1 mod 2^64
SEEDS = [0, (1 << 64) - 1]


def _rotl(x, r: int):
    return (x << np.uint64(r)) | (x >> np.uint64(64 - r))


def _round(acc, inp2):
    return _rotl(acc + inp2, 31) * P1


def _step(a, inp2):
    """The kernel's round on a = acc + in * P2: rotl(a, 31) * P1 + the
    next word times P2."""
    return _rotl(a, 31) * P1 + inp2


def loader(nst: int) -> list:
    """The loader warp's events: ("wait" | "arrive", barrier) and
    ("store", t)."""
    ev = []
    for t in range(nst):
        if t >= STAGES:
            ev.append(("wait", ("empty", t % STAGES)))
        ev += [("store", t), ("arrive", ("full", t % STAGES))]
    return ev


def fold(nst: int) -> list:
    """The fold warp's events: barriers, ("read", t) and ("rounds", t).
    A stage's words are read after its FULL (its first two before the
    last rounds of the stage before) and its slot is handed back after
    its rounds where the loader refills it."""
    ev = [("wait", ("full", 0)), ("read", 0)]
    for t in range(nst):
        if t + 1 < nst:
            ev += [("wait", ("full", (t + 1) % STAGES)), ("read", t + 1)]
        ev.append(("rounds", t))
        if t + STAGES < nst:
            ev.append(("arrive", ("empty", t % STAGES)))
    return ev


def run_schedule(agents, on_store, on_read, on_rounds):
    """Run the two warps' events (the loader's, the fold's); a barrier
    phase completes once both warps reached it; an agent stops at a wait
    whose phase is open."""
    pos = [0, 0]
    reached = {}            # barrier -> [phases reached by each agent]
    while pos[0] < len(agents[0]) or pos[1] < len(agents[1]):
        moved = False
        for a in (0, 1):
            while pos[a] < len(agents[a]):
                kind, x = agents[a][pos[a]]
                if kind in ("wait", "arrive"):
                    got = reached.setdefault(x, [0, 0])
                    if kind == "wait" and got[1 - a] <= got[a]:
                        break           # the other warp has not come yet
                    got[a] += 1
                elif kind == "store":
                    on_store(x)
                elif kind == "read":
                    on_read(x)
                else:
                    on_rounds(x)
                pos[a] += 1
                moved = True
        assert moved, "deadlock"
    assert all(g[0] == g[1] for g in reached.values())   # none left pending


def model_xxh64(rows: np.ndarray, seed: int) -> np.ndarray:
    """(B, 2) int64 [lo, hi] digests by the kernel's schedule."""
    B, n = rows.shape
    stripes = n // 32
    nst = -(-stripes // SS)
    words = np.ascontiguousarray(rows).view("<u8").reshape(B, stripes, 4)
    s = np.uint64(seed)
    with np.errstate(over="ignore"):
        acc0 = np.stack([np.full(B, s + P1 + P2), np.full(B, s + P2),
                         np.full(B, s), np.full(B, s - P1)], axis=1)
        state = {"a": _rotl(acc0 * P1_INV, 64 - 31)}   # _step(a, w) = acc0 + w
        slot = [None] * STAGES   # (stage, products, read) in each slot
        regs = {}
        seen = np.zeros(stripes, np.int64)

        def on_store(t):
            prev = slot[t % STAGES]
            assert prev is None or prev[2]         # read before reuse
            lo, hi = t * SS, min((t + 1) * SS, stripes)
            slot[t % STAGES] = [t, words[:, lo:hi] * P2, False]

        def on_read(t):
            cur = slot[t % STAGES]
            assert cur is not None and cur[0] == t
            regs[t] = cur[1]
            cur[2] = True

        def on_rounds(t):
            lo, hi = t * SS, min((t + 1) * SS, stripes)
            for u in range(hi - lo):
                state["a"] = _step(state["a"], regs[t][:, u])
            seen[lo:hi] += 1

        run_schedule([loader(nst), fold(nst)], on_store, on_read, on_rounds)
        assert (seen == 1).all()           # the stages partition the row
        acc = _step(state["a"], np.uint64(0))
        h = (_rotl(acc[:, 0], 1) + _rotl(acc[:, 1], 7) + _rotl(acc[:, 2], 12)
             + _rotl(acc[:, 3], 18))
        for k in range(4):
            h = h ^ _round(np.zeros(B, np.uint64), acc[:, k] * P2)
            h = h * P1 + P4
        h = h + np.uint64(n)
        h ^= h >> np.uint64(33)
        h = h * P2
        h ^= h >> np.uint64(29)
        h = h * P3
        h ^= h >> np.uint64(32)
    return np.stack([(h & np.uint64(0xFFFFFFFF)).astype(np.int64),
                     (h >> np.uint64(32)).astype(np.int64)], axis=1)


def _rows(B: int, n: int, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (B, n), dtype=np.uint8)
    rows[1] = 0
    return rows


@pytest.mark.parametrize("seed", SEEDS, ids=["0", "2^64-1"])
@pytest.mark.parametrize("n", [32, 32 * SS + 32, 32 * SS * STAGES + 96,
                               65536])
def test_model_matches_plain_and_host(n, seed):
    """n = 32 (one partial stage), a stage plus 32 bytes, more stages than
    the ring with a partial one, and 64 KiB (128 stages)."""
    rows = _rows(3, n, n)
    got = model_xxh64(rows, seed)
    np.testing.assert_array_equal(
        got, ck.xxh64_batch_ref(torch.from_numpy(rows), seed).numpy())
    assert [int(lo) | int(hi) << 32 for lo, hi in got] == \
        [xxh64(r.tobytes(), seed) for r in rows]


@pytest.mark.parametrize("seed", SEEDS, ids=["0", "2^64-1"])
@pytest.mark.parametrize("n", [32, 32 * SS + 32, 32 * SS * STAGES + 96,
                               32768])
def test_model_matches_jax(n, seed):
    rows = _rows(3, n, n + 7)
    want = np.asarray(jax_ck.xxh64_batch(rows, seed=seed)).astype(np.int64)
    np.testing.assert_array_equal(model_xxh64(rows, seed), want)


def test_schedule_for_every_length_up_to_past_the_ring():
    """Every row length from one stripe to past STAGES + 2 stages: each
    stage stored and folded once, in order, every barrier phase reached
    by both warps (checked inside the model)."""
    for stripes in range(1, SS * (STAGES + 2) + 3):
        nst = -(-stripes // SS)
        assert [t for e, t in loader(nst) if e == "store"] == list(range(nst))
        assert [t for e, t in fold(nst) if e == "rounds"] == list(range(nst))
        rows = _rows(2, 32 * stripes, stripes)
        np.testing.assert_array_equal(
            model_xxh64(rows, 5),
            ck.xxh64_batch_ref(torch.from_numpy(rows), 5).numpy())


def test_schedule_reuse_needs_the_fold_to_hand_slots_back():
    """Were the fold not to arrive on EMPTY, the loader would stop before
    its fifth stage: the run is a deadlock, not a silent overwrite."""
    nst = STAGES + 2
    silent = [e for e in fold(nst) if e[0] != "arrive"]
    with pytest.raises(AssertionError, match="deadlock"):
        run_schedule([loader(nst), silent], lambda t: None, lambda t: None,
                     lambda t: None)
