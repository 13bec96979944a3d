"""PyTorch port of the match finder (compress_tpu_torch/ops/lzkern.py).

The port's finder, run on the CPU (its plain PyTorch version), must give
the same (off, L) as the JAX package's Pallas finder in interpret mode,
bit for bit (tolerance 0: integers), on every seeded corpus class, for
the full (cap 10) and slim (cap 6) variants.  The CUDA kernel is held
against the plain version on the card in test_torch_cuda.py."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from compress_tpu.ops import lzkern as jax_lzkern  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch.ops import lzkern  # noqa: E402

NAMES = list(corpus.CLASSES)


@pytest.fixture(scope="module")
def blocks():
    """One block per corpus class (the gate block as in test_lzemit)."""
    out = corpus.corpus_blocks(len(NAMES), seed=5)
    out[NAMES.index("gate")] = corpus.make_block(
        "gate", np.random.default_rng(0))
    return out


@pytest.fixture(scope="module")
def jax_found(blocks):
    out = {}
    for slim in (False, True):
        off, L = jax_lzkern.find_matches_blocks(
            jnp.asarray(blocks), interpret=True, slim=slim)
        out[slim] = (np.asarray(off), np.asarray(L))
    return out


@pytest.fixture(scope="module")
def port_found(blocks):
    t = torch.from_numpy(blocks.copy())
    return {slim: tuple(x.numpy() for x in
                        lzkern.find_matches_blocks(t, slim=slim))
            for slim in (False, True)}


@pytest.mark.parametrize("slim", [False, True], ids=["cap10", "slim"])
@pytest.mark.parametrize("name", NAMES)
def test_finder_matches_jax(name, slim, jax_found, port_found):
    i = NAMES.index(name)
    j_off, j_L = jax_found[slim]
    p_off, p_L = port_found[slim]
    assert p_off.dtype == np.int32 and p_L.dtype == np.int32
    assert np.array_equal(p_off[i], j_off[i]), f"{name}: offsets differ"
    assert np.array_equal(p_L[i], j_L[i]), f"{name}: lengths differ"


@pytest.mark.parametrize("slim", [False, True], ids=["cap10", "slim"])
def test_finder_length_caps_and_tail(slim, port_found):
    off, L = port_found[slim]
    cap = lzkern.L_CAP_SLIM if slim else lzkern.L_CAP
    assert L.max() == cap
    assert ((L == 0) | (L >= 4)).all()
    assert ((L == 0) == (off == 0)).all()
    assert (L[:, lzkern._SENT_BASE:] == 0).all()
    g = np.arange(lzkern.BS)
    assert (off <= g).all()


def test_constants_match_jax():
    for name in ("ROWS", "LANES", "BS", "L_CAP", "_SENT_BASE"):
        assert getattr(lzkern, name) == getattr(jax_lzkern, name), name


def test_finder_rejects_bad_shape():
    with pytest.raises(ValueError):
        lzkern.find_matches_blocks(torch.zeros((2, 1000), dtype=torch.uint8))



# ---- a CPU model of the CUDA finder's algorithm (csrc/lzkern.cu) ----------
#
# The kernel sorts 16-bit positions by four stable byte-digit passes, split
# over a cluster of two CTAs of 32 warps.  The model below runs the same
# steps in numpy (the same digit order, the same scan order, the same
# 32-entry warp steps with match_any peers, lower-lane popcounts and leader
# advances, the same split of ranks and positions between the two CTAs)
# and is held against the plain version, bit for bit, before any chip run.

NWARP = 32
HALF = lzkern.BS // 2
SEG = HALF // NWARP
LOWER = np.tril(np.ones((32, 32), bool), -1)  # [lane, other]: other < lane
FINDER_NAMES = [k for k in corpus.FINDER_CLASSES if k not in NAMES]


def _model_pass(halves, s, d):
    """One stable digit pass (digit d: the byte at p + d) over the two
    CTAs' halves of the current order; returns the next halves."""
    BS = lzkern.BS
    n = [len(h) for h in halves]
    digs = [s[(h + d) & (BS - 1)] for h in halves]
    # 1. each warp's digit counts over its 1024-entry segment
    cnt = np.zeros((2, NWARP, 256), np.int64)
    for c in range(2):
        np.add.at(cnt[c], (np.arange(n[c]) // SEG, digs[c]), 1)
    # 2. exclusive scan in (digit, CTA, warp) order, split as the kernel
    # splits it: warps inside a CTA, then the two CTAs' digit totals
    tot = cnt.sum(axis=1)
    both = tot[0] + tot[1]
    base = np.cumsum(cnt, axis=1) - cnt + (np.cumsum(both) - both)
    base[1] += tot[0]
    assert base.max() < 1 << 16 and cnt.max() <= SEG  # 16-bit counts
    # 3. the scatter, 32 entries of every warp at a time
    new = [np.full(HALF, -1, np.int64) for _ in range(2)]
    warps = np.broadcast_to(np.arange(NWARP)[:, None], (NWARP, 32))
    for c in range(2):
        dig = np.full(HALF, -1, np.int64)
        dig[:n[c]] = digs[c]
        pos = np.zeros(HALF, np.int64)
        pos[:n[c]] = halves[c]
        dig = dig.reshape(NWARP, SEG // 32, 32)
        pos = pos.reshape(NWARP, SEG // 32, 32)
        run = base[c].copy()
        for j in range(SEG // 32):
            dj = dig[:, j]
            same = dj[:, :, None] == dj[:, None, :]       # match_any
            below = (same & LOWER).sum(-1)                # popc(peers & lt)
            valid = dj >= 0
            rank = run[warps, np.where(valid, dj, 0)] + below
            for r, p in zip(rank[valid], pos[:, j][valid]):
                new[r // HALF][r % HALF] = p              # local or remote
            lead = valid & (below == 0)
            run[warps[lead], dj[lead]] += same.sum(-1)[lead]
    out = [new[0][:n[0]], new[1][:n[1]]]
    assert all((h >= 0).all() for h in out)
    return out


def _model_finder(blk: np.ndarray, cap: int):
    BS, SENT = lzkern.BS, lzkern._SENT_BASE
    s = blk.astype(np.int64)
    halves = [np.arange(HALF), np.arange(HALF, SENT)]  # position order
    for d in range(4):
        halves = _model_pass(halves, s, d)

    def word(p):
        return (s[p] | s[(p + 1) & (BS - 1)] << 8
                | s[(p + 2) & (BS - 1)] << 16 | s[(p + 3) & (BS - 1)] << 24)

    # 4. predecessor (across the CTA boundary for the second half's first
    # entry) -> 16-bit offset, scattered by position into the halves
    off16 = [np.full(HALF, -1, np.int64) for _ in range(2)]
    for c in range(2):
        p = halves[c]
        q = np.concatenate([[halves[0][-1] if c else -1], p[:-1]])
        o = np.where((q >= 0) & (word(p) == word(np.maximum(q, 0))), p - q, 0)
        assert o.max() < 1 << 16
        for c2 in range(2):
            mine = p // HALF == c2
            off16[c2][p[mine] % HALF] = o[mine]
    off16[1][SENT - HALF:] = 0
    o = np.concatenate(off16)
    assert (o >= 0).all()  # every position written once
    # 5. suffix compare in position order
    pos = np.arange(BS)
    q = pos - o
    L = np.where(o > 0, 4, 0)
    alive = o > 0
    for k in range(4, cap):
        alive &= s[(pos + k) & (BS - 1)] == s[(q + k) & (BS - 1)]
        L += alive
    L = np.where(o > 0, np.minimum(L, BS - pos), 0)
    return o.astype(np.int32), L.astype(np.int32)


@pytest.mark.parametrize("slim", [False, True], ids=["cap10", "slim"])
@pytest.mark.parametrize("name", NAMES + FINDER_NAMES)
def test_radix_model_matches_plain(name, slim, blocks):
    blk = (blocks[NAMES.index(name)] if name in NAMES
           else corpus.finder_block(name))
    cap = lzkern.L_CAP_SLIM if slim else lzkern.L_CAP
    want = lzkern.find_matches_blocks_ref(torch.from_numpy(blk[None].copy()),
                                          slim=slim)
    got = _model_finder(blk, cap)
    for g, w in zip(got, want):
        assert np.array_equal(g, w[0].numpy())


def test_finder_blocks_are_hostile():
    """The hostile blocks do what their names say (plain version)."""
    def found(kind):
        b = torch.from_numpy(corpus.finder_block(kind)[None].copy())
        return [x[0].numpy() for x in lzkern.find_matches_blocks_ref(b)]

    off, L = found("zeros")
    assert (off[1:lzkern._SENT_BASE] == 1).all() and off[0] == 0
    assert not found("unique")[1].any()
    off, L = found("far_pair")
    assert np.flatnonzero(L).tolist() == [65532] and off[65532] == 65532
    off, L = found("wrap")
    assert (off[lzkern.BS - 16:lzkern._SENT_BASE] == lzkern.BS - 1016).all()
    assert (L[lzkern.BS - 10:lzkern._SENT_BASE]
            == lzkern.BS - np.arange(lzkern.BS - 10, lzkern._SENT_BASE)).all()
    blk = corpus.finder_block("one_bin")
    assert np.count_nonzero(blk) == 1
