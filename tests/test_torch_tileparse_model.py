"""A numpy model of the tile parse as ``csrc/tileparse.cu`` runs it, held
against the plain PyTorch version (``ops/lz2.tile_parse_ref``).

The kernel parses a tile in three exact phases, none of them
speculative.  The tile is cut into segments of S = max(ceil(tile / 32),
min(16, tile)) positions (the last one short), one a lane; G lanes (the
power of two at or above the segments' number) take a tile, and a warp
32 / G tiles side by side, which changes no tile's result.  Position r's
next cursor is nx[r] = r + 1 for a literal and, where L_t[r] >= 4, r +
L_t[r] capped at the tile end.

1. Each lane builds its segment's exits backwards: ex[e] is the first
   position at or past the segment's end that the cursor reaches from e,
   ``ex[e] = nx[e] if nx[e] >= end else ex[nx[e]]`` (S dependent steps).
2. The tile's lanes follow the exits from position 0; each lane keeps
   the position where the cursor enters its segment, if it does (at most
   one hop a segment entered).
3. Each lane walks its segment forward from its entry and marks take and
   lit (at most S steps).

A tile past ``TP_WARP_MAX`` positions (whose L_t, exits and flags would
pass a warp's share of shared memory) takes the chunked walk of one
thread a tile instead, a route of the same kernel file; both routes are
counted.  Tolerance 0: every output is a flag."""

import numpy as np
import pytest
import torch

from compress_tpu_torch import corpus
from compress_tpu_torch.ops import lz2

TP_WARP_MAX = 2048    # the kernel's largest tile on the warp route
I32_MAX = (1 << 31) - 1


def seg_len(tile: int) -> int:
    """The kernel's segment length S at ``tile``."""
    return max(-(-tile // 32), min(16, tile))


def model_tile_parse(L, tile: int):
    """(take, lit, routes, stats) of ``tile_parse`` as the kernel computes
    them: routes = (tiles on the warp route, tiles on the chunked route);
    stats the largest number of phase-2 hops and of phase-1 and phase-3
    steps a lane took over the tiles."""
    L = np.asarray(L, np.int64)
    NB, bs = L.shape
    T = L.reshape(-1, tile)
    n = T.shape[0]
    take = np.zeros((n, tile), bool)
    lit = np.zeros((n, tile), bool)
    if tile > TP_WARP_MAX:
        _serial(T, take, lit)
        return (take.reshape(NB, bs), lit.reshape(NB, bs), (0, n),
                {"hops": 0, "steps": tile})
    S = seg_len(tile)
    nseg = -(-tile // S)
    r = np.arange(tile)
    nx = np.where(T >= 4, np.where(T > tile - r, tile, r + T), r + 1)
    rows = np.arange(n)[:, None]
    start = np.arange(nseg) * S
    end = np.minimum(start + S, tile)
    # phase 1: every lane a step at a time, from its segment's last
    # position down
    ex = np.zeros((n, tile + 1), np.int64)
    for a in range(S - 1, -1, -1):
        e = start + a
        ok = e < end
        e, en = e[ok], end[ok]
        step = nx[:, e]
        ex[:, e] = np.where(step >= en, step, ex[rows, np.minimum(step,
                                                                tile)])
    # phase 2: the cursor's entry into each segment (-1: none)
    entry = np.full((n, nseg), -1)
    p = np.zeros(n, np.int64)
    hops = 0
    while (p < tile).any():
        act = p < tile
        entry[act, p[act] // S] = p[act]
        p = np.where(act, ex[np.arange(n), np.minimum(p, tile)], p)
        hops += 1
    # phase 3: each lane from its entry to its segment's end
    p = entry.copy()
    steps = 0
    while True:
        act = (p >= 0) & (p < end[None, :])
        if not act.any():
            break
        steps += 1
        i, s = np.nonzero(act)
        q = p[i, s]
        op = T[i, q] >= 4
        take[i[op], q[op]] = True
        lit[i[~op], q[~op]] = True
        p[i, s] = nx[i, q]
    return (take.reshape(NB, bs), lit.reshape(NB, bs), (n, 0),
            {"hops": hops, "steps": steps})


def _serial(T, take, lit):
    """The chunked route's walk: one cursor a tile, position by position."""
    n, tile = T.shape
    p = np.zeros(n, np.int64)
    for r in range(tile):
        act = p == r
        v = T[:, r] >= 4
        take[:, r] = act & v
        lit[:, r] = act & ~v
        p = np.where(act, np.where(v, np.where(T[:, r] > tile - r, tile,
                                               r + T[:, r]), r + 1), p)


KINDS = ("every_4", "end_at_tile_end", "whole_tile", "raw_random",
         "near_int32_max")


def hostile_lengths(kind: str, tile: int, nb: int = 3) -> np.ndarray:
    """(nb, 8 * tile) int32 L_t of the card tests' hostile kinds: every
    position 4 (not capped at the tile end), matches that end exactly at
    a tile's end (reached by literals and by a jump), L_t = tile at each
    tile's start and capped values elsewhere, raw random values from -5
    to tile + 5, and values near INT32_MAX (a jump that must not wrap)."""
    bs = 8 * tile
    rng = np.random.default_rng([KINDS.index(kind), tile])
    r = np.arange(bs) % tile
    if kind == "every_4":
        return np.full((nb, bs), 4, np.int32)
    if kind == "end_at_tile_end":
        L = np.zeros((max(nb, 3), bs), np.int32)
        L[:, r == tile - 20] = 20
        L[1, r == max(tile - 20, 0)] = tile - 20
        L[2, r == min(5, tile - 1)] = tile - 5
        return L[:nb]
    if kind == "whole_tile":
        L = np.minimum(rng.integers(0, tile + 1, (nb, bs)), tile - r)
        L[:, r == 0] = tile
        return L.astype(np.int32)
    if kind == "raw_random":
        return rng.integers(-5, tile + 6, (nb, bs)).astype(np.int32)
    L = rng.integers(-5, 8, (nb, bs)).astype(np.int64)
    big = rng.random((nb, bs)) < 0.05
    L[big] = I32_MAX - rng.integers(0, 3, big.sum())
    return L.astype(np.int32)


def _hold(L, tile):
    take, lit, routes, stats = model_tile_parse(L, tile)
    want = lz2.tile_parse_ref(torch.from_numpy(L), tile)
    np.testing.assert_array_equal(take, want[0].numpy())
    np.testing.assert_array_equal(lit, want[1].numpy())
    return routes, stats


@pytest.mark.parametrize("tile", [1, 31, 33, 100, 256, 512, 700, 1024, 2048])
@pytest.mark.parametrize("kind", KINDS)
def test_model_matches_plain_on_hostile_lengths(kind, tile):
    L = hostile_lengths(kind, tile)
    routes, stats = _hold(L, tile)
    assert routes == (L.size // tile, 0)
    S = seg_len(tile)
    assert stats["hops"] <= -(-tile // S) <= 32 and stats["steps"] <= S


def test_model_takes_the_chunked_route_past_the_limit():
    """One tile past the warp route's limit, and the whole 64 KiB block
    (``s2_encode_blocks`` accepts any tile that divides it)."""
    for tile in (2 * TP_WARP_MAX, 1 << 16):
        L = hostile_lengths("raw_random", 64, nb=2).reshape(-1)
        L = np.resize(L, (2, tile)).astype(np.int32)
        assert _hold(L, tile)[0] == (0, 2)
    L = hostile_lengths("whole_tile", TP_WARP_MAX // 8, nb=1)
    assert _hold(L, TP_WARP_MAX)[0] == (1, 0)


@pytest.mark.parametrize("tile,level", [(512, 1), (512, 2), (256, 2),
                                        (2048, 1)])
def test_model_matches_plain_on_s2_engine_lengths(tile, level):
    """The S2 XLA engine's own L_t on corpus blocks: every segment's
    walk stays within its S steps and the hops within 32."""
    blocks = torch.from_numpy(corpus.corpus_blocks(2, 9 + level))
    L_t = lz2._find_parse(blocks, tile, level=level)[2]
    routes, stats = _hold(L_t.to(torch.int32).numpy(), tile)
    assert routes == (L_t.numel() // tile, 0)
    assert stats["hops"] <= 32


def test_the_serial_walk_is_long_and_the_phases_short():
    """The finding behind the design: on the S2 engine's L_t of one block
    of each corpus class a 512-position tile's cursor visits about 200
    positions on average and all 512 at most (one dependent step each
    in a serial walk), while the three phases take at most 16 + 32 + 16
    dependent steps."""
    blocks = torch.from_numpy(corpus.corpus_blocks(len(corpus.CLASSES), 3))
    L_t = lz2._find_parse(blocks, 512, level=1)[2].to(torch.int32).numpy()
    take, lit = lz2.tile_parse_ref(torch.from_numpy(L_t), 512)
    visits = (take | lit).numpy().reshape(-1, 512).sum(1)
    assert visits.max() == 512 and visits.mean() > 200
    _, stats = _hold(L_t, 512)
    assert stats["steps"] <= 16 and stats["hops"] <= 32
