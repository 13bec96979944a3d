"""A numpy model of the parse stages as ``csrc/lzparse.cuh`` and
``csrc/zparse.cu`` run them, held against the plain PyTorch versions
(``ops/lzemit2.parse_stages``, ``ops/zparse.parse_blocks_ref``).

The kernels compute the reference's function with other steps, which no
CPU test can run; the model runs those steps on the CPU:

- A0: continuation bits, then one backward pass per residue class mod cap
  over each tile (the chain links, cut at the tile end), only in tiles
  with a continuation bit;
- B: the greedy walk 32 positions at a time, stepping from op to op in a
  window (the next op at or after the current position, the literals
  before it, its successor); the tile's ops listed in order;
- C: the cross-tile merge over the tile summaries as scans (the chain's
  terminal tile a suffix minimum);
- D-F (zstd): each tile's first sequence and literal slot, the literal
  run entering it (from the last tile with an op: a prefix maximum), each
  op's literal run as the walk counted it, the literals compacted tile by
  tile.

Inputs: one seeded block per corpus class with the plain finder's (off,
L), at cap 10 (and cap 6, the slim finder, for the S2 stages), and the
hostile blocks of ``corpus.parse_inputs`` (all zeros, long chains, the
most sequences the gate allows, no op at all); the chains and all-zeros
inputs also at the caps the kernels take at run time (1, 8, 16, 17, 100,
600 and 70000: shorter than the cap ahead a lane holds, 32 residue
classes and more, caps past the tile and past the block).  Tolerance 0:
every output is an integer or a byte."""

import numpy as np
import pytest
import torch

from compress_tpu_torch import corpus
from compress_tpu_torch.ops import lzemit2, lzkern, zparse

BS, TILE = 1 << 16, 512
NT = BS // TILE
PROBES = (1, 2, 3, 4, 8)


def _tile_runs(m):
    """Per position of (n, NT, TILE) bools: ones from it to the first zero,
    cut at the tile end."""
    run = np.zeros(m.shape, np.int64)
    nxt = np.zeros(m.shape[:2], np.int64)
    for q in range(TILE - 1, -1, -1):
        nxt = np.where(m[:, :, q], nxt + 1, 0)
        run[:, :, q] = nxt
    return run


def _stage_a(blk, off, L, cap, gate):
    """A0, A and the gate: (n, NT, TILE) L_t | probe << 12 (0: no op)."""
    n = blk.shape[0]
    up_off = np.zeros_like(off)
    up_L = np.zeros_like(L)
    up_off[:, :-cap], up_L[:, :-cap] = off[:, cap:], L[:, cap:]
    cont = ((L == cap) & (off > 0) & (up_off == off) & (up_L >= 4)
            ).reshape(n, NT, TILE)
    # one backward pass per residue class: runs along the chain q, q + cap,
    # in the tiles that have a continuation bit
    run = np.zeros((n, NT, TILE), np.int64)
    chains = cont.any(axis=2)
    for q in range(TILE - 1, -1, -1):
        after = run[:, :, q + cap] if q + cap < TILE else 0
        run[:, :, q] = np.where(cont[:, :, q] & chains, after + 1, 0)
    r_t = np.arange(TILE)
    L3 = L.reshape(n, NT, TILE)
    Lg = np.where((L3 == cap) & (run > 0), cap * run + 4, L3)
    Lu, Lc = Lg.copy(), np.minimum(Lg, TILE - r_t)
    pr = np.zeros_like(Lc)
    for pid, o in enumerate(PROBES, start=1):
        m = np.zeros((n, BS), bool)
        m[:, o:] = blk[:, o:] == blk[:, :-o]
        Lr = _tile_runs(m.reshape(n, NT, TILE))
        better = (Lr > Lc) & (Lr >= 4)
        Lc, Lu, pr = (np.where(better, Lr, Lc), np.where(better, Lr, Lu),
                      np.where(better, pid, pr))
    off3 = off.reshape(n, NT, TILE)
    if gate:
        og = np.where(pr > 0, np.array((0,) + PROBES)[pr], off3)
        Lc = np.where(Lu < 6 + (og >= 1024) + (og >= 65536), 0, Lc)
    return np.where(Lc >= 4, Lc | (pr << 12), 0), off3


def _walk(wlt):
    """B on (m, TILE) tiles, 32 positions at a time: (take, lit) bools, the
    ops' values in order (m, TILE // 4) with the literals since the op
    before each (or the tile start) in bits 16 and up, and per tile its op
    count, literal count, the end of its last op and the op ending at the
    tile end (-1: none).  In a window the walk steps from op to op: the
    next op at or after the current position, the literals before it, its
    successor."""
    m = wlt.shape[0]
    lane = np.arange(32)
    rows = np.arange(m)
    take = np.zeros((m, TILE), bool)
    lit = np.zeros((m, TILE), bool)
    opt = np.zeros((m, TILE // 4), np.int64)
    nops = np.zeros(m, np.int64)
    end = np.zeros(m, np.int64)
    epos = np.full(m, -1)
    p = np.zeros(m, np.int64)
    pend = np.zeros(m, np.int64)    # literals since the last op
    while (p < TILE).any():
        act = p < TILE
        lim = np.where(act, np.minimum(32, TILE - p), 0)
        pos = np.minimum(p[:, None] + lane, TILE - 1)
        v = np.where(lane < lim[:, None], wlt[rows[:, None], pos], 0)
        valid = (v & 0x3FF) >= 4
        nx = lane + (v & 0x3FF)
        vis = np.zeros((m, 32), bool)
        tb = np.zeros((m, 32), bool)
        cur = np.zeros(m, np.int64)
        f = np.full(m, -1)
        lits = np.zeros((m, 32), np.int64)
        while (cur < lim).any():
            step = cur < lim
            rest = valid & (lane >= cur[:, None])
            has = step & rest.any(axis=1)
            ff = np.argmax(rest, axis=1)
            # literals to the window's end where no op is left
            tail = step & ~has
            vis |= tail[:, None] & (lane >= cur[:, None]) & (
                lane < lim[:, None])
            f = np.where(tail, -1, f)
            pend = np.where(tail, pend + lim - cur, pend)
            # else the literals up to the op, the op, its successor
            vis |= has[:, None] & (lane >= cur[:, None]) & (
                lane <= ff[:, None])
            tb[has, ff[has]] = True
            lits[has, ff[has]] = (pend + ff - cur)[has]
            pend = np.where(has, 0, pend)
            f = np.where(has, ff, f)
            cur = np.where(has, nx[rows, ff], np.where(tail, lim, cur))
        lb = vis & ~tb
        for i in range(32):
            r = tb[:, i]
            opt[r, nops[r] + tb[r, :i].sum(axis=1)] = v[r, i] | (
                lits[r, i] << 16)
        lastop = 31 - np.argmax(tb[:, ::-1], axis=1)
        end = np.where(tb.any(axis=1), p + nx[rows, lastop], end)
        epos = np.where(act & (f >= 0) & (p + cur == TILE), p + f, epos)
        nops += tb.sum(axis=1)
        for arr, bits in ((take, tb), (lit, lb)):
            r, i = np.nonzero(bits)
            arr[r, p[r] + i] = True
        p = np.where(act, p + cur, p)
    return take, lit, opt, nops, lit.sum(axis=1), end, epos


def _resolve(v, finder_off):
    return np.where(v >> 12, np.array((0,) + PROBES)[v >> 12], finder_off)


def model_parse(blk, off, L, cap, gate):
    """The kernels' steps; returns per block the parse (take with the
    absorbed heads dropped, lit, L2 and off at the ops) and the zstd
    outputs (ll, ml, of, lits, n_seqs, lit_cnt)."""
    n = blk.shape[0]
    wlt, off3 = _stage_a(blk, off.astype(np.int64), L.astype(np.int64), cap,
                         gate)
    take, lit, opt, nops, nlit, end, epos = _walk(wlt.reshape(n * NT, TILE))
    take, lit = take.reshape(n, NT, TILE), lit.reshape(n, NT, TILE)
    opt, nops, nlit, end, epos = (a.reshape(n, NT, *a.shape[1:])
                                  for a in (opt, nops, nlit, end, epos))
    v0 = wlt[:, :, 0]
    opl, opt = opt >> 16, opt & 0xFFFF
    op0 = (v0 & 0x3FF) >= 4
    off0 = np.where(op0, _resolve(v0, off3[:, :, 0]), 0)
    ve = np.take_along_axis(wlt, np.maximum(epos, 0)[..., None], 2)[..., 0]
    oe = np.take_along_axis(off3, np.maximum(epos, 0)[..., None], 2)[..., 0]
    eoff = np.where(epos >= 0, _resolve(ve, oe), -1)
    out = []
    for b in range(n):
        # C: the merge by scans: each tile's absorbed flag, the chain's
        # terminal tile (the first non-link tile after it: a suffix minimum)
        tl = np.arange(NT)
        absd = np.zeros(NT, np.int64)
        absd[1:] = (op0[b, 1:] & (eoff[b, :-1] > 0)
                    & (off0[b, 1:] == eoff[b, :-1]))
        L0 = v0[b] & 0x3FF
        nc = np.where(absd.astype(bool) & (L0 == TILE), NT, tl)
        k = np.append(np.minimum.accumulate(nc[::-1])[::-1][1:], NT)
        kk = np.minimum(k, NT - 1)
        Ln = np.where((k < NT) & absd[kk].astype(bool),
                      np.minimum(L0[kk], 1023), 0)
        W = (k - (tl + 1)) * TILE + Ln
        recv = np.where(np.append(absd[1:], 0).astype(bool) & (nc == tl),
                        epos[b], -1)
        # D-F: the literal run entering each tile, from the last tile
        # with an op before it (a prefix maximum); then each tile's ops
        # and literals in order
        has = np.where(nops[b] > 0, tl, -1)
        last = np.concatenate([[-1], np.maximum.accumulate(has)[:-1]])
        carry = np.where(last < 0, 0, TILE - end[b][np.maximum(last, 0)]) \
            + (tl - last - 1) * TILE
        ll, ml, of, lits = [], [], [], []
        for t in range(NT):
            run = carry[t]
            ops = np.flatnonzero(take[b, t])
            vals = opt[b, t, :len(ops)]
            Lt = vals & 0x3FF
            # the walk's literal runs, the first op's with the run entering
            lrun = opl[b, t, :len(ops)] + np.where(np.arange(len(ops)) == 0,
                                                   run, 0)
            keep = slice(int(absd[t]), None)
            ll.append(lrun[keep])
            ml.append((Lt + np.where(ops == recv[t], W[t], 0))[keep])
            of.append(_resolve(vals, off3[b, t, ops])[keep])
            lits.append(blk[b, t * TILE:(t + 1) * TILE][lit[b, t]])
        tk = take[b].copy()
        tk[absd.astype(bool), 0] = False
        # each op's value from its tile's list, in position order
        vals = opt[b][np.arange(TILE // 4)[None] < nops[b][:, None]]
        L2 = np.zeros((NT, TILE), np.int64)
        L2[take[b]] = vals & 0x3FF
        L2 += np.where(np.arange(TILE) == recv[:, None], W[:, None], 0)
        offs = np.zeros((NT, TILE), np.int64)
        offs[take[b]] = _resolve(vals, off3[b][take[b]])
        out.append(dict(take=tk.reshape(-1), lit=lit[b].reshape(-1),
                        L2=L2.reshape(-1), off=offs.reshape(-1),
                        ll=np.concatenate(ll), ml=np.concatenate(ml),
                        of=np.concatenate(of), lits=np.concatenate(lits)))
    return out


@pytest.fixture(scope="module")
def inputs():
    blocks = corpus.corpus_blocks(len(corpus.CLASSES), seed=23)
    found = {cap: [a.numpy() for a in lzkern.find_matches_blocks_ref(
        torch.from_numpy(blocks), slim=cap == lzkern.L_CAP_SLIM)]
        for cap in (lzkern.L_CAP, lzkern.L_CAP_SLIM)}
    out = {}
    for i, name in enumerate(corpus.CLASSES):
        for cap, (off, L) in found.items():
            out[name, cap] = (blocks[i:i + 1], off[i:i + 1], L[i:i + 1])
    for name in corpus.PARSE_CLASSES:
        blk, off, L = corpus.parse_inputs(name)
        out[name, lzkern.L_CAP] = (blk[None], off[None], L[None])
    return out


NAMES = corpus.CLASSES + corpus.PARSE_CLASSES
# the zstd parse runs at the finder's cap 10; the S2 emit at 10 and 6
CASES = ([(name, lzkern.L_CAP, gate) for name in NAMES
          for gate in (True, False)]
         + [(name, lzkern.L_CAP_SLIM, False) for name in corpus.CLASSES])


@pytest.mark.parametrize("name,cap,gate", CASES)
def test_model_stages_match_plain(name, cap, gate, inputs):
    blk, off, L = inputs[name, cap]
    got = model_parse(blk, off, L, cap, gate)[0]
    take, lit, L2, offp = (a[0].numpy() for a in lzemit2.parse_stages(
        torch.from_numpy(blk).to(torch.int32), torch.from_numpy(off),
        torch.from_numpy(L), cap, zstd_gate=gate))
    assert np.array_equal(got["take"], take)
    assert np.array_equal(got["lit"], lit)
    assert np.array_equal(got["L2"][take], L2[take])
    assert np.array_equal(got["off"][take], offp[take])


@pytest.mark.parametrize("kind", ["chains", "all_zeros"])
@pytest.mark.parametrize("cap", [1, 8, 16, 17, 100, 600, 70000])
def test_model_stages_match_plain_any_cap(kind, cap):
    blk, off, L = (a[None] for a in corpus.parse_inputs(kind, cap))
    got = model_parse(blk, off, L, cap, True)[0]
    take, lit, L2, offp = (a[0].numpy() for a in lzemit2.parse_stages(
        torch.from_numpy(blk).to(torch.int32), torch.from_numpy(off),
        torch.from_numpy(L), cap, zstd_gate=True))
    assert np.array_equal(got["take"], take)
    assert np.array_equal(got["lit"], lit)
    assert np.array_equal(got["L2"][take], L2[take])
    assert np.array_equal(got["off"][take], offp[take])


@pytest.mark.parametrize("name", NAMES)
def test_model_zparse_matches_plain(name, inputs):
    blk, off, L = inputs[name, lzkern.L_CAP]
    got = model_parse(blk, off, L, lzkern.L_CAP, True)[0]
    ll, ml, of, lits, n_seqs, lit_cnt = (a[0].numpy() for a in
                                         zparse.parse_blocks_ref(
        *(torch.from_numpy(a) for a in (blk, off, L))))
    n, nl = int(n_seqs), int(lit_cnt)
    assert len(got["ll"]) == n and len(got["lits"]) == nl
    assert np.array_equal(got["ll"], ll[:n])
    assert np.array_equal(got["ml"], ml[:n])
    assert np.array_equal(got["of"], of[:n])
    assert np.array_equal(got["lits"], lits[:nl])
    if name == "most_seqs":
        assert n == 85 * NT
    if name == "no_match":
        assert n == 0 and nl == BS
