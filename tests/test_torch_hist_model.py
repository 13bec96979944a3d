"""A numpy model of the multi-block history execute as ``csrc/exec.cu``'s
cluster kernel runs it, held against the plain PyTorch version
(``ops/exec_kern.execute_blocks_hist_ref``).

The kernel runs a frame on a thread-block cluster of C CTAs.  The step's
64 KiB output half lives in the cluster's distributed shared memory, 512
/ C rows a CTA; each CTA zeroes its rows at the step's start.  Each group
(the history pieces, then one per round) is split by index into C
contiguous ranges, one a CTA; a piece writes its bytes into the rows of
the CTA that owns them and a round reads output bytes from their owner;
history pieces read the frame's earlier output.  A cluster barrier ends
each group, and each CTA stores its rows at the step's end.  The model
does the same with the C owners' rows as separate arrays, the CTAs'
ranges taken in reverse order and each range's pieces in their order
(any order the barrier allows), and stores where the plain version sums:
equal on plans that write no byte twice within a group and read no byte
their own group writes, which the planner's plans satisfy (tested here
too).  Plans: the port's multi-block accel encode of
``corpus.history_streams``, ``corpus.hist_plans`` and random frames of 1
to 16 blocks, at C in {1, 2, 8, 16}, with each group's pieces shuffled.
Tolerance 0: every output is a byte."""

import numpy as np
import pytest
import torch

from compress_tpu_torch import corpus
from compress_tpu_torch.ops import exec_kern, execute
from compress_tpu_torch.zstd import accel as zaccel

HALF = 512 * 128
HIST_BASE = execute.HIST_BASE


def _fields(pieces):
    """(src, offset of dst in the output half, live length) of each
    piece, as the kernel decodes them."""
    src = pieces[:, 0].astype(np.int64)
    w1 = pieces[:, 1].astype(np.int64) & 0xFFFFFFFF
    d = (w1 & 0xFFFFFF) - HALF
    n = np.minimum(((w1 >> 24) & 127) + 1, 128 - (w1 & 127))
    n = np.where((d >= 0) & (d < HALF), n, 0)
    return src, d, n


def _groups(gstart, P, b, k):
    gs = gstart[b, k].astype(np.int64)
    lo = np.clip(gs[:-1], 0, P)
    hi = np.maximum(np.minimum(gs[1:], P), lo)
    return list(zip(lo.tolist(), hi.tolist()))


def model_hist(lit, pieces, gstart, hist_rows, C):
    """The cluster kernel's output, (B, K, 512, 128) uint8."""
    B, K = lit.shape[:2]
    P = len(pieces)
    share = HALF // C
    src, dst, n = _fields(pieces)
    out = np.zeros((B, K * HALF), np.uint8)
    hist_cap = hist_rows * 128
    for b in range(B):
        for k in range(K):
            rows = np.zeros((C, share), np.uint8)      # each CTA's rows
            lit_k = lit[b, k].reshape(-1)
            for g, (lo, hi) in enumerate(_groups(gstart, P, b, k)):
                cut = [lo + (hi - lo) * c // C for c in range(C + 1)]
                for c in reversed(range(C)):
                    idx = np.arange(cut[c], cut[c + 1])
                    p = np.repeat(idx, n[idx])
                    j = np.arange(len(p)) - np.repeat(
                        np.cumsum(n[idx]) - n[idx], n[idx])
                    a = src[p] + j
                    if g == 0:
                        x = a - HIST_BASE
                        at = (k * HALF - hist_cap
                              + np.clip(x >> 7, 0, hist_rows - 1) * 128
                              + (x & 127))
                        val = np.where(at < 0, 0,
                                       out[b, np.maximum(at, 0)])
                    else:
                        at = np.clip(a >> 7, 0, 1023) * 128 + (a & 127)
                        o = np.maximum(at - HALF, 0)
                        val = np.where(at < HALF,
                                       lit_k[np.minimum(at, HALF - 1)],
                                       rows[o // share, o % share])
                    o = dst[p] + j
                    rows[o // share, o % share] = val
            out[b, k * HALF:(k + 1) * HALF] = rows.reshape(-1)
    return out.reshape(B, K, 512, 128)


def _shuffled(pieces, gstart, seed):
    """The plan with each group's pieces in a random order."""
    rng = np.random.default_rng(seed)
    out = pieces.copy()
    B, K = gstart.shape[:2]
    for b in range(B):
        for k in range(K):
            for lo, hi in _groups(gstart, len(pieces), b, k):
                out[lo:hi] = pieces[lo:hi][rng.permutation(hi - lo)]
    return out


def _hold(plans_kb, hb, seed, Cs=(1, 2, 8, 16), shuffle=True):
    pieces, gstart = execute.pack_pieces_mb(plans_kb, hb << 16)
    K = gstart.shape[1]
    lit = np.random.default_rng(seed).integers(
        0, 256, (len(plans_kb), K, 512, 128), np.uint8)
    want = exec_kern.execute_blocks_hist_ref(
        *(torch.from_numpy(a) for a in (lit, pieces, gstart)),
        hb * 512).numpy()
    plans = [pieces] + ([_shuffled(pieces, gstart, seed)] if shuffle else [])
    for pc in plans:
        for C in Cs:
            np.testing.assert_array_equal(
                model_hist(lit, pc, gstart, hb * 512, C), want)
    return pieces, gstart


def _accel_plans(n_streams, blocks, seed):
    """Per-frame plans of the port's multi-block accel encode of
    ``corpus.history_streams`` (as the card test builds them, smaller)."""
    plans_kb = []
    for d in corpus.history_streams(n_streams, blocks << 16, seed=seed):
        side, _frame = zaccel.split_sidecar(
            zaccel.compress_accel(d, level=1, multi_block=True))
        hb, accs = zaccel.parse_sidecar(side)
        plans_kb.append([zaccel.accel_plan(a, hb) for a in accs])
    return plans_kb, hb


def _ops_plans(n_blocks: int, hb: int, seed: int) -> list:
    """Random literal and copy ops of n_blocks 64 KiB blocks (the last
    one short) through the planner, with hb blocks of history."""
    rng = np.random.default_rng(seed)
    hist_cap = hb << 16
    plans = []
    for k in range(n_blocks):
        avail = min(k << 16, hist_cap)
        kinds, lens, offs, pos = [], [], [], 0
        while True:
            if rng.random() < 0.3 or pos + avail == 0:
                op = (0, int(rng.integers(1, 300)), 0)
            else:
                far = int(rng.integers(1, pos + avail + 1))
                op = (1, int(rng.integers(3, 400)),
                      int(rng.choice([1, 2, 3, far, far])))
            if pos + op[1] > 1 << 16:
                break
            kinds.append(op[0])
            lens.append(op[1])
            offs.append(op[2])
            pos += op[1]
        if k < n_blocks - 1:
            kinds.append(0)
            lens.append((1 << 16) - pos)
            offs.append(0)
        dst, src, ln, rnd = execute.plan_ops(kinds, lens, offs, 4,
                                             execute.OUT_BASE, avail,
                                             hist_cap)
        plans.append(dict(src=src.astype(np.int32), dst=dst.astype(np.int32),
                          len=ln.astype(np.int32),
                          round=rnd.astype(np.int32),
                          n_rounds=int(rnd.max()) + 1 if len(rnd) else 1))
    return plans


@pytest.fixture(scope="module")
def accel_plans():
    return _accel_plans(1, 4, 5)


def test_model_matches_plain_on_accel_plans(accel_plans):
    plans_kb, hb = accel_plans
    assert any((p["src"] >= HIST_BASE).any() for p in plans_kb[0][1:])
    _hold(plans_kb, hb, 1)


@pytest.mark.parametrize("hb", [1, 5, 128])
def test_model_matches_plain_on_hostile_plans(hb):
    _hold(corpus.hist_plans(hb), hb, 2)


def test_model_matches_plain_on_frames_of_1_to_16_blocks():
    plans_kb = [_ops_plans(n, 8, 40 + n)[:n] for n in range(1, 17)]
    _hold(plans_kb, 8, 3, Cs=(1, 8, 16), shuffle=False)


@pytest.mark.parametrize("C", [2, 8])
def test_model_matches_plain_on_shuffled_frames(C):
    plans_kb = [_ops_plans(n, 2, 60 + n) for n in (3, 5)]
    _hold(plans_kb, 2, 4, Cs=(C,))


def _group_bytes(pieces, gstart):
    """Per step and group: (bytes written, output bytes read) as offsets
    in the output half."""
    src, dst, n = _fields(pieces)
    B, K = gstart.shape[:2]
    for b in range(B):
        for k in range(K):
            for g, (lo, hi) in enumerate(_groups(gstart, len(pieces), b, k)):
                idx = np.arange(lo, hi)
                p = np.repeat(idx, n[idx])
                j = np.arange(len(p)) - np.repeat(
                    np.cumsum(n[idx]) - n[idx], n[idx])
                a = src[p] + j
                reads = (np.zeros(0, np.int64) if g == 0 else
                         np.clip(a >> 7, 0, 1023) * 128 + (a & 127) - HALF)
                yield dst[p] + j, reads[reads >= 0]


def test_planner_plans_split_safely(accel_plans):
    """What the split relies on: within a group no byte is written twice
    and no piece reads a byte its own group writes, on the planner's
    plans (the accel encode's and random ops through ``plan_ops``)."""
    plans = [execute.pack_pieces_mb(*accel_plans[0:1], accel_plans[1] << 16),
             execute.pack_pieces_mb([_ops_plans(n, 8, 70 + n)
                                     for n in (2, 7)], 8 << 16)]
    groups = 0
    for pieces, gstart in plans:
        for writes, reads in _group_bytes(pieces, gstart):
            assert len(np.unique(writes)) == len(writes)
            assert not np.isin(reads, writes).any()
            groups += 1
    assert groups > 20
