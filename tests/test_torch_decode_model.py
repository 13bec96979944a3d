"""A numpy model of the two checkpoint-chunk decode kernels as
``csrc/huff0dec.cu`` and ``csrc/zseqdec.cu`` run them, held against the
plain PyTorch versions (``ops/entropy_kern.decode_chunks_plain``,
``ops/zseq_kern.decode_plain``).

The kernels compute the plain versions' function with other steps, which
no CPU test can run; the model runs those steps on the CPU:

- huff0 (a CTA a tile of 256 chunks): a step peeks through a 64-bit
  funnel of two 32-bit window words, clamped at bit 0 and zero-filled
  below it; the CTA stages up to ``stage_slots`` table rows from its
  tile's first, as they are, and a chunk whose row was not staged reads
  it from device memory;
- sequences: the bit container (``ct::BitWindow``), four window words in
  registers refilled from the staged window when a read's word leaves
  words cw .. cw + 2, the reads' positions wrapping as int32 does; the
  carry in 32 bits, with of_val > 3 as offset code >= 2 and a flag per
  carried offset for "2^31 or more", which the floor of repeat code 3
  reads; tiles of 256 chunks, each CTA walking every grid-th tile and
  staging a tile's table rows two at a time, kept while the next tile
  reads them.

Every chunk is decoded once, from its own row.

Inputs: every class of ``corpus.huff0_inputs`` / ``corpus.zseq_inputs``,
huff0 containers of seeded text (shared table, max_log 8 and 11) and of
mixed rows (a table per container), the sequence sections of seeded text
frames (own and predefined tables); the sequence model at every k from 1
to 8 and both repeat-code-3 rules.  Tolerance 0: every output is an
integer.  ``PYTHONPATH=. python tests/test_torch_decode_model.py`` prints
the symbols, chunks and staged chunks of ``chip_smoke.py`` phase 14 (256
seeded text blocks as 1024 rows of 16 KiB, max_log 8)."""

import numpy as np
import pytest
import torch

from compress_tpu_torch import corpus
from compress_tpu_torch import huff0 as H
from compress_tpu_torch.huff0 import batch as HB
from compress_tpu_torch.ops import entropy_dec as ED
from compress_tpu_torch.ops import entropy_kern as EK
from compress_tpu_torch.ops import zseq_kern as ZK

TILE = 256
HD_ROWS = 8
ZS_SLOTS = 2
M32 = (1 << 32) - 1


def _wrap32(x):
    return (np.asarray(x, np.int64) + (1 << 31)) % (1 << 32) - (1 << 31)


# ---- the bit container -------------------------------------------------------

class BitWindows:
    """``ct::BitWindow`` for every chunk at once: window words (NC, ww),
    the container's lowest word and its four words; counts refills."""

    def __init__(self, windows: np.ndarray):
        nc, win = windows.shape
        assert win % 4 == 0
        w = windows.astype(np.uint64)
        self.words = (w[:, 0::4] | w[:, 1::4] << 8 | w[:, 2::4] << 16
                      | w[:, 3::4] << 24)
        self.ww = win // 4
        self.cw = np.full(nc, -(1 << 40), np.int64)   # forces a refill
        self.c = np.zeros((nc, 4), np.uint64)
        self.refills = 0

    def _word(self, j):
        ok = (j >= 0) & (j < self.ww)
        jj = np.clip(j, 0, self.ww - 1)
        v = np.take_along_axis(self.words, jj[:, None], 1)[:, 0]
        return np.where(ok, v, 0).astype(np.uint64)

    def refill(self, wp, where):
        cw = wp - 2
        self.cw = np.where(where, cw, self.cw)
        for q in range(4):
            self.c[:, q] = np.where(where, self._word(cw + q), self.c[:, q])
        self.refills += int(where.sum())

    def get32(self, p, live):
        """32 window bits from position p (int32 values), for the chunks
        where ``live``; the others keep their container."""
        p = _wrap32(p)
        wp = p >> 5
        d = wp - self.cw
        need = live & ((d < 0) | (d > 2))
        self.refill(wp, need)
        d = np.clip(np.where(need, 2, d), 0, 2)
        lo = np.take_along_axis(self.c, d[:, None], 1)[:, 0]
        hi = np.take_along_axis(self.c, d[:, None] + 1, 1)[:, 0]
        return (((hi << 32) | lo) >> (p & 31).astype(np.uint64)) & M32

    def field(self, lbp, n, live):
        v = self.get32(np.asarray(lbp, np.int64) - n, live)
        mask = np.where(n >= 32, M32, (1 << np.minimum(n, 32)) - 1)
        return (v & mask.astype(np.uint64)).astype(np.int64)


# ---- tiles and table rows ----------------------------------------------------

def tile_groups(nc: int, per_row: int, slots: int):
    """(tile, group rows, chunks decoded) as the sequence kernel walks
    them: each tile's rows in groups of ``slots``, a row staged again only
    when its slot held another.  Returns the decoded chunks in order,
    their rows, and the number of stagings."""
    staged = [-1] * slots
    stagings = 0
    order, rows = [], []
    for c0 in range(0, nc, TILE):
        n = min(TILE, nc - c0)
        c = np.arange(c0, c0 + n)
        my = c // per_row if per_row else np.zeros(n, np.int64)
        first, last = int(my[0]), int(my[-1])
        for rg in range(first, last + 1, slots):
            for s in range(slots):
                if rg + s <= last and staged[s] != rg + s:
                    staged[s] = rg + s
                    stagings += 1
            sel = (my >= rg) & (my < rg + slots)
            assert all(staged[int(r) - rg] == r for r in my[sel])
            order.append(c[sel])
            rows.append(my[sel])
    return np.concatenate(order), np.concatenate(rows), stagings


def stage_slots(per_row: int, nc: int) -> int:
    """The table rows a huff0 tile stages (``stage_slots`` in the
    kernel)."""
    if not per_row or per_row % TILE == 0:
        return 1
    span = TILE // per_row if TILE % per_row == 0 else TILE // per_row + 2
    return min(HD_ROWS, span, -(-nc // per_row))


def huff0_staged(nc: int, per_row: int):
    """Per chunk, its row and whether its CTA staged that row: the CTA of
    tile [c0, c0 + 256) stages nr = min(slots, rows it spans) rows from
    its first row."""
    slots = stage_slots(per_row, nc)
    c = np.arange(nc)
    row = c // per_row if per_row else np.zeros(nc, np.int64)
    c0 = c - c % TILE
    first = c0 // per_row if per_row else np.zeros(nc, np.int64)
    last = (np.minimum(c0 + TILE, nc) - 1) // per_row if per_row else first
    span = last - first + 1
    assert (span <= (1 if not per_row or per_row % TILE == 0
                     else TILE // per_row + 2)).all()
    return row, row < first + np.minimum(slots, span)


@pytest.mark.parametrize("kernel", ["huff0", "zseq"])
@pytest.mark.parametrize("per_row", [0, 1, 3, 48, 100, 128, 255, 256, 257,
                                     300, 1633])
def test_tiles_decode_each_chunk_once_from_its_row(per_row, kernel):
    nc = 3 * TILE + 17
    n_rows = -(-nc // per_row) if per_row else 1
    if kernel == "zseq":
        order, rows, stagings = tile_groups(nc, per_row, ZS_SLOTS)
        assert np.array_equal(np.sort(order), np.arange(nc))
        assert np.array_equal(rows, order // per_row if per_row
                              else 0 * order)
        assert stagings >= n_rows
        if per_row >= TILE or per_row == 0:    # at most two rows a tile
            assert stagings <= 2 * (-(-nc // TILE))
        return
    row, staged = huff0_staged(nc, per_row)
    assert np.array_equal(row, np.arange(nc) // per_row if per_row
                          else np.zeros(nc))
    first = (np.arange(nc) // TILE * TILE) // per_row if per_row else row
    assert staged[row == first].all()
    # a tile's rows are all staged wherever it spans HD_ROWS or fewer
    if per_row == 0 or per_row >= 48:
        assert staged.all()
    else:
        assert not staged.all()


# ---- huff0 -------------------------------------------------------------------

def huff0_model(windows, lbit, nsym, tabs, per_row: int, k: int, mb: int):
    """The kernel's steps on every chunk at once.  Returns (syms (NC, k)
    uint8, end cursors (NC,) int32, counts)."""
    nc, win = windows.shape
    assert win % 4 == 0
    w = windows.astype(np.uint64)
    words = w[:, 0::4] | w[:, 1::4] << 8 | w[:, 2::4] << 16 | w[:, 3::4] << 24
    ww = win // 4
    tabs = np.asarray(tabs, np.int64).reshape(-1, 1 << mb)
    row, staged = huff0_staged(nc, per_row)
    ar = np.arange(nc)

    def word(j):
        v = words[ar, np.clip(j, 0, ww - 1)]
        return np.where(j < ww, v, 0).astype(np.uint64)

    lbp = lbit.astype(np.int64)
    ns = nsym.astype(np.int64)
    syms = np.zeros((nc, k), np.int64)
    for i in range(k):
        live = i < ns
        bp = _wrap32(lbp - mb)
        bpc = np.maximum(bp, 0)
        wi = bpc >> 5
        v = ((word(wi) | word(wi + 1) << np.uint64(32))
             >> (bpc & 31).astype(np.uint64)) & M32
        zs = bpc - bp
        peek = np.where(zs >= 32, 0, (v.astype(np.int64)
                                      << np.minimum(zs, 31)) & ((1 << mb) - 1))
        e = tabs[row, peek]
        syms[:, i] = np.where(live, e & 255, 0)
        lbp = np.where(live, _wrap32(lbp - (e >> 8)), lbp)
    counts = dict(symbols=int(np.clip(ns, 0, k).sum()), chunks=nc,
                  staged=int(staged.sum()))
    return (syms.astype(np.uint8), lbp.astype(np.int32), counts)


def _hold_huff0(windows, lbit, nsym, tabs, per_row, k, mb):
    got_s, got_e, counts = huff0_model(windows, lbit, nsym, tabs, per_row,
                                       k, mb)
    want_s, want_e = EK.decode_chunks_plain(
        torch.from_numpy(windows), torch.from_numpy(lbit),
        torch.from_numpy(nsym), torch.from_numpy(np.asarray(tabs)), per_row,
        k, mb)
    assert np.array_equal(got_s, want_s.numpy())
    assert np.array_equal(got_e, want_e.numpy())
    return counts


@pytest.mark.parametrize("kind", corpus.HUFF0_CLASSES)
def test_huff0_model_hostile(kind):
    d = corpus.huff0_inputs(kind)
    counts = _hold_huff0(d["windows"], d["lbit"], d["nsym"], d["tables"],
                         d["per_row"], d["k"], d["max_bits"])
    nc = len(d["lbit"])
    if kind == "per_row_3":         # rows past a tile's eighth: device
        assert 0 < counts["staged"] < nc
    else:
        assert counts["staged"] == nc


def _containers(shared: bool, max_log: int, n_rows: int, seed: int):
    rng = np.random.default_rng(seed)
    if shared:
        rows = np.concatenate([corpus.make_block("text", rng)
                               for _ in range(-(-n_rows // 4))])
        rows = rows[:n_rows * 16384].reshape(n_rows, 16384)
    else:
        rows = corpus.corpus_blocks(-(-n_rows // 4), seed).reshape(-1, 16384)
        rows = rows[:n_rows]
    conts, accel = H.compress_4x_batch(rows, return_accel=True,
                                       shared_table=shared, max_log=max_log,
                                       device="cpu")
    args, metas, _ = HB._prep_decode_batch(conts, accel)
    return [a.numpy() for a in args], metas


@pytest.mark.parametrize("shared,max_log", [(True, 8), (True, 11),
                                            (False, 11)])
def test_huff0_model_containers(shared, max_log):
    (windows, lbit, nsym, tables), metas = _containers(shared, max_log, 8, 3)
    N, C, W = windows.shape
    if shared:
        packed, mb = H.shared_packed_table(metas)
        counts = _hold_huff0(windows.reshape(N * C, W), lbit.reshape(-1),
                             nsym.reshape(-1), packed[None], 0, 32, mb)
    else:
        counts = _hold_huff0(windows.reshape(N * C, W), lbit.reshape(-1),
                             nsym.reshape(-1), tables, C, 32, 11)
    assert counts["staged"] == N * C


# ---- sequences ---------------------------------------------------------------

def zseq_model(windows, lbit, nsym, nore, states, reps, tabs, per_row: int,
               k: int, rep3_floor: bool):
    """The kernel's steps (32-bit carry, bit container) on every chunk at
    once; arguments as ``decode_plain``.  Returns (ll, ml, of_val, off)
    (NC, k) int32 and the end cursors (NC,) int32."""
    nc = windows.shape[0]
    tab = np.asarray(tabs, np.int64).reshape(-1, ZK.ZTAB)
    row = np.arange(nc) // per_row if per_row else np.zeros(nc, np.int64)
    t = tab[row]

    def look(base, idx):
        return np.take_along_axis(t, (base + idx)[:, None], 1)[:, 0]

    bw = BitWindows(windows)
    lbp = lbit.astype(np.int64)
    ns = nsym.astype(np.int64)
    nr = nore.astype(np.int64)
    s_ll, s_of, s_ml = (states[:, j].astype(np.int64) for j in range(3))
    r = [reps[:, j].astype(np.int64) & M32 for j in range(3)]
    big = [np.zeros(nc, bool) for _ in range(3)]
    outs = [np.zeros((nc, k), np.int64) for _ in range(4)]
    for i in range(k):
        act = i < ns
        e_ll = look(ZK.LL_ROW, s_ll & 511)
        e_of = look(ZK.OF_ROW, s_of & 511)
        e_ml = look(ZK.ML_ROW, s_ml & 511)
        of_c = e_of & 63
        x_ml = look(ZK.MLX_ROW, e_ml & 63)
        x_ll = look(ZK.LLX_ROW, e_ll & 63)
        cur = lbp
        of_x = bw.field(cur, of_c, act)
        cur = _wrap32(cur - of_c)
        ml_x = bw.field(cur, x_ml & 31, act)
        cur = _wrap32(cur - (x_ml & 31))
        ll_x = bw.field(cur, x_ll & 31, act)
        cur = _wrap32(cur - (x_ll & 31))
        of_val = np.where(of_c > 0, (1 << np.minimum(of_c, 31)) + of_x,
                          1) & M32
        ml = ((x_ml >> 5) + ml_x) & M32
        ll = ((x_ll >> 5) + ll_x) & M32
        long_ = of_c >= 2
        code = np.where(long_, 0, of_val - 1 + (ll == 0))
        r0, r1, r2 = r
        b0, b1, b2 = big
        if rep3_floor:
            r0s = np.where(r0 >= 1 << 31, r0 - (1 << 32), r0)   # as int32
            # r0 - 1 in int32 (INT32_MIN wraps to INT32_MAX), floored at 1
            rep3 = np.where(b0 | (r0s >= 2) | (r0s == -(1 << 31)),
                            (r0 - 1) & M32, 1)
            b3 = b0 & (r0 != 1 << 31)
        else:
            rep3 = (r0 - 1) & M32
            b3 = np.zeros(nc, bool)
        off = np.where(long_, (of_val - 3) & M32, np.where(
            code == 0, r0, np.where(code == 1, r1, np.where(
                code == 2, r2, rep3))))
        b_off = np.where(long_, (of_c >= 31) & (of_x >= 3), np.where(
            code == 0, b0, np.where(code == 1, b1, np.where(
                code == 2, b2, b3))))
        push2 = long_ | (code >= 2)
        push1 = long_ | (code >= 1)
        n_r = [np.where(push1, off, r0), np.where(push1, r0, r1),
               np.where(push2, r1, r2)]
        n_b = [np.where(push1, b_off, b0), np.where(push1, b0, b1),
               np.where(push2, b1, b2)]
        upd = act & (i < nr)
        nb_ll = (e_ll >> 6) & 15
        nb_ml = (e_ml >> 6) & 15
        nb_of = (e_of >> 6) & 15
        n_ll = (e_ll >> 10) + bw.field(cur, nb_ll, upd)
        cur2 = _wrap32(cur - nb_ll)
        n_ml = (e_ml >> 10) + bw.field(cur2, nb_ml, upd)
        cur2 = _wrap32(cur2 - nb_ml)
        n_of = (e_of >> 10) + bw.field(cur2, nb_of, upd)
        cur2 = _wrap32(cur2 - nb_of)
        cur = np.where(upd, cur2, cur)
        for o, v in zip(outs, (ll, ml, of_val, off)):
            o[:, i] = np.where(act, v, 0)
        lbp = np.where(act, cur, lbp)
        s_ll = np.where(upd, n_ll, s_ll)
        s_ml = np.where(upd, n_ml, s_ml)
        s_of = np.where(upd, n_of, s_of)
        r = [np.where(act, a, b) for a, b in zip(n_r, r)]
        big = [np.where(act, a, b) for a, b in zip(n_b, big)]
    return ([_wrap32(o).astype(np.int32) for o in outs],
            lbp.astype(np.int32), bw.refills)


def _hold_zseq(windows, lbit, nsym, nore, states, reps, tabs, per_row, k,
               floor):
    got, got_e, _ = zseq_model(windows, lbit, nsym, nore, states, reps,
                               tabs, per_row, k, floor)
    want = ZK.decode_plain(*(torch.from_numpy(np.ascontiguousarray(a)) for a
                             in (windows, lbit, nsym, nore, states, reps,
                                 tabs)), per_row, k, floor)
    for g, w in zip(got, want[:4]):
        assert np.array_equal(g, w.numpy())
    assert np.array_equal(got_e, want[4].numpy())


def _nore(d):
    if "nore" in d:
        return d["nore"]
    return (d["nsym"] - (d["last"] > 0)).astype(np.int32)


@pytest.mark.parametrize("floor", [False, True], ids=["pallas", "xla"])
@pytest.mark.parametrize("kind", corpus.ZSEQ_CLASSES)
def test_zseq_model_hostile(kind, floor):
    d = corpus.zseq_inputs(kind)
    _hold_zseq(d["windows"], d["lbit"], d["nsym"], _nore(d), d["states"],
               d["reps"], d["tables"], d["per_row"], d["k"], floor)


@pytest.mark.parametrize("k", range(1, 9))
def test_zseq_model_every_k(k):
    for kind in ("of31_ones", "per_row_100"):
        d = corpus.zseq_inputs(kind)
        _hold_zseq(d["windows"], d["lbit"], d["nsym"], _nore(d),
                   d["states"], d["reps"], d["tables"], d["per_row"], k,
                   True)


def test_zseq_model_offset_31_carry():
    """Offset code 31 with every extra bit set gives of_val 2^32 - 1 and
    carries 2^32 - 4; repeat code 3 after it floors on the 64-bit value,
    which the flag keeps."""
    d = corpus.zseq_inputs("of31_ones")
    got, _e, _r = zseq_model(d["windows"], d["lbit"], d["nsym"], d["nore"],
                             d["states"], d["reps"], d["tables"],
                             d["per_row"], 8, True)
    assert (got[2] == -1).any()            # of_val 2^32 - 1 (low 32 bits)
    assert (got[3] == -4).any()            # its offset 2^32 - 4


def test_zseq_model_text_frames():
    """The sequence sections of seeded text frames (own tables and the
    predefined ones), in per-item mode and, for the predefined half, in
    the shared mode's layout."""
    from compress_tpu_torch.zstd import encoder as E
    from compress_tpu_torch.zstd import seqdev as SD
    from compress_tpu_torch.zstd.device_dec import _route

    rng = np.random.default_rng(9)
    texts = [corpus.make_block("text", rng).tobytes()[:30000]
             for _ in range(4)]
    frames = [E.compress(t, level=1) for t in texts[:2]]
    with E.predef_seq_tables():
        frames += [E.compress(t, level=1) for t in texts[2:]]
    items = [_route(f)[1][4] for f in frames]
    _metas, a, _w = SD.prep_sequences(items)
    N, C = a["lbit"].shape
    flat = {key: a[key].reshape(N * C, -1) for key in a if key != "tables"}
    states = np.concatenate([flat["sll"], flat["sof"], flat["sml"]], 1)
    reps = np.concatenate([flat["r1"], flat["r2"], flat["r3"]], 1)
    _hold_zseq(flat["windows"], flat["lbit"][:, 0], flat["nseq"][:, 0],
               flat["nore"][:, 0], states, reps, a["tables"], C, 8, True)


def _phase14_counts():
    (windows, lbit, nsym, _t), metas = _containers(True, 8, 1024, 0)
    N, C, W = windows.shape
    packed, mb = H.shared_packed_table(metas)
    _s, _e, counts = huff0_model(windows.reshape(N * C, W),
                                 lbit.reshape(-1), nsym.reshape(-1),
                                 packed[None], 0, 32, mb)
    return counts


if __name__ == "__main__":
    c = _phase14_counts()
    print(f"phase-14 text, shared table: {c['symbols']} symbols in "
          f"{c['chunks']} chunks, {c['staged']} of them from the staged "
          "table")
