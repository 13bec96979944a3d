"""The port's sequence decode (``compress_tpu_torch/ops/zseq_kern.py``,
``ops/entropy_dec.py``, ``zstd/seqdev.py``) against the JAX package on the
CPU, bit for bit (tolerance 0: the outputs are integers).

- On predefined-table frames with sidecars (the JAX encoder and
  ``build_sidecar(seq_cks=True)``): ``prep_frames`` arrays equal, the
  packed tables agree once converted, the shared plain decode equals
  ``zseq_decode_chunks_shared(interpret=True)``, and the port's
  ``seq_accel(k=8)`` records equal the sidecar's checkpoints.
- The per-item plain decodes equal the XLA ``zseq_decode_chunks(_rep)`` on
  the ``decode_sequences_device`` inputs of frames with FSE, RLE and
  predefined tables, and ``decode_sequences_device`` equals JAX's.
- Crafted chunks: cursors at and just below the window top, nsym 0 and
  below 8, repeat code 3 at r1 = 1 (each reference's value), offset codes
  23 (device) and 24 (host route)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from compress_tpu import zstd as jax_z  # noqa: E402
from compress_tpu.ops import entropy_dec as jax_ed  # noqa: E402
from compress_tpu.ops import zseq_pallas as jax_zp  # noqa: E402
from compress_tpu.zstd import accel as jax_ac  # noqa: E402
from compress_tpu.zstd.device_dec import \
    _resolve_reps as jax_resolve_reps  # noqa: E402
from compress_tpu.zstd import encoder as jax_enc  # noqa: E402
from compress_tpu.zstd import seqdev as jax_sd  # noqa: E402
from compress_tpu.zstd import seqs as jax_s  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch.fse import core as fse_core  # noqa: E402
from compress_tpu_torch.ops import entropy_dec as ED  # noqa: E402
from compress_tpu_torch.ops import zseq_kern as ZK  # noqa: E402
from compress_tpu_torch.zstd import encoder as E  # noqa: E402
from compress_tpu_torch.zstd import seqdev as SD  # noqa: E402
from compress_tpu_torch.zstd import seqs as S  # noqa: E402
from compress_tpu_torch.zstd.device_dec import _route  # noqa: E402
from test_torch_jaxref import jax_native_core  # noqa: E402,F401


def _text(n, seed):
    return corpus.make_block("text", np.random.default_rng(seed)).tobytes()[:n]


# ---------------------------------------------------------------------------
# table conversions to the two reference layouts
# ---------------------------------------------------------------------------


def _pallas_tables(tset):
    """A port table set (log <= 7) in the Pallas (3, 128) + (2, 128)
    layout."""
    rows = tset[:3 * 512].reshape(3, 512)
    assert not rows[:, 128:].any()
    xb = np.zeros((2, 128), np.int32)
    xb[:, :64] = tset[3 * 512:].reshape(2, 64)
    return rows[:, :128].copy(), xb


def _xla_tables(tset):
    """A port table set as the XLA scan's three (16, 192) float32 planes
    (the baselines and extra-bit counts looked up by code, as the
    reference's ``pack_table`` does)."""
    out = []
    for j, (base_t, bits_t) in enumerate((
            (jax_s.LL_BASELINE, jax_s.LL_BITS),
            (np.zeros(32, np.int64), np.arange(32)),
            (jax_s.ML_BASELINE, jax_s.ML_BITS))):
        e = tset[512 * j:512 * (j + 1)].astype(np.int64)
        spread, nb, ns = e & 63, (e >> 6) & 15, e >> 10
        code = np.clip(spread, 0, len(bits_t) - 1)
        out.append(jax_ed.expand_zseq_table(spread, nb, ns, bits_t[code],
                                            base_t[code]))
    return out


def test_table_sets_match_reference_layouts():
    tst, xb = jax_zp.pack_tables()
    got = _pallas_tables(ZK.pack_tables())
    assert np.array_equal(got[0], tst) and np.array_equal(got[1], xb)
    text = _text(30000, 1)
    own = _items([E.compress(text, level=1)])[0][2:]
    for tabs in (S.predef_tables(), own):
        jt = [jax_s.STable(t.norm, t.log, t.mode, t.rle_symbol)
              for t in tabs]
        tset = ZK.table_set(*(SD.pack_table(t) for t in tabs))
        for got_p, t, which in zip(_xla_tables(tset), jt, ("ll", "of", "ml")):
            assert np.array_equal(got_p, jax_sd.pack_table(t, which))


# ---------------------------------------------------------------------------
# shared mode: predefined-table frames with sidecars
# ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def predef_frames():
    """Single-block predefined-table frames with sequence-checkpoint
    sidecars, made by the JAX package's encoder and ``build_sidecar``."""
    out = []
    for seed, n in ((1, 30000), (2, 20000), (3, 9000)):
        data = _text(n, seed)
        with jax_enc.predef_seq_tables():
            frame = jax_enc.compress(data, level=2)
        side = jax_ac.build_sidecar(frame, seq_cks=True)
        assert side is not None
        out.append(side + frame)
    return out


def test_prep_frames_matches_jax(predef_frames):
    got = ZK.prep_frames(predef_frames)
    want = jax_zp.prep_frames(predef_frames)
    for g, w in zip(got[:6], want[:6]):
        assert g.dtype == w.dtype and np.array_equal(g, w)
    assert got[6] == want[6]


def test_shared_plain_matches_pallas(predef_frames):
    wins, lbit, nsym, sts, rps, last, metas = ZK.prep_frames(predef_frames)
    tst, xb = jax_zp.pack_tables()
    want = jax_zp.zseq_decode_chunks_shared(
        *map(jnp.asarray, (wins, lbit, nsym, sts, rps, last)), tst, xb,
        interpret=True)
    got = ZK.zseq_decode_chunks_shared(
        *map(torch.from_numpy, (wins, lbit, nsym, sts, rps, last,
                                ZK.pack_tables())))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    # and the decoded sequences are the frames' own
    ll, ml, off = (g.numpy() for g in got[:3])
    c0 = 0
    for blob, (nseq, nch) in zip(predef_frames, metas):
        lls, mls, ofvs = jax_s.decode_sequences(
            *_stream_of(blob), *jax_s.predef_tables())
        offs = jax_resolve_reps(lls, mls, ofvs)
        sl = slice(c0, c0 + nch)
        assert np.array_equal(ll[sl].reshape(-1)[:nseq], lls)
        assert np.array_equal(ml[sl].reshape(-1)[:nseq], mls)
        assert np.array_equal(off[sl].reshape(-1)[:nseq], offs)
        c0 += nch


def _stream_of(blob):
    _side, frame = jax_ac.split_sidecar(blob)
    h = jax_z.parse_frame_header(frame)
    return ZK.seq_section(frame[h.header_size + 3:])


def test_seq_accel_matches_sidecar(predef_frames):
    for blob in predef_frames:
        side, _ = jax_ac.split_sidecar(blob)
        a = jax_ac.parse_sidecar(side)[1][0]
        stream, nseq = _stream_of(blob)
        cks = np.array(SD.seq_accel(stream, nseq, *S.predef_tables(), k=8),
                       np.int64)
        assert np.array_equal(cks[:, 0], a.seq_bits)
        assert np.array_equal(cks[:, 1:4], a.seq_states)
        assert np.array_equal(cks[:, 4:7], a.seq_reps)


# ---------------------------------------------------------------------------
# per-item mode: decode_sequences_device inputs
# ---------------------------------------------------------------------------


def _items(frames):
    """The sequence items of single-block frames on the device route."""
    out = []
    for f in frames:
        route, m = _route(f)
        assert route == "dev"
        out.append(m[4])
    return out


def _jax_items(items):
    return [(st, n, *(jax_s.STable(t.norm, t.log, t.mode, t.rle_symbol)
                      for t in tabs)) for st, n, *tabs in items]


def _item_from_section(sec: bytes):
    """The item of a sequences section from the port's encoder."""
    from compress_tpu_torch.zstd import block as B

    n = sec[0] if sec[0] < 128 else ((sec[0] - 128) << 8) + sec[1]
    q = 1 if sec[0] < 128 else 2
    modes = sec[q]
    q += 1
    hist = B.History()
    tabs = []
    for shift, which in ((6, "ll"), (4, "of"), (2, "ml")):
        t, q = B._read_table(sec, q, (modes >> shift) & 3, which, hist, None)
        tabs.append(t)
    return (sec[q:], n, *tabs)


@pytest.fixture(scope="module")
def seq_items():
    """Sections with FSE tables (a frame of the port's encoder), the
    predefined tables (under ``predef_seq_tables``), and RLE tables (one
    match-length code, one offset code)."""
    rng = np.random.default_rng(5)
    frames = [E.compress(_text(24000, 7), level=1)]
    with E.predef_seq_tables():
        frames.append(E.compress(_text(16000, 8), level=3))
    items = _items(frames)
    n = 300
    lls = rng.integers(0, 30, n)
    for mls, ofv in ((np.full(n, 7), rng.integers(4, 5000, n)),
                     (rng.integers(3, 200, n), np.full(n, 1))):
        items.append(_item_from_section(
            E.encode_sequences_section(lls, mls, ofv)))
    modes = {t.mode for it in items for t in it[2:]}
    assert {S.MODE_FSE, S.MODE_RLE, S.MODE_PREDEFINED} <= modes
    return items


@pytest.mark.parametrize("resolve", [False, True], ids=["ofv", "rep"])
def test_per_item_plain_matches_xla(seq_items, resolve):
    metas, a, _ = SD.prep_sequences(seq_items)
    assert all(kind == "dev" for kind, _m in metas)
    jt = [np.stack(p) for p in zip(*(_xla_tables(t) for t in a["tables"]))]
    base = ("windows", "lbit", "sll", "sof", "sml", "nseq", "nore")
    if resolve:
        got, got_e = ED.zseq_decode_chunks_rep(
            *(torch.from_numpy(a[k]) for k in base + ("r1", "r2", "r3",
                                                      "tables")))
        want, want_e = jax_ed.zseq_decode_chunks_rep(
            *(jnp.asarray(a[k]) for k in base + ("r1", "r2", "r3")),
            *map(jnp.asarray, jt))
    else:
        got, got_e = ED.zseq_decode_chunks(
            *(torch.from_numpy(a[k]) for k in base + ("tables",)))
        want, want_e = jax_ed.zseq_decode_chunks(
            *(jnp.asarray(a[k]) for k in base), *map(jnp.asarray, jt))
    assert np.array_equal(got_e.numpy(), np.asarray(want_e))
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("resolve", [False, True], ids=["ofv", "rep"])
def test_decode_sequences_device_matches_jax(seq_items, resolve):
    got = SD.decode_sequences_device(seq_items, resolve=resolve,
                                     device="cpu")
    want = jax_sd.decode_sequences_device(_jax_items(seq_items),
                                          resolve=resolve)
    for g, w, item in zip(got, want, seq_items):
        assert len(g) == len(w) == (4 if resolve else 3)
        for x, y in zip(g, w):
            assert x.dtype == np.int64 and np.array_equal(x, y)
        assert np.array_equal(g[:3], S.decode_sequences(*item))


# ---------------------------------------------------------------------------
# crafted chunks
# ---------------------------------------------------------------------------


def _of23_table_set():
    """FSE tables from random histograms with offset codes up to 23 (the
    XLA scan's exact range)."""
    rng = np.random.default_rng(11)
    rows = []
    for max_sym, log in ((35, 9), (23, 8), (52, 9)):
        hist = rng.integers(1, 50, max_sym + 1)
        norm = fse_core.normalize_count(hist, log, int(hist.sum()), max_sym)
        rows.append(ZK.state_row(*fse_core.build_dtable(norm, log)))
    return ZK.table_set(*rows)


def _crafted(nc, win, logs, seed):
    """Random windows with cursors at the top (8 * win) or just below it,
    and pad chunks; nsym from 0 to 8; states below 2^log; r1 = 1 in some
    chunks."""
    rng = np.random.default_rng(seed)
    windows = rng.integers(0, 256, (nc, win), np.uint8)
    lbit = (8 * win - rng.integers(0, 9, nc)).astype(np.int32)
    nsym = rng.integers(0, 9, nc).astype(np.int32)
    pad = rng.random(nc) < 0.15
    lbit[pad], nsym[pad] = 8 * win, 0
    states = np.stack([rng.integers(0, 1 << lg, nc) for lg in logs],
                      1).astype(np.int32)
    reps = rng.integers(1, 5000, (nc, 3)).astype(np.int32)
    reps[rng.random(nc) < 0.3, 0] = 1
    return windows, lbit, nsym, states, reps


def test_crafted_shared_matches_pallas():
    w, lb, ns, st, rp = _crafted(512, ZK.WIN, (6, 5, 6), seed=1)
    last = (np.random.default_rng(2).random(512) < 0.3).astype(np.int32)
    tst, xb = jax_zp.pack_tables()
    want = jax_zp.zseq_decode_chunks_shared(
        *map(jnp.asarray, (w, lb, ns, st, rp, last)), tst, xb,
        interpret=True)
    got = ZK.zseq_decode_chunks_shared(*map(torch.from_numpy, (
        w, lb, ns, st, rp, last, ZK.pack_tables())))
    for g, x in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(x))


def test_crafted_per_item_matches_xla():
    N, C = 4, 64
    w, lb, ns, st, rp = _crafted(N * C, ED.ZWIN, (9, 8, 9), seed=3)
    nore = np.minimum(ns, np.random.default_rng(4).integers(0, 9, N * C))
    tset = _of23_table_set()
    tables = np.stack([tset] * N)
    cols = [x.reshape(N, C) for x in (lb, st[:, 0], st[:, 1], st[:, 2], ns,
                                      nore.astype(np.int32), rp[:, 0],
                                      rp[:, 1], rp[:, 2])]
    wj = w.reshape(N, C, -1)
    got, got_e = ED.zseq_decode_chunks_rep(
        *map(torch.from_numpy, [wj, *cols, tables]))
    want, want_e = jax_ed.zseq_decode_chunks_rep(
        *map(jnp.asarray, [wj, *cols]),
        *(jnp.asarray(np.stack([p] * N)) for p in _xla_tables(tset)))
    assert np.array_equal(got_e.numpy(), np.asarray(want_e))
    for g, x in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(x))


def _rep3_chunk(win):
    """One chunk whose first sequence is repeat code 3 (offset code 1 with
    extra bit 1, literal length 0) at r1 = 1: RLE tables of one state."""
    rle = [S.STable(None, 0, S.MODE_RLE, rle_symbol=s) for s in (0, 1, 0)]
    tset = ZK.table_set(*(SD.pack_table(t) for t in rle))
    windows = np.zeros((1, win), np.uint8)
    windows[0, -1] = 0x80                  # the offset's extra bit
    return (windows, np.array([8 * win], np.int32), np.ones(1, np.int32),
            np.zeros((1, 3), np.int32), np.array([[1, 4, 8]], np.int32),
            tset)


def test_repeat_code_3_at_r1_1_follows_each_reference():
    w, lb, ns, st, rp, tset = _rep3_chunk(ZK.WIN)
    last = np.ones(1, np.int32)
    tst, xb = _pallas_tables(tset)
    want = jax_zp.zseq_decode_chunks_shared(
        *map(jnp.asarray, (w, lb, ns, st, rp, last)), tst, xb,
        interpret=True)
    got = ZK.zseq_decode_chunks_shared(*map(torch.from_numpy, (
        w, lb, ns, st, rp, last, tset)))
    assert int(np.asarray(want[2])[0, 0]) == int(got[2][0, 0]) == 0
    assert int(got[0][0, 0]) == 0          # ll = 0: the code is 3
    w, lb, ns, st, rp, tset = _rep3_chunk(ED.ZWIN)
    cols = [x.reshape(1, 1) for x in (lb, st[:, 0], st[:, 1], st[:, 2], ns,
                                      ns - 1, rp[:, 0], rp[:, 1], rp[:, 2])]
    got, _ = ED.zseq_decode_chunks_rep(*map(torch.from_numpy, [
        w.reshape(1, 1, -1), *cols, tset[None]]))
    want, _ = jax_ed.zseq_decode_chunks_rep(
        *map(jnp.asarray, [w.reshape(1, 1, -1), *cols]),
        *(jnp.asarray(p[None]) for p in _xla_tables(tset)))
    assert int(np.asarray(want[3])[0, 0, 0]) == int(got[3][0, 0, 0]) == 1
    assert int(got[2][0, 0, 0]) == 3


@pytest.mark.parametrize("code", [23, 24])
def test_offset_code_gate(code):
    """A section that uses offset code 23 decodes on the device; one that
    uses 24 takes the host loop; both equal the host decode and JAX."""
    rng = np.random.default_rng(code)
    n = 40
    lls = rng.integers(0, 40, n)
    mls = rng.integers(3, 60, n)
    ofv = rng.integers(4, 1 << 12, n)
    ofv[n // 2] = (1 << code) + 12345
    tabs = S.predef_tables()
    item = (S.encode_sequences(lls, mls, ofv, *tabs), n, *tabs)
    assert max(S.of_code(ofv)) == code
    stats = {}
    got = SD.decode_sequences_device([item], device="cpu", stats=stats)[0]
    assert (stats["device"], stats["host"]) == ((1, 0) if code == 23
                                                else (0, 1))
    want = jax_sd.decode_sequences_device(_jax_items([item]))[0]
    for g, w, x in zip(got, want, (lls, mls, ofv)):
        assert np.array_equal(g, w) and np.array_equal(g, x)


@pytest.mark.parametrize("kind", [c for c in corpus.ZSEQ_CLASSES
                                  if c != "of31_ones"])
def test_hostile_chunks_match_jax(kind):
    """Each ``corpus.zseq_inputs`` class against the reference its mode
    follows (``of31_ones``, with offset codes beyond 23, the XLA scan's
    exact range, is held against the plain version alone: in the model
    and on the card).

    Shared-mode classes: the plain shared decode against JAX
    ``zseq_decode_chunks_shared(interpret=True)`` (repeat code 3 at r1 = 1
    gives 0) on every chunk whose cursor stays at or above bit 0: the
    Pallas kernel takes each sequence's 64 bits below the cursor with a
    zero-fill shift it keeps in [0, 64), which holds only there.

    Per-item classes: the plain decodes with and without the repeat
    offsets against the XLA ``zseq_decode_chunks(_rep)`` (repeat code 3
    floored at 1 after r1 - 1 in int32, so a carried INT32_MIN gives
    INT32_MAX), every output of every chunk, the chunks that enter with a
    repeat offset of INT32_MIN included."""
    d = corpus.zseq_inputs(kind)
    if d["shared"]:
        args = (d["windows"], d["lbit"], d["nsym"], d["states"], d["reps"],
                d["last"])
        tst, xb = _pallas_tables(d["tables"][0])
        want = jax_zp.zseq_decode_chunks_shared(
            *map(jnp.asarray, args), tst, xb, interpret=True)
        got = ZK.zseq_decode_chunks_shared(*map(torch.from_numpy, (
            *args, d["tables"][0])))
        held = got[3].numpy() >= 0
        assert held.mean() > 0.8
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy()[held], np.asarray(w)[held])
        return
    C = d["per_row"]
    N = len(d["lbit"]) // C
    cols = [np.ascontiguousarray(x).reshape(N, C) for x in (
        d["lbit"], *d["states"].T, d["nsym"], d["nore"])]
    reps = [np.ascontiguousarray(x).reshape(N, C) for x in d["reps"].T]
    wj = d["windows"].reshape(N, C, -1)
    jt = [np.stack(p) for p in zip(*(_xla_tables(t) for t in d["tables"]))]
    got, got_e = ED.zseq_decode_chunks_rep(
        *map(torch.from_numpy, [wj, *cols, *reps, d["tables"]]))
    want, want_e = jax_ed.zseq_decode_chunks_rep(
        *map(jnp.asarray, [wj, *cols, *reps]), *map(jnp.asarray, jt))
    assert np.array_equal(got_e.numpy(), np.asarray(want_e))
    for g, x in zip(got[:3], want[:3]):
        assert np.array_equal(g.numpy(), np.asarray(x))
    assert np.array_equal(got[3].numpy(), np.asarray(want[3]))
    got, got_e = ED.zseq_decode_chunks(
        *map(torch.from_numpy, [wj, *cols, d["tables"]]))
    want, want_e = jax_ed.zseq_decode_chunks(
        *map(jnp.asarray, [wj, *cols]), *map(jnp.asarray, jt))
    assert np.array_equal(got_e.numpy(), np.asarray(want_e))
    for g, x in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(x))
