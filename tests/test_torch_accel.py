"""The port's accel encode and multi-block decode against the JAX package
on the CPU (tolerance 0: bytes and integers).

- ``s2.encode`` equals JAX ``s2.encode`` (its native core, which the
  reference specifies equal to its Python path) on every corpus class and
  at sizes 0, 1, 17, 4096, 65536 and 65537.
- ``zstd/accel.build_sidecar`` equals JAX's (a wrapper of the native
  ``ct_zstd_build_sidecar``) byte for byte, or both are None, on frames
  of the port's encoder (levels 1-4, predefined tables), of JAX's native
  ``compress`` and ``_compress_frame_bs`` (history of 1, 3 and 8
  blocks), of ``zstandard`` (among them 64 KiB-block frames with raw,
  RLE, 1X, treeless and repeat-table blocks), with and without sequence
  checkpoints, on ineligible frames and on frames with flipped bits.
- ``compress_accel`` / ``split_stream_accel`` streams decode with
  ``zstandard``, the port's host decoder, JAX's and the port's
  ``decompress_frames_device``; the multi-block frames keep 64 KiB blocks
  and offsets within their window, and JAX's builder accepts them.
- ``plan_ops`` without history equals JAX ``plan_block_ops``;
  ``pack_plans_mb`` and ``execute_blocks_hist_ref`` (on the compact plan
  of ``pack_pieces_mb``) equal JAX ``pack_plans_mb`` and
  ``execute_blocks_hist`` (its XLA scan) on the plans of multi-block
  sidecars and on ``corpus.hist_plans``.
- The accel and accel_mb routes make no host walk (``_hwalk``,
  ``seq_accel``); a hostile multi-block sidecar sends its frame to the
  host decoder."""

import io

import numpy as np
import pytest

jax = pytest.importorskip("jax")
zstandard = pytest.importorskip("zstandard")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from compress_tpu import s2 as jax_s2  # noqa: E402
from compress_tpu import zstd as jax_z  # noqa: E402
from compress_tpu.ops import execute as jax_x  # noqa: E402
from compress_tpu.zstd import accel as jax_a  # noqa: E402
from compress_tpu.zstd import device_dec as jax_dd  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch import s2 as S2  # noqa: E402
from compress_tpu_torch import zstd as Z  # noqa: E402
from compress_tpu_torch.ops import exec_kern  # noqa: E402
from compress_tpu_torch.ops import execute as X  # noqa: E402
from compress_tpu_torch.utils.crc import crc32c  # noqa: E402
from compress_tpu_torch.zstd import accel as A  # noqa: E402
from compress_tpu_torch.zstd import block as B  # noqa: E402
from compress_tpu_torch.zstd import device_dec as DD  # noqa: E402
from compress_tpu_torch.zstd import encoder as E  # noqa: E402
from compress_tpu_torch.zstd import seqdev  # noqa: E402
from compress_tpu_torch.zstd.frame import parse_frame_header  # noqa: E402
from test_torch_jaxref import jax_native_core  # noqa: E402,F401

BS = 1 << 16


def _text(seed: int, n: int = BS) -> bytes:
    return corpus.make_block("text", np.random.default_rng(seed)).tobytes()[:n]


def _same_sidecar(frame: bytes, **kw) -> bytes | None:
    got = A.build_sidecar(frame, **kw)
    assert got == jax_a.build_sidecar(frame, **kw)
    return got


def _zstandard_64k(data: bytes, level: int) -> bytes:
    """A libzstd frame whose window, and so its block size, is 64 KiB."""
    p = zstandard.ZstdCompressionParameters.from_level(level, window_log=16)
    return zstandard.ZstdCompressor(compression_params=p).compress(data)


def _block_kinds(frame: bytes) -> set:
    """The block shapes of a frame: "raw", "rle", "1x", "4x", "treeless",
    "raw_lit", "rle_lit" and "repeat" (a sequence table in repeat mode)."""
    pos = parse_frame_header(frame).header_size
    kinds = set()
    while True:
        bh = int.from_bytes(frame[pos:pos + 3], "little")
        pos += 3
        btype, bsize = (bh >> 1) & 3, bh >> 3
        if btype == B.BLOCK_RAW:
            kinds.add("raw")
        elif btype == B.BLOCK_RLE:
            kinds.add("rle")
        else:
            body = frame[pos:pos + bsize]
            lt, sf = body[0] & 3, (body[0] >> 2) & 3
            if lt < 2:
                regen, q = B.raw_lit_size(body, 0, sf)
                q += regen if lt == 0 else 1
                kinds.add("raw_lit" if lt == 0 else "rle_lit")
            else:
                _regen, comp, q = B.huff_lit_sizes(body, 0, sf)
                q += comp
                kinds.add("treeless" if lt == 3 else
                          "1x" if sf == 0 else "4x")
            nseq = body[q]
            q += 1 + (nseq >= 128) + (nseq == 255)
            if nseq and any((body[q] >> s) & 3 == 3 for s in (2, 4, 6)):
                kinds.add("repeat")
        pos += 1 if btype == B.BLOCK_RLE else bsize
        if bh & 1:
            return kinds


# ---- S2 encode -------------------------------------------------------------

@pytest.mark.parametrize("cls", corpus.CLASSES)
def test_s2_encode_matches_jax(cls):
    d = corpus.make_block(cls, np.random.default_rng(3)).tobytes()
    assert S2.encode(d) == jax_s2.encode(d)
    assert S2.decode(S2.encode(d)) == d


@pytest.mark.parametrize("n", [0, 1, 17, 4096, 65536, 65537])
def test_s2_encode_edge_sizes_match_jax(n):
    d = corpus.corpus_blocks(2, 5).tobytes()[:n]
    assert S2.encode(d) == jax_s2.encode(d)


# ---- the sidecar builder -------------------------------------------------

@pytest.mark.parametrize("seq_cks", [False, True], ids=["plan", "cks"])
@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_sidecar_of_port_frames(level, seq_cks):
    frame = E.compress(_text(level, 30000), level=level)
    assert _same_sidecar(frame, seq_cks=seq_cks) is not None


def test_sidecar_of_predefined_table_frames():
    with E.predef_seq_tables():
        frame = E.compress(_text(9, 40000), level=1)
    for seq_cks in (False, True):
        assert _same_sidecar(frame, seq_cks=seq_cks) is not None


@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_sidecar_of_jax_native_frames(level):
    frame = jax_z.compress(_text(20 + level, 40000), level=level)
    assert _same_sidecar(frame, max_rounds=level) is not None


@pytest.fixture(scope="module")
def mb_data():
    """Four blocks of text whose later blocks repeat stretches 1 to 3
    blocks back."""
    return b"".join(corpus.history_streams(1, 4 * BS, seed=3))


@pytest.mark.parametrize("seq_cks", [False, True], ids=["plan", "cks"])
@pytest.mark.parametrize("hb", [1, 3, 8])
def test_sidecar_of_jax_multi_block_frames(mb_data, hb, seq_cks):
    frame = jax_a._compress_frame_bs(mb_data, 1, 16, hb << 16)
    assert _same_sidecar(frame, hist_blocks=hb, seq_cks=seq_cks) is not None


@pytest.fixture(scope="module")
def mixed_data():
    """64 KiB blocks of the shapes libzstd writes at a 64 KiB window: text,
    zeros (an RLE block), a near copy of the block before (few sequences:
    treeless literals, and from level 7 on sequence tables in repeat
    mode), random bytes (a raw block), runs of one byte."""
    t = [_text(40 + i) for i in range(3)]
    near = bytearray(t[1])
    rng = np.random.default_rng(1)
    for j, at in enumerate(rng.integers(0, BS - 16, 30)):
        near[at:at + 12] = t[2][12 * j:12 * j + 12]
    rand = rng.integers(0, 256, BS, np.uint8).tobytes()
    return (t[0] + bytes(BS) + t[1] + bytes(near) + rand + t[2]
            + b"\x07" * 70000 + t[0][:5000])


ZSTANDARD_LEVELS = (1, 7, 19)


@pytest.mark.parametrize("seq_cks", [False, True], ids=["plan", "cks"])
@pytest.mark.parametrize("level", ZSTANDARD_LEVELS)
def test_sidecar_of_zstandard_block_shapes(mixed_data, level, seq_cks):
    frame = _zstandard_64k(mixed_data, level)
    for hb in (1, 3):
        assert _same_sidecar(frame, hist_blocks=hb,
                             seq_cks=seq_cks) is not None


def _zstandard_frame(level: int, n: int) -> bytes:
    return zstandard.ZstdCompressor(level=level).compress(_text(50, n))


def test_zstandard_frames_cover_every_block_shape(mixed_data):
    kinds = _block_kinds(_zstandard_frame(3, 200))
    for level in ZSTANDARD_LEVELS:
        kinds |= _block_kinds(_zstandard_64k(mixed_data, level))
    assert kinds >= {"raw", "rle", "1x", "4x", "treeless", "repeat"}


@pytest.mark.parametrize("n", [200, 50000])
@pytest.mark.parametrize("level", [1, 3, 19])
def test_sidecar_of_zstandard_frames(level, n):
    assert _same_sidecar(_zstandard_frame(level, n)) is not None


def test_sidecar_none_on_the_same_ineligible_frames(mixed_data):
    rand = np.random.default_rng(6).integers(0, 256, 9000,
                                             np.uint8).tobytes()
    long_blocks = zstandard.ZstdCompressor(level=3).compress(mixed_data)
    frames = [
        (E.compress(rand, level=1), {}),                  # raw block only
        (long_blocks, {"hist_blocks": 8}),                # 128 KiB blocks
        (_zstandard_64k(mixed_data, 3), {}),              # no history
        (E.compress(_text(7, 2000), level=1), {"hist_blocks": 129}),
    ]
    for frame, kw in frames:
        assert _same_sidecar(frame, **kw) is None


@pytest.fixture(scope="module")
def fuzz_frames(mb_data):
    """(frame, hist_blocks) to corrupt: single-block frames of the port's
    encoder and of ``zstandard``, multi-block frames of the port's
    ``compress_frame_bs`` and of ``zstandard`` at a 64 KiB window."""
    p = zstandard.ZstdCompressionParameters.from_level(7, window_log=16)
    return {"single": [(E.compress(_text(80, 20000), level=1), 0),
                       (zstandard.ZstdCompressor(level=3).compress(
                           _text(81, 9000)), 0)],
            "multi": [(E.compress_frame_bs(mb_data[:3 * BS], 1, 16,
                                           2 << 16), 2),
                      (zstandard.ZstdCompressor(compression_params=p)
                       .compress(mb_data[:3 * BS]), 1)]}


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("kind", ["single", "multi"])
def test_sidecar_matches_jax_on_corrupted_frames(fuzz_frames, kind, seed):
    """Frames with one to three flipped bits: both builders give the same
    sidecar, or both None (the eligibility rules of the walk)."""
    rng = np.random.default_rng([seed, len(kind)])
    outcomes = set()
    for i in range(12 if kind == "single" else 4):
        frame, hb = fuzz_frames[kind][i % 2]
        bad = bytearray(frame)
        for _ in range(int(rng.integers(1, 4))):
            k = int(rng.integers(6, len(bad)))
            bad[k] ^= 1 << int(rng.integers(0, 8))
        for seq_cks in (False, True):
            got = _same_sidecar(bytes(bad), hist_blocks=hb, seq_cks=seq_cks)
            outcomes.add(got is None)
    if kind == "single":
        assert outcomes == {True, False}


# ---- accel encode and decode -----------------------------------------------

def _frame_offsets(frame: bytes):
    """(decoded size of each block, every sequence's resolved offset) of
    a frame, walked with the port's host decoder pieces."""
    pos = parse_frame_header(frame).header_size
    hist = B.History(window_size=1 << 23)
    sizes, offs = [], []
    while True:
        bh = int.from_bytes(frame[pos:pos + 3], "little")
        pos += 3
        btype, bsize = (bh >> 1) & 3, bh >> 3
        body = frame[pos:pos + (1 if btype == B.BLOCK_RLE else bsize)]
        if btype == B.BLOCK_COMPRESSED:
            lits, q = B.decode_literals(body, 0, hist)
            lls, mls, ofv, _q = B.decode_sequences_section(body, q, hist)
            r = hist.rep_offsets
            if lls is not None:
                r1, r2, r3 = r
                for ll, o in zip(lls.tolist(), ofv.tolist()):
                    if o > 3:
                        r1, r2, r3 = o - 3, r1, r2
                    else:
                        c = o - 1 + (ll == 0)
                        if c == 1:
                            r1, r2 = r2, r1
                        elif c == 2:
                            r1, r2, r3 = r3, r1, r2
                        elif c == 3:
                            r1, r2, r3 = r1 - 1, r1, r2
                    offs.append(r1)
            out = B.execute_sequences(lits, lls, mls, ofv, hist, 1 << 17)
        else:
            out = body if btype == B.BLOCK_RAW else body * bsize
        hist.append(out)
        sizes.append(len(out))
        pos += 1 if btype == B.BLOCK_RLE else bsize
        if bh & 1:
            return sizes, offs


@pytest.fixture(scope="module")
def accel_streams(mb_data):
    """(input, port compress_accel stream, multi_block, hist_blocks)."""
    small = _text(60, 20000)
    out = [(small, A.compress_accel(small, level=1), False, 0),
           (mb_data[:150000], A.compress_accel(mb_data[:150000], level=2),
            False, 0)]
    for hb, n in ((8, 4 * BS), (3, 3 * BS + 777), (1, 2 * BS + 5)):
        d = mb_data[:n]
        out.append((d, A.compress_accel(d, level=1, multi_block=True,
                                        hist_blocks=hb), True, hb))
    return out


def test_accel_streams_decode_everywhere(accel_streams):
    for data, blob, _mb, _hb in accel_streams:
        r = zstandard.ZstdDecompressor().stream_reader(
            io.BytesIO(blob), read_across_frames=True)
        assert r.read() == data
        assert Z.decompress(blob) == data
        items = A.split_stream_accel(blob)
        assert b"".join(jax_dd.decompress_frames_device(items)) == data
        assert b"".join(DD.decompress_frames_device(items,
                                                    device="cpu")) == data


def test_multi_block_frames_keep_blocks_and_window(accel_streams):
    for data, blob, mb, hb in accel_streams:
        if not mb:
            continue
        items = A.split_stream_accel(blob)
        assert len(items) == 1
        side, frame = A.split_sidecar(items[0])
        n_blocks = -(-len(data) // BS)
        hb = min(hb, n_blocks - 1)
        assert A.parse_sidecar(side)[0] == hb
        sizes, offs = _frame_offsets(frame)
        assert sizes[:-1] == [BS] * (n_blocks - 1)
        assert 0 < max(offs) <= hb << 16
        assert jax_a.build_sidecar(frame, hist_blocks=hb) is not None
        assert A.build_sidecar(frame, hist_blocks=hb) == \
            jax_a.build_sidecar(frame, hist_blocks=hb)


def test_split_stream_accel_matches_jax(accel_streams):
    for _data, blob, _mb, _hb in accel_streams:
        assert A.split_stream_accel(blob) == jax_a.split_stream_accel(blob)
    tail = accel_streams[0][1] + b"\x5a\x2a\x4d\x18\x02\x00\x00\x00ab"
    assert A.split_stream_accel(tail) == jax_a.split_stream_accel(tail)


def test_compress_accel_small_and_segmented_frames_match_encoder():
    d = _text(61) + _text(62, 4464)
    blob = A.compress_accel(d, level=3)
    items = A.split_stream_accel(blob)
    assert len(items) == 2
    for item, lo in zip(items, (0, BS)):
        side, frame = A.split_sidecar(item)
        assert frame == E.compress(d[lo:lo + BS], level=3)
        assert side is not None
    assert A.compress_accel(b"") == E.compress(b"")


# ---- the planner and the history executor ----------------------------------

def test_plan_ops_without_history_matches_jax(mb_data):
    frame = E.compress(mb_data[:BS], level=1)
    body = DD._parse_single_block(frame)
    lit = DD._parse_4x_literals(body)
    seq = DD._route(frame)[1][4]
    walk = seqdev.seq_walk(seq[0], seq[1], *seq[2:])
    _cks, lls, mls, offs, _r = walk
    kinds, lens, offsets = [], [], []
    for ll, ml, off in zip(lls, mls, offs):
        kinds += [0, 1]
        lens += [ll, ml]
        offsets += [0, off]
    kinds.append(0)
    lens.append(lit[0] - sum(lls))
    offsets.append(0)
    for max_rounds in (1, 2, 4):
        got = X.plan_ops(kinds, lens, offsets, max_rounds, X.OUT_BASE,
                         hist_avail=0, hist_cap=0)
        want = jax_x.plan_block_ops(np.array(kinds), np.array(lens),
                                    np.array(offsets), max_rounds)
        for g, key in zip(got, ("dst", "src", "len", "round")):
            assert np.array_equal(g, want[key])


def _sidecar_plans(blob: bytes):
    side, _frame = A.split_sidecar(A.split_stream_accel(blob)[0])
    hb, accs = A.parse_sidecar(side)
    return hb, [A.accel_plan(a, hb) for a in accs]


def _hold_hist(plans_kb, hb, seed):
    """pack_plans_mb against JAX, and execute_blocks_hist_ref on the
    compact plan against the JAX scan on the padded one."""
    got = X.pack_plans_mb(plans_kb, hb << 16)
    want = jax_x.pack_plans_mb(plans_kb, hb << 16)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert np.array_equal(np.asarray(g), np.asarray(w))
    hsrc, hdst, hlen, src, dst, length, adv, caps, _hcap = want
    K, Bn = adv.shape
    rng = np.random.default_rng(seed)
    lit = rng.integers(0, 256, (Bn, K, 512, 128), np.uint8)
    ref = jax_x.execute_blocks_hist(
        jnp.asarray(lit.transpose(1, 0, 2, 3)), *map(jnp.asarray, (
            hsrc, hdst, hlen, src, dst, length, adv)), caps, hb * 512)
    pieces, gstart = X.pack_pieces_mb(plans_kb, hb << 16)
    out = X.execute_blocks_hist(*(torch.from_numpy(a) for a in (
        lit, pieces, gstart)), hb * 512)
    assert np.array_equal(out.numpy(),
                          np.asarray(ref).transpose(1, 0, 2, 3))
    return out


def test_history_executor_matches_jax_on_sidecar_plans(accel_streams):
    """Frames of 4, 3 and 2 blocks at histories of 8, 3 and 1 blocks,
    each group at its own history size, and two frames of unequal block
    counts in one group."""
    plans = [_sidecar_plans(blob) for _d, blob, mb, _hb in accel_streams
             if mb]
    for hb, p in plans:
        _hold_hist([p], hb, hb)
    extra = A.compress_accel(_text(70) + _text(71)[:9000], level=1,
                             multi_block=True, hist_blocks=8)
    hb, p2 = _sidecar_plans(extra)
    assert hb == 1
    _hold_hist([plans[-1][1], p2], 1, 5)


@pytest.mark.parametrize("hb", [1, 8])
def test_history_executor_hostile_plans_match_jax(hb):
    out = _hold_hist(corpus.hist_plans(hb), hb, 100 + hb).numpy()
    # the first step's history reads before the frame: zeros
    assert not out[0, 0].reshape(-1)[:256].any()
    assert not out[2, 0].reshape(-1)[64:128].any()


def test_pack_pieces_mb_layout():
    plans_kb = corpus.hist_plans(8)
    pieces, gstart = X.pack_pieces_mb(plans_kb, 8 << 16)
    assert gstart.shape == (3, 3, 5)       # 3 frames, 3 steps, nr 3 + 2
    src = pieces[:, 0]
    for b, pb in enumerate(plans_kb):
        for k in range(3):
            lo, hi = gstart[b, k, 0], gstart[b, k, 1]
            assert (src[lo:hi] >= X.HIST_BASE).all()
            assert (src[hi:gstart[b, k, -1]] < X.HIST_BASE).all()
            if k >= len(pb):
                assert gstart[b, k, 0] == gstart[b, k, -1]
    assert gstart[-1, -1, -1] == len(pieces)


def test_pack_mb_rejects_what_jax_rejects():
    bad_round = corpus.hist_plans(1)
    p = bad_round[0][0]
    p["round"] = np.where(p["src"] >= X.HIST_BASE, 1, p["round"])
    p["n_rounds"] = 3
    out_of_range = corpus.hist_plans(1)
    out_of_range[1][1]["src"][0] = X.HIST_BASE + (1 << 16) - 10
    for plans_kb in (bad_round, out_of_range):
        for pack in (X.pack_plans_mb, jax_x.pack_plans_mb,
                     X.pack_pieces_mb):
            with pytest.raises(ValueError):
                pack(plans_kb, 1 << 16)


def test_execute_blocks_hist_rejects_bad_shapes():
    lit = torch.zeros((2, 3, 512, 128), dtype=torch.uint8)
    pieces = torch.zeros((0, 2), dtype=torch.int32)
    gstart = torch.zeros((2, 3, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="lit_rows"):
        exec_kern.execute_blocks_hist(lit[0], pieces, gstart, 512)
    with pytest.raises(ValueError, match="gstart"):
        exec_kern.execute_blocks_hist(lit, pieces, gstart[:1], 512)
    with pytest.raises(ValueError, match="hist_rows"):
        exec_kern.execute_blocks_hist(lit, pieces, gstart, 256)
    assert not exec_kern.execute_blocks_hist(lit, pieces, gstart,
                                             512).any()


# ---- the decode routes -------------------------------------------------------

def _counting(monkeypatch):
    calls = {"hwalk": 0, "seq_accel": 0}
    for mod, name, key in ((DD, "_hwalk", "hwalk"),
                           (seqdev, "seq_accel", "seq_accel")):
        orig = getattr(mod, name)

        def counted(*a, _orig=orig, _key=key, **kw):
            calls[_key] += 1
            return _orig(*a, **kw)

        monkeypatch.setattr(mod, name, counted)
    return calls


def test_accel_routes_make_no_host_walk(accel_streams, monkeypatch):
    items = [it for _d, blob, _mb, _hb in accel_streams
             for it in A.split_stream_accel(blob)]
    calls = _counting(monkeypatch)
    stats = {}
    before = DD.decompress_frames_device.host_frames
    out = DD.decompress_frames_device(items, device="cpu", stats=stats)
    assert calls == {"hwalk": 0, "seq_accel": 0}
    assert DD.decompress_frames_device.host_frames == before
    assert stats["routes"] == {"accel": len(items) - 3, "accel_mb": 3}
    assert b"".join(out) == b"".join(d for d, *_r in accel_streams)


def _round_array_at(payload: bytes, block: int) -> int:
    """Where the round array of a block's plan starts in a sidecar
    payload ('CTA3')."""
    pos = 8
    for i in range(int.from_bytes(payload[4:6], "little")):
        flags, kind = payload[pos], payload[pos + 1]
        pos += 14
        for _q in range({0: 4, 3: 1}.get(kind, 0)):
            pos += 2 + 4 * int.from_bytes(payload[pos:pos + 2], "little")
        if flags & 2:
            pos += 2 + 22 * int.from_bytes(payload[pos:pos + 2], "little")
        n = int.from_bytes(payload[pos:pos + 4], "little")
        pos += 5
        if i == block:
            return pos + 5 * n
        pos += 6 * n
    raise IndexError(block)


def test_hostile_multi_block_sidecar_falls_back(accel_streams):
    data, blob, _mb, _hb = accel_streams[2]
    item = A.split_stream_accel(blob)[0]
    payload_len = int.from_bytes(item[4:8], "little")
    rng = np.random.default_rng(3)
    bad = []
    for _ in range(8):
        b = bytearray(item)
        k = 8 + int(rng.integers(0, payload_len))
        b[k] ^= 1 + int(rng.integers(0, 255))
        bad.append(bytes(b))
    # a sidecar that passes its CRC with a history piece beyond round 0:
    # accel_plan refuses it before any launch
    side, frame = A.split_sidecar(item)
    _hb, accs = A.parse_sidecar(side)
    hist = np.flatnonzero(accs[1].src >= X.HIST_BASE)
    assert len(hist)
    rec = bytearray(side)
    rec[_round_array_at(side, 1) + int(hist[0])] = 1
    payload = b"CTAC" + crc32c(bytes(rec)).to_bytes(4, "little") + bytes(rec)
    forged = ((0x184D2A5A).to_bytes(4, "little")
              + len(payload).to_bytes(4, "little") + payload + frame)
    assert DD._route(forged)[0] == "accel_mb"
    with pytest.raises(ValueError, match="round 0"):
        A.accel_plan(A.parse_sidecar(A.split_sidecar(forged)[0])[1][1], 8)
    bad.append(forged)
    before = DD.decompress_frames_device.host_frames
    out = DD.decompress_frames_device(bad, device="cpu")
    assert out == [data] * len(bad)
    assert DD.decompress_frames_device.host_frames - before >= 1
    assert jax_dd.decompress_frames_device(bad) == out
