"""The port's host zstd codec (``compress_tpu_torch/zstd``: ``decompress``,
``encoder.compress``, ``block``, ``frame``, ``seqs``; ``huff0`` host
pieces) against the JAX package and ``zstandard`` on the CPU, byte for
byte.

- ``decompress`` equals JAX ``decompress`` and ``zstandard`` on JAX native
  frames (levels 1-4, checksum on and off), ``zstandard`` frames (levels
  1, 3, 19), multi-block frames with raw and RLE blocks, skippable frames
  and the port's own device v2 frames; corrupt inputs raise
  ``ZstdError`` where JAX raises.
- ``encoder.compress_matcher`` is byte-equal to the JAX encoder's Python
  path (its native encoder patched out) and ``encoder.compress`` (the host
  core's ladder) to the unpatched JAX encoder, on every corpus class,
  levels 1-4; under ``predef_seq_tables`` every sequence section has modes
  byte 0, in the ladder's frames and the Matcher's, and the frames decode
  with ``zstandard``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
zstandard = pytest.importorskip("zstandard")

from compress_tpu import zstd as jax_z  # noqa: E402
from compress_tpu.zstd import encoder as jax_enc  # noqa: E402
from compress_tpu.zstd import frame as jax_frame  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch import zstd as Z  # noqa: E402
from compress_tpu_torch.huff0 import batch as HB  # noqa: E402
from compress_tpu_torch.huff0 import table as HT  # noqa: E402
from compress_tpu_torch.ops.zseq_kern import _skip_literals  # noqa: E402
from compress_tpu_torch.zstd import encoder as E  # noqa: E402
from compress_tpu_torch.zstd.device import compress_device  # noqa: E402
from test_torch_jaxref import jax_native_core  # noqa: E402,F401


def _block(cls, n, seed):
    return corpus.make_block(cls, np.random.default_rng(seed)).tobytes()[:n]


def _mixed(n, seed):
    """Text, then a run of zeros, then random bytes: a frame of several
    kinds of block."""
    k = n // 3
    return (_block("text", k, seed) + bytes(k)
            + _block("rand256", n - 2 * k, seed))


def _check(frame, data):
    assert jax_z.decompress(frame) == data
    assert Z.decompress(frame) == data


@pytest.mark.parametrize("level", [1, 2, 3, 4])
@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "xxh"])
def test_decompress_jax_native_frames(level, checksum):
    for data in (_block("text", 40000, level), _mixed(30000, level),
                 _block("period3", 20000, level)):
        frame = jax_z.compress(data, level=level, checksum=checksum)
        _check(frame, data)


@pytest.mark.parametrize("level", [1, 3, 19])
def test_decompress_zstandard_frames(level):
    data = _mixed(60000, level) + _block("rand4", 30000, level)
    frame = zstandard.ZstdCompressor(level=level,
                                     write_checksum=True).compress(data)
    _check(frame, data)


def _block_types(frame):
    h = jax_frame.parse_frame_header(frame)
    pos, types = h.header_size, []
    while True:
        bh = int.from_bytes(frame[pos:pos + 3], "little")
        types.append((bh >> 1) & 3)
        pos += 3 + (1 if (bh >> 1) & 3 == 1 else bh >> 3)
        if bh & 1:
            return types


def test_decompress_multiblock_raw_and_rle_blocks():
    """Blocks of all three types in one frame (zstandard, 128 KiB blocks),
    and the port's own 192 KiB multi-block frame."""
    data = (bytes(140000) + _block("rand256", 65536, 1)
            + _block("text", 65536, 2) + b"\x07" * 50000)
    frame = zstandard.ZstdCompressor(level=3).compress(data)
    assert {0, 1, 2} <= set(_block_types(frame))
    _check(frame, data)
    text = b"".join(_block("text", 65536, s) for s in range(3))
    own = E.compress(text, level=1)
    assert _block_types(own) == [2, 2]
    _check(own, text)


def test_decompress_skippable_frames():
    a, b = _block("text", 9000, 3), _block("rand4", 7000, 4)
    skip = jax_frame.write_skippable_frame(b"side channel", 5)
    stream = (skip + jax_z.compress(a, level=1) + skip
              + zstandard.ZstdCompressor().compress(b) + skip)
    _check(stream, a + b)
    assert Z.decompress(skip) == b""


def test_decompress_port_device_frames():
    data = corpus.replica_jobs(1, 1 << 17).tobytes()
    frame = compress_device(data, job=1 << 17, device="cpu", engine="v2")
    _check(frame, data)
    assert zstandard.ZstdDecompressor().decompress(frame) == data


def _outcome(fn):
    try:
        return fn()
    except ValueError as e:   # ZstdError and its JAX counterpart
        return type(e).__name__


def test_corrupt_inputs_raise_where_jax_raises():
    data = _mixed(20000, 9)
    frames = [jax_z.compress(data, level=2, checksum=True),
              E.compress(data, level=1),
              zstandard.ZstdCompressor(level=3).compress(data)]
    rng = np.random.default_rng(9)
    raised = 0
    for frame in frames:
        cuts = [bytes(frame[:n]) for n in (3, 6, len(frame) // 2,
                                           len(frame) - 1)]
        flips = []
        for _ in range(12):
            bad = bytearray(frame)
            bad[int(rng.integers(4, len(frame)))] ^= 1 << int(
                rng.integers(0, 8))
            flips.append(bytes(bad))
        for bad in cuts + flips:
            want = _outcome(lambda: jax_z.decompress(bad))
            got = _outcome(lambda: Z.decompress(bad))
            if isinstance(want, str):
                assert got == "ZstdError", want
                raised += 1
            else:
                assert got == want
    assert raised >= 20
    dict_frame = jax_frame.write_frame_header(5, 1024, False, False,
                                              dict_id=77) + b"\x01\x00\x00"
    with pytest.raises(Z.ZstdError, match="dictionary"):
        Z.decompress(dict_frame)
    with pytest.raises(jax_z.ZstdError):
        jax_z.decompress(dict_frame)


ENCODER_CASES = [pytest.param(lv, False, id=str(lv)) for lv in (1, 2, 3, 4)] \
    + [pytest.param(lv, True, id=f"native-{lv}") for lv in (1, 2, 3, 4)]


@pytest.mark.parametrize("level,native", ENCODER_CASES)
def test_encoder_matches_jax_python_path(level, native, monkeypatch):
    """The port's Matcher path (``compress_matcher``) equals the JAX
    encoder's Python path (its native ladder patched out); the port's
    default ``compress`` (``native``) equals the unpatched JAX encoder."""
    fn = E.compress if native else E.compress_matcher
    if not native:
        monkeypatch.setattr(jax_enc, "_native_compress", lambda *a, **k: None)
    for i, cls in enumerate(corpus.CLASSES):
        data = _block(cls, 12000 + 1000 * i, level * 10 + i)
        for checksum in (False, True):
            want = jax_enc.compress(data, level=level, checksum=checksum)
            got = fn(data, level=level, checksum=checksum)
            assert got == want, (cls, checksum)
    for data in (b"", b"abc", _mixed(200000, level)):
        assert fn(data, level=level) == jax_enc.compress(data, level=level)


def _seq_modes(frame):
    """The modes byte of every compressed block's sequences section."""
    h = jax_frame.parse_frame_header(frame)
    pos, modes = h.header_size, []
    while True:
        bh = int.from_bytes(frame[pos:pos + 3], "little")
        btype, size = (bh >> 1) & 3, bh >> 3
        pos += 3
        if btype == 2:
            body = frame[pos:pos + size]
            q = _skip_literals(body)
            n = body[q]
            q += 1 if n < 128 else (2 if n < 255 else 3)
            if n:
                modes.append(body[q])
        pos += 1 if btype == 1 else size
        if bh & 1:
            return modes


def test_predef_seq_tables_frames():
    data = _block("text", 65536, 5) + _block("rand4", 30000, 5)
    for fn in (E.compress, E.compress_matcher):
        plain = fn(data, level=1)
        with E.predef_seq_tables():
            frame = fn(data, level=1)
        assert not E._FORCE_PREDEF
        modes = _seq_modes(frame)
        assert modes and all(m == 0 for m in modes)
        assert any(m != 0 for m in _seq_modes(plain))
        assert zstandard.ZstdDecompressor().decompress(frame) == data
        _check(frame, data)


def test_huff0_host_pieces_match_jax():
    from compress_tpu import huff0 as jax_h

    for seed in range(4):
        buf = np.frombuffer(_block("text", 5000 + 3000 * seed, seed),
                            np.uint8)
        hist = np.bincount(buf, minlength=256).astype(np.int64)
        nbits, mb = HT.build_nbits(hist, 11 - seed)
        jn, jmb = jax_h.build_nbits(hist, 11 - seed)
        assert mb == jmb and np.array_equal(nbits, jn)
        codes = HT.canonical_codes(nbits, mb)
        assert np.array_equal(codes, jax_h.canonical_codes(jn, jmb))
        assert HB._encode_stream(buf, codes, nbits) == \
            jax_h._encode_stream(buf, codes, nbits)
        c1 = jax_h.compress_1x(buf.tobytes())
        assert HB.decompress_1x(c1) == jax_h.decompress_1x(c1) == \
            buf.tobytes()
    with pytest.raises(HT.UseRLEError):
        HT.build_nbits(np.bincount(np.zeros(9, np.uint8), minlength=256))
