"""The port's converters and snappy facades (``s2/lz4convert.py``,
``snappy/__init__.py``, ``snappy/xerial.py``, ``zstd/snappy_convert.py``)
against the JAX package's, on the CPU, byte for byte (tolerance 0: bytes
and the class of what is raised).

- LZ4 blocks built by hand (a greedy LZ4 encoder below, and hostile
  token streams: long literal and match length extensions, a
  literals-only mid-stream LZ4s token, 4-byte LZ4s matches, repeated
  offsets) convert to the JAX package's S2 and snappy blocks, which decode
  to the LZ4 block's content; corrupt LZ4 raises ``LZ4Error`` on both.
- snappy blocks and framed streams, and xerial framing (plain and better,
  capped decode, a plain snappy block), equal JAX's.
- ``snappy_convert.convert`` of snappy-mode S2 streams equals JAX's frame,
  which ``zstandard`` and the port's ``zstd.decompress`` decode; a bad CRC
  or an S2 repeat tag raises as JAX does.
"""

import io

import numpy as np
import pytest

pytest.importorskip("jax")
zstandard = pytest.importorskip("zstandard")

from compress_tpu import snappy as jax_snappy  # noqa: E402
from compress_tpu.s2 import lz4convert as jax_lz4  # noqa: E402
from compress_tpu.snappy import xerial as jax_xerial  # noqa: E402
from compress_tpu.zstd import snappy_convert as jax_sc  # noqa: E402
from compress_tpu_torch import corpus, snappy  # noqa: E402
from compress_tpu_torch import zstd as Z  # noqa: E402
from compress_tpu_torch.s2 import block as B  # noqa: E402
from compress_tpu_torch.s2 import lz4convert as L  # noqa: E402
from compress_tpu_torch.s2 import stream as S  # noqa: E402
from compress_tpu_torch.snappy import xerial  # noqa: E402
from compress_tpu_torch.zstd import snappy_convert as SC  # noqa: E402
from test_torch_jaxref import jax_native_core  # noqa: E402,F401

NAMES = list(corpus.CLASSES)


def _block(name: str, seed: int = 0) -> bytes:
    return corpus.make_block(name, np.random.default_rng(seed)).tobytes()


def _ext(out: bytearray, rest: int) -> None:
    while rest >= 255:
        out.append(255)
        rest -= 255
    out.append(rest)


def _seq(out: bytearray, lit: bytes, ml: int, off: int, min_match: int = 4):
    """One LZ4 sequence; ml == 0 writes a literals-only token."""
    tl = min(len(lit), 15)
    tm = min(ml - min_match, 15) if ml else 0
    out.append((tl << 4) | tm)
    if tl == 15:
        _ext(out, len(lit) - 15)
    out += lit
    if ml:
        out += off.to_bytes(2, "little")
        if tm == 15:
            _ext(out, ml - min_match - 15)


def _lz4_block(data: bytes, max_len: int = 400) -> bytes:
    """A greedy LZ4 block encoder: 4-byte repeats found through a dict,
    offsets below 64 KiB, the last 12 bytes as literals."""
    out = bytearray()
    table = {}
    pos = lit_start = 0
    n = len(data)
    while pos + 12 < n:
        key = data[pos:pos + 4]
        c = table.get(key, -1)
        table[key] = pos
        if c >= 0 and pos - c <= 65535:
            length = 4
            while (pos + length < n - 5 and length < max_len
                   and data[c + length] == data[pos + length]):
                length += 1
            _seq(out, data[lit_start:pos], length, pos - c)
            pos += length
            lit_start = pos
        else:
            pos += 1
    _seq(out, data[lit_start:], 0, 0)
    return bytes(out)


def _hostile_lz4() -> tuple[bytes, bytes]:
    """(LZ4 block, its content): literal runs of 14, 15, 270 and 600
    bytes, matches of 4, 19, 274 and 1000 bytes, the same offset twice in
    a row (an S2 repeat), an overlapping copy (offset 1)."""
    rng = np.random.default_rng(5)
    out, content = bytearray(), bytearray()
    for lit_n, ml, off in ((14, 4, 3), (15, 19, 7), (270, 274, 270),
                           (600, 1000, 1), (3, 19, 7), (1, 19, 7)):
        lit = rng.integers(0, 256, lit_n, dtype=np.uint8).tobytes()
        _seq(out, lit, ml, off)
        content += lit
        for _ in range(ml):
            content.append(content[-off])
    tail = b"the end of the block"
    _seq(out, tail, 0, 0)
    return bytes(out), bytes(content + tail)


def _lz4_inputs():
    items = {name: (_lz4_block(_block(name, 2)), _block(name, 2))
             for name in NAMES}
    items["hostile"] = _hostile_lz4()
    return items


LZ4 = _lz4_inputs()


@pytest.mark.parametrize("snappy_mode", [False, True],
                         ids=["s2", "snappy"])
@pytest.mark.parametrize("name", list(LZ4))
def test_lz4_convert_equals_jax(name, snappy_mode):
    blob, content = LZ4[name]
    assert L.lz4_decompressed_len(blob) == len(content)
    assert jax_lz4.lz4_decompressed_len(blob) == len(content)
    got = L.convert_block(blob, snappy=snappy_mode)
    assert got == jax_lz4.convert_block(blob, snappy=snappy_mode)
    assert B.decode(got, allow_repeat=not snappy_mode) == content


def _lz4s_block() -> tuple[bytes, bytes]:
    """An LZ4s token stream: the match nibble counts from 3 (nibble 1 is a
    4-byte match), nibble 0 is a literals-only token with no offset, here
    also in the middle."""
    rng = np.random.default_rng(11)
    out, content = bytearray(), bytearray()
    for lit_n, ml, off in ((20, 4, 5), (4, 0, 0), (17, 40, 11),
                           (2, 4, 11), (0, 300, 2), (30, 18, 30)):
        lit = rng.integers(0, 256, lit_n, dtype=np.uint8).tobytes()
        tl = min(lit_n, 15)
        tm = min(ml - 3, 15) if ml else 0
        out.append((tl << 4) | tm)
        if tl == 15:
            _ext(out, lit_n - 15)
        out += lit
        content += lit
        if ml:
            out += off.to_bytes(2, "little")
            if tm == 15:
                _ext(out, ml - 3 - 15)
            for _ in range(ml):
                content.append(content[-off])
    out.append(0x50)
    out += b"tail!"
    return bytes(out), bytes(content + b"tail!")


@pytest.mark.parametrize("snappy_mode", [False, True],
                         ids=["s2", "snappy"])
def test_lz4s_convert_equals_jax(snappy_mode):
    blob, content = _lz4s_block()
    got = L.convert_block_lz4s(blob, snappy=snappy_mode)
    assert got == jax_lz4.convert_block_lz4s(blob, snappy=snappy_mode)
    assert B.decode(got, allow_repeat=not snappy_mode) == content


@pytest.mark.parametrize("bad", [b"\xf0", b"\x10", b"\x01\x00\x00",
                                 b"\x1f\x41\x05", b"\x1f\x41\x01\x00",
                                 b"\x00\x00\x00"])
def test_lz4_corrupt_raises_as_jax(bad):
    for fn in ("convert_block", "lz4_decompressed_len"):
        with pytest.raises(Exception) as want:
            getattr(jax_lz4, fn)(bad)
        with pytest.raises(Exception) as got:
            getattr(L, fn)(bad)
        assert type(got.value).__name__ == type(want.value).__name__


# -- snappy and xerial -------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_snappy_block_and_xerial_equal_jax(name):
    src = _block(name, 4) + _block(name, 5)[:7000]
    blk = snappy.encode(src)
    assert blk == jax_snappy.encode(src)
    assert snappy.decode(blk) == src
    assert snappy.decoded_len(blk) == len(src)
    assert snappy.max_encoded_len(len(src)) == jax_snappy.max_encoded_len(
        len(src))
    for fn in ("encode", "encode_better"):
        x = getattr(xerial, fn)(src)
        assert x == getattr(jax_xerial, fn)(src)
        assert xerial.decode(x) == src
    assert xerial.decode(blk) == src          # a plain snappy block
    with pytest.raises(xerial.MalformedError):
        xerial.decode_capped(xerial.encode(src), len(src) - 1)


def test_snappy_rejects_s2_repeats_as_jax():
    blk = B.encode(b"abcdefgh" * 500)
    for mod in (snappy, jax_snappy):
        with pytest.raises(mod.CorruptError):
            mod.decode(blk)
    x = xerial.HEADER + bytes(8) + len(blk).to_bytes(4, "big") + blk
    for mod in (xerial, jax_xerial):
        with pytest.raises(mod.MalformedError):
            mod.decode(x)
        with pytest.raises(mod.MalformedError):
            mod.decode(x[:-len(blk) - 2])
    assert xerial.encode(b"") == jax_xerial.encode(b"")
    assert xerial.decode(xerial.encode(b"")) == b""


def _snappy_stream(data: bytes, **kw) -> bytes:
    buf = io.BytesIO()
    w = snappy.writer(buf, **kw)
    w.write(data)
    w.close()
    return buf.getvalue()


@pytest.fixture(scope="module")
def data():
    return corpus.corpus_blocks(6, 8).tobytes() + b"odd tail" * 999


def test_snappy_stream_equals_jax(data):
    f = _snappy_stream(data)
    jbuf = io.BytesIO()
    jw = jax_snappy.writer(jbuf)
    jw.write(data)
    jw.close()
    assert f == jbuf.getvalue()
    assert snappy.reader(io.BytesIO(f)).read() == data
    assert f.startswith(S.MAGIC_CHUNK_SNAPPY)


# -- snappy stream to zstd ---------------------------------------------------

@pytest.mark.parametrize("checksum", [True, False])
@pytest.mark.parametrize("kw", [{}, {"level": 3}, {"uncompressed": True},
                                {"padding": 777}], ids=["fast", "best",
                                                        "stored", "padding"])
def test_snappy_convert_equals_jax(data, kw, checksum):
    f = _snappy_stream(data, **kw)
    got = SC.convert(f, checksum=checksum)
    assert got == jax_sc.convert(f, checksum=checksum)
    assert Z.decompress(got) == data
    assert zstandard.ZstdDecompressor().decompressobj().decompress(got) == data


def test_snappy_convert_empty_and_errors(data):
    empty = _snappy_stream(b"")
    assert SC.convert(empty) == jax_sc.convert(empty)
    assert Z.decompress(SC.convert(empty)) == b""
    f = bytearray(_snappy_stream(data[:100000]))
    f[len(S.MAGIC_CHUNK_SNAPPY) + 4] ^= 1          # the first chunk's CRC
    s2 = io.BytesIO()
    w = S.Writer(s2)                               # S2 mode: repeat tags
    w.write(b"abcdefgh" * 5000)
    w.close()
    for bad in (bytes(f), s2.getvalue(), bytes(f[:-5])):
        with pytest.raises(Exception) as want:
            jax_sc.convert(bad)
        with pytest.raises(Exception) as got:
            SC.convert(bad)
        assert type(got.value).__name__ == type(want.value).__name__
