"""The port's S2 stream tier (``s2/stream.py``, ``s2/index.py``,
``s2/seek.py``, ``s2/dict.py`` and the block codec's tiers in
``s2/block.py``) against the JAX package's, on the CPU, byte for byte
(tolerance 0: bytes, offsets, and the class of what is raised).

- Block tiers: ``encode_better`` / ``encode_best`` and the three snappy
  encoders equal JAX on every corpus class; the Python encoder
  ``_encode_block_py`` in snappy mode equals the host core's fast tier;
  ``concat_blocks``, ``estimate_block_size``, ``decoded_len`` and
  ``max_encoded_len`` equal JAX.
- Writer: every option (block size, snappy, padding, uncompressed, a
  custom encoder, the index, a flush, a skippable chunk) at levels 1-3,
  with ``workers`` 1 and 4, equals JAX's bytes; ``workers=4`` equals
  serial; the port's Reader and ``decode_concurrent`` give the input back.
- Index and seek: ``Index`` bytes, ``index_stream``, ``load``,
  ``find``, the JSON dump and the header strip and restore equal JAX's on
  streams of uneven chunks (negative deltas, ``_trunc_div2``);
  ``ReadSeeker`` reads at seeded offsets equal the input and JAX's reads.
- Corrupt streams (a flipped CRC, a cut chunk, no stream identifier, an
  unknown chunk, a bad index) raise the class JAX raises.
- Dictionaries: ``make_dict``, ``load_dict``, ``Dict.bytes``,
  ``encode_with_dict`` equal JAX at the dictionary's bounds (inputs past
  64 KiB, a repeat offset at its limit), ``decode_with_dict`` gives the
  input back.
"""

import io

import numpy as np
import pytest

pytest.importorskip("jax")

from compress_tpu.s2 import block as jax_block  # noqa: E402
from compress_tpu.s2 import dict as jax_dict  # noqa: E402
from compress_tpu.s2 import index as jax_index  # noqa: E402
from compress_tpu.s2 import seek as jax_seek  # noqa: E402
from compress_tpu.s2 import stream as jax_stream  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch.s2 import block as B  # noqa: E402
from compress_tpu_torch.s2 import dict as D  # noqa: E402
from compress_tpu_torch.s2 import index as I  # noqa: E402
from compress_tpu_torch.s2 import seek as K  # noqa: E402
from compress_tpu_torch.s2 import stream as S  # noqa: E402
from test_torch_jaxref import jax_native_core  # noqa: E402,F401

NAMES = list(corpus.CLASSES)


def _data(n_blocks: int = 5, seed: int = 0, tail: int = 12345) -> bytes:
    return (corpus.corpus_blocks(n_blocks, seed).tobytes()
            + corpus.corpus_blocks(1, seed + 1).tobytes()[:tail])


@pytest.fixture(scope="module")
def data():
    return _data()


def _block(name: str, seed: int = 0) -> bytes:
    return corpus.make_block(name, np.random.default_rng(seed)).tobytes()


# -- block tiers -------------------------------------------------------------

TIERS = ("encode", "encode_better", "encode_best", "encode_snappy",
         "encode_snappy_better", "encode_snappy_best")


@pytest.mark.parametrize("tier", TIERS)
@pytest.mark.parametrize("name", NAMES)
def test_block_tiers_equal_jax(tier, name):
    src = _block(name, 3)
    got = getattr(B, tier)(src)
    assert got == getattr(jax_block, tier)(src)
    assert B.decode(got, allow_repeat="snappy" not in tier) == src


@pytest.mark.parametrize("name", NAMES)
def test_python_encoder_snappy_mode_equals_core(name):
    src = _block(name, 5)[:40000]
    want = B._encode_body(src, B._MODE_SNAPPY)
    assert B._encode_block_py(src, B._MODE_SNAPPY) == want
    assert want == jax_block._encode_block_py(src, jax_block._MODE_SNAPPY)
    assert B._encode_block_py(src) == B.encode_body(src)


def test_block_helpers_equal_jax(data):
    parts = [B.encode(data[i:i + 30000]) for i in range(0, 90000, 30000)]
    cat = B.concat_blocks(*parts)
    assert cat == jax_block.concat_blocks(*parts)
    assert B.decode(cat) == data[:90000]
    for n in (0, 100, 65536, 200000, len(data)):
        assert B.estimate_block_size(data[:n]) == \
            jax_block.estimate_block_size(data[:n])
        assert B.max_encoded_len(n) == jax_block.max_encoded_len(n)
    assert B.decoded_len(parts[0]) == 30000
    with pytest.raises(ValueError):
        B.concat_blocks(B.encode(bytes(3 << 20)), B.encode(bytes(2 << 20)))


# -- Writer ------------------------------------------------------------------

OPTIONS = {
    "plain": {},
    "small_block": {"block_size": 4 << 10},
    "snappy": {"snappy": True},
    "padding": {"padding": 1000},
    "uncompressed": {"uncompressed": True},
    "custom": {"custom_encoder": "better"},
    "index": {"add_index": True, "block_size": 64 << 10},
}


def _write(mod, blk, data, opts, level, workers, flush_at=None):
    opts = dict(opts)
    if opts.get("custom_encoder") == "better":
        # every third block left to the stored-chunk fallback
        opts["custom_encoder"] = (
            lambda b: None if len(b) % 3 == 0 else blk.encode_better(b))
    buf = io.BytesIO()
    w = mod.Writer(buf, level=level, workers=workers, **opts)
    if flush_at is None:
        w.write(data)
    else:
        w.write(data[:flush_at])
        w.flush()
        w.add_skippable_block(0x80, b"user chunk")
        w.write(data[flush_at:])
    w.close()
    return buf.getvalue()


@pytest.mark.parametrize("workers", [1, 4])
@pytest.mark.parametrize("level", [1, 2, 3])
@pytest.mark.parametrize("opt", list(OPTIONS))
def test_writer_equals_jax(data, opt, level, workers):
    got = _write(S, B, data, OPTIONS[opt], level, workers)
    assert got == _write(jax_stream, jax_block, data, OPTIONS[opt], level,
                         workers)
    if workers > 1:
        assert got == _write(S, B, data, OPTIONS[opt], level, 1)
    assert S.Reader(io.BytesIO(got)).read() == data
    assert S.decode_concurrent(got, workers=4) == data
    if opt == "padding":
        assert len(got) % 1000 == 0


@pytest.mark.parametrize("workers", [1, 4])
def test_writer_flush_and_skippable_equal_jax(data, workers):
    seen = []
    got = _write(S, B, data, {"add_index": True}, 2, workers, flush_at=70001)
    assert got == _write(jax_stream, jax_block, data, {"add_index": True}, 2,
                         workers, flush_at=70001)
    r = S.Reader(io.BytesIO(got), skippable_cb=lambda t, b: seen.append((t, b)))
    assert r.read() == data
    # the index chunk (0x99) lies in the skippable range too
    assert [t for t, _ in seen] == [0x80, S.CHUNK_INDEX]
    assert seen[0][1] == b"user chunk"


def test_writer_read_from_and_async_flush(data):
    out = []
    for mod in (S, jax_stream):
        buf = io.BytesIO()
        w = mod.Writer(buf, workers=3, block_size=64 << 10)
        assert w.read_from(io.BytesIO(data), chunk=50000) == len(data)
        w.async_flush()
        w.write(b"after the flush")
        w.close()
        out.append(buf.getvalue())
    assert out[0] == out[1]
    assert S.Reader(io.BytesIO(out[0])).read() == data + b"after the flush"


def test_reader_read_byte_skip_and_steps(data):
    f = _write(S, B, data, {"block_size": 64 << 10}, 1, 1)
    r = S.Reader(io.BytesIO(f))
    assert r.read_byte() == data[0]
    r.skip(99999)
    assert r.read(5000) == data[100000:105000]
    rest = bytearray()
    while True:
        x = r.read(7777)
        if not x:
            break
        rest += x
    assert bytes(rest) == data[105000:]
    assert r.uncompressed_pos == len(data)
    with pytest.raises(EOFError):
        r.read_byte()
    with pytest.raises(EOFError):
        S.Reader(io.BytesIO(f)).skip(len(data) + 1)


def _corrupt(f: bytes) -> dict:
    first = len(S.MAGIC_CHUNK)
    flip = bytearray(f)
    flip[first + 4] ^= 1          # the first chunk's CRC
    unknown = bytearray(f)
    unknown[first] = 0x42         # an unskippable chunk type
    return {
        "crc": bytes(flip),
        "cut": f[:first + 100],
        "no_id": f[first:],
        "unknown_chunk": bytes(unknown),
        "bad_id": b"\xff\x06\x00\x00S2sTwX" + f[first:],
        "header_cut": f[:first + 2],
    }


@pytest.mark.parametrize("kind", ["crc", "cut", "no_id", "unknown_chunk",
                                  "bad_id", "header_cut"])
def test_corrupt_streams_raise_as_jax(data, kind):
    f = _corrupt(_write(S, B, data[:150000], {"block_size": 64 << 10}, 1,
                        1))[kind]
    for reader in (lambda m, b: m.Reader(io.BytesIO(b)).read(),
                   lambda m, b: m.decode_concurrent(b)):
        with pytest.raises(Exception) as want:
            reader(jax_stream, f)
        with pytest.raises(Exception) as got:
            reader(S, f)
        assert type(got.value).__name__ == type(want.value).__name__
        assert isinstance(got.value, ValueError)


def test_writer_rejects_bad_options():
    for mod in (S, jax_stream):
        with pytest.raises(ValueError):
            mod.Writer(io.BytesIO(), block_size=100)
        with pytest.raises(ValueError):
            mod.Writer(io.BytesIO(), padding=2)
        w = mod.Writer(io.BytesIO())
        with pytest.raises(ValueError):
            w.add_skippable_block(0x10, b"")
        w.close()
        with pytest.raises(S.StreamError if mod is S else
                           jax_stream.StreamError):
            w.write(b"x")


# -- index and seek ----------------------------------------------------------

def _uneven_stream(data: bytes, seed: int) -> bytes:
    """Chunks of seeded uneven sizes (flushes), so the index's deltas go
    negative and its guess moves both ways."""
    rng = np.random.default_rng(seed)
    buf = io.BytesIO()
    w = S.Writer(buf, block_size=64 << 10)
    pos = 0
    while pos < len(data):
        n = int(rng.integers(1, 70000))
        w.write(data[pos:pos + n])
        w.flush()
        pos += n
    w.close()
    return buf.getvalue()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_index_equals_jax(data, seed):
    f = _uneven_stream(data, seed)
    idx = I.index_stream(f)
    jidx = jax_index.index_stream(f)
    chunk = idx.append_to()
    assert chunk == jidx.append_to()
    assert idx.entries == jidx.entries
    loaded, used = I.Index.load(chunk)
    assert used == len(chunk)
    assert loaded.entries == idx.entries
    assert I.Index.load_stream(f + chunk).entries == idx.entries
    assert loaded.to_json() == jax_index.Index.load(chunk)[0].to_json()
    stripped = I.remove_index_headers(chunk)
    assert stripped == jax_index.remove_index_headers(chunk)
    assert I.restore_index_headers(stripped) == chunk
    rng = np.random.default_rng(seed + 10)
    for off in rng.integers(0, len(data), 16).tolist() + [0, len(data) - 1,
                                                          -1, -len(data)]:
        assert idx.find(off) == jidx.find(off)


def test_trunc_div2_rounds_toward_zero():
    for d in (-7, -6, -1, 0, 1, 6, 7, -(1 << 40) - 1):
        assert I._trunc_div2(d) == jax_index._trunc_div2(d) == int(d / 2)


def test_index_find_and_load_errors():
    idx = I.Index([(0, 0), (100, 50)], 200, 120)
    with pytest.raises(I.IndexError_):
        idx.find(201)
    with pytest.raises(I.IndexError_):
        I.Index([], -1, -1).find(-1)
    chunk = idx.append_to()
    for bad in (b"\x00" + chunk[1:], chunk[:-3], chunk[:4] + b"x" + chunk[5:],
                chunk[:-1] + b"t"):
        with pytest.raises(I.IndexError_):
            I.Index.load(bad)
        with pytest.raises(jax_index.IndexError_):
            jax_index.Index.load(bad)
    with pytest.raises(I.IndexError_):
        I.Index.load_stream(b"no index here")


@pytest.mark.parametrize("mode", ["writer_index", "external_index"])
def test_read_seeker_equals_input_and_jax(data, mode):
    if mode == "writer_index":
        f = _write(S, B, data, {"add_index": True, "block_size": 64 << 10},
                   1, 1)
        rs, jrs = K.ReadSeeker(io.BytesIO(f)), jax_seek.ReadSeeker(
            io.BytesIO(f))
    else:
        f = _uneven_stream(data, 7)
        rs = K.ReadSeeker(io.BytesIO(f), I.index_stream(f))
        jrs = jax_seek.ReadSeeker(io.BytesIO(f), jax_index.index_stream(f))
    assert rs.size() == len(data)
    rng = np.random.default_rng(8)
    for off in rng.integers(0, len(data), 8).tolist():
        assert rs.seek(off) == off
        jrs.seek(off)
        got = rs.read(4096)
        assert got == data[off:off + 4096] == jrs.read(4096)
    assert rs.seek(-10, io.SEEK_END) == len(data) - 10
    assert rs.read() == data[-10:]
    rs.seek(5)
    assert rs.seek(10, io.SEEK_CUR) == 15
    assert rs.read_at(len(data), 10) == b""
    with pytest.raises(ValueError):
        rs.seek(-1)


# -- dictionaries ------------------------------------------------------------

@pytest.mark.parametrize("n", [0, 10, 5000, 70000, 200000])
@pytest.mark.parametrize("first", [None, b"the", b"no such bytes"])
def test_dict_encode_equals_jax(data, n, first):
    content = data[:30000]
    d, jd = D.make_dict(content, first), jax_dict.make_dict(content, first)
    assert d.bytes() == jd.bytes()
    assert D.load_dict(d.bytes()).bytes() == d.bytes()
    src = data[20000:20000 + n]
    got = D.encode_with_dict(src, d)
    assert got == jax_dict.encode_with_dict(src, jd)
    assert D.decode_with_dict(got, d) == src
    assert jax_dict.decode_with_dict(got, jd) == src


@pytest.mark.parametrize("name", NAMES)
def test_dict_bounds_equal_jax(name):
    """A 64 KiB dictionary with its repeat offset at the limit, an input
    that repeats it past 64 KiB of output (dictionary use stops there)."""
    content = _block(name, 9)
    rep = len(content) - 9
    d, jd = D.Dict(content, rep), jax_dict.Dict(content, rep)
    src = content[100:] + _block(name, 10)[:30000] + content[:5000]
    got = D.encode_with_dict(src, d)
    assert got == jax_dict.encode_with_dict(src, jd)
    assert D.decode_with_dict(got, d) == src
    with pytest.raises(ValueError):
        D.Dict(content, len(content) - 8)
    with pytest.raises(ValueError):
        D.Dict(b"short")


def test_dict_decode_rejects_what_jax_rejects(data):
    d = D.make_dict(data[:20000])
    blk = D.encode_with_dict(data[15000:40000], d)
    for bad in (blk[:-5], blk[:1] + b"\xff" + blk[2:]):
        with pytest.raises(Exception) as want:
            jax_dict.decode_with_dict(bad, jax_dict.make_dict(data[:20000]))
        with pytest.raises(Exception) as got:
            D.decode_with_dict(bad, d)
        assert type(got.value).__name__ == type(want.value).__name__
