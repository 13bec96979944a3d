"""The port's deflate codec (``flate/``, on the host core's ``flate.cpp``)
against the JAX package's, on the CPU, byte for byte (tolerance 0: bytes,
checkpoints, and the class of what is raised).  Stdlib ``zlib`` is the
outside oracle: it decodes every stream both packages write.

Three comparisons, as for the host core:
- the port's default path against the JAX package's unpatched function,
  which takes its native core;
- the port's plain Python path (``deflate_py``, ``inflate_py``,
  ``WriterPy``, ``ReaderPy``) against the JAX function with its native
  entry patched out;
- the port's native path against its own plain path where the reference
  states they agree (inflate outputs; deflate streams differ by design).
"""

import dataclasses
import importlib
import io
import pathlib
import zlib as stdzlib

import numpy as np
import pytest

pytest.importorskip("jax")

from compress_tpu import _native as jax_native  # noqa: E402
from compress_tpu_torch import _native, corpus  # noqa: E402
from compress_tpu_torch.huff0 import table as HT  # noqa: E402
from test_torch_jaxref import jax_native_core  # noqa: E402,F401

D = importlib.import_module("compress_tpu_torch.flate.deflate")
I = importlib.import_module("compress_tpu_torch.flate.inflate")
H = importlib.import_module("compress_tpu_torch.flate.huffman")
JD = importlib.import_module("compress_tpu.flate.deflate")
JI = importlib.import_module("compress_tpu.flate.inflate")
JH = importlib.import_module("compress_tpu.flate.huffman")

LEVELS = (-2, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9)
LENGTHS = (0, 1, 31, 32, 33, 65_535, 65_536, 200_003)
FLATE_ENTRIES = ("ct_deflate_level", "ct_deflate_blocks", "ct_deflate",
                 "ct_inflate_stream", "ct_inflate")


@pytest.fixture(scope="module")
def data():
    """Text, rand4, zeros and rand256 blocks in turn, then more text."""
    return (corpus.corpus_blocks(4, 19).tobytes()
            + corpus.corpus_blocks(1, 20).tobytes())


@pytest.fixture
def jax_python(monkeypatch):
    """The JAX package with its native deflate, inflate and streaming
    entries patched out (its Python paths)."""
    monkeypatch.setattr(JD, "_native_deflate", lambda data, level=6: None)
    monkeypatch.setattr(JD, "native_inflate", lambda data, max_size: None)
    monkeypatch.setattr(jax_native, "raw", lambda: None)
    monkeypatch.setenv("COMPRESS_TPU_NONATIVE", "1")


def outcome(fn, *args, **kw):
    """("ok", value) or ("raised", class name, is a ValueError)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return ("raised", type(e).__name__, isinstance(e, ValueError))


def cp_tuple(cp):
    return dataclasses.astuple(cp)


# -- the host core's entries --------------------------------------------------


def test_flate_entries_typed():
    lib = _native.library()
    assert "flate.cpp" in _native.SOURCES
    ref = pathlib.Path(jax_native.__file__).parent / "src" / "flate.cpp"
    assert (_native.SRC_DIR / "flate.cpp").read_bytes() == ref.read_bytes()
    for name in FLATE_ENTRIES:
        assert name in _native._SIGNATURES
        assert getattr(lib, name).argtypes is not None


# -- huffman: code lengths ------------------------------------------------------


def test_literal_alphabet_takes_python_package_merge(monkeypatch, data):
    """The 286-symbol literal/length alphabet is over 256 symbols: it takes
    ``package_merge_lengths_py``, as the reference's does; the distance
    and code-length alphabets take the host core."""
    calls = []
    real = HT.package_merge_lengths_py

    def spy(freqs, limit):
        calls.append(len(freqs))
        return real(freqs, limit)

    monkeypatch.setattr(HT, "package_merge_lengths_py", spy)
    rng = np.random.default_rng(3)
    for n_sym, limit in ((286, 15), (30, 15), (19, 7)):
        freqs = rng.integers(0, 50, n_sym).astype(np.int64)
        freqs[rng.integers(0, n_sym, n_sym // 3)] = 0
        np.testing.assert_array_equal(H.build_lengths(freqs, limit),
                                      JH.build_lengths(freqs, limit))
    assert calls == [286]
    np.testing.assert_array_equal(
        H.build_lengths(np.zeros(286, np.int64), 15),
        JH.build_lengths(np.zeros(286, np.int64), 15))


def test_canonical_codes_and_dynamic_header(data):
    freqs = np.bincount(np.frombuffer(data[:70000], np.uint8),
                        minlength=286).astype(np.int64)
    freqs[256] = 1
    lit = H.build_lengths(freqs, 15)
    dist = H.build_lengths(np.arange(30, dtype=np.int64) % 7, 15)
    np.testing.assert_array_equal(H.canonical_codes_rfc1951(lit),
                                  JH.canonical_codes_rfc1951(lit))
    a, b = H.BitWriterLSB(), JH.BitWriterLSB()
    assert H.write_dynamic_header(a, lit, dist) == JH.write_dynamic_header(
        b, lit, dist)
    a.align_byte()
    b.align_byte()
    assert a.bytes() == b.bytes()


# -- deflate -------------------------------------------------------------------


@pytest.mark.parametrize("n", LENGTHS)
@pytest.mark.parametrize("level", LEVELS)
def test_deflate_equals_jax(data, level, n):
    src = data[:n]
    got = D.deflate(src, level)
    assert got == JD.deflate(src, level)
    assert stdzlib.decompress(got, wbits=-15) == src


@pytest.mark.parametrize("level", LEVELS)
@pytest.mark.parametrize("n", (33, 65_536))
def test_deflate_py_equals_jax_python(data, jax_python, level, n):
    src = data[:n]
    got = D.deflate_py(src, level)
    assert got == JD.deflate(src, level)
    assert stdzlib.decompress(got, wbits=-15) == src


@pytest.mark.parametrize("level", (1, 6, 9))
def test_deflate_py_long_equals_jax_python(data, jax_python, level):
    src = data[:200_003]
    got = D.deflate_py(src, level)
    assert got == JD.deflate(src, level)
    assert stdzlib.decompress(got, wbits=-15) == src


@pytest.mark.parametrize("window", (1024, 4096, 32_767))
@pytest.mark.parametrize("level", (1, 6))
def test_small_window_equals_jax(data, level, window):
    """A window below 32 KiB takes the Python encoder in both packages."""
    src = data[:65_536] + data[:20_000]
    got = D.deflate(src, level, window=window)
    assert got == JD.deflate(src, level, window=window)
    assert got == D.deflate_py(src, level, window=window)
    assert stdzlib.decompress(got, wbits=-15) == src


@pytest.mark.parametrize("with_dict", (False, True))
def test_stateless_deflate_equals_jax(data, with_dict):
    src = data[:5000] + data[:3000]
    d = data[100:2100] if with_dict else None
    got = D.stateless_deflate(src, dictionary=d)
    assert got == JD.stateless_deflate(src, dictionary=d)
    dec = stdzlib.decompressobj(wbits=-15, **({"zdict": d} if d else {}))
    assert dec.decompress(got) == src
    if with_dict:
        assert I.inflate(got, prefix=d) == src


def _write(cls, src, level, flush_at=()):
    buf = io.BytesIO()
    w = cls(buf, level=level)
    pos = 0
    for cut in (*flush_at, len(src)):
        w.write(src[pos:cut])
        if cut < len(src):
            w.flush()
        pos = cut
    w.close()
    return buf.getvalue()


@pytest.mark.parametrize("level", (-2, 0, 1, 4, 6, 9))
def test_writer_equals_jax(data, level):
    src = data * 4      # 1.25 MiB: flushes, a whole chunk and a part
    flush_at = (70_001, 300_000)
    got = _write(D.Writer, src, level, flush_at)
    assert got == _write(JD.Writer, src, level, flush_at)
    assert stdzlib.decompress(got, wbits=-15) == src


@pytest.mark.parametrize("level", (-2, 0, 1, 6, 9))
def test_writer_py_equals_jax_python(data, jax_python, monkeypatch, level):
    """The Python block path with chunks of 32 KiB (both classes)."""
    monkeypatch.setattr(D.Writer, "CHUNK", 1 << 15)
    monkeypatch.setattr(JD.Writer, "CHUNK", 1 << 15)
    src = data[:90_000]
    got = _write(D.WriterPy, src, level, (40_000,))
    assert got == _write(JD.Writer, src, level, (40_000,))
    assert stdzlib.decompress(got, wbits=-15) == src


def test_writer_rejects_levels_and_closed():
    for cls in (D.Writer, JD.Writer):
        with pytest.raises(ValueError):
            cls(io.BytesIO(), level=10)
        w = cls(io.BytesIO(), level=-1)
        assert w.level == 6
        w.close()
        with pytest.raises(ValueError):
            w.write(b"x")


# -- inflate -------------------------------------------------------------------


def _streams(data):
    """(name, raw deflate stream, its output): the port's levels, stdlib's
    levels and a stored stream."""
    out = []
    for level in (-2, 0, 1, 6, 9):
        out.append((f"port{level}", D.deflate(data, level), data))
    for level in (1, 6, 9):
        out.append((f"stdlib{level}", stdzlib.compress(data, level)[2:-4],
                    data))
    return out


def test_inflate_equals_jax(data):
    for name, blob, want in _streams(data[:200_003]):
        got = I.inflate(blob)
        assert got == want, name
        assert got == JI.inflate(blob), name
        assert I.inflate_py(blob) == want, name


def test_inflate_py_equals_jax_python(data, jax_python):
    for name, blob, want in _streams(data[:70_000]):
        assert I.inflate_py(blob) == JI.inflate(blob) == want, name


def test_checkpoints_and_resume_equal_jax(data):
    src = data[:300_000]
    blob = D.deflate(src, 6)
    ours, theirs = [], []
    assert I.inflate(blob, eob_callback=ours.append) == src
    assert JI.inflate(blob, eob_callback=theirs.append) == src
    assert len(ours) >= 2
    assert [cp_tuple(c) for c in ours] == [cp_tuple(c) for c in theirs]
    for cp, jcp in zip(ours, theirs):
        rest = I.inflate(blob, resume_from=cp)
        assert rest == JI.inflate(blob, resume_from=jcp)
        assert rest == src[cp.uncompressed_offset:]
        assert I.Checkpoint(*cp_tuple(cp)) == cp


def test_prefix_equals_jax(data):
    d = data[:4000]
    c = stdzlib.compressobj(6, stdzlib.DEFLATED, -15, zdict=d)
    src = data[1000:9000] * 2
    blob = c.compress(src) + c.flush()
    assert I.inflate(blob, prefix=d) == JI.inflate(blob, prefix=d) == src


def _hostile(data):
    """test_flate.py's hostile inputs, then cut and garbled streams."""
    bad = stdzlib.compress(b"abcdef" * 100)[2:-4]
    cases = [b"", b"\x07", bytes([0x01, 0x05, 0x00, 0x00, 0x00]),
             bad[:-1] + b"\xff"]
    good = D.deflate(data[:20_000], 6)
    rng = np.random.default_rng(41)
    for cut in rng.integers(1, len(good), 6).tolist():
        cases.append(good[:cut])
    for pos in rng.integers(0, len(good), 16).tolist():
        g = bytearray(good)
        g[pos] ^= int(rng.integers(1, 256))
        cases.append(bytes(g))
    cases.append(bytes([0x04, 0x00]))          # dynamic block, no tables
    cases.append(bytes(rng.integers(0, 256, 64, dtype=np.uint8)))
    return cases


def test_hostile_inputs_raise_as_jax(data):
    for i, blob in enumerate(_hostile(data)):
        got, want = outcome(I.inflate, blob), outcome(JI.inflate, blob)
        assert got == want, i
        assert outcome(I.inflate_py, blob) == want, i
        assert outcome(lambda b: I.Reader(b).read(), blob) == outcome(
            lambda b: JI.Reader(b).read(), blob), i
    for blob in _hostile(data)[:4]:
        assert outcome(I.inflate, blob)[:2] == ("raised", "InflateError")


def test_max_size_equals_jax(data):
    src = bytes(8 << 20)               # 8 MiB of zeros: > 40x the stream
    blob = D.deflate(src, 6)
    assert I.inflate(blob, max_size=9 << 20) == src   # retried larger
    assert I.inflate(blob, max_size=9 << 20) == JI.inflate(
        blob, max_size=9 << 20)
    for limit in (1000, 1 << 20, (8 << 20) - 1):
        got = outcome(I.inflate, blob, max_size=limit)
        assert got == outcome(JI.inflate, blob, max_size=limit)
        assert got[:2] == ("raised", "InflateError")
    assert I.inflate(blob, max_size=8 << 20) == src
    small = D.deflate(data[:50_000], 1)
    assert outcome(I.inflate_py, small, max_size=100) == outcome(
        JI.inflate, small, max_size=100)


# -- the streaming Reader -------------------------------------------------------


def _read_steps(r, step):
    out = bytearray()
    while True:
        x = r.read(step)
        if not x:
            return bytes(out)
        out += x


@pytest.mark.parametrize("step", (1000, 1 << 16, -1))
def test_reader_equals_jax(data, step):
    for name, blob, want in _streams(data[:200_003]):
        tail = b"TRAILER!"
        ours = I.Reader(io.BytesIO(blob + tail))
        theirs = JI.Reader(io.BytesIO(blob + tail))
        got = ours.read() if step < 0 else _read_steps(ours, step)
        assert got == want, name
        assert (theirs.read() if step < 0 else _read_steps(theirs, step)
                ) == got, name
        assert ours.unused_tail == theirs.unused_tail, name


def test_reader_py_equals_jax_python(data, jax_python):
    for name, blob, want in _streams(data[:70_000]):
        tail = b"\x01\x02\x03\x04"
        ours = I.ReaderPy(io.BytesIO(blob + tail))
        theirs = JI.Reader(io.BytesIO(blob + tail))
        assert _read_steps(ours, 5000) == _read_steps(theirs, 5000) == want
        assert ours.unused_tail == theirs.unused_tail == tail, name


def test_reader_dictionary_and_read1(data):
    d = data[:4000]
    c = stdzlib.compressobj(6, stdzlib.DEFLATED, -15, zdict=d)
    src = data[1000:9000] * 3
    blob = c.compress(src) + c.flush()
    for cls in (I.Reader, I.ReaderPy, JI.Reader):
        r = cls(blob, dictionary=d)
        first = r.read1(100)
        assert 1 <= len(first) <= 100
        assert first + b"".join(r) == src
