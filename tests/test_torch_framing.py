"""The port's framings of deflate and zstd (``gzip``, ``zlib``, ``zip``)
against the JAX package's, on the CPU, byte for byte (tolerance 0: bytes,
header fields, and the class of what is raised).  Stdlib ``gzip``,
``zlib`` and ``zipfile`` are the outside oracles.

- gzip: ``compress`` with every header field at levels 1, 6 and 9,
  ``decompress`` of multistream input (the Python inflater, as in the
  reference), the streaming ``Writer`` and ``Reader`` (the host core's
  inflate), hostile members.
- zlib: ``compress`` with and without a dictionary, ``decompress``, the
  ``Writer`` and ``Reader``, hostile headers and trailers.
- zip: every method (stored, deflate, zstd), the raw copy, the codec
  registry, legacy names, zip64 records, stdlib interop.
"""

import dataclasses
import gzip as stdgzip
import io
import struct
import zipfile as stdzip
import zlib as stdzlib

import numpy as np
import pytest

pytest.importorskip("jax")

from compress_tpu import gzip as jax_gzip  # noqa: E402
from compress_tpu import zip as jax_zip  # noqa: E402
from compress_tpu import zlib as jax_zlib  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch import gzip as G  # noqa: E402
from compress_tpu_torch import zip as Zp  # noqa: E402
from compress_tpu_torch import zlib as Zl  # noqa: E402
from test_torch_jaxref import jax_native_core  # noqa: E402,F401

MTIME = (2021, 3, 4, 5, 6, 8)


@pytest.fixture(scope="module")
def data():
    return (corpus.corpus_blocks(4, 23).tobytes()
            + corpus.corpus_blocks(1, 24).tobytes())


def outcome(fn, *args, **kw):
    """("ok", value) or ("raised", class name, is a ValueError)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return ("raised", type(e).__name__, isinstance(e, ValueError))


def _steps(r, step):
    out = bytearray()
    while True:
        x = r.read(step)
        if not x:
            return bytes(out)
        out += x


# -- gzip ----------------------------------------------------------------------


def _headers():
    return [dict(), dict(name="f.txt", comment="a comment", mtime=12345,
                         os=3), dict(extra=b"\x01\x02xyz", name="\xe9t\xe9")]


@pytest.mark.parametrize("level", (1, 6, 9))
@pytest.mark.parametrize("hdr", range(3))
def test_gzip_compress_equals_jax(data, level, hdr):
    src = data[:300_000]
    kw = _headers()[hdr]
    got = G.compress(src, level, header=G.Header(**kw))
    assert got == jax_gzip.compress(src, level, header=jax_gzip.Header(**kw))
    assert stdgzip.decompress(got) == src


@pytest.mark.parametrize("hdr", range(3))
def test_gzip_decompress_equals_jax(data, hdr):
    a, b = data[:120_000], data[200_000:260_000]
    kw = _headers()[hdr]
    blob = G.compress(a, 6, header=G.Header(**kw)) + stdgzip.compress(b, 9)
    out, h = G.decompress(blob)
    j_out, j_h = jax_gzip.decompress(blob)
    assert out == j_out == a + b
    assert dataclasses.astuple(h) == dataclasses.astuple(j_h)
    one, h1 = G.decompress(blob, multistream=False)
    assert one == jax_gzip.decompress(blob, multistream=False)[0] == a
    assert dataclasses.astuple(h1) == dataclasses.astuple(h)


def _gzip_hostile(data):
    good = G.compress(data[:20_000], 6, header=G.Header(name="n"))
    rng = np.random.default_rng(7)
    crc = bytearray(good)
    crc[-8] ^= 1
    isize = bytearray(good)
    isize[-1] ^= 1
    cases = [b"\x1f\x8c" + good[2:], good[:2] + b"\x07" + good[3:],
             bytes(crc), bytes(isize), good[:9], good[:-3]]
    for pos in rng.integers(12, len(good) - 8, 8).tolist():
        g = bytearray(good)
        g[pos] ^= 0x5A
        cases.append(bytes(g))
    return cases


def test_gzip_hostile_raises_as_jax(data):
    for i, blob in enumerate(_gzip_hostile(data)):
        assert outcome(G.decompress, blob) == outcome(
            jax_gzip.decompress, blob), i
        assert outcome(lambda b: G.Reader(b).read(), blob) == outcome(
            lambda b: jax_gzip.Reader(b).read(), blob), i
    assert outcome(G.decompress, b"\x1f\x8c" + b"\x00" * 20)[:2] == (
        "raised", "GzipError")


@pytest.mark.parametrize("level", (0, 1, 6, 9))
def test_gzip_writer_equals_jax(data, level):
    src = data * 4

    def write(mod):
        buf = io.BytesIO()
        w = mod.Writer(buf, level=level, header=mod.Header(name="w.bin",
                                                           mtime=7))
        for i in range(0, len(src), 400_001):
            w.write(src[i:i + 400_001])
            w.flush()
        w.close()
        return buf.getvalue()

    got = write(G)
    assert got == write(jax_gzip)
    assert stdgzip.decompress(got) == src


@pytest.mark.parametrize("step", (777, 1 << 16, -1))
def test_gzip_reader_equals_jax(data, step):
    a, b = data[:200_000], data[100_000:]
    blob = (G.compress(a, 1, header=G.Header(name="a", comment="c"))
            + stdgzip.compress(b, 6) + G.compress(b"", 9))
    for multistream in (True, False):
        ours = G.Reader(io.BytesIO(blob), multistream=multistream)
        theirs = jax_gzip.Reader(io.BytesIO(blob), multistream=multistream)
        got = ours.read() if step < 0 else _steps(ours, step)
        assert got == (a + b if multistream else a)
        assert got == (theirs.read() if step < 0 else _steps(theirs, step))
        assert dataclasses.astuple(ours.header) == dataclasses.astuple(
            theirs.header)
    assert outcome(lambda: G.Reader(blob, max_size=1000).read()) == outcome(
        lambda: jax_gzip.Reader(blob, max_size=1000).read())


# -- zlib ----------------------------------------------------------------------


@pytest.mark.parametrize("level", (0, 1, 2, 6, 8, 9))
def test_zlib_compress_equals_jax(data, level):
    src = data[:250_000]
    got = Zl.compress(src, level)
    assert got == jax_zlib.compress(src, level)
    assert stdzlib.decompress(got) == src
    assert Zl.decompress(got) == jax_zlib.decompress(got) == src


@pytest.mark.parametrize("level", (0, 1, 6, 9))
def test_zlib_dictionary_equals_jax(data, level):
    d = data[:6000]
    src = data[3000:40_000] + data[:6000]
    got = Zl.compress(src, level, dictionary=d)
    assert got == jax_zlib.compress(src, level, dictionary=d)
    dec = stdzlib.decompressobj(zdict=d)
    assert dec.decompress(got) == src
    assert Zl.decompress(got, dictionary=d) == src
    c = stdzlib.compressobj(level, zdict=d)
    theirs = c.compress(src) + c.flush()
    assert Zl.decompress(theirs, dictionary=d) == jax_zlib.decompress(
        theirs, dictionary=d) == src


def test_zlib_hostile_raises_as_jax(data):
    d = data[:1000]
    good = Zl.compress(data[:20_000], 6)
    with_dict = Zl.compress(data[:20_000], 6, dictionary=d)
    bad_adler = good[:-1] + bytes([good[-1] ^ 1])
    cases = [(b"x\x9c", {}), (b"\x79\x9c" + good[2:], {}),
             (b"\x78\x9d" + good[2:], {}), (bad_adler, {}),
             (with_dict, {}), (with_dict, {"dictionary": d[:-1]}),
             (good[:-6], {}), (good, {"max_size": 100})]
    for i, (blob, kw) in enumerate(cases):
        assert outcome(Zl.decompress, blob, **kw) == outcome(
            jax_zlib.decompress, blob, **kw), i
        rkw = {k: v for k, v in kw.items() if k == "dictionary"}
        assert outcome(lambda: Zl.Reader(blob, **rkw).read()) == outcome(
            lambda: jax_zlib.Reader(blob, **rkw).read()), i


@pytest.mark.parametrize("level", (1, 3, 6))
def test_zlib_writer_reader_equal_jax(data, level):
    src = data * 4

    def write(mod):
        buf = io.BytesIO()
        w = mod.Writer(buf, level=level)
        w.write(src[:500_000])
        w.flush()
        w.write(src[500_000:])
        w.close()
        return buf.getvalue()

    got = write(Zl)
    assert got == write(jax_zlib)
    assert stdzlib.decompress(got) == src
    assert _steps(Zl.Reader(io.BytesIO(got)), 70_000) == _steps(
        jax_zlib.Reader(io.BytesIO(got)), 70_000) == src
    d = data[:5000]
    c = stdzlib.compressobj(level, zdict=d)
    theirs = c.compress(src[:100_000]) + c.flush()
    assert Zl.Reader(theirs, dictionary=d).read() == jax_zlib.Reader(
        theirs, dictionary=d).read() == src[:100_000]


# -- zip -----------------------------------------------------------------------


def _archive(mod, files):
    buf = io.BytesIO()
    w = mod.Writer(buf)
    for name, blob, method in files:
        w.create(name, blob, method=method, mtime=MTIME)
    w.comment = b"archive comment"
    w.close()
    return buf.getvalue()


def _files(data):
    return [("a.txt", data[:100_000], Zp.DEFLATE),
            ("dir/b.bin", bytes(range(256)) * 50, Zp.DEFLATE),
            ("empty", b"", Zp.DEFLATE),
            ("c.zst", data[:150_000], Zp.ZSTD),
            ("d.raw", data[:5000], Zp.STORE),
            ("rand.bin", data[3 * 65536:3 * 65536 + 20_000], Zp.DEFLATE),
            ("caf\xe9.txt", b"non-ascii name " * 40, Zp.ZSTD)]


def test_zip_archive_equals_jax(data):
    files = _files(data)
    got = _archive(Zp, files)
    assert got == _archive(jax_zip, files)
    r, jr = Zp.Reader(got), jax_zip.Reader(got)
    assert r.namelist() == jr.namelist() == [f[0] for f in files]
    for h, jh, (name, blob, _m) in zip(r.entries, jr.entries, files):
        assert dataclasses.astuple(h) == dataclasses.astuple(jh)
        assert r.read(h) == jr.read(jh) == blob
        assert r.open_raw(h) == jr.open_raw(jh)
    # the rand entry did not shrink: stored, as the reference does
    assert r.entries[5].method == Zp.STORE


def test_zip_stdlib_interop(data):
    files = [f for f in _files(data) if f[2] != Zp.ZSTD]
    blob = _archive(Zp, files)
    z = stdzip.ZipFile(io.BytesIO(blob))
    for name, want, _m in files:
        assert z.read(name) == want
    buf = io.BytesIO()
    with stdzip.ZipFile(buf, "w", stdzip.ZIP_DEFLATED) as z2:
        z2.writestr("p.txt", data[:90_000])
        z2.writestr("q.txt", b"another")
        z2.writestr(stdzip.ZipInfo("s.bin"), data[:3000],
                    compress_type=stdzip.ZIP_STORED)
    r, jr = Zp.Reader(buf.getvalue()), jax_zip.Reader(buf.getvalue())
    assert {h.name: r.read(h) for h in r.entries} == {
        h.name: jr.read(h) for h in jr.entries} == {
        "p.txt": data[:90_000], "q.txt": b"another", "s.bin": data[:3000]}


def test_zip_raw_copy_equals_jax(data):
    src = _archive(Zp, _files(data)[:4])

    def copy(mod):
        r = mod.Reader(src)
        buf = io.BytesIO()
        w = mod.Writer(buf)
        for h in r.entries:
            w.create_raw(dataclasses.replace(h, name="copy/" + h.name),
                         r.open_raw(h))
        w.close()
        return buf.getvalue()

    got = copy(Zp)
    assert got == copy(jax_zip)
    r = Zp.Reader(got)
    assert [r.read(h) for h in r.entries] == [f[1] for f in _files(data)[:4]]


def test_zip_codec_registry_equals_jax(data):
    for mod in (Zp, jax_zip):
        mod.register_compressor(201, lambda d: bytes(d)[::-1])
        mod.register_decompressor(201, lambda b, n: bytes(b)[::-1])
    files = [("r.bin", b"reversible codec! " * 30, 201)]
    got = _archive(Zp, files)
    assert got == _archive(jax_zip, files)
    assert Zp.Reader(got).read(Zp.Reader(got).entries[0]) == files[0][1]
    for mod in (Zp, jax_zip):
        with pytest.raises(mod.ZipError):
            mod.Writer(io.BytesIO()).create("x", b"x", method=77)


def test_zip_legacy_names_equal_jax():
    raw = bytearray(_archive(Zp, [("tmpname", b"hello legacy", Zp.STORE)]))
    nm = "café".encode("cp437") + b"\x01\x02\x03"
    i = raw.find(b"tmpname")
    while i >= 0:
        raw[i:i + 7] = nm
        i = raw.find(b"tmpname", i + 1)
    raw = bytes(raw)
    assert Zp.Reader(raw).namelist() == jax_zip.Reader(raw).namelist() == [
        nm.decode("cp437")]
    dec = lambda b: b.decode("latin-1")  # noqa: E731
    assert Zp.Reader(raw, name_decoder=dec).namelist() == jax_zip.Reader(
        raw, name_decoder=dec).namelist() == [nm.decode("latin-1")]


def test_zip64_records_equal_jax(data):
    """An entry whose offset is past 4 GiB in the central directory (a
    header written by hand) and 65,535 entries' end records: both
    packages read the zip64 fields alike."""
    h_kw = dict(name="big", method=Zp.STORE, mtime=MTIME, crc32=0,
                compressed_size=0, uncompressed_size=0)

    def write(mod):
        buf = io.BytesIO()
        w = mod.Writer(buf)
        w.create_raw(mod.FileHeader(**h_kw), b"")
        w.entries[0].offset = 1 << 32     # forces the zip64 extra
        w.close()
        return buf.getvalue()

    got = write(Zp)
    assert got == write(jax_zip)
    h, jh = Zp.Reader(got).entries[0], jax_zip.Reader(got).entries[0]
    assert h.offset == jh.offset == 1 << 32
    assert struct.unpack("<I", got[-22:-18])[0] == 0x06054B50


def test_zip_hostile_raises_as_jax(data):
    good = _archive(Zp, _files(data)[:4])
    r = Zp.Reader(good)
    c_off = good.find(struct.pack("<I", 0x02014B50))
    cases = [good[:-30], good[:c_off] + b"XXXX" + good[c_off + 4:]]
    for i, blob in enumerate(cases):
        assert outcome(lambda: Zp.Reader(blob).namelist()) == outcome(
            lambda: jax_zip.Reader(blob).namelist()), i
    bad = bytearray(good)
    first = r.entries[0]
    bad[first.offset + 30 + len(first.name) + 50] ^= 0xFF
    bad = bytes(bad)
    got = outcome(lambda: Zp.Reader(bad).read(Zp.Reader(bad).entries[0]))
    assert got == outcome(lambda: jax_zip.Reader(bad).read(
        jax_zip.Reader(bad).entries[0]))
    assert got[0] == "raised"
