"""The port's zstd stream tier (``zstd/stream.py``, ``zstd/dict.py``, the
encoder's ``window_log`` and ``dict_`` routes, ``decompress(dicts=)``,
``split_frames``, ``decode_concurrent`` and the streaming ``Xxh64``)
against the JAX package's, on the CPU, byte for byte (tolerance 0:
bytes, integers, arrays, and the class of what is raised).  Every frame
also decodes with ``zstandard``.

- ``Xxh64`` (host core) and ``Xxh64Py`` over split updates equal JAX's
  streaming digest and the one-shot ``xxh64``.
- ``zstd.stream.Writer`` at levels 1-4, with checksums, padding, a
  dictionary, a flush in the middle, ``read_from``, ``reset`` and worker
  threads, equals JAX's Writer; its plain job encoder
  (``_encode_job_blocks_py``) equals JAX's.
- ``compress(dict_=..., window_log=...)`` equals JAX on the ladder's
  windowed jobs, the dictionary job and the Python branch.
- ``load_dict`` of a ``zstandard``-trained and of a built dictionary gives
  JAX's content, id, repeat offsets and tables (arrays compared);
  ``build_dict`` equals JAX's and each side decodes the other's frames.
- Readers: ``Reader.read(n)`` steps, read-ahead, ``decompress(dicts=)``
  and ``decode_concurrent(split_frames)`` give the input back; a flipped
  checksum, a cut frame and an unknown dictionary id raise as JAX does;
  a frame with no dictionary id and no dictionaries takes the native
  path.
"""

import io

import numpy as np
import pytest

pytest.importorskip("jax")
zstandard = pytest.importorskip("zstandard")

from compress_tpu import zstd as jax_z  # noqa: E402
from compress_tpu.utils import xxhash64 as jax_xx  # noqa: E402
from compress_tpu.zstd import dict as jax_dict  # noqa: E402
from compress_tpu.zstd import stream as jax_stream  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch import zstd as Z  # noqa: E402
from compress_tpu_torch.utils import xxhash64 as XX  # noqa: E402
from compress_tpu_torch.zstd import dict as ZD  # noqa: E402
from compress_tpu_torch.zstd import encoder as E  # noqa: E402
from compress_tpu_torch.zstd import native_dec  # noqa: E402
from compress_tpu_torch.zstd import stream as ZS  # noqa: E402
from test_torch_jaxref import jax_native_core  # noqa: E402,F401


@pytest.fixture(scope="module")
def data():
    return (corpus.replica_jobs(1, 1 << 20, 3).tobytes()
            + corpus.corpus_blocks(2, 4).tobytes()[:77777])


def _samples(data: bytes, n: int = 32, size: int = 4096, seed: int = 0):
    rng = np.random.default_rng(seed)
    return [data[i:i + size]
            for i in rng.integers(0, len(data) - size, n).tolist()]


@pytest.fixture(scope="module")
def built(data):
    """A dictionary blob built by the port's ``build_dict`` from 32
    seeded 4 KiB samples, the first 64 KiB of them as its content."""
    s = _samples(data)
    return ZD.build_dict(s, b"".join(s)[:64 << 10], dict_id=7)


@pytest.fixture(scope="module")
def trained(data):
    return zstandard.train_dictionary(8192, _samples(data, 200, 2048,
                                                     1)).as_bytes()


def _zstd_decode(frame: bytes, blob: bytes | None = None) -> bytes:
    dd = (zstandard.ZstdDecompressor(dict_data=zstandard.ZstdCompressionDict(
        blob)) if blob else zstandard.ZstdDecompressor())
    return dd.decompressobj().decompress(frame)


# -- xxHash64 ----------------------------------------------------------------

@pytest.mark.parametrize("cls", ["Xxh64", "Xxh64Py"])
@pytest.mark.parametrize("seed", [0, 1, (1 << 64) - 1])
def test_xxh64_streaming_equals_jax(data, cls, seed):
    rng = np.random.default_rng(seed & 0xFFFF)
    cuts = sorted(rng.integers(0, 5000, 12).tolist()) + [5000]
    d = data[:5000]
    h, j = getattr(XX, cls)(seed), jax_xx.Xxh64(seed)
    assert h.digest() == j.digest() == XX.xxh64(b"", seed)
    prev = 0
    for c in cuts:
        h.update(d[prev:c])
        j.update(d[prev:c])
        prev = c
        assert h.digest() == j.digest() == XX.xxh64(d[:c], seed)


# -- Writer ------------------------------------------------------------------

def _write(mod, data, flush_at=None, **kw):
    buf = io.BytesIO()
    w = mod.Writer(buf, **kw)
    if flush_at is None:
        w.write(data)
    else:
        w.write(data[:flush_at])
        w.flush()
        w.write(data[flush_at:])
    w.close()
    return buf.getvalue()


CASES = {
    "plain": {},
    "checksum": {"checksum": True},
    "padding": {"checksum": True, "padding": 4096},
    "flush": {"checksum": True, "flush_at": 300001},
    "small_jobs": {"job_size": 1 << 16},
    "window_log": {"window_log": 17},
}


@pytest.mark.parametrize("level", [1, 2, 3, 4])
@pytest.mark.parametrize("case", list(CASES))
def test_writer_equals_jax(data, case, level):
    kw = dict(CASES[case], level=level)
    got = _write(ZS, data, **kw)
    assert got == _write(jax_stream, data, **kw)
    assert _zstd_decode(got) == data
    if case == "padding":
        assert len(got) % 4096 == 0


@pytest.mark.parametrize("level", [1, 3])
def test_writer_dict_equals_jax(data, built, level):
    d, jd = ZD.load_dict(built), jax_dict.load_dict(built)
    kw = {"level": level, "checksum": True, "flush_at": 123457}
    got = _write(ZS, data, dict_=d, **kw)
    assert got == _write(jax_stream, data, dict_=jd, **kw)
    assert _zstd_decode(got, built) == data
    assert ZS.Reader(io.BytesIO(got), dicts=[built]).read() == data
    assert Z.decompress(got, dicts=[d]) == data


def test_writer_workers_read_from_and_reset(data):
    serial = _write(ZS, data, level=2, checksum=True, job_size=1 << 16)
    assert _write(ZS, data, level=2, checksum=True, job_size=1 << 16,
                  workers=3) == serial
    buf = io.BytesIO()
    w = ZS.Writer(buf, level=2, checksum=True, job_size=1 << 16)
    w.write(b"discarded by the reset")
    w.reset(buf2 := io.BytesIO())
    assert w.read_from(io.BytesIO(data), chunk=100000) == len(data)
    assert w.n_input == len(data)
    w.close()
    assert buf2.getvalue() == serial
    with pytest.raises(Z.ZstdError):
        w.write(b"closed")


@pytest.mark.parametrize("plen", [0, 5000, 70000])
@pytest.mark.parametrize("level", [1, 2])
def test_job_blocks_plain_version_equals_jax(data, plen, level):
    seg = data[:plen + 40000]
    got = ZS._encode_job_blocks_py(seg, plen, level)
    assert got == jax_stream._encode_job_blocks_py(seg, plen, level)
    # a frame of the plain blocks and of the native ones decode alike
    for blocks in (got, E.compress_blocks(seg, plen, level)):
        head = E.compress_blocks(seg[:plen], 0, level) if plen else b""
        frame = (E.F.write_frame_header(None, 1 << 20, False, False)
                 + head + blocks + (1).to_bytes(3, "little"))
        assert _zstd_decode(frame) == seg


# -- compress with a window or a dictionary ---------------------------------

@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
@pytest.mark.parametrize("window_log", [None, 10, 14, 17, 30])
def test_compress_window_log_equals_jax(data, level, window_log):
    src = data[:50000] if level > 4 else data
    got = Z.compress(src, level=level, checksum=True, window_log=window_log)
    assert got == jax_z.compress(src, level=level, checksum=True,
                                 window_log=window_log)
    assert _zstd_decode(got) == src
    assert Z.decompress(got) == src


@pytest.mark.parametrize("which", ["built", "trained"])
@pytest.mark.parametrize("level", [1, 2, 3, 4, 5])
def test_compress_dict_equals_jax(data, built, trained, which, level):
    blob = built if which == "built" else trained
    d, jd = ZD.load_dict(blob), jax_dict.load_dict(blob)
    for n in (10, 5000, 200000 if level <= 4 else 40000):
        src = data[50000:50000 + n]
        got = Z.compress(src, level=level, checksum=True, dict_=d)
        assert got == jax_z.compress(src, level=level, checksum=True,
                                     dict_=jd)
        assert _zstd_decode(got, blob) == src
        assert Z.decompress(got, dicts=[blob]) == src
    # a window and a dictionary together take the Python branch (a window
    # of 128 KiB or more: the branch writes 128 KiB blocks)
    got = Z.compress(data[:40000], level=level, dict_=d, window_log=17)
    assert got == jax_z.compress(data[:40000], level=level, dict_=jd,
                                 window_log=17)
    assert _zstd_decode(got, blob) == data[:40000]


@pytest.mark.parametrize("which", ["built", "trained"])
def test_load_dict_equals_jax(built, trained, which):
    blob = built if which == "built" else trained
    d, jd = ZD.load_dict(blob), jax_dict.load_dict(blob)
    assert (d.id, d.content, d.reps, d.huf_blob) == (jd.id, jd.content,
                                                     jd.reps, jd.huf_blob)
    for a, b in zip(d.huf, jd.huf):
        assert np.array_equal(np.asarray(a), np.asarray(b))
    for t in ("t_ll", "t_of", "t_ml"):
        x, y = getattr(d, t), getattr(jd, t)
        assert (x.log, x.mode) == (y.log, y.mode)
        assert np.array_equal(x.norm, y.norm)
    assert ZD.inspect_dictionary(blob).id == d.id
    assert not d.raw and ZD.raw_dict(b"x" * 100, 5).raw
    with pytest.raises(ZD.DictError):
        ZD.load_dict(b"\x00" * 16)
    with pytest.raises(jax_dict.DictError):
        jax_dict.load_dict(b"\x00" * 16)


def test_build_dict_equals_jax_and_cross_decodes(data, built):
    s = _samples(data)
    hist = b"".join(s)[:64 << 10]
    assert built == jax_dict.build_dict(s, hist, dict_id=7)
    jblob = jax_dict.build_dict(s[:8], hist[:20000], dict_id=9, level=3)
    assert ZD.build_dict(s[:8], hist[:20000], dict_id=9, level=3) == jblob
    src = data[200000:400000]
    ours = Z.compress(src, level=2, dict_=ZD.load_dict(jblob))
    theirs = jax_z.compress(src, level=2, dict_=jax_dict.load_dict(jblob))
    assert jax_z.decompress(ours, dicts=[jblob]) == src
    assert Z.decompress(theirs, dicts=[jblob]) == src
    with pytest.raises(ZD.DictError):
        ZD.build_dict(s, b"short")


def test_raw_dict_frames(data):
    d, jd = ZD.raw_dict(data[:20000], 0), jax_dict.raw_dict(data[:20000], 0)
    src = data[10000:90000]
    f = Z.compress(src, level=5, dict_=d)
    assert f == jax_z.compress(src, level=5, dict_=jd)
    assert Z.decompress(f, dicts=[d]) == src == jax_z.decompress(f,
                                                                  dicts=[jd])


# -- readers -----------------------------------------------------------------

def _read_steps(r, n):
    out = bytearray()
    while True:
        x = r.read(n)
        if not x:
            return bytes(out)
        out += x


@pytest.fixture(scope="module")
def frames(data):
    """Three frames (levels 1, 3, and a libzstd frame) with a skippable
    frame between them."""
    parts = [Z.compress(data[:400000], level=1, checksum=True),
             E.F.write_skippable_frame(b"skip me", 3),
             Z.compress(data[400000:], level=3),
             zstandard.ZstdCompressor(level=5, write_checksum=True)
             .compress(data[:99999])]
    return b"".join(parts), data + data[:99999]


@pytest.mark.parametrize("step", [1 << 20, 4096, 777])
def test_reader_steps_equal_input(frames, step):
    f, want = frames
    r = ZS.Reader(io.BytesIO(f))
    assert _read_steps(r, step) == want
    r.close()
    r.close()
    assert ZS.Reader(io.BytesIO(f)).read() == want
    assert ZS.Reader(io.BytesIO(f), readahead=3).read(-1) == want
    assert _read_steps(ZS.Reader(io.BytesIO(f), readahead=2), step) == want


def test_split_frames_and_decode_concurrent(frames):
    f, want = frames
    spans = Z.split_frames(f)
    assert spans == jax_z.split_frames(f)
    assert len(spans) == 3
    assert Z.decode_concurrent(f, workers=3) == want
    assert b"".join(Z.decompress(f[a:b]) for a, b in spans) == want
    with pytest.raises(Z.ZstdError):
        Z.split_frames(f[:-3])


def test_native_path_without_dicts(frames, monkeypatch):
    """A frame with no dictionary id and no dictionaries given takes the
    host core's whole-stream decode."""
    f, want = frames
    calls = []
    real = native_dec.decode_all
    monkeypatch.setattr(native_dec, "decode_all",
                        lambda *a: calls.append(1) or real(*a))
    assert Z.decompress(f) == want
    assert Z.decompress(f, dicts=[]) == want
    assert len(calls) == 2
    assert Z.decompress(f, dicts=[ZD.raw_dict(b"y" * 64, 5)]) == want
    assert len(calls) == 2


def _bad_frames(data, built):
    good = Z.compress(data[:200000], level=2, checksum=True)
    flip = bytearray(good)
    flip[-1] ^= 0xFF
    d = ZD.load_dict(built)
    return {
        "checksum": bytes(flip),
        "cut": good[:len(good) // 2],
        "unknown_dict": Z.compress(data[:5000], level=2,
                                   dict_=ZD.raw_dict(b"z" * 100, 99)),
        "wrong_dict": Z.compress(data[:5000], level=2, dict_=d),
    }


@pytest.mark.parametrize("kind", ["checksum", "cut", "unknown_dict",
                                  "wrong_dict"])
def test_corrupt_frames_raise_as_jax(data, built, kind):
    f = _bad_frames(data, built)[kind]
    other = [ZD.raw_dict(b"q" * 64, 3)] if kind == "wrong_dict" else None
    jother = [jax_dict.raw_dict(b"q" * 64, 3)] if other else None
    cases = [(lambda b: _read_steps(ZS.Reader(io.BytesIO(b), dicts=other),
                                    65536),
              lambda b: _read_steps(jax_stream.Reader(io.BytesIO(b),
                                                      dicts=jother), 65536)),
             (lambda b: Z.decompress(b, dicts=other),
              lambda b: jax_z.decompress(b, dicts=jother))]
    for ours, theirs in cases:
        with pytest.raises(Exception) as want:
            theirs(f)
        with pytest.raises(Exception) as got:
            ours(f)
        assert type(got.value).__name__ == type(want.value).__name__


def test_simple_api(data):
    src = data[:100000]
    assert Z.encode_to(b"head", src, level=2) == jax_z.encode_to(b"head", src,
                                                                 level=2)
    assert Z.decode_to(b"head", Z.compress(src)) == b"head" + src
    assert ZS.encode_to(src, 3) == jax_stream.encode_to(src, 3)
    assert ZS.decode_to(ZS.encode_to(src)) == src
    for n in (0, 1, 1 << 17, (1 << 17) + 1, 10 << 20):
        assert Z.max_encoded_size(n) == jax_z.max_encoded_size(n)
    assert len(Z.compress(src, level=1)) <= Z.max_encoded_size(len(src))
