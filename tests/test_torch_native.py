"""The port's host core (``compress_tpu_torch/_native``) against the JAX
package's native core and against the port's own plain Python versions,
on the CPU, byte for byte (tolerance 0: bytes, integers and raised-or-not).

- Build and load: a failed build raises with the compiler's message; the
  port's library and the JAX package's live side by side, and
  ``predef_seq_tables`` of one changes that one's frames only.
- Checksums: ``crc32c`` / ``crc32c_masked`` / ``xxh64`` equal the JAX
  package's (native) and the Python versions.
- S2: block encode, decode (S2 and strict snappy) and the device decode's
  planner equal JAX and the Python versions, on corpus classes, empty and
  1-byte inputs, blocks over 256 KiB, corrupt tags and truncations.
- zstd: ``compress`` (the ladder, levels 1-4, checksum on and off, under
  ``predef_seq_tables``), ``compress_frame_bs`` and ``compress_accel``
  equal JAX's unpatched functions and decode through ``zstandard`` and
  ``decompress_py``; ``decompress`` equals JAX and ``decompress_py`` on
  valid, truncated and bad-checksum frames; the sidecar payload equals
  ``sidecar.build_payload`` and the sidecar JAX's, also on truncated
  frames; job assembly equals ``_assemble_job_py`` and JAX's.
- FSE and huff0: the NCount writer, the 2-state codec, the container
  decode, package-merge, the table writer and the stream codec equal JAX
  and the Python versions, on corpus classes and hostile containers."""

import ctypes

import numpy as np
import pytest

jax = pytest.importorskip("jax")
zstandard = pytest.importorskip("zstandard")
import torch  # noqa: E402

from compress_tpu import fse as jax_fse  # noqa: E402
from compress_tpu import huff0 as jax_h  # noqa: E402
from compress_tpu import zstd as jax_z  # noqa: E402
from compress_tpu.fse import core as jax_fc  # noqa: E402
from compress_tpu.s2 import block as jax_s2  # noqa: E402
from compress_tpu.utils import crc as jax_crc  # noqa: E402
from compress_tpu.utils import xxhash64 as jax_xx  # noqa: E402
from compress_tpu.zstd import accel as jax_a  # noqa: E402
from compress_tpu.zstd import device as jax_dev  # noqa: E402
from compress_tpu.zstd import encoder as jax_enc  # noqa: E402
from compress_tpu_torch import _native  # noqa: E402
from compress_tpu_torch import corpus, fse  # noqa: E402
from compress_tpu_torch import zstd as Z  # noqa: E402
from compress_tpu_torch.fse import core as FC  # noqa: E402
from compress_tpu_torch.huff0 import batch as HB  # noqa: E402
from compress_tpu_torch.huff0 import table as HT  # noqa: E402
from compress_tpu_torch.ops import zdev, zenc2  # noqa: E402
from compress_tpu_torch.s2 import block as S2B  # noqa: E402
from compress_tpu_torch.s2 import device_dec as SD  # noqa: E402
from compress_tpu_torch.s2 import plan as SP  # noqa: E402
from compress_tpu_torch.utils import crc as CRC  # noqa: E402
from compress_tpu_torch.utils import xxhash64 as XX  # noqa: E402
from compress_tpu_torch.utils.varint import read_uvarint  # noqa: E402
from compress_tpu_torch.zstd import accel as A  # noqa: E402
from compress_tpu_torch.zstd import device as D  # noqa: E402
from compress_tpu_torch.zstd import encoder as E  # noqa: E402
from compress_tpu_torch.zstd import sidecar  # noqa: E402
from compress_tpu_torch.zstd.frame import parse_frame_header  # noqa: E402
from test_torch_jaxref import jax_native_core  # noqa: E402,F401

NAMES = list(corpus.CLASSES)


def _block(cls: str, n: int, seed: int) -> bytes:
    return corpus.make_block(cls, np.random.default_rng(seed)).tobytes()[:n]


def _outcome(fn):
    """The bytes a call returns, or "raised" for a ValueError (or subclass:
    the corrupt-input errors of both packages) or IndexError."""
    try:
        r = fn()
    except (ValueError, IndexError, MemoryError):
        return "raised"
    return bytes(r) if isinstance(r, (bytes, bytearray, np.ndarray)) else r


def _length(block: bytes):
    """(decoded length, body offset) of an S2 block, or None where its
    uvarint is cut."""
    try:
        return read_uvarint(block)
    except ValueError:
        return None


def _damaged(blob: bytes, seed: int, flips: int = 8) -> list:
    """Truncations and single bit flips of blob."""
    rng = np.random.default_rng(seed)
    out = [blob[:k] for k in sorted({0, 1, len(blob) // 2, len(blob) - 1})]
    for _ in range(flips):
        bad = bytearray(blob)
        if bad:
            bad[int(rng.integers(0, len(bad)))] ^= 1 << int(rng.integers(8))
        out.append(bytes(bad))
    return out


@pytest.fixture(scope="module")
def samples():
    """Seeded inputs: every corpus class (20,000 bytes), the hostile
    lengths, and a block over 256 KiB."""
    out = {f"{c}": _block(c, 20000, 7 + i) for i, c in enumerate(NAMES)}
    out.update(empty=b"", one=b"\x5a", sixteen=bytes(range(16)),
               seventeen=bytes(range(17)))
    big = corpus.corpus_blocks(5, 3).tobytes()[:300000]
    out["big"] = big
    return out


# ---- build and load --------------------------------------------------------

def test_failed_build_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_native, "CXX", str(tmp_path / "no-such-g++"))
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="host core build failed"):
        _native.build()
    assert not list((tmp_path / "build").glob("*.so"))


def test_failed_compile_raises_with_compiler_output(monkeypatch, tmp_path):
    src = tmp_path / "src"
    src.mkdir()
    for name in _native.SOURCES:
        (src / name).write_text("this is not C++;\n")
    monkeypatch.setattr(_native, "SRC_DIR", src)
    monkeypatch.setattr(_native, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="error"):
        _native.build()


def test_library_loaded_local_and_typed():
    from compress_tpu import _native as jax_native

    lib = _native.library()
    assert lib is _native.library()
    assert _native.build().parent == _native.BUILD_DIR
    assert jax_native.raw() is not None
    assert lib._handle != jax_native.raw()._handle
    for name in _native._SIGNATURES:
        assert getattr(lib, name).argtypes is not None


def test_predef_flag_is_per_library():
    """Each package's predef_seq_tables changes its own frames and not the
    other's: the two libraries' ct_g_force_predef are apart."""
    data = _block("text", 60000, 5) + _block("rand4", 20000, 5)
    port0, jax0 = E.compress(data, level=1), jax_enc.compress(data, level=1)
    assert port0 == jax0
    with E.predef_seq_tables():
        port1 = E.compress(data, level=1)
        assert jax_enc.compress(data, level=1) == jax0
    with jax_enc.predef_seq_tables():
        jax1 = jax_enc.compress(data, level=1)
        assert E.compress(data, level=1) == port0
    assert port1 == jax1 != port0
    assert E.compress(data, level=1) == port0
    assert not E._FORCE_PREDEF


# ---- checksums -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_crc32c_and_xxh64(samples, seed):
    rng = np.random.default_rng(seed)
    for name, data in samples.items():
        d = data[:int(rng.integers(0, 4000))] if seed else data
        init = int(rng.integers(0, 1 << 32))
        assert CRC.crc32c(d) == jax_crc.crc32c(d) == CRC.crc32c_py(d), name
        assert CRC.crc32c(d, init) == jax_crc.crc32c(d, init) == \
            CRC.crc32c_py(d, init)
        assert CRC.crc32c_masked(d) == jax_crc.crc32c_masked(d)
        s = int(rng.integers(0, 1 << 64, dtype=np.uint64))
        assert XX.xxh64(d, s) == jax_xx.xxh64(d, s) == XX.xxh64_py(d, s)
    assert CRC.crc32c(b"123456789") == 0xE3069283
    assert XX.xxh64(b"") == 0xEF46DB3751D8E999


# ---- S2 --------------------------------------------------------------------

def test_s2_encode_equals_jax_and_python(samples):
    for name, data in samples.items():
        block = S2B.encode(data)
        assert block == jax_s2.encode(data), name
        assert S2B.encode_body(data) == S2B._encode_block_py(data), name
        assert S2B.decode(block) == data


def test_s2_decode_equals_jax_on_hostile_blocks(samples):
    for i, name in enumerate(("text", "period3", "rand4", "one", "empty")):
        data = samples[name]
        for strict, block in ((False, jax_s2.encode(data)),
                              (True, jax_s2.encode_snappy(data))):
            for bad in _damaged(block, i):
                want = _outcome(lambda: jax_s2.decode(
                    bad, allow_repeat=not strict))
                got = _outcome(lambda: S2B.decode(bad,
                                                  allow_repeat=not strict))
                assert got == want, (name, strict)
                hdr = _length(bad)
                if hdr is not None and hdr[0] < (1 << 20):
                    dlen, pos = hdr
                    py = _outcome(lambda: S2B._decode_block_py(
                        dlen, bad[pos:], int(strict)))
                    assert py == got, (name, strict)


def _jax_plan(body: bytes, dlen: int, allow_repeat: bool, max_rounds: int):
    from compress_tpu import _native as jax_native
    from compress_tpu.s2 import device_dec as jax_sd

    cap = 8 + dlen + 6 * (4 * dlen + 2048) + 64
    oarr, out = jax_native.out_buf(cap)
    r = jax_sd._lib().ct_s2_build_plan(body, len(body), dlen,
                                       int(allow_repeat), max_rounds, out,
                                       cap)
    return jax_sd._parse_payload(oarr[:r].tobytes()) if r > 0 else None


def _same_plan(a, b):
    if a is None or b is None:
        return a is None and b is None
    return (a[0] == b[0] and a[1] == b[1] and a[5] == b[5]
            and all(np.array_equal(x, y) for x, y in zip(a[2:5], b[2:5])))


@pytest.mark.parametrize("max_rounds", [1, 4])
def test_s2_plan_equals_jax_and_python(samples, max_rounds):
    planned = 0
    for i, (name, data) in enumerate(samples.items()):
        for strict in (False, True):
            block = (jax_s2.encode_snappy if strict else jax_s2.encode)(data)
            cases = [block] + (_damaged(block, i, 4) if name in (
                "text", "period7") else [])
            for blk in cases:
                hdr = _length(blk)
                if hdr is None or hdr[0] > (1 << 19):
                    continue
                dlen, pos = hdr
                body = blk[pos:]
                got = SD.native_plan(body, dlen, not strict, max_rounds)
                want = (_jax_plan(body, dlen, not strict, max_rounds)
                        if 0 < dlen <= SP.MAX_LEN else None)
                assert _same_plan(got, want), (name, strict)
                if dlen > 0:
                    assert _same_plan(got, SP.build_plan(
                        body, dlen, not strict, max_rounds)), (name, strict)
                planned += got is not None
    assert planned >= 2 * len(NAMES)
    assert SD.native_plan(S2B.encode(samples["big"])[3:],
                          len(samples["big"])) is None


# ---- zstd: the ladder, frame_bs, accel -------------------------------------

@pytest.mark.parametrize("level", [1, 2, 3, 4])
@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "xxh"])
def test_compress_ladder_equals_jax(samples, level, checksum):
    dz = zstandard.ZstdDecompressor()
    names = list(samples) if level == 1 else ["text", "zeros", "gate",
                                              "seventeen", "sixteen", "big"]
    for name in names:
        data = samples[name]
        frame = E.compress(data, level=level, checksum=checksum)
        assert frame == jax_z.compress(data, level=level,
                                       checksum=checksum), name
        assert dz.decompress(frame, max_output_size=max(len(data), 1)) == data
        if name != "big":
            assert Z.decompress_py(frame) == data


@pytest.mark.parametrize("level", [1, 4])
def test_compress_ladder_predef_equals_jax(samples, level):
    for name in ("text", "period3", "rand4"):
        data = samples[name] + samples["text"][:5000]
        with E.predef_seq_tables(), jax_enc.predef_seq_tables():
            frame = E.compress(data, level=level)
            assert frame == jax_z.compress(data, level=level), name
        assert Z.decompress_py(frame) == data
        assert zstandard.ZstdDecompressor().decompress(frame) == data


def test_compress_frame_bs_and_accel_equal_jax():
    data = b"".join(_block(c, 40000, 11) for c in ("text", "rand4", "text"))
    for hb in (1, 3):
        frame = E.compress_frame_bs(data, 1, 16, hb << 16)
        assert frame == jax_a._compress_frame_bs(data, 1, 16, hb << 16)
        assert zstandard.ZstdDecompressor().decompress(frame) == data
    for mb in (False, True):
        blob = A.compress_accel(data, level=1, multi_block=mb)
        assert blob == jax_a.compress_accel(data, level=1, multi_block=mb)
        assert Z.decompress(blob) == data
    with pytest.raises(ValueError):
        E.compress_frame_bs(b"short", 1, 16, 0)


# ---- zstd: decode ----------------------------------------------------------

def test_decompress_equals_jax_and_python(samples):
    frames = [jax_z.compress(samples["text"], level=2, checksum=True),
              zstandard.ZstdCompressor(level=3).compress(samples["gate"]),
              E.compress_matcher(samples["period7"], 1, True),
              E.compress(samples["big"], 1)]
    for i, frame in enumerate(frames):
        want = jax_z.decompress(frame)
        assert Z.decompress(frame) == want
        if i < 3:
            assert Z.decompress_py(frame) == want
        assert Z.decompress(frame + frames[0]) == want + jax_z.decompress(
            frames[0])
    bad_ck = bytearray(frames[0])
    bad_ck[-1] ^= 1
    for bad in _damaged(frames[0], 3) + _damaged(frames[1], 4) + [
            bytes(bad_ck)]:
        want = _outcome(lambda: jax_z.decompress(bad))
        assert _outcome(lambda: Z.decompress(bad)) == want
        assert _outcome(lambda: Z.decompress_py(bad)) == want
    assert _outcome(lambda: Z.decompress(bytes(bad_ck),
                                         ignore_checksum=True)) == \
        samples["text"]
    assert Z.decompress(b"") == b""
    with pytest.raises(Z.ZstdError):
        Z.decompress(frames[0], max_size=100)


# ---- zstd: the sidecar ------------------------------------------------------

def _sidecar_frames():
    t = b"".join(_block("text", 65536, s) for s in (21, 22))
    return [E.compress(t[:60000], 1),
            E.compress(_block("gate", 65536, 2), 3),
            zstandard.ZstdCompressor(level=5).compress(t[:50000]),
            E.compress_frame_bs(t, 1, 16, 1 << 16)]


@pytest.mark.parametrize("seq_cks", [False, True], ids=["plan", "seq_cks"])
def test_sidecar_equals_jax_and_python(seq_cks):
    built = 0
    for i, frame in enumerate(_sidecar_frames()):
        hb = 1 if i == 3 else 0
        body = frame[parse_frame_header(frame).header_size:]
        got = A.sidecar_payload(body, 4, seq_cks, hb)
        assert got == sidecar.build_payload(body, 4, seq_cks, hb), i
        assert A.build_sidecar(frame, 4, seq_cks, hb) == \
            jax_a.build_sidecar(frame, 4, seq_cks, hb)
        built += got is not None
        for bad in ([body[:len(body) // 2], body[:3], b""] if i < 2 else []):
            assert A.sidecar_payload(bad, 4, seq_cks, hb) == \
                sidecar.build_payload(bad, 4, seq_cks, hb)
    assert built == 4


def test_split_sidecar_rejects_bad_checksum_and_truncation():
    frame = _sidecar_frames()[0]
    side = A.build_sidecar(frame)
    payload, rest = A.split_sidecar(side + frame)
    assert payload is not None and rest == frame
    assert payload == jax_a.split_sidecar(side + frame)[0]
    bad = bytearray(side)
    bad[12] ^= 0x40            # inside the CRC-covered payload
    assert A.split_sidecar(bytes(bad) + frame) == (None, frame)
    assert jax_a.split_sidecar(bytes(bad) + frame)[0] is None
    cut = side[:-5]
    assert A.split_sidecar(cut)[0] is None


# ---- zstd: job assembly -----------------------------------------------------

@pytest.mark.parametrize("engine", ["v1", "v2"])
def test_assemble_job_equals_python_and_jax(engine):
    if engine == "v2":
        job, block = 2 * zenc2.BLOCK, zenc2.BLOCK
        parts = ("text", "zeros", "rand256", "period3")
    else:
        job, block = 32 << 10, 8 << 10
        parts = ("text", "zeros", "rand256", "period7", "gate", "rand4",
                 "text", "zeros")
    data = b"".join(_block(c, job // 2, 40 + i) for i, c in enumerate(parts))
    src = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    n_jobs = len(data) // job
    jobs, prefixes, has_prefix = D.launch_inputs(src, 0, n_jobs, job)
    if engine == "v2":
        t = zenc2.zstd_encode_jobs_v2(jobs, job=job, prefixes=prefixes,
                                      has_prefix=has_prefix)
    else:
        t = zdev.zstd_encode_jobs(jobs, job=job, block=block,
                                  prefixes=prefixes, has_prefix=has_prefix,
                                  level=2)
    t = {k: v.cpu().numpy() for k, v in t.items()}
    kinds = set()
    for j in range(n_jobs):
        jb = data[j * job:(j + 1) * job]
        got = D._assemble_job(jb, t, j, block)
        assert got == D._assemble_job_py(jb, t, j, block)
        assert got == jax_dev._assemble_job_native(jb, t, j, block)
        kinds |= {type(b).__name__ for b in got}
    assert {"bytes", "tuple", "NoneType"} <= kinds


# ---- FSE and huff0 ----------------------------------------------------------

def test_fse_codec_equals_jax_and_python(samples):
    for i, name in enumerate(("text", "rand4", "period3", "gate", "big")):
        data = samples[name][:60000]
        try:
            blob = jax_fse.compress(data)
        except ValueError:
            continue
        assert fse.compress(data) == blob, name
        assert fse.decompress(blob) == data == fse.decompress_py(blob)
        n, pos = read_uvarint(blob)
        norm, tl, p = FC.read_ncount(blob, pos, max_symbol=255)
        assert FC.write_ncount(norm, tl) == FC.write_ncount_py(norm, tl) == \
            jax_fc.write_ncount(norm, tl) == blob[pos:p]
        sym = np.frombuffer(data, np.uint8)
        stream = FC.encode_interleaved2(sym, norm, tl)
        assert stream == FC.encode_interleaved2_py(sym, norm, tl) == \
            jax_fc.encode_interleaved2(sym, norm, tl) == blob[p:]
        assert np.array_equal(FC.decode_interleaved2(stream, norm, tl, n),
                              FC.decode_interleaved2_py(stream, norm, tl, n))
        for bad in _damaged(blob, i, 6):
            want = _outcome(lambda: jax_fse.decompress(bad))
            assert _outcome(lambda: fse.decompress(bad)) == want, name
            assert _outcome(lambda: fse.decompress_py(bad)) == want, name


def test_huff0_equals_jax_and_python(samples):
    for i, name in enumerate(("text", "rand4", "period7", "gate")):
        data = samples[name][:12000]
        buf = np.frombuffer(data, np.uint8)
        hist = np.bincount(buf, minlength=256).astype(np.int64)
        for limit in (11, 9):
            assert np.array_equal(HT.package_merge_lengths(hist, limit),
                                  HT.package_merge_lengths_py(hist, limit))
            assert np.array_equal(HT.package_merge_lengths(hist, limit),
                                  jax_h.package_merge_lengths(hist, limit))
        nbits, mb = HT.build_nbits(hist, 11)
        table = HT.write_table(nbits, mb)
        assert table == HT.write_table_py(nbits, mb) == \
            jax_h.write_table(nbits, mb)
        codes = HT.canonical_codes(nbits, mb)
        stream = HB._encode_stream(buf, codes, nbits)
        assert stream == HB._encode_stream_py(buf, codes, nbits) == \
            jax_h._encode_stream(buf, codes, nbits)
        sym_t, nb_t, mbits, _ = HT.read_table(table)
        assert np.array_equal(
            HB._decode_stream(stream, sym_t, nb_t, mbits, len(buf)),
            HB._decode_stream_py(stream, sym_t, nb_t, mbits, len(buf)))
        for compress, dec in ((jax_h.compress_1x, "decompress_1x"),
                              (jax_h.compress_4x, "decompress_4x")):
            blob = compress(data)
            assert getattr(HB, dec)(blob) == data
            for bad in _damaged(blob, i, 6):
                want = _outcome(lambda: getattr(jax_h, dec)(bad))
                assert _outcome(lambda: getattr(HB, dec)(bad)) == want, name


# -- the stream tier's entries ----------------------------------------------

STREAM_ENTRIES = ("ct_zstd_compress_blocks_level", "ct_zstd_state_new",
                  "ct_zstd_state_append", "ct_zstd_state_free",
                  "ct_zstd_decode_block", "ct_xxh64_new", "ct_xxh64_update",
                  "ct_xxh64_digest", "ct_xxh64_free")


def test_stream_entries_in_the_table():
    lib = _native.library()
    for name in STREAM_ENTRIES:
        assert name in _native._SIGNATURES
        assert getattr(lib, name).argtypes is not None


@pytest.mark.parametrize("seed", [0, 7, (1 << 64) - 1])
def test_streaming_xxh64_equals_jax_and_python(samples, seed):
    data = samples["text"][:20000] + samples["rand256"][:20000]
    cuts = [0, 1, 31, 32, 33, 100, 4099, 20000, 39999, 40000]
    ours, plain, theirs = XX.Xxh64(seed), XX.Xxh64Py(seed), jax_xx.Xxh64(seed)
    assert theirs._st is not None      # the JAX package's native state
    for a, b in zip(cuts, cuts[1:]):
        for h in (ours, plain, theirs):
            h.update(data[a:b])
        assert ours.digest() == plain.digest() == theirs.digest() == \
            XX.xxh64(data[:b], seed)


@pytest.mark.parametrize("level", [1, 2, 3, 4])
def test_job_entry_equals_jax_and_python(samples, level):
    from compress_tpu import _native as jax_native
    from compress_tpu.zstd.encoder import bind_job_entry
    from compress_tpu_torch.zstd import stream as ZS

    seg = b"".join(samples[n][:40000] for n in ("text", "period7", "gate"))
    jlib = bind_job_entry(jax_native.raw())
    for start in (0, 1, 50000):
        ours = E.compress_blocks(seg, start, level)
        arr, dst = jax_native.out_buf(len(seg) * 2 + 4096)
        r = jlib.ct_zstd_compress_blocks_level(seg, len(seg), start, dst,
                                               len(seg) * 2 + 4096, level)
        assert ours == arr[:r].tobytes()
        head = E.compress_blocks(seg[:start], 0, level) if start else b""
        for blocks in (ours, ZS._encode_job_blocks_py(seg, start, level)):
            frame = (E.F.write_frame_header(None, 1 << 20, False, False)
                     + head + blocks + (1).to_bytes(3, "little"))
            assert Z.decompress_py(frame) == seg


def test_incremental_block_decode_equals_jax_and_python(samples):
    """The frame's blocks one at a time through the native state (raw and
    RLE blocks appended to its window) against the JAX package's state and
    the Python block decoder with its history."""
    from compress_tpu.zstd import native_dec as jax_nd
    from compress_tpu_torch.zstd import block as ZB

    data = (samples["big"] + bytes(5000) + samples["rand256"]
            + samples["period7"])
    # jobs of compressed or raw blocks, then an empty raw last block
    frame = jax_z.compress(data, level=2, checksum=False, window_log=17)
    h = parse_frame_header(frame)
    lib, jlib = _native.library(), jax_nd._lib()
    st, jst = lib.ct_zstd_state_new(h.window_size), jlib.ct_zstd_state_new(
        h.window_size)
    hist = ZB.History(window_size=h.window_size)
    out = np.empty((1 << 17) + 64, np.uint8)
    jout = ctypes.create_string_buffer((1 << 17) + 64)
    pos, got, kinds, last = h.header_size, bytearray(), set(), 0
    try:
        while not last:
            bh = int.from_bytes(frame[pos:pos + 3], "little")
            last = bh & 1
            btype, bsize = (bh >> 1) & 3, bh >> 3
            pos += 3
            kinds.add(btype)
            if btype == ZB.BLOCK_COMPRESSED:
                body = frame[pos:pos + bsize] + bytes(16)
                r = lib.ct_zstd_decode_block(st, body, bsize, _native.ptr(out),
                                             len(out))
                jr = jlib.ct_zstd_decode_block(jst, body, bsize, jout,
                                               len(jout))
                blk = out[:r].tobytes()
                assert blk == jout.raw[:jr]
                assert blk == ZB.decode_block(frame[pos:pos + bsize], hist,
                                              ZB.MAX_BLOCK_SIZE)
                pos += bsize
            else:
                blk = (frame[pos:pos + bsize] if btype == ZB.BLOCK_RAW
                       else frame[pos:pos + 1] * bsize)
                pos += bsize if btype == ZB.BLOCK_RAW else 1
                lib.ct_zstd_state_append(st, blk, len(blk))
                jlib.ct_zstd_state_append(jst, blk, len(blk))
            hist.append(blk)
            got += blk
    finally:
        lib.ct_zstd_state_free(st)
        jlib.ct_zstd_state_free(jst)
    assert bytes(got) == data
    assert {ZB.BLOCK_COMPRESSED, ZB.BLOCK_RAW} <= kinds
