"""The port's dictionary trainer (``dictbuilder``), compressibility
estimate (``estimate``) and debug log (``utils/debuglog``) against the JAX
package's, on the CPU (tolerance 0: bytes, integers and the float the
estimate returns, bit for bit).

- ``build_raw_dict``, ``build_zstd_dict`` and ``build_s2_dict`` on seeded
  samples of each corpus class, with cross-sample matches (the match
  coverage path on the host core's ``s2.encode_better``) and without (the
  fragment path), and the op walk ``_iter_copy_ops``.
- ``estimate`` and ``shannon_entropy_bits`` on every corpus class, short
  inputs and numpy arrays, exported from the package as the reference
  exports them.
- ``COMPRESS_TPU_DEBUG``: the tags, the message format, and the lines the
  host zstd decoder, the host encoder's ladder, the multi-block device
  decode's host route and the sharded encoder write.
"""

import importlib

import numpy as np
import pytest

pytest.importorskip("jax")

import compress_tpu  # noqa: E402
import compress_tpu_torch  # noqa: E402
from compress_tpu import dictbuilder as jax_db  # noqa: E402
from compress_tpu import zstd as jax_zstd  # noqa: E402
from compress_tpu.utils import debuglog as jax_log  # noqa: E402
from compress_tpu_torch import corpus, dictbuilder  # noqa: E402
from compress_tpu_torch import s2  # noqa: E402
from compress_tpu_torch import zstd as Z  # noqa: E402
from compress_tpu_torch.utils import debuglog  # noqa: E402
from test_torch_jaxref import jax_native_core  # noqa: E402,F401

est = importlib.import_module("compress_tpu_torch.estimate")
jax_est = importlib.import_module("compress_tpu.estimate")


def _samples(kind: str, n: int = 32, seed: int = 0):
    rng = np.random.default_rng([seed, 61])
    if kind == "json":
        return [b'{"user": "%d", "tags": ["alpha", "beta"], "score": %d}'
                % (int(rng.integers(0, 999)), i) * 12 for i in range(n)]
    cls = corpus.CLASSES.index(kind)
    blocks = corpus.corpus_blocks(len(corpus.CLASSES) * 2, seed)
    src = blocks[cls::len(corpus.CLASSES)].reshape(-1).tobytes()
    return [src[i:i + 2048]
            for i in rng.integers(0, len(src) - 2048, n).tolist()]


KINDS = ("json", *corpus.CLASSES)


# -- dictbuilder ---------------------------------------------------------------


@pytest.mark.parametrize("kind", KINDS)
def test_raw_dict_equals_jax(kind):
    samples = _samples(kind)
    got = dictbuilder.build_raw_dict(samples, 8192)
    assert got == jax_db.build_raw_dict(samples, 8192)
    assert 16 <= len(got) <= 8192


def outcome(fn, *args, **kw):
    """("ok", value) or ("raised", class name, is a ValueError)."""
    try:
        return ("ok", fn(*args, **kw))
    except Exception as e:  # noqa: BLE001 - the class is what is compared
        return ("raised", type(e).__name__, isinstance(e, ValueError))


@pytest.mark.parametrize("kind", ("json", "text", "period7", "rand256"))
def test_zstd_and_s2_dicts_equal_jax(kind):
    """On random bytes both packages' zstd dictionaries raise: the
    literal table of random content does not serialize."""
    samples = _samples(kind)
    zd = outcome(dictbuilder.build_zstd_dict, samples, 16384, dict_id=5)
    assert zd == outcome(jax_db.build_zstd_dict, samples, 16384, dict_id=5)
    assert (zd[0] == "raised") == (kind == "rand256")
    sd = dictbuilder.build_s2_dict(samples, 16384)
    assert sd == jax_db.build_s2_dict(samples, 16384)
    if zd[0] == "ok":
        from compress_tpu_torch.zstd.dict import load_dict

        d = load_dict(zd[1])
        frame = Z.compress(samples[0], level=2, dict_=d)
        assert Z.decompress(frame, dicts=[d]) == samples[0]


def test_match_segments_and_fragments_equal_jax():
    samples = _samples("text", 16)
    assert dictbuilder._match_segments(samples, 4096) == (
        jax_db._match_segments(samples, 4096))
    assert dictbuilder._match_segments([b"tiny"], 4096) is None
    assert jax_db._match_segments([b"tiny"], 4096) is None
    # no cross-sample matches: the fragment path
    rnd = _samples("rand256", 4)
    assert dictbuilder._match_segments(rnd, 4096) == jax_db._match_segments(
        rnd, 4096)
    assert dictbuilder._fragments(samples) == jax_db._fragments(samples)
    for few in ([b"x" * 10], [], [b"abc" * 3, b"abc" * 3]):
        assert dictbuilder.build_raw_dict(few) == jax_db.build_raw_dict(few)


def test_copy_ops_walk_equals_jax():
    data = b"".join(_samples("text", 8)) + b"".join(_samples("period3", 8))
    blk = s2.encode_better(data)
    from compress_tpu_torch.utils.varint import read_uvarint

    _n, pos = read_uvarint(blk)
    ops = list(dictbuilder._iter_copy_ops(blk[pos:]))
    assert ops == list(jax_db._iter_copy_ops(blk[pos:]))
    assert ops and all(off > 0 and ln >= 1 for _d, off, ln in ops)


# -- estimate ------------------------------------------------------------------


@pytest.mark.parametrize("kind", corpus.CLASSES)
def test_estimate_equals_jax(kind):
    block = corpus.corpus_blocks(len(corpus.CLASSES), 3)[
        corpus.CLASSES.index(kind)]
    for x in (block.tobytes(), block, block.tobytes()[:1000],
              np.tile(block, 3)):
        assert est.estimate(x) == jax_est.estimate(x)
        assert est.shannon_entropy_bits(x) == jax_est.shannon_entropy_bits(x)


def test_estimate_edges_and_exports():
    for x in (b"", b"a", b"0123456789abcde", b"0123456789abcdef",
              bytes(range(256)), b"\x00" * 100_000):
        assert est.estimate(x) == jax_est.estimate(x)
        assert est.shannon_entropy_bits(x) == jax_est.shannon_entropy_bits(x)
    assert compress_tpu_torch.estimate is est.estimate
    assert compress_tpu_torch.shannon_entropy_bits is est.shannon_entropy_bits
    assert set(compress_tpu_torch.__all__) == set(compress_tpu.__all__)


# -- debuglog ------------------------------------------------------------------


@pytest.fixture
def debug(monkeypatch):
    """Set COMPRESS_TPU_DEBUG for both packages; reset after."""

    def on(value):
        monkeypatch.setenv("COMPRESS_TPU_DEBUG", value)
        debuglog._reset_for_tests()
        jax_log._reset_for_tests()

    yield on
    monkeypatch.delenv("COMPRESS_TPU_DEBUG", raising=False)
    debuglog._reset_for_tests()
    jax_log._reset_for_tests()


@pytest.mark.parametrize("value", ("", "zstd", "zstd, engine", "all",
                                   "flate,device"))
def test_debuglog_convention_equals_jax(debug, capsys, value):
    debug(value)
    for tag in ("zstd", "engine", "device_dec", "flate", "s2"):
        assert debuglog.enabled(tag) == jax_log.enabled(tag)
        debuglog.dbg(tag, "n=%d s=%s", 3, "x")
        ours = capsys.readouterr().err
        jax_log.dbg(tag, "n=%d s=%s", 3, "x")
        assert ours == capsys.readouterr().err
        assert (ours == f"[ct:{tag}] n=3 s=x\n") == debuglog.enabled(tag)


def test_debuglog_host_zstd_lines_equal_jax(debug, capsys):
    data = corpus.corpus_blocks(2, 9).tobytes()
    debug("zstd")
    frame = Z.compress(data, level=2)
    ours = capsys.readouterr().err
    assert jax_zstd.compress(data, level=2) == frame
    assert capsys.readouterr().err == ours
    assert ours == f"[ct:zstd] compress n={len(data)} level=2 native -> " \
        f"{len(frame)} bytes\n"
    # the frame-by-frame native route: a flipped checksum makes the
    # whole-stream call refuse the input; the frame's blocks still decode
    # on the core (the line) before the checksum raises
    good = Z.compress(data, level=2, checksum=True)
    blob = good[:-1] + bytes([good[-1] ^ 1])
    capsys.readouterr()
    with pytest.raises(Z.ZstdError):
        Z.decompress(blob)
    ours = capsys.readouterr().err
    with pytest.raises(jax_zstd.ZstdError):
        jax_zstd.decompress(blob)
    assert capsys.readouterr().err == ours
    assert ours.startswith("[ct:zstd] decompress frame@") and ours.endswith(
        "native=True\n")
    debug("")
    Z.compress(data, level=1)
    assert capsys.readouterr().err == ""


def test_debuglog_device_and_engine_lines(debug, capsys, monkeypatch):
    """The multi-block decode's host route and the sharded encoder write
    their lines under the reference's tags."""
    from compress_tpu_torch.ops import execute as X
    from compress_tpu_torch.parallel import block_mesh, engine
    from compress_tpu_torch.zstd import accel, device_dec

    debug("device_dec,engine")
    stream = corpus.history_streams(1, 1 << 17, 4)[0]
    items = accel.split_stream_accel(Z.compress_accel(
        stream, level=1, multi_block=True))

    def refuse(*a, **k):
        raise ValueError("refused packing")

    monkeypatch.setattr(X, "pack_pieces_mb", refuse)
    assert b"".join(device_dec.decompress_frames_device(
        items, device="cpu")) == stream
    assert capsys.readouterr().err == (
        "[ct:device_dec] multi-block group fell back to host: "
        "refused packing\n")
    engine.zstd_encode_sharded(b"x" * 1000, block_mesh(device="cpu"),
                               job=4096, block=1024)
    assert capsys.readouterr().err == (
        "[ct:engine] zstd_encode_sharded n=1000 mesh=1 job=4096 "
        "block=1024\n")
