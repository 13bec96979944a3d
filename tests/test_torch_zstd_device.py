"""PyTorch port of the device zstd frame encoder (compress_tpu_torch/zstd/
device.py) with ``engine="v2"`` (the card's default; the CPU's is v1, held
in tests/test_torch_zdev_v1.py) against the JAX package's
``compress_device`` with the v2 encoder in interpret mode (its frame assembly is its native one where that
library is built), byte for byte, on two 128 KiB jobs: a replica job (the
long-range channel) and a job of an all-zero block (an RLE block) and a
random block (a raw block); and on inputs that are not whole jobs: a
sub-job tail of one and of two host blocks after the device jobs, an input
shorter than one job and the empty input, which go through the host
encoder (the JAX package's native ladder patched out).  Every frame
decodes with ``zstandard``."""

import functools

import numpy as np
import pytest

jax = pytest.importorskip("jax")
zstandard = pytest.importorskip("zstandard")
import torch  # noqa: E402

from compress_tpu.ops import zenc2 as jax_zenc2  # noqa: E402
from compress_tpu.zstd import device as jax_device  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch.fse import core as port_fse  # noqa: E402
from compress_tpu_torch.huff0 import table as port_huff  # noqa: E402
from compress_tpu_torch.utils import xxhash64 as port_xxh  # noqa: E402
from compress_tpu_torch.zstd import device, frame  # noqa: E402

BS = 1 << 16
JOB = 128 << 10
CASES = [(False, 8), (True, 8), (False, 1)]
IDS = ["one_launch", "checksum", "launch_per_job"]


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(21)
    return np.concatenate([
        corpus.replica_jobs(1, JOB, 21),
        np.zeros(BS, np.uint8),
        rng.integers(0, 256, BS, dtype=np.uint8)]).tobytes()


def _jax_frame(data, checksum, max_launch_jobs):
    fn = functools.partial(jax_zenc2.zstd_encode_jobs_v2, interpret=True)
    return jax_device.compress_device(data, checksum=checksum, job=JOB,
                                      block=BS, encode_fn=fn,
                                      max_launch_jobs=max_launch_jobs)


@pytest.fixture(scope="module")
def frames(data):
    out = {}
    for checksum, mlj in CASES:
        port = device.compress_device(data, checksum=checksum, job=JOB,
                                      max_launch_jobs=mlj, device="cpu",
                                      engine="v2")
        out[(checksum, mlj)] = (port, _jax_frame(data, checksum, mlj))
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_frame_matches_jax(case, frames):
    port, ref = frames[case]
    assert port == ref


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_frame_decodes_with_zstandard(case, frames, data):
    port, _ = frames[case]
    out = zstandard.ZstdDecompressor().decompress(port,
                                                  max_output_size=len(data))
    assert out == data


def _blocks(fr: bytes):
    """(type, last, size) of every block after the frame header."""
    fhd = fr[4]
    pos = 4 + 1 + 1 + {0: 0, 1: 2, 2: 4, 3: 8}[fhd >> 6]
    out = []
    while True:
        bh = int.from_bytes(fr[pos:pos + 3], "little")
        typ, last, size = (bh >> 1) & 3, bh & 1, bh >> 3
        out.append((typ, last, size))
        pos += 3 + (1 if typ == 1 else size)
        if last:
            return out, pos


def test_frame_has_rle_raw_and_compressed_blocks(frames):
    port, _ = frames[(False, 8)]
    assert int.from_bytes(port[:4], "little") == frame.MAGIC
    blocks, end = _blocks(port)
    assert end == len(port)
    assert [b[0] for b in blocks] == [2, 2, 1, 0]
    assert [b[1] for b in blocks] == [0, 0, 0, 1]


def test_launch_grouping_changes_the_shared_tables(frames):
    """Each launch builds its own FSE tables: one launch per job gives
    another frame of the same data (both equal to the reference)."""
    assert frames[(False, 8)][0] != frames[(False, 1)][0]


def test_checksum_is_xxh64_low_word(frames, data):
    port, _ = frames[(True, 8)]
    assert port[-4:] == (port_xxh.xxh64(data) & 0xFFFFFFFF).to_bytes(
        4, "little")


def test_xxh64_matches_jax_package():
    from compress_tpu.utils.xxhash64 import xxh64 as jax_xxh64

    rng = np.random.default_rng(2)
    for n in (0, 3, 31, 32, 100, 1000):
        b = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert port_xxh.xxh64(b) == jax_xxh64(b)
        assert port_xxh.xxh64(b, 7) == jax_xxh64(b, 7)


def test_frame_header_matches_jax_package():
    from compress_tpu.zstd import frame as jax_frame

    for args in [(1 << 20, 1 << 20, False, False), (300, 1024, False, True),
                 (100, 100, True, False), (5 << 30, 9 << 20, False, True)]:
        assert frame.write_frame_header(*args) == \
            jax_frame.write_frame_header(*args)


def test_huff_table_and_ncount_match_jax_python_paths(monkeypatch):
    """The port's pure-Python copies equal the JAX package's pure-Python
    paths (its native twins switched off)."""
    from compress_tpu import huff0 as jax_huff0
    from compress_tpu.fse import core as jax_fse

    monkeypatch.setattr(jax_fse, "_native_entropy_lib", lambda: None)
    monkeypatch.setattr(jax_huff0, "_write_table_native", lambda *a: None)
    rng = np.random.default_rng(3)
    for _ in range(20):
        k = int(rng.integers(2, 256))
        nbits = np.zeros(256, np.int64)
        hist = rng.integers(1, 500, k)
        hist[rng.random(k) < 0.3] = 1
        nb, mb = jax_huff0.build_nbits(
            np.bincount(rng.choice(256, k, replace=False),
                        weights=hist, minlength=256).astype(np.int64), 11)
        nbits[:] = nb
        assert port_huff.write_table(nbits, mb) == \
            jax_huff0.write_table(nbits, mb)
    for log in (5, 6, 7):
        norm = np.array([10, 0, 0, 1, -1, 5] + [0] * 10, np.int64)
        norm[0] += (1 << log) - int(np.abs(norm).sum())
        assert port_fse.write_ncount(norm, log) == \
            jax_fse.write_ncount(norm, log)


_JAX_JOBS: dict = {}


def _memo_encode(jobs, **kw):
    """The JAX v2 encode of a launch, computed once per input (the tests
    below send the same jobs with and without a checksum)."""
    key = (np.asarray(jobs).tobytes(), np.asarray(kw["prefixes"]).tobytes(),
           kw["job"])
    if key not in _JAX_JOBS:
        _JAX_JOBS[key] = jax_zenc2.zstd_encode_jobs_v2(jobs, interpret=True,
                                                       **kw)
    return _JAX_JOBS[key]


@pytest.fixture(scope="module")
def tail_data():
    """Two replica jobs, then 200,705 bytes of corpus blocks (a tail of
    two host blocks, the second 69,633 bytes)."""
    return np.concatenate([corpus.replica_jobs(2, JOB, 23),
                           corpus.corpus_blocks(4, 23).reshape(-1)[
                               :3 * BS + 4097]]).tobytes()


TAILS = [(JOB + 1000, False), (JOB + 1000, True),
         (2 * JOB + 3 * BS + 4097, False), (2 * JOB + 3 * BS + 4097, True)]


@pytest.mark.parametrize("n,checksum", TAILS,
                         ids=["one_host_block", "one_host_block_checksum",
                              "two_host_blocks", "two_host_blocks_checksum"])
def test_sub_job_tail_matches_jax(n, checksum, tail_data):
    data = tail_data[:n]
    port = device.compress_device(data, checksum=checksum, job=JOB,
                                  device="cpu", engine="v2")
    ref = jax_device.compress_device(data, checksum=checksum, job=JOB,
                                     block=BS, encode_fn=_memo_encode)
    assert port == ref
    assert zstandard.ZstdDecompressor().decompress(
        port, max_output_size=n) == data
    blocks, _ = _blocks(port)
    n_tail = n - n // JOB * JOB
    assert len(blocks) == n // JOB * (JOB // BS) + -(-n_tail // (128 << 10))


SHORT = [(JOB // 2 + 7, JOB, False), (JOB // 2 + 7, JOB, True),
         (0, JOB, False), (0, JOB, True), (JOB, None, False)]


@pytest.mark.parametrize("n,job,checksum", SHORT,
                         ids=["half_job", "half_job_checksum", "empty",
                              "empty_checksum", "one_small_job_default"])
def test_input_shorter_than_a_job_matches_jax(n, job, checksum, tail_data,
                                              monkeypatch):
    """``n < job`` goes through the host encoder at level 1 (at the
    default 4 MiB job too), with the JAX package's native ladder off."""
    from compress_tpu.zstd import encoder as jax_enc

    monkeypatch.setattr(jax_enc, "_native_compress", lambda *a, **k: None)
    data = tail_data[:n]
    port = device.compress_device(data, checksum=checksum, job=job,
                                  device="cpu", engine="v2")
    ref = jax_device.compress_device(data, checksum=checksum,
                                     job=job or device.DEFAULT_JOB,
                                     block=BS, encode_fn=_memo_encode)
    assert port == ref
    assert zstandard.ZstdDecompressor().decompress(
        port, max_output_size=max(n, 1)) == data


@pytest.mark.parametrize("job,block", [(1000, None), (JOB, 4096),
                                       (-BS, None)])
def test_bad_job_or_block_raises_value_error(job, block, data):
    with pytest.raises(ValueError):
        device.compress_device(data, job=job, block=block, device="cpu",
                               engine="v2")


def test_no_device_raises_without_cuda(data, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.compress_device(data, job=JOB)


@pytest.mark.parametrize("engine", ["v1", "v2"])
def test_no_device_raises_without_cuda_either_engine(data, monkeypatch,
                                                     engine):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        device.compress_device(data, job=JOB, engine=engine)
