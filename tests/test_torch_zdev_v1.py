"""PyTorch port of the zstd v1 engine (compress_tpu_torch/ops/zdev.py
``zstd_encode_jobs``, and ``zstd/device.compress_device`` with its
``engine``) against the JAX package on the CPU, with tolerance 0.

- The repeat-offset scan that v1 calls (``zseqenc.rep_scan_ref``) equals
  the JAX ``zdev._rep_offsets`` at v1's sequence slots (2,731 for 16 KiB
  blocks, 1,366 for 8 KiB), with live offsets near INT32_MAX.
- ``_fse_scan`` over per-job tables of logs 9/8/9 equals the JAX
  ``_fse_scan`` (RLE streams, n_seqs of 0, 1 and MS, several jobs), and
  the tables equal the JAX ``_fse_build``'s.
- The whole ``zstd_encode_jobs`` dict, ``debug`` keys included, equals the
  JAX one at job 32 KiB / block 8 KiB and at job 64 KiB / block 16 KiB
  (MS = 2,731), levels 1-3, with and without prefixes.
- ``compress_device`` on the CPU (``engine="auto"``, which is v1 there)
  equals the JAX ``compress_device(engine="v1")`` byte for byte (the JAX
  native ladder patched out for inputs shorter than a job), and the frame
  decodes with ``zstandard`` and the port's host decoder."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
zstandard = pytest.importorskip("zstandard")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from compress_tpu.ops import common as jax_common  # noqa: E402
from compress_tpu.ops import zdev as J  # noqa: E402
from compress_tpu.zstd import device as jax_device  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch import zstd as port_zstd  # noqa: E402
from compress_tpu_torch.ops import zdev, zseqenc  # noqa: E402
from compress_tpu_torch.zstd import device  # noqa: E402


def _same(got, want, what=""):
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.shape == w.shape, what
    assert np.array_equal(g.astype(np.int64), w.astype(np.int64)), what


def test_constants_match_jax():
    assert (zdev.JOB, zdev.BLOCK, zdev.TILE, zdev.MINMATCH, zdev.LIT_TO,
            zdev.SEQ_TO, zdev.FSE_LOGS) == (J.JOB, J.BLOCK, J.TILE,
                                            J.MINMATCH, J.LIT_TO, J.SEQ_TO,
                                            J.FSE_LOGS)
    for block in (8192, 16384):
        assert zdev._maxseq(block) == J._maxseq(block)


@pytest.mark.parametrize("ms", [2731, 1366])
def test_rep_scan_equals_jax_rep_offsets(ms):
    of, ll, n = corpus.v1_rep_inputs(ms, 1)
    is_seq = np.arange(ms)[None, :] < n[:, None]
    want = J._rep_offsets(jnp.asarray(of), jnp.asarray(ll),
                          jnp.asarray(is_seq))
    got = zseqenc.rep_scan_ref(*(torch.from_numpy(a) for a in (of, ll, n)))
    _same(got, want)
    assert (np.asarray(want)[5, 3:int(n[5])] < 0).any()   # off + 3 wrapped


def _scan_inputs(seed, nj=2, nblk=4, ms=2731, n_seqs=None, rle=()):
    """Skewed random codes and both packages' per-job tables."""
    rng = np.random.default_rng(seed)
    R = nj * nblk
    n = (rng.integers(0, ms + 1, R) if n_seqs is None
         else np.resize(np.asarray(n_seqs), R)).astype(np.int32)
    is_seq = np.arange(ms)[None, :] < n[:, None]
    codes = []
    for hi in (36, 21, 53):
        c = np.minimum(rng.geometric(rng.uniform(0.05, 0.5), (R, ms)) - 1,
                       hi - 1)
        for j, k in rle:                     # one symbol in that stream
            if hi == (36, 21, 53)[k]:
                c[j * nblk:(j + 1) * nblk] = 3
        codes.append(np.where(is_seq, c, 0).astype(np.int32))
    return codes, n, is_seq


SCAN_CASES = {"random": dict(), "n_0_1_ms": dict(n_seqs=[0, 1, 2731, 2]),
              "rle_streams": dict(rle=[(0, 1), (1, 0), (1, 2)])}


@pytest.mark.parametrize("case", list(SCAN_CASES))
def test_fse_scan_matches_jax(case):
    codes, n, is_seq = _scan_inputs(list(SCAN_CASES).index(case),
                                    **SCAN_CASES[case])
    nj, nblk = 2, 4
    jtabs = [J._fse_build(jnp.asarray(c), jnp.asarray(is_seq), nj, lg)
             for c, lg in zip(codes, J.FSE_LOGS)]
    ptabs = [zdev._fse_build(torch.from_numpy(c), torch.from_numpy(is_seq),
                             nj, lg) for c, lg in zip(codes, zdev.FSE_LOGS)]
    for jt, pt in zip(jtabs, ptabs):
        for k in jt:
            _same(pt[k], jt[k], k)
    want = J._fse_scan(*(jnp.asarray(c) for c in codes), jnp.asarray(n),
                       jtabs, nblk)
    got = zdev._fse_scan(*(torch.from_numpy(c) for c in codes),
                         torch.from_numpy(n), ptabs)
    for g, w, what in zip(got, want, ("val", "nb", "fin", "logs")):
        _same(g, w, what)
    if case == "rle_streams":
        assert bool(ptabs[1]["rle"][0]) and bool(ptabs[0]["rle"][1])


def test_of_code_exact_past_jax_float_floor():
    """The port's _of_code is exact at 2^21 - 2 and 2^21 - 1, where the
    reference's float floor_log2 gives 21; the two agree up to and past
    v1's largest offset value (job + prefix + 3 = 1,179,651)."""
    v = np.array([1, 2, 3, 1023, 1024, 1_179_651, 1 << 20, 2_097_149,
                  2_097_150, 2_097_151, 2_097_152], np.int32)
    got = zdev._of_code(torch.from_numpy(v)).numpy()
    assert got.tolist() == [int(x).bit_length() - 1 for x in v]
    ref = np.asarray(J._of_code(jnp.asarray(v)))
    assert np.array_equal(got[:8], ref[:8])
    assert ref[8:10].tolist() == [21, 21]      # the reference's float floor


def _jobs(job: int, nj: int = 2, seed: int = 12) -> np.ndarray:
    """nj jobs of job bytes: job / 4 bytes of four corpus classes each."""
    cb = corpus.corpus_blocks(4 * nj, seed)
    return np.ascontiguousarray(cb[:, :job // 4].reshape(nj, job))


GEOMS = [(32 << 10, 8 << 10), (64 << 10, 16 << 10)]
DICT_CASES = [(g, lv, pre) for g in GEOMS for lv in (1, 2, 3)
              for pre in (False, True)]
DICT_IDS = [f"job{g[0] >> 10}k-level{lv}-{'prefix' if pre else 'noprefix'}"
            for g, lv, pre in DICT_CASES]


@pytest.mark.parametrize("case", DICT_CASES, ids=DICT_IDS)
def test_zstd_encode_jobs_matches_jax(case):
    (job, block), level, with_prefix = case
    jobs = _jobs(job)
    kw, pkw = {}, {}
    if with_prefix:
        pre = np.zeros((2, job // 8), np.uint8)
        pre[1] = jobs[0, -job // 8:]
        hp = np.array([False, True])
        kw = dict(prefixes=jnp.asarray(pre), has_prefix=jnp.asarray(hp))
        pkw = dict(prefixes=torch.from_numpy(pre),
                   has_prefix=torch.from_numpy(hp))
    want = J.zstd_encode_jobs(jnp.asarray(jobs), job=job, block=block,
                              debug=True, level=level, **kw)
    got = zdev.zstd_encode_jobs(torch.from_numpy(jobs), job=job, block=block,
                                debug=True, level=level, **pkw)
    assert set(got) == set(want)
    for k in want:
        _same(got[k], want[k], k)
    assert int(got["n_seqs"].sum()) > 0


_JAX_JOBS: dict = {}


def _memo_v1(jobs, **kw):
    """The JAX v1 encode of a launch, computed once per input."""
    key = (np.asarray(jobs).tobytes(), np.asarray(kw["prefixes"]).tobytes(),
           kw["job"], kw["block"], kw["level"])
    if key not in _JAX_JOBS:
        _JAX_JOBS[key] = J.zstd_encode_jobs(jobs, **kw)
    return _JAX_JOBS[key]


@pytest.fixture(scope="module")
def frame_data():
    """Three jobs of 32 KiB and a sub-job tail of 5,000 bytes."""
    job = 32 << 10
    return np.concatenate([_jobs(job, 3, 21).reshape(-1),
                           corpus.corpus_blocks(1, 22)[0, :5000]]).tobytes()


FRAME_CASES = [(2, False, 8), (1, True, 8), (3, False, 1)]
FRAME_IDS = ["level2", "level1-checksum", "level3-launch-per-job"]


@pytest.mark.parametrize("case", FRAME_CASES, ids=FRAME_IDS)
def test_compress_device_auto_on_cpu_matches_jax_v1(case, frame_data,
                                                    monkeypatch):
    from compress_tpu.zstd import encoder as jax_enc

    monkeypatch.setattr(jax_enc, "_native_compress", lambda *a, **k: None)
    level, checksum, mlj = case
    job, block = 32 << 10, 8 << 10
    port = device.compress_device(frame_data, job=job, block=block,
                                  level=level, checksum=checksum,
                                  max_launch_jobs=mlj, device="cpu")
    ref = jax_device.compress_device(frame_data, job=job, block=block,
                                     level=level, checksum=checksum,
                                     max_launch_jobs=mlj, engine="v1",
                                     encode_fn=_memo_v1)
    assert port == ref
    assert zstandard.ZstdDecompressor().decompress(
        port, max_output_size=len(frame_data)) == frame_data
    assert port_zstd.decompress(port) == frame_data


def test_compress_device_sizes_monotone_in_level(frame_data):
    job, block = 32 << 10, 8 << 10
    sizes = [len(device.compress_device(frame_data, job=job, block=block,
                                        level=lv, device="cpu"))
             for lv in (1, 2, 3)]
    assert sizes[2] <= sizes[1] <= sizes[0]


def test_auto_on_cpu_is_v1_at_its_defaults(monkeypatch):
    """engine="auto" on the CPU calls v1 with 1 MiB jobs, 16 KiB blocks,
    a job // 8 prefix and the caller's level."""
    seen = {}

    def spy(jobs, **kw):
        seen.update(kw, shape=tuple(jobs.shape), device=jobs.device.type)
        raise RuntimeError("stop")

    monkeypatch.setattr(zdev, "zstd_encode_jobs", spy)
    with pytest.raises(RuntimeError, match="stop"):
        device.compress_device(bytes(zdev.JOB + 9), level=3, device="cpu")
    assert seen["shape"] == (1, zdev.JOB) and seen["device"] == "cpu"
    assert (seen["job"], seen["block"], seen["level"]) == (zdev.JOB,
                                                           zdev.BLOCK, 3)
    assert tuple(seen["prefixes"].shape) == (1, zdev.JOB // 8)


def test_short_input_at_v1_default_job_matches_jax(monkeypatch):
    """Below v1's 1 MiB default job both go to the host encoder."""
    from compress_tpu.zstd import encoder as jax_enc

    monkeypatch.setattr(jax_enc, "_native_compress", lambda *a, **k: None)
    data = corpus.corpus_blocks(2, 3).reshape(-1)[:100_003].tobytes()
    port = device.compress_device(data, device="cpu")
    assert port == jax_device.compress_device(data, engine="v1")
    assert port_zstd.decompress(port) == data


def test_engine_argument_checks(frame_data):
    with pytest.raises(ValueError):
        device.compress_device(frame_data, engine="v3", device="cpu")
    with pytest.raises(ValueError):       # v2 takes only 64 KiB blocks
        device.compress_device(frame_data, job=1 << 17, block=1 << 14,
                               engine="v2", device="cpu")
    with pytest.raises(ValueError):       # v1: job a multiple of block
        device.compress_device(frame_data, job=1000, block=512,
                               device="cpu")


def test_jax_floor_log2_is_the_reference_quirk():
    """What the comment in the port's _of_code states about the
    reference's floor_log2."""
    v = jnp.asarray([2_097_149, 2_097_150], jnp.int32)
    assert np.asarray(jax_common.floor_log2(v)).tolist() == [20, 21]
