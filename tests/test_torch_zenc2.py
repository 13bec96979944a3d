"""PyTorch port of the device zstd encoder v2 (compress_tpu_torch/ops/
zenc2.py and the zdev helpers it uses) against the JAX package, Pallas in
interpret mode, tolerance 0 (integers throughout):

- the literal lookup ``_litlut``;
- the long-range channel ``_ldm_channel`` on an odd-period replica;
- ``_bitpack_rows``, rows without items included;
- ``_huff_build`` and ``_normalize_count`` on inputs with tied sort keys;
- all 18 arrays of ``zstd_encode_jobs_v2`` on two 128 KiB jobs (a
  replica job and a job of one all-zero and one random block);
- the port's exact ``floor_log2`` and where the reference's float form
  is one too high."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from compress_tpu.ops import common as jax_common  # noqa: E402
from compress_tpu.ops import zdev as jax_zdev  # noqa: E402
from compress_tpu.ops import zenc2 as jax_zenc2  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch.ops import common, zdev, zenc2  # noqa: E402
from compress_tpu_torch.zstd import device as port_device  # noqa: E402

BS = 1 << 16
JOB = 128 << 10
KEYS = ["n_seqs", "lit_cnt", "ll", "ml", "ofv", "nbits", "max_bits",
        "huff_ok", "stream_bits", "lit_halves", "lit_nh", "seq_halves",
        "seq_nh", "seq_total_bits", "fse_norm", "fse_log", "fse_rle",
        "fse_rle_sym"]


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def mixed_data(seed=0):
    """Two 128 KiB jobs: a replica job, then an all-zero and a random
    block."""
    rng = np.random.default_rng(seed)
    return np.concatenate([
        corpus.replica_jobs(1, JOB, seed),
        np.zeros(BS, np.uint8),
        rng.integers(0, 256, BS, dtype=np.uint8)]).tobytes()


@pytest.fixture(scope="module")
def launch():
    src = torch.frombuffer(bytearray(mixed_data(3)), dtype=torch.uint8)
    return port_device.launch_inputs(src, 0, 2, JOB)


@pytest.fixture(scope="module")
def encoded(launch):
    jobs, pre, hp = launch
    got = zenc2.zstd_encode_jobs_v2(jobs, job=JOB, prefixes=pre,
                                    has_prefix=hp)
    want = jax_zenc2.zstd_encode_jobs_v2(
        jnp.asarray(jobs.numpy()), job=JOB, prefixes=jnp.asarray(pre.numpy()),
        has_prefix=jnp.asarray(hp.numpy()), interpret=True)
    return ({k: _np(v) for k, v in got.items()},
            {k: np.asarray(v) for k, v in want.items()})


@pytest.mark.parametrize("key", KEYS)
def test_encode_jobs_v2_array_matches_jax(key, encoded):
    got, want = encoded
    assert sorted(got) == sorted(want) == sorted(KEYS)
    assert got[key].dtype == want[key].dtype, key
    assert got[key].shape == want[key].shape, key
    assert np.array_equal(got[key], want[key]), key


def test_encode_jobs_v2_covers_rle_raw_and_long_range(encoded):
    got, _ = encoded
    lc = got["lit_cnt"].reshape(-1)
    assert lc[2] <= 1                  # the all-zero block: one literal
    assert lc[3] == BS                 # the random block: literals only
    assert got["n_seqs"].reshape(-1)[1] > 0     # the replica half


def _odd_period_replica():
    rng = np.random.default_rng(9)
    text = corpus.make_block("text", rng)
    period = 5003
    full = np.resize(text[:period], 2 * JOB + JOB // 8)
    return full


def test_ldm_channel_matches_jax_on_odd_period_replica():
    pre = JOB // 8
    stream = _odd_period_replica()
    full = np.stack([np.concatenate([np.zeros(pre, np.uint8),
                                     stream[pre:pre + JOB]]),
                     stream[JOB:JOB + pre + JOB]])
    hp = np.array([False, True])
    got = zenc2._ldm_channel(torch.from_numpy(full), torch.from_numpy(hp),
                             pre, JOB)
    want = jax_zenc2._ldm_channel(jnp.asarray(full), jnp.asarray(hp), pre,
                                  JOB)
    for a, b in zip(got, want):
        assert a.dtype == torch.int32
        assert np.array_equal(_np(a), np.asarray(b))
    L = _np(got[1])
    off = _np(got[0])
    assert (L > 0).sum() > 1000
    assert set(np.unique(off[L > 0]) % 5003) == {0}


def test_litlut_matches_jax():
    rng = np.random.default_rng(11)
    lits = rng.integers(0, 256, (3, BS), dtype=np.uint8)
    tab = rng.integers(0, 1 << 20, (3, 2, 128), dtype=np.int32)
    got = zenc2._litlut(torch.from_numpy(lits), torch.from_numpy(tab))
    want = jax_zenc2._litlut(jnp.asarray(lits), jnp.asarray(tab),
                             interpret=True)
    for a, b in zip(got, want):
        assert np.array_equal(_np(a), np.asarray(b))


def _items(rng, R, I, max_bits, empty_rows):
    nb = rng.integers(0, max_bits + 1, (R, I)).astype(np.int32)
    nb[:, rng.random(I) < 0.2] = 0
    for r in empty_rows:
        nb[r] = 0
    vals = (rng.integers(0, 1 << 30, (R, I)) & ((1 << nb) - 1)).astype(
        np.int32)
    dest = (np.cumsum(nb, axis=1) - nb).astype(np.int32)
    return vals, nb, dest


@pytest.mark.parametrize("bytesplit", [False, True], ids=["f32", "bytes"])
@pytest.mark.parametrize("geom", [(256, 192, 11), (128, 208, 26)],
                         ids=["literals", "sequences"])
def test_bitpack_rows_matches_jax(geom, bytesplit):
    T, to, max_bits = geom
    rng = np.random.default_rng(T + to)
    vals, nb, dest = _items(rng, 4, 4 * T, max_bits, empty_rows=[1])
    total = nb.sum(axis=1)
    region_end = ((total + 16) >> 4).astype(np.int32)
    got = zdev._bitpack_rows(torch.from_numpy(vals), torch.from_numpy(nb),
                             torch.from_numpy(dest), to,
                             region_end=torch.from_numpy(region_end), T=T,
                             max_item_bits=max_bits)
    want = jax_zdev._bitpack_rows(jnp.asarray(vals), jnp.asarray(nb),
                                  jnp.asarray(dest), to,
                                  region_end=jnp.asarray(region_end), T=T,
                                  bytesplit=bytesplit,
                                  max_item_bits=max_bits)
    for a, b in zip(got, want):
        assert np.array_equal(_np(a), np.asarray(b))
    assert int(_np(got[1])[1]) == 0        # a row without items is empty


def test_bitpack_rows_without_items():
    vals = np.zeros((2, 512), np.int32)
    nb = np.zeros((2, 512), np.int32)
    end = np.array([0, 1], np.int32)
    got = zdev._bitpack_rows(torch.from_numpy(vals), torch.from_numpy(nb),
                             torch.from_numpy(nb), 384,
                             torch.from_numpy(end), 512)
    want = jax_zdev._bitpack_rows(jnp.asarray(vals), jnp.asarray(nb),
                                  jnp.asarray(nb), 384, jnp.asarray(end))
    for a, b in zip(got, want):
        assert np.array_equal(_np(a), np.asarray(b))
    assert not _np(got[1]).any()


def _tied_hists():
    rng = np.random.default_rng(13)
    h = rng.choice([0, 1, 2, 5, 5, 40], (6, 256)).astype(np.int32)
    h[1] = 0
    h[1, :3] = 7                                   # three equal symbols
    h[2] = 0
    h[2, 10] = 100                                 # one symbol
    h[3, :] = 3                                    # everything tied
    h[4] = 0                                       # empty
    return h


def test_huff_build_matches_jax_with_ties():
    h = _tied_hists()
    got = zdev._huff_build(torch.from_numpy(h))
    want = jax_zdev._huff_build(jnp.asarray(h))
    for a, b in zip(got, want):
        assert np.array_equal(_np(a), np.asarray(b))
    codes = zdev._canonical_codes_dev(got[0], got[1])
    jcodes = jax_zdev._canonical_codes_dev(want[0], want[1])
    assert np.array_equal(_np(codes), np.asarray(jcodes))


@pytest.mark.parametrize("log", [5, 7])
def test_normalize_count_matches_jax_with_ties(log):
    h = np.zeros((5, 64), np.int32)
    h[0, :20] = 3                         # equal remainders
    h[1, 0] = 10000
    h[1, 1:61] = 1                        # a deficit: steal from the top
    h[2, :7] = [5, 5, 9, 9, 1, 1, 1]
    h[3, 3] = 8                           # one symbol
    rng = np.random.default_rng(log)
    h[4] = rng.choice([0, 2, 2, 6], 64)
    got = zdev._normalize_count(torch.from_numpy(h), log)
    want = jax_zdev._normalize_count(jnp.asarray(h), log)
    assert np.array_equal(_np(got), np.asarray(want))
    fits = ((h > 0).sum(axis=1) <= 1 << log) & (h > 0).any(axis=1)
    assert (_np(got).sum(axis=1)[fits] == 1 << log).all()


# where the reference's float32 log2 form gives one more than floor(log2 v)
JAX_FLOOR_LOG2_HIGH = [2097150, 2097151, 4194302, 4194303]


def test_floor_log2_is_exact_below_2_pow_23():
    v = torch.arange(1, 1 << 23, dtype=torch.int32)
    want = np.repeat(np.arange(23), 1 << np.arange(23))[:v.numel()]
    assert np.array_equal(common.floor_log2(v).numpy(), want)


def test_reference_floor_log2_is_one_high_where_port_is_exact():
    v = np.array(JAX_FLOOR_LOG2_HIGH, np.int32)
    exact = np.array([int(x).bit_length() - 1 for x in v])
    jax_val = np.asarray(jax_common.floor_log2(jnp.asarray(v)))
    assert np.array_equal(jax_val, exact + 1)
    port = zdev._of_code(torch.from_numpy(v)).numpy()
    assert np.array_equal(port, exact)          # the format's offset code
    # the extra bits then stay non-negative: ofx = v - (1 << code)
    assert (v - (1 << port) >= 0).all()


def test_wrap32_and_mul32_match_int32_arithmetic():
    rng = np.random.default_rng(17)
    a = rng.integers(-(1 << 31), 1 << 31, 1000, dtype=np.int64)
    for c in (-1640531527, -2048144789, -1028477387, 3):
        want = (a.astype(np.int32) * np.int32(c)).astype(np.int64)
        got = common.wrap32(common.mul32(torch.from_numpy(a), c)).numpy()
        assert np.array_equal(got, want)
