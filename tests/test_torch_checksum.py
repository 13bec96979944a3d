"""The port's batch checksums (``compress_tpu_torch/ops/checksum.py``), its
histogram (``utils/histogram.py``) and ``utils/crc.crc32c_masked`` against
the JAX package and the host oracles on the CPU, bit for bit (tolerance 0:
integers).

- ``crc32c_batch`` equals JAX's and the port's host ``crc32c`` at n =
  512, 513, 1000, 4096, 65536 and 100000, and on prefixes (``length``)
  of 0, 1 and lengths that cut a chunk;
- ``xxh64_batch`` equals JAX's and the host ``xxh64`` at N = 32, 64, 1024
  and 32768 with seeds 0, 12345 and 2^64 - 1, and both refuse N % 32 != 0
  and N < 32;
- ``histogram256_torch`` equals ``histogram256_jax``; ``crc32c_masked``
  equals JAX's."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from compress_tpu.ops import checksum as jax_ck  # noqa: E402
from compress_tpu.utils import crc as jax_crc  # noqa: E402
from compress_tpu.utils import histogram as jax_hist  # noqa: E402
from compress_tpu_torch.ops import checksum as ck  # noqa: E402
from compress_tpu_torch.utils import crc, histogram  # noqa: E402
from compress_tpu_torch.utils.xxhash64 import xxh64  # noqa: E402


def _rows(B, n, seed):
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (B, n), dtype=np.uint8)
    rows[1] = 0                      # a row of zeros
    rows[2, : n // 2] = 0xFF         # a run, then random bytes
    return rows


@pytest.mark.parametrize("n", [512, 513, 1000, 4096, 65536, 100000])
def test_crc32c_batch_matches_jax_and_host(n):
    rows = _rows(3, n, n)
    got = ck.crc32c_batch(torch.from_numpy(rows))
    assert got.dtype == torch.int64
    want = np.asarray(jax_ck.crc32c_batch(rows)).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got.tolist() == [crc.crc32c(r.tobytes()) for r in rows]


@pytest.mark.parametrize("length", [0, 1, 7, 255, 256, 257, 4097,
                                    65536 - 4097])
def test_crc32c_batch_prefix(length):
    rows = _rows(3, 65536, length)
    got = ck.crc32c_batch(torch.from_numpy(rows), length=length)
    assert got.tolist() == [crc.crc32c(r[:length].tobytes()) for r in rows]
    if length:
        want = np.asarray(jax_ck.crc32c_batch(rows, length=length))
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


def test_crc32c_batch_refuses_bad_input():
    rows = torch.zeros((2, 100), dtype=torch.uint8)
    for length in (-1, 101):
        with pytest.raises(ValueError):
            ck.crc32c_batch(rows, length=length)
    with pytest.raises(ValueError):
        ck.crc32c_batch(rows.to(torch.int32))


def test_crc_operators_match_jax_shift_matrix():
    """x^(8 n) mod P applied to a raw CRC is the reference's GF(2) shift
    matrix for n zero bytes."""
    rng = np.random.default_rng(1)
    for n in (0, 1, 3, 512, 1000, 65536):
        m = jax_crc._shift_matrix(n)
        for v in rng.integers(0, 1 << 32, 4).tolist():
            assert ck.mulmodp(ck.xpow8(n), v) == \
                jax_crc._gf2_matrix_times(m, v)


SEEDS = [0, 12345, (1 << 64) - 1]


@pytest.mark.parametrize("seed", SEEDS, ids=["0", "12345", "2^64-1"])
@pytest.mark.parametrize("N", [32, 64, 1024, 32768])
def test_xxh64_batch_matches_jax_and_host(N, seed):
    rows = _rows(3, N, N + 1)
    got = ck.xxh64_batch(torch.from_numpy(rows), seed=seed)
    assert got.shape == (3, 2) and got.dtype == torch.int64
    want = np.asarray(jax_ck.xxh64_batch(rows, seed=seed)).astype(np.int64)
    np.testing.assert_array_equal(got.numpy(), want)
    for r, (lo, hi) in zip(rows, got.tolist()):
        assert lo | hi << 32 == xxh64(r.tobytes(), seed)


@pytest.mark.parametrize("N", [0, 16, 33, 100])
def test_xxh64_batch_refuses_bad_length(N):
    rows = np.zeros((2, N), np.uint8)
    with pytest.raises(ValueError):
        ck.xxh64_batch(torch.from_numpy(rows))
    with pytest.raises(ValueError):
        jax_ck.xxh64_batch(rows)


@pytest.mark.parametrize("shape,segment", [((100,), 1 << 14),
                                           ((3, 70000), 1 << 14),
                                           ((5000,), 512), ((7, 9), 1)])
def test_histogram256_torch_matches_jax(shape, segment):
    rng = np.random.default_rng(len(shape) + segment)
    x = rng.integers(0, 256, shape, dtype=np.uint8)
    x.reshape(-1)[: x.size // 3] = 7
    got = histogram.histogram256_torch(torch.from_numpy(x), segment)
    want = np.asarray(jax_hist.histogram256_jax(jnp.asarray(x), segment))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(histogram.histogram256(x),
                                  jax_hist.histogram256(x))


def test_histogram256_torch_ignores_values_outside_a_byte():
    x = np.array([-5, 0, 255, 256, 1000, 3, 3], np.int32)
    got = histogram.histogram256_torch(torch.from_numpy(x))
    want = np.asarray(jax_hist.histogram256_jax(jnp.asarray(x)))
    np.testing.assert_array_equal(got.numpy(), want)
    with pytest.raises(ValueError):
        histogram.histogram256_torch(torch.from_numpy(x), 0)


def test_crc32c_masked_matches_jax():
    rng = np.random.default_rng(4)
    for n in (0, 1, 15, 16, 17, 1000, 65536):
        data = rng.integers(0, 256, n, dtype=np.uint8).tobytes()
        assert crc.crc32c_masked(data) == jax_crc.crc32c_masked(data)
