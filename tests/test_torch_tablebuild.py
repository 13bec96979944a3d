"""The plain versions of the two per-row table builds against the JAX
package, tolerance 0 (integers):

- ``ops/zdev._huff_build_ref`` (and the canonical codes built on its
  lengths) against the JAX ``_huff_build`` / ``_canonical_codes_dev`` at
  maxlog 8 and 11 on every ``corpus.huff_build_hists`` class: an empty
  row, one symbol, two symbols, all 256 equal, one dominant symbol and
  255 singletons, Fibonacci counts, rows summing to 16 MiB, the counts
  of each ``corpus.py`` block class and random supports;
- ``ops/zdev._normalize_count_ref`` against the JAX ``_normalize_count``
  (NSYM 64) and the norm inside the JAX ``_fse_tables_bytes`` (NSYM 256)
  at logs 5-12 on every ``corpus.normalize_hists`` class (surplus,
  deficit, one-symbol, tied, empty and corpus rows);
- the FSE batch encoder's norm (``ops/entropy._fse_tables_bytes`` of its
  per-row byte counts, the table that ``fse_encode_blocks`` encodes with)
  against the norm inside the JAX ``_fse_tables_bytes`` on the same rows.

The same numpy-made inputs go to both.  On CPU tensors the port's
``_huff_build`` and ``_normalize_count`` are these plain versions;
``tests/test_torch_tablebuild_model.py`` holds the kernels' design
against them, and ``tests/test_torch_cuda.py`` the kernels on the card.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from compress_tpu.ops import entropy as jax_entropy  # noqa: E402
from compress_tpu.ops import zdev as jax_zdev  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch.ops import entropy, zdev  # noqa: E402

LOGS = [5, 6, 7, 8, 9, 10, 11, 12]
# one compile a log of the whole table build, not one an operation
_jax_fse_tables = jax.jit(jax_entropy._fse_tables_bytes, static_argnums=1)


def _huff_rows() -> np.ndarray:
    return np.concatenate([corpus.huff_build_hists(k)
                           for k in corpus.HUFF_BUILD_CLASSES])


def _norm_rows(nsym: int, log: int) -> np.ndarray:
    return np.concatenate([corpus.normalize_hists(k, nsym, log)
                           for k in corpus.NORMALIZE_CLASSES])


@pytest.mark.parametrize("maxlog", [8, 11])
def test_huff_build_ref_matches_jax(maxlog):
    h = _huff_rows()
    got = zdev._huff_build_ref(torch.from_numpy(h), maxlog)
    want = jax_zdev._huff_build(jnp.asarray(h), maxlog=maxlog)
    for a, b in zip(got, want):
        assert np.array_equal(a.numpy(), np.asarray(b))
    codes = zdev._canonical_codes_dev(got[0], got[1])
    jcodes = jax_zdev._canonical_codes_dev(want[0], want[1])
    assert np.array_equal(codes.numpy(), np.asarray(jcodes))
    # the classes reach what they are there for: rows with and without a
    # table, rows whose first lengths pass maxlog, a 16 MiB total
    assert got[2].any() and not got[2].all()
    assert (h.sum(axis=1) == 1 << 24).any()


@pytest.mark.parametrize("log", LOGS)
def test_normalize_count_ref_matches_jax_nsym64(log):
    h = _norm_rows(64, log)
    got = zdev._normalize_count_ref(torch.from_numpy(h), log)
    want = jax_zdev._normalize_count(jnp.asarray(h), log)
    assert np.array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("log", LOGS)
def test_normalize_count_ref_matches_jax_nsym256(log):
    h = _norm_rows(256, log)
    got = zdev._normalize_count_ref(torch.from_numpy(h), log)
    want = _jax_fse_tables(jnp.asarray(h), log)[3]
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_fse_batch_norm_matches_jax():
    rows = corpus.corpus_blocks(2, 9).reshape(-1, 1 << 14)
    got = entropy._fse_tables_bytes(entropy.byte_histograms(
        torch.from_numpy(rows)), entropy.FSE_LOG)[3]
    hist = np.stack([np.bincount(r, minlength=256) for r in rows])
    want = _jax_fse_tables(jnp.asarray(hist, jnp.int32), entropy.FSE_LOG)[3]
    assert np.array_equal(got.numpy(), np.asarray(want))
