"""The byte-histogram entries (``compress_tpu_torch/utils/histogram.py``:
``byte_histograms``, which ``ops/entropy.py`` re-exports, and
``histogram256_torch``) against the JAX package on the CPU, bit for bit
(tolerance 0: integers).

- ``byte_histograms`` equals ``histogram256_jax`` row by row and the
  reference's one-hot einsums (``entropy.py:175-177``, ``zenc2.py:257``,
  ``zdev.py:619-620``) on every corpus class, all-zeros and all-255 rows,
  without a mask and with masks all false, all true, a prefix a row and
  random;
- the outputs that depend on the counts equal the JAX ones: the ``norm``
  of ``fse_encode_blocks``, the ``nbits`` of ``huff0_encode_blocks`` and
  of the v2 literal stage (``zenc2._literal_stage``);
- the four call sites (``huff0_encode_blocks``, ``fse_encode_blocks``, the
  v2 literal stage and the v1 engine's literals) call ``byte_histograms``
  once each with their mask, and give the outputs of the scatter-add they
  replaced;
- ``histogram256_torch`` equals ``histogram256_jax`` for uint8, int8,
  int16, int32 and int64 input with values outside 0..255, on empty input
  and at several segments; the entries refuse what they do not take.
"""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from compress_tpu.ops import entropy as jax_e  # noqa: E402
from compress_tpu.ops import zenc2 as jax_z2  # noqa: E402
from compress_tpu.utils import histogram as jax_hist  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch.ops import entropy as E  # noqa: E402
from compress_tpu_torch.ops import zdev, zenc2  # noqa: E402
from compress_tpu_torch.utils import histogram as H  # noqa: E402

MASKS = ["none", "false", "true", "prefix", "random"]


def _rows(N: int, L: int, seed: int) -> np.ndarray:
    """N rows of L bytes: the corpus classes, an all-zeros and an all-255
    row, then random bytes."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (N, L), dtype=np.uint8)
    for i, cls in enumerate(corpus.CLASSES[:N]):
        rows[i] = np.resize(corpus.make_block(cls, rng), L)
    k = len(corpus.CLASSES)
    if N > k:
        rows[k] = 0
    if N > k + 1:
        rows[k + 1] = 255
    return rows


def _mask(kind: str, N: int, L: int, seed: int):
    rng = np.random.default_rng(seed)
    if kind == "none":
        return None
    if kind == "prefix":
        cnt = rng.integers(0, L + 1, (N, 1))
        cnt[0] = L
        return np.arange(L)[None, :] < cnt
    return {"false": np.zeros((N, L), bool), "true": np.ones((N, L), bool),
            "random": rng.random((N, L)) < 0.5}[kind]


def _jax_onehot(rows: np.ndarray, mask) -> np.ndarray:
    """The reference's per-row count: a one-hot einsum in bf16 with f32
    accumulation (exact below 2^24 a bin)."""
    m = np.ones(rows.shape, bool) if mask is None else mask
    oh = jax.nn.one_hot(jnp.asarray(rows.astype(np.int32)), 256,
                        dtype=jnp.bfloat16)
    return np.asarray(jnp.einsum(
        "rb,rbs->rs", jnp.asarray(m).astype(jnp.bfloat16), oh,
        preferred_element_type=jnp.float32).astype(jnp.int32))


@pytest.mark.parametrize("kind", MASKS)
@pytest.mark.parametrize("N,L", [(1, 2), (11, 999), (12, 16384)])
def test_byte_histograms_match_jax(N, L, kind):
    rows = _rows(N, L, N + L)
    m = _mask(kind, N, L, L)
    got = H.byte_histograms(torch.from_numpy(rows),
                            None if m is None else torch.from_numpy(m))
    assert got.dtype == torch.int32 and got.shape == (N, 256)
    assert E.byte_histograms is H.byte_histograms
    np.testing.assert_array_equal(got.numpy(), _jax_onehot(rows, m))
    # histogram256_jax row by row, masked-out bytes as 256 (not counted)
    for r in range(min(N, 4)):
        v = rows[r].astype(np.int32)
        if m is not None:
            v = np.where(m[r], v, 256)
        np.testing.assert_array_equal(
            got[r].numpy(), np.asarray(jax_hist.histogram256_jax(
                jnp.asarray(v), 512)))


def test_byte_histograms_of_no_rows_and_empty_rows():
    assert H.byte_histograms(torch.zeros((0, 5), dtype=torch.uint8)).shape \
        == (0, 256)
    got = H.byte_histograms(torch.zeros((3, 0), dtype=torch.uint8))
    assert got.shape == (3, 256) and int(got.abs().sum()) == 0


def test_byte_histograms_refuse_what_they_do_not_take():
    t = torch.zeros((2, 8), dtype=torch.uint8)
    for bad in (t.to(torch.int32), t.view(-1)):
        with pytest.raises(ValueError):
            H.byte_histograms(bad)
    for m in (torch.ones((2, 7), dtype=torch.bool),
              torch.ones((2, 8), dtype=torch.uint8)):
        with pytest.raises(ValueError):
            H.byte_histograms(t, m)


def test_fse_norm_matches_jax():
    """The FSE table's normalized counts from ``byte_histograms`` equal the
    JAX ``fse_encode_blocks``' ``norm``."""
    rows = _rows(10, 4096, 1)
    norm = E._fse_tables_bytes(H.byte_histograms(torch.from_numpy(rows)),
                               E.FSE_LOG)[3]
    want = np.asarray(jax_e.fse_encode_blocks(jnp.asarray(rows))["norm"])
    np.testing.assert_array_equal(norm.numpy(), want)


@pytest.mark.parametrize("max_log", [8, 11])
def test_huff0_nbits_match_jax(max_log):
    """The Huffman code lengths from ``byte_histograms`` equal the JAX
    ``huff0_encode_blocks``' ``nbits``."""
    rows = _rows(10, 2048, 2)
    hist = H.byte_histograms(torch.from_numpy(rows)).to(torch.int64)
    nbits = zdev._huff_build(hist, maxlog=max_log)[0]
    want = np.asarray(jax_e.huff0_encode_blocks(
        jnp.asarray(rows), max_log=max_log)["nbits"])
    np.testing.assert_array_equal(nbits.numpy(), want)


def test_literal_stage_nbits_match_jax():
    """The v2 literal stage's tables (the first ``lit_cnt`` bytes of each
    row counted) equal the JAX ``_literal_stage``'s ``nbits``, with counts
    of 0, 1, the whole row and in between."""
    bs = 1024
    lits = _rows(10, bs, 3)
    lit_cnt = np.array([0, 1, bs, 700, 5, 1000, 513, bs, 64, 2], np.int32)
    got = zenc2._literal_tables(torch.from_numpy(lits),
                                torch.from_numpy(lit_cnt), bs)[1]
    want = jax_z2._literal_stage(jnp.asarray(lits), jnp.asarray(lit_cnt), bs,
                                 interpret=True)[0]
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _scatter(blocks, mask=None):
    """The scatter-add each call site held before the kernel."""
    b = blocks.to(torch.int64)
    hist = torch.zeros((blocks.shape[0], 256), dtype=torch.int64)
    hist.scatter_add_(1, b, torch.ones_like(b) if mask is None
                      else mask.to(torch.int64))
    return hist.to(torch.int32)


class _Spy:
    """Stands in for ``byte_histograms`` in a module: records the masks
    and returns the old scatter-add's counts."""

    def __init__(self):
        self.masks = []

    def __call__(self, blocks, mask=None):
        self.masks.append(mask)
        return _scatter(blocks, mask)


def _same(a, b):
    if isinstance(a, dict):
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    elif isinstance(a, (tuple, list)):
        for x, y in zip(a, b):
            _same(x, y)
    elif isinstance(a, torch.Tensor):
        assert torch.equal(a, b)
    else:
        assert a == b


def _routed(monkeypatch, module, fn):
    """fn()'s output with ``module.byte_histograms`` and with the old
    scatter-add in its place, and the masks it was called with."""
    got = fn()
    spy = _Spy()
    monkeypatch.setattr(module, "byte_histograms", spy)
    want = fn()
    monkeypatch.undo()
    _same(got, want)
    return spy.masks


def test_call_sites_route_through_byte_histograms(monkeypatch):
    """huff0 and FSE count every byte; the v2 literal stage counts the
    first ``lit_cnt`` bytes of a row; the v1 engine counts the bytes its
    parse left as literals.  Each calls ``byte_histograms`` once with that
    mask and gives the outputs of the scatter-add it replaced."""
    rows = torch.from_numpy(_rows(4, 2048, 4))
    assert _routed(monkeypatch, E, lambda: E.huff0_encode_blocks(rows)) \
        == [None]
    assert _routed(monkeypatch, E, lambda: E.fse_encode_blocks(rows)) \
        == [None]
    lit_cnt = torch.tensor([0, 7, 2048, 1500], dtype=torch.int32)
    masks = _routed(monkeypatch, zenc2,
                    lambda: zenc2._literal_stage(rows, lit_cnt, 2048))
    assert len(masks) == 1
    assert torch.equal(masks[0], torch.arange(2048)[None, :]
                       < lit_cnt[:, None].to(torch.int64))
    jobs = torch.from_numpy(corpus.corpus_blocks(2, 5).reshape(2, -1)[
        :, : 1 << 16].copy())
    masks = _routed(monkeypatch, zdev, lambda: zdev.zstd_encode_jobs(
        jobs, job=1 << 16, block=1 << 14))
    assert len(masks) == 1 and masks[0].dtype == torch.bool
    assert masks[0].shape == (8, 1 << 14)
    assert 0 < int(masks[0].sum()) < masks[0].numel()


DTYPES = [torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64]


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
def test_histogram256_torch_dtypes_match_jax(dtype):
    """Values outside 0..255 (negative, 256 and above) are not counted, as
    in the reference, at segments that do not divide the length."""
    info = torch.iinfo(dtype)
    rng = np.random.default_rng(info.bits - info.min)
    x = rng.integers(max(info.min, -700), min(info.max, 700) + 1, 5001)
    x[:1000] = 3
    t = torch.from_numpy(x).to(dtype)
    for segment in (1 << 14, 512, 7):
        got = H.histogram256_torch(t, segment)
        want = np.asarray(jax_hist.histogram256_jax(
            jnp.asarray(x.astype(np.int32)), segment))
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        H.histogram256_torch(t.view(5001, 1)[::2]).numpy(),
        np.asarray(jax_hist.histogram256_jax(jnp.asarray(
            x[::2].astype(np.int32)))))


def test_histogram256_torch_empty_and_2d():
    for x in (np.zeros(0, np.uint8), np.zeros((0, 4), np.int32),
              _rows(3, 100, 9)):
        got = H.histogram256_torch(torch.from_numpy(x))
        want = np.asarray(jax_hist.histogram256_jax(jnp.asarray(x)))
        np.testing.assert_array_equal(got.numpy(), want)
    assert int(H.histogram256_torch(torch.zeros(0, dtype=torch.uint8))
               .abs().sum()) == 0
