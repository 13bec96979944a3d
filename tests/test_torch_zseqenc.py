"""PyTorch port of the zstd sequence chains (compress_tpu_torch/ops/
zseqenc.py) against the JAX package's ``rep_scan`` and ``fse_chain`` in
interpret mode, on the sequences that the parse gives one block per corpus
class, on a launch whose offset stream is RLE (the doped tables: no
bits, state 0), and on the hostile chains of ``corpus.rep_inputs`` and
``corpus.fse_inputs`` (the card tests and the chain model use them too).
Tolerance 0: all outputs are integers."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from compress_tpu.ops import zdev as jax_zdev  # noqa: E402
from compress_tpu.ops import zenc2 as jax_zenc2  # noqa: E402
from compress_tpu.ops import zseqenc as jax_zseqenc  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch.ops import lzkern, zdev, zenc2, zparse  # noqa: E402
from compress_tpu_torch.ops import zseqenc  # noqa: E402

NAMES = list(corpus.CLASSES)


def _np(x):
    return np.asarray(x.numpy() if isinstance(x, torch.Tensor) else x)


@pytest.fixture(scope="module")
def seqs():
    """(ll, ml, of, n_seqs) of the parse, one block per class."""
    blocks = torch.from_numpy(corpus.corpus_blocks(len(NAMES), seed=43))
    off, L = lzkern.find_matches_blocks(blocks)
    ll, ml, of, _, n, _ = zparse.parse_blocks(blocks, off, L)
    return ll, ml, of, n


@pytest.fixture(scope="module")
def rep(seqs):
    ll, _, of, n = seqs
    want = jax_zseqenc.rep_scan(jnp.asarray(of.numpy()), jnp.asarray(
        ll.numpy()), jnp.asarray(n.numpy()), interpret=True)
    return zseqenc.rep_scan(of, ll, n).numpy(), np.asarray(want)


@pytest.mark.parametrize("name", NAMES)
def test_rep_scan_matches_jax(name, rep):
    got, want = rep
    i = NAMES.index(name)
    assert got.dtype == want.dtype
    assert np.array_equal(got[i], want[i])


@pytest.mark.parametrize("kind", corpus.REP_CLASSES)
def test_rep_scan_hostile_matches_jax(kind):
    """Offset alphabets with runs of ll = 0, n_seqs 0-4, MS and out of
    range, live offsets of 0, -5 and INT32_MIN, and offsets within 3 of
    INT32_MAX, where off + 3 wraps negative in int32 and the step moves no
    state, as the reference's int32 arithmetic has it."""
    of, ll, n = corpus.rep_inputs(kind)
    got = zseqenc.rep_scan(*(torch.from_numpy(a) for a in (of, ll, n)))
    want = jax_zseqenc.rep_scan(jnp.asarray(of), jnp.asarray(ll),
                                jnp.asarray(n), interpret=True)
    assert np.array_equal(got.numpy(), np.asarray(want))
    if kind == "serial_route":
        assert (got[4, 10:200:3] < 0).all() and (got[5, :40] < 0).all()


@pytest.mark.parametrize("kind", corpus.FSE_CLASSES)
def test_fse_chain_hostile_matches_jax(kind):
    """Random deltas and tables at n_seqs 0-4, MS, past MS and negative,
    a doped RLE stream, and tables that make every trajectory a
    permutation."""
    got, want = _both_chains([torch.from_numpy(a)
                              for a in corpus.fse_inputs(kind)])
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert np.array_equal(a, b)


def _chain_inputs(ll, ml, of_v2, n):
    """Packed deltas and tables from the port's codes stage."""
    pk_ll, pk_of, pk_ml, tables, *_ = zenc2._codes_stage(ll, ml, of_v2, n)
    return pk_ll, pk_of, pk_ml, n, tables


def _both_chains(args):
    got = zseqenc.fse_chain(*args)
    want = jax_zseqenc.fse_chain(*(jnp.asarray(_np(a)) for a in args),
                                 interpret=True)
    return [_np(x) for x in got], [np.asarray(x) for x in want]


@pytest.fixture(scope="module")
def chain(seqs, rep):
    ll, ml, _, n = seqs
    return _both_chains(_chain_inputs(ll, ml, torch.from_numpy(rep[0]), n))


@pytest.mark.parametrize("name", NAMES)
def test_fse_chain_matches_jax(name, chain):
    got, want = chain
    i = NAMES.index(name)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        assert np.array_equal(a[i], b[i])


@pytest.fixture(scope="module")
def rle_launch():
    """Two blocks, one with 300 sequences whose offset values are all 4
    (one offset code: an RLE stream), one with none."""
    rng = np.random.default_rng(5)
    ms = zparse.MAXSEQ
    ll = np.zeros((2, ms), np.int32)
    ml = np.zeros((2, ms), np.int32)
    of = np.zeros((2, ms), np.int32)
    ll[0, :300] = rng.integers(0, 40, 300)
    ml[0, :300] = rng.integers(3, 200, 300)
    of[0, :300] = 4
    n = np.array([300, 0], np.int32)
    return [torch.from_numpy(x) for x in (ll, ml, of, n)]


def test_codes_stage_dopes_rle_stream_like_jax(rle_launch):
    ll, ml, of, n = rle_launch
    got = zenc2._codes_stage(ll, ml, of, n)
    want = jax_zenc2._codes_stage(*(jnp.asarray(x.numpy()) for x in
                                    rle_launch))
    rle3 = _np(got[6])
    assert rle3.tolist() == [False, True, False]
    assert (_np(got[3])[1] == zseqenc.SIZE).all()        # doped of table
    for a, b in zip([*got[:4], *got[5:]], [*want[:4], *want[5:]]):
        assert np.array_equal(_np(a), np.asarray(b))
    for a, b in zip(got[4], want[4]):
        assert np.array_equal(_np(a), np.asarray(b))


def test_fse_chain_rle_stream_matches_jax(rle_launch):
    ll, ml, of, n = rle_launch
    args = _chain_inputs(ll, ml, of, n)
    got, want = _both_chains(args)
    for a, b in zip(got, want):
        assert np.array_equal(a, b)
    assert got[2][0, 1] == 0                 # the doped stream stays at 0
    assert not got[0][1].any() and not got[2][1].any()


def test_doped_tables_match_jax(rle_launch):
    ll, ml, of, n = rle_launch
    is_seq = torch.arange(zparse.MAXSEQ)[None, :] < n[:, None]
    codes = [zdev._ll_code(ll), zdev._of_code(of),
             zdev._ml_code(torch.clamp(ml, min=3))]
    codes = [torch.where(is_seq, c, 0) for c in codes]
    tabs = [zdev._fse_build(c, is_seq, 1, zseqenc.FSE_LOG) for c in codes]
    jtabs = [jax_zdev._fse_build(jnp.asarray(c.numpy()),
                                 jnp.asarray(is_seq.numpy()), 1,
                                 jax_zseqenc.FSE_LOG) for c in codes]
    for t, jt in zip(tabs, jtabs):
        for k in jt:
            assert np.array_equal(_np(t[k]), np.asarray(jt[k])), k
    for a, b in zip(zseqenc.doped_tables(tabs),
                    jax_zseqenc.doped_tables(jtabs)):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("dnb,dfs", [(-128, -128), (0, 0), (7 << 16, 127),
                                     (1 << 16, -5)])
def test_pack_deltas_matches_jax(dnb, dfs):
    pk = zseqenc.pack_deltas(dnb, dfs)
    assert pk == int(jax_zseqenc.pack_deltas(jnp.int32(dnb), jnp.int32(dfs)))
    assert ((pk >> 9) - 128, (pk & 511) - 128) == (dnb, dfs)


def test_chains_reject_bad_inputs(seqs):
    ll, ml, of, n = seqs
    with pytest.raises(ValueError):
        zseqenc.rep_scan(of, ll[:, :100], n)
    with pytest.raises(ValueError):
        zseqenc.fse_chain(of, of, of, n, torch.zeros((3, 64), dtype=torch.int32))
