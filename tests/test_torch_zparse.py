"""PyTorch port of the zstd parse + extract stage
(compress_tpu_torch/ops/zparse.py) against the JAX package's
``zparse.parse_blocks`` in interpret mode.

Inputs: one seeded block per corpus class with the JAX finder's (off, L),
plus two blocks with a synthetic (off, L) channel whose offsets straddle
1024 and 65536 and whose lengths straddle the gate's minimum (6, 7, 8),
so both gate steps decide; at the other caps 6, 8 and 16 (the chain
extension's cap is an argument of both), a text block, a period-7 block
and a synthetic channel whose runs carry L = cap.  Tolerance 0: every
output is an integer or a byte."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from compress_tpu.ops import lzkern as jax_lzkern  # noqa: E402
from compress_tpu.ops import zparse as jax_zparse  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch.ops import zparse  # noqa: E402

BS = 1 << 16
NAMES = list(corpus.CLASSES) + ["gate_offsets_a", "gate_offsets_b"]
FIELDS = ["ll", "ml", "of", "lits", "n_seqs", "lit_cnt"]


def _synthetic_channel(seed):
    """(off, L) with offsets around both gate steps and short lengths."""
    rng = np.random.default_rng(seed)
    offs = np.array([1, 3, 700, 1023, 1024, 1025, 4000, 65535, 65536,
                     65537, 200000], np.int32)
    lens = np.array([0, 4, 5, 6, 7, 8, 9, 10, 12, 24, 100, 700], np.int32)
    off = offs[rng.integers(0, len(offs), BS)]
    L = lens[rng.integers(0, len(lens), BS)]
    # runs of one offset so the chain extension and the merge see them
    for s in rng.integers(0, BS - 600, 40):
        off[s:s + 600] = offs[rng.integers(0, len(offs))]
        L[s:s + 600] = 10
    L[-3:] = 0
    return np.where(L > 0, off, 0).astype(np.int32), L


@pytest.fixture(scope="module")
def inputs():
    blocks = corpus.corpus_blocks(len(corpus.CLASSES), seed=41)
    off, L = jax_lzkern.find_matches_blocks(jnp.asarray(blocks),
                                            interpret=True)
    off, L = [np.asarray(off)], [np.asarray(L)]
    rng = np.random.default_rng(7)
    extra = rng.integers(0, 256, (2, BS), dtype=np.uint8)
    for i in range(2):
        o, l_ = _synthetic_channel(100 + i)
        off.append(o[None])
        L.append(l_[None])
    return (np.concatenate([blocks, extra]), np.concatenate(off),
            np.concatenate(L))


@pytest.fixture(scope="module")
def jax_out(inputs):
    blocks, off, L = inputs
    out = jax_zparse.parse_blocks(jnp.asarray(blocks), jnp.asarray(off),
                                  jnp.asarray(L), interpret=True)
    return [np.asarray(x) for x in out]


@pytest.fixture(scope="module")
def port_out(inputs):
    blocks, off, L = inputs
    out = zparse.parse_blocks(torch.from_numpy(blocks), torch.from_numpy(off),
                              torch.from_numpy(L))
    return [x.numpy() for x in out]


@pytest.mark.parametrize("name", NAMES)
def test_parse_matches_jax(name, jax_out, port_out):
    i = NAMES.index(name)
    for field, a, b in zip(FIELDS, port_out, jax_out):
        assert a.dtype == b.dtype, field
        assert np.array_equal(a[i], b[i]), (name, field)


def test_gate_decides_on_synthetic_blocks(inputs, port_out):
    """The synthetic channel reaches both gate steps: some ops at offsets
    >= 1024 and >= 65536 survive, with lengths at or above their minimum."""
    ml, of, n = port_out[1], port_out[2], port_out[4]
    for i in (8, 9):
        k = int(n[i])
        o, m = of[i, :k], ml[i, :k]
        far = (o >= 1024) & (o < 65536)
        farther = o >= 65536
        assert far.any() and farther.any()
        assert (m[far] >= 4).all() and (m[farther] >= 4).all()


def test_parse_shapes_and_padding(port_out):
    ll, ml, of, lits, n_seqs, lit_cnt = port_out
    assert ll.shape == (len(NAMES), zparse.MAXSEQ) and lits.shape[1] == BS
    for i in range(len(NAMES)):
        assert not ll[i, n_seqs[i]:].any() and not ml[i, n_seqs[i]:].any()
        assert not of[i, n_seqs[i]:].any() and not lits[i, lit_cnt[i]:].any()
        # the parse covers the block: matched bytes + literals
        assert int(ml[i].sum()) + int(lit_cnt[i]) == BS
        assert int(ll[i].sum()) <= int(lit_cnt[i])


@pytest.mark.parametrize("cap", [6, 8, 16])
def test_parse_matches_jax_at_other_caps(cap, inputs):
    pick = [NAMES.index(k) for k in ("text", "period7", "gate_offsets_a")]
    blocks, off, L = (a[pick].copy() for a in inputs)
    L[2] = np.where(L[2] == 10, cap, L[2])      # chains at this cap
    want = jax_zparse.parse_blocks(jnp.asarray(blocks), jnp.asarray(off),
                                   jnp.asarray(L), interpret=True, cap=cap)
    got = zparse.parse_blocks(*(torch.from_numpy(a) for a in (blocks, off,
                                                              L)), cap=cap)
    for field, a, b in zip(FIELDS, got, want):
        assert np.array_equal(a.numpy(), np.asarray(b)), (cap, field)
    # the chain extension changed the parse at this cap
    base = zparse.parse_blocks_ref(*(torch.from_numpy(a) for a in (
        blocks, off, L)), cap=cap + 1)
    assert not torch.equal(got[1][2], base[1][2])


def test_parse_rejects_cap_0(inputs):
    blocks, off, L = (torch.from_numpy(x[:1]) for x in inputs)
    for fn in (zparse.parse_blocks, zparse.parse_blocks_ref):
        with pytest.raises(ValueError, match="cap"):
            fn(blocks, off, L, cap=0)


def test_parse_rejects_bad_inputs(inputs):
    blocks, off, L = (torch.from_numpy(x) for x in inputs)
    with pytest.raises(ValueError):
        zparse.parse_blocks(blocks[:, :1000], off, L)
    with pytest.raises(ValueError):
        zparse.parse_blocks(blocks, off[:1], L)
