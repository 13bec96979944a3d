"""The port's FSE codec (``compress_tpu_torch/fse``, ``ops/entropy.py``
``fse_encode_blocks``, ``ops/entropy_dec.py`` ``fse_decode_chunks``)
against the JAX package on the CPU, bit for bit (tolerance 0: integers
and bytes).

- ``fse.compress`` / ``decompress`` equal JAX's byte for byte on every
  corpus class at table logs 9 and 11, with the RLE and incompressible
  contracts.
- ``fse_encode_blocks`` equals JAX's arrays (norm, total_bits, halves,
  n_halves, hist) and ``compress_batch`` its containers at L = 2, 4096 and
  16384, on the corpus classes and on high-entropy rows; the plain chain
  equals the JAX scan's items on hostile tables (the clips decide).
- ``make_accel`` gives JAX's checkpoints and logs; the plain chunk decode
  equals JAX ``fse_decode_chunks`` on prepared and hostile chunks (where
  the reference's float arithmetic holds); ``decompress_batch`` equals
  JAX's with and without ``accel``, log-11 and None entries included."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from compress_tpu import fse as jax_fse  # noqa: E402
from compress_tpu.ops import entropy as jax_e  # noqa: E402
from compress_tpu.ops import entropy_dec as jax_ed  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch import fse  # noqa: E402
from compress_tpu_torch.ops import entropy as E  # noqa: E402
from compress_tpu_torch.ops import entropy_dec as ED  # noqa: E402


def _outcome(fn):
    try:
        return fn()
    except (ValueError, AssertionError) as e:
        return type(e).__name__


@pytest.mark.parametrize("log", [9, 11])
@pytest.mark.parametrize("cls", corpus.CLASSES)
def test_host_codec_matches_jax(cls, log):
    rng = np.random.default_rng([corpus.CLASSES.index(cls), log])
    data = corpus.make_block(cls, rng)[:12000 + 1001 * log].tobytes()
    want = _outcome(lambda: jax_fse.compress(data, table_log=log))
    got = _outcome(lambda: fse.compress(data, table_log=log))
    assert got == want
    if isinstance(got, bytes):
        assert fse.decompress(got) == data
        assert jax_fse.decompress(got) == data


def test_rle_and_incompressible_contracts():
    rng = np.random.default_rng(5)
    cases = {b"": fse.IncompressibleError, b"a": fse.IncompressibleError,
             b"aaaa" * 100: fse.UseRLEError,
             bytes(range(256)): fse.IncompressibleError,
             rng.integers(0, 256, 5000, dtype=np.uint8).tobytes():
             fse.IncompressibleError}
    for data, err in cases.items():
        with pytest.raises(err):
            fse.compress(data)
        with pytest.raises(getattr(jax_fse, err.__name__)):
            jax_fse.compress(data)
    blob = fse.compress(corpus.make_block("text", rng)[:5000].tobytes())
    with pytest.raises(ValueError, match="limit"):
        fse.decompress(blob, max_size=100)


def _rows(L, seed):
    """Rows of L bytes: every corpus class, then two high-entropy rows
    (the skewed 201-symbol rows of the JAX package's bit-pack bound
    test)."""
    rng = np.random.default_rng(seed)
    rows = [np.resize(corpus.make_block(c, rng), L) for c in corpus.CLASSES]
    p = np.ones(201)
    p[0] = 220.0
    rows += list(rng.choice(201, size=(2, L), p=p / p.sum()))
    return np.stack(rows).astype(np.uint8)


@pytest.fixture(scope="module", params=[2, 4096, 16384],
                ids=["L2", "L4096", "L16384"])
def encoded(request):
    L = request.param
    arr = _rows(L, L)
    want = {k: np.asarray(v) for k, v in
            jax_e.fse_encode_blocks(jnp.asarray(arr)).items()}
    got = {k: v.numpy() for k, v in
           E.fse_encode_blocks(torch.from_numpy(arr)).items()}
    return arr, want, got


@pytest.mark.parametrize("key", ["norm", "total_bits", "halves", "n_halves",
                                 "hist"])
def test_encode_blocks_match_jax(key, encoded):
    _, want, got = encoded
    assert got[key].dtype == np.int32
    np.testing.assert_array_equal(got[key], want[key])


def test_compress_batch_matches_jax(encoded):
    arr = encoded[0]
    got = fse.compress_batch(arr, device="cpu")
    assert got == jax_fse.compress_batch(arr)
    for blob, row in zip(got, arr):
        if blob is not None:
            assert fse.decompress(blob) == row.tobytes()


def test_odd_row_length_is_refused():
    arr = np.zeros((2, 5), np.uint8)
    with pytest.raises(ValueError):
        E.fse_encode_blocks(torch.from_numpy(arr))
    with pytest.raises(AssertionError):
        jax_e.fse_encode_blocks(jnp.asarray(arr))


@pytest.mark.parametrize("log", [9, 11])
def test_tables_match_jax(log):
    """Surpluses and deficits (many symbols of count 1) alike."""
    rng = np.random.default_rng(log)
    hist = rng.integers(0, 50, (6, 256))
    hist[hist < 25] = 0
    hist[3] = 1
    hist[4, :200] = 1
    hist[4, 200] = 100000
    hist[5] = 0
    hist[5, 9] = 7
    hist[5, 10] = 1
    got = E._fse_tables_bytes(torch.from_numpy(hist).to(torch.int32), log)
    want = jax_e._fse_tables_bytes(jnp.asarray(hist, jnp.int32), log)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w).astype(
            np.int64))


@pytest.mark.parametrize("kind", corpus.FSE_ENC_CLASSES)
def test_chain_matches_jax_scan(kind, monkeypatch):
    """The plain chain against the JAX scan's raw items on the same
    tables: the JAX function under a jit of a new function (so that no
    trace is shared with another call) with its tables replaced and its
    bit-pack replaced by one that hands back the items."""
    blocks, st, dnb, dfs = corpus.fse_enc_inputs(kind)
    tabs = tuple(jnp.asarray(t) for t in (st, dnb, dfs))
    monkeypatch.setattr(jax_e, "_fse_tables_bytes",
                        lambda hist, log: (*tabs, hist))
    monkeypatch.setattr(jax_e, "_bitpack_rows",
                        lambda v, n, dest, to, **kw: (v, n))
    ref = jax.jit(lambda b: jax_e.fse_encode_blocks.__wrapped__(b))(
        jnp.asarray(blocks))
    got = E.fse_encode_chain_ref(*(torch.from_numpy(a) for a in
                                   (blocks, st, dnb, dfs)))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(ref["halves"]))
    np.testing.assert_array_equal(got[1].numpy(),
                                  np.asarray(ref["n_halves"]))


def _containers():
    """compress_batch containers (some None), host containers of log 11
    and an odd-length log-9 container, and a None entry."""
    arr = _rows(4096, 9)
    conts = fse.compress_batch(arr, device="cpu")
    rng = np.random.default_rng(3)
    text = corpus.make_block("text", rng)
    conts += [fse.compress(text[:9000].tobytes(), table_log=11),
              fse.compress(text[9000:13001].tobytes(), table_log=9), None,
              fse.compress(text[20000:30000].tobytes(), table_log=11)]
    return conts


@pytest.fixture(scope="module")
def containers():
    return _containers()


@pytest.mark.parametrize("k", [32, 16])
def test_make_accel_matches_jax(k, containers):
    got = fse.make_accel(containers, k=k)
    want = jax_fse.make_accel(containers, k=k)
    assert got["k"] == want["k"] == k
    np.testing.assert_array_equal(got["logs"], want["logs"])
    np.testing.assert_array_equal(got["ckpt"], want["ckpt"])


def _jax_planes(dtables):
    return np.stack([jax_ed.expand_fse_table(*d) for d in dtables])


def _decode_both(d):
    ins = [d[k] for k in ("windows", "lbit", "st1", "st2", "npair", "nore1",
                          "nore2")]
    got = ED.fse_decode_chunks(*(torch.from_numpy(a) for a in ins),
                               torch.from_numpy(d["tables"]))
    want = jax_ed.fse_decode_chunks(*(jnp.asarray(a) for a in ins),
                                    jnp.asarray(_jax_planes(d["dtables"])))
    return [g.numpy() for g in got], [np.asarray(w) for w in want]


def test_decode_chunks_match_jax_on_prepared_inputs(containers):
    accel = fse.make_accel(containers)
    for i, blob in enumerate(containers):
        if blob is None or accel["logs"][i] != 9:
            continue
        _, table, windows, *cur = fse._prep(blob, accel["ckpt"][i], 32,
                                            1 << 20)
        norm, tl, _ = fse.core.read_ncount(
            blob, fse.read_uvarint(blob)[1], 255)
        d = dict(zip(("lbit", "st1", "st2", "npair", "nore1", "nore2"),
                     (np.asarray(a, np.int32)[None] for a in cur)))
        d.update(windows=windows[None], tables=table[None],
                 dtables=[fse.core.build_dtable(norm, tl)])
        (syms, endl), (jsyms, jendl) = _decode_both(d)
        np.testing.assert_array_equal(syms, jsyms)
        np.testing.assert_array_equal(endl, jendl)


@pytest.mark.parametrize("kind", corpus.FSE_DEC_CLASSES)
def test_decode_chunks_match_jax_on_hostile_chunks(kind):
    """Chunk for chunk where the reference's float bit reads are exact:
    every cursor at or above -100 bits (its zero fill builds 2^(9 - lbp)
    from the float exponent field, exact down to about -118).  Chunks
    below that are compared with the plain version's own rule in
    ``test_decode_chunks_zero_fill_below_bit_0``."""
    d = corpus.fse_dec_inputs(kind)
    (syms, endl), (jsyms, jendl) = _decode_both(d)
    ok = endl >= -100
    assert ok.sum() >= ok.size // 3
    np.testing.assert_array_equal(syms[ok], jsyms[ok])
    np.testing.assert_array_equal(endl[ok], jendl[ok])


def test_decode_chunks_zero_fill_below_bit_0():
    """From cursor 0 every read is 0, so each state goes to its entry's
    new_state and the cursor drops by nb: a walk of the table alone."""
    d = corpus.fse_dec_inputs("cursor_edges")
    d["lbit"][:] = 0
    d["npair"][:] = 16
    ins = [torch.from_numpy(d[k]) for k in ("windows", "lbit", "st1", "st2",
                                            "npair", "nore1", "nore2")]
    syms, endl = ED.fse_decode_chunks(*ins, torch.from_numpy(d["tables"]))
    for r in range(2):
        for c in range(5):
            spread, nb, ns = d["dtables"][r]
            s1, s2, lbp, want = int(d["st1"][r, c]), int(d["st2"][r, c]), 0, []
            for _ in range(16):
                want += [spread[s1], spread[s2]]
                lbp -= int(nb[s1]) + int(nb[s2])
                s1, s2 = int(ns[s1]), int(ns[s2])
            assert syms[r, c].tolist() == want
            assert int(endl[r, c]) == lbp


def test_decompress_batch_matches_jax(containers):
    accel = fse.make_accel(containers)
    want = jax_fse.decompress_batch(containers, accel=jax_fse.make_accel(
        containers))
    fse.decompress_batch.host_containers = 0
    got = fse.decompress_batch(containers, accel=accel, device="cpu")
    assert got == want
    n_host = sum(c is not None and accel["logs"][i] != 9
                 for i, c in enumerate(containers))
    assert fse.decompress_batch.host_containers == n_host == 2
    host = fse.decompress_batch(containers, device="cpu")
    assert host == jax_fse.decompress_batch(containers)
    # the reference's device path drops the last symbol of an odd-length
    # container (npair = floor(count / 2)); the host path does not
    odd = containers[-3]
    assert got[-3] != host[-3] and got[-3][:-1] == host[-3][:-1]
    for g, h, c in zip(got, host, containers):
        if c is not None and c is not odd:
            assert g == h


def test_decompress_batch_all_host_or_none():
    conts = [None, fse.compress(corpus.make_block(
        "text", np.random.default_rng(1))[:4000].tobytes(), table_log=11)]
    accel = fse.make_accel(conts)
    assert fse.decompress_batch(conts, accel=accel, device="cpu") == \
        jax_fse.decompress_batch(conts, accel=jax_fse.make_accel(conts))


def test_no_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fse.compress_batch(np.zeros((1, 64), np.uint8))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        fse.decompress_batch([None])
