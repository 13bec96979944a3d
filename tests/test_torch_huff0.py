"""The port's huff0 4X batch codec (``compress_tpu_torch/ops/entropy.py``,
``ops/entropy_dec.py``, ``ops/entropy_kern.py``, ``huff0/``) against the
JAX package on the CPU, bit for bit (tolerance 0: integers and bytes).

- ``huff0_encode_blocks`` equals the JAX one array for array (shared
  table or not, max_log 8, 9 and 11, rows of 4 KiB and 16 KiB), and
  ``compress_4x_batch`` gives byte-equal containers and checkpoints.
- Both plain chunk decoders equal JAX ``huff0_decode_chunks`` (XLA) and
  ``huff0_decode_chunks_shared(interpret=True)`` on the same windows,
  including pad chunks and chunks whose peek reaches the window's top.
- ``decompress_4x_batch`` returns the input with both engines; foreign
  containers decode through ``make_accel``; a corrupted container raises
  ``CorruptError``; a single-symbol batch gives None."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from compress_tpu import huff0 as jax_h  # noqa: E402
from compress_tpu.ops import entropy as jax_e  # noqa: E402
from compress_tpu.ops import entropy_dec as jax_ed  # noqa: E402
from compress_tpu.ops import entropy_pallas as jax_ep  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch import huff0 as H  # noqa: E402
from compress_tpu_torch.huff0 import batch as HB  # noqa: E402
from compress_tpu_torch.huff0 import table as HT  # noqa: E402
from compress_tpu_torch.ops import entropy as E  # noqa: E402
from compress_tpu_torch.ops import entropy_dec as ED  # noqa: E402
from compress_tpu_torch.ops import entropy_kern as EK  # noqa: E402


def _rows(L, seed, shared=False):
    """8 compressible rows of L bytes cut from seeded corpus blocks: text
    only for a shared table (as the reference's shared-table bench),
    else text, rand4, period3 and skewed bytes."""
    rng = np.random.default_rng(seed)
    text = np.concatenate([corpus.make_block("text", rng) for _ in range(2)])
    if shared:
        return text[:8 * L].reshape(8, L)
    skew = rng.choice(8, 1 << 16, p=[.6, .2, .1, .04, .03, .02, .005, .005])
    parts = [text[i * L:(i + 1) * L] for i in range(4)]
    parts += [corpus.make_block("rand4", rng)[:L],
              corpus.make_block("period3", rng)[:L],
              skew[:L].astype(np.uint8), skew[L:2 * L].astype(np.uint8)]
    return np.stack(parts)


CONFIGS = [(True, 8, 16384), (True, 9, 4096), (True, 11, 4096),
           (False, 11, 16384), (False, 8, 4096), (False, 9, 16384)]
IDS = [f"{'shared' if s else 'own'}-log{m}-{L // 1024}k" for s, m, L in CONFIGS]


@pytest.fixture(scope="module", params=CONFIGS, ids=IDS)
def encoded(request):
    shared, max_log, L = request.param
    arr = _rows(L, seed=max_log, shared=shared)
    jc, ja = jax_h.compress_4x_batch(arr, return_accel=True,
                                     shared_table=shared, max_log=max_log)
    pc, pa = H.compress_4x_batch(arr, return_accel=True, shared_table=shared,
                                 max_log=max_log, device="cpu")
    return dict(shared=shared, max_log=max_log, arr=arr, jax=(jc, ja),
                port=(pc, pa))


def test_encode_arrays_match_jax(encoded):
    arr = encoded["arr"]
    kw = dict(shared_table=encoded["shared"], max_log=encoded["max_log"])
    want = jax_e.huff0_encode_blocks(jnp.asarray(arr), **kw)
    got = E.huff0_encode_blocks(torch.from_numpy(arr), **kw)
    assert sorted(got) == sorted(want)
    for key, w in want.items():
        w = np.asarray(w)
        g = got[key].numpy()
        assert g.shape == w.shape and g.dtype == w.dtype, key
        assert np.array_equal(g, w), key


def test_containers_match_jax(encoded):
    (jc, ja), (pc, pa) = encoded["jax"], encoded["port"]
    assert pc == jc
    assert sum(c is not None for c in pc) >= 6
    assert np.array_equal(pa["ckpt"], ja["ckpt"])
    assert (pa["k"], pa["shared"]) == (ja["k"], ja["shared"]) == (
        E.HUFF_CKPT_K, encoded["shared"])


def _with_edge_chunks(args):
    """Append chunks of a pad row (lbit 8 * WIN, nsym 0) and chunks whose
    cursor sits at the window's top (lbit 409-416) over random windows."""
    windows, lbit, nsym, tables = (a.numpy() for a in args)
    N, C, W = windows.shape
    rng = np.random.default_rng(3)
    extra_w = rng.integers(0, 256, (N, 16, W)).astype(np.uint8)
    extra_l = np.concatenate([np.full((N, 8), 8 * W),
                              rng.integers(409, 417, (N, 8))],
                             axis=1).astype(np.int32)
    extra_n = np.concatenate([np.zeros((N, 8)),
                              rng.integers(1, 33, (N, 8))],
                             axis=1).astype(np.int32)
    return (np.concatenate([windows, extra_w], 1),
            np.concatenate([lbit, extra_l], 1),
            np.concatenate([nsym, extra_n], 1), tables)


def _jax_tables(tables):
    """The port's (N, 2048) int32 sym | nb << 8 tables in the reference's
    (N, 64, 32) float32 sym * 16 + nb layout."""
    return ((tables & 255) * 16 + (tables >> 8)).astype(
        np.float32).reshape(-1, 64, 32)


def test_table_chunk_decoder_matches_xla(encoded):
    pc, pa = encoded["port"]
    args, _, _ = HB._prep_decode_batch(pc, pa)
    jargs, _, _ = jax_h._prep_decode_batch(pc, pa)
    for a, b in zip(args[:3], jargs[:3]):
        assert np.array_equal(a.numpy(), np.asarray(b))
    assert args[3].dtype == torch.int32
    assert np.array_equal(_jax_tables(args[3].numpy()), np.asarray(jargs[3]))
    full = _with_edge_chunks(args)
    syms, endl = ED.huff0_decode_chunks(*(torch.from_numpy(a) for a in full),
                                        k=E.HUFF_CKPT_K)
    want_s, want_e = jax_ed.huff0_decode_chunks(
        *map(jnp.asarray, full[:3] + (_jax_tables(full[3]),)),
        k=E.HUFF_CKPT_K)
    assert np.array_equal(syms.numpy().astype(np.int32), np.asarray(want_s))
    assert np.array_equal(endl.numpy(), np.asarray(want_e))


def test_shared_chunk_decoder_matches_pallas(encoded):
    """On a batch with one table per container, the first container alone
    is a shared-table batch."""
    pc, pa = encoded["port"]
    if not encoded["shared"]:
        i = next(i for i, c in enumerate(pc) if c is not None)
        pc, pa = [pc[i]], {**pa, "ckpt": pa["ckpt"][i:i + 1]}
    args, metas, _ = HB._prep_decode_batch(pc, pa)
    packed, mb = H.shared_packed_table(metas)
    assert mb <= encoded["max_log"]
    windows, lbit, nsym, _ = _with_edge_chunks(args)
    N, C, W = windows.shape
    flat = (windows.reshape(N * C, W), lbit.reshape(-1), nsym.reshape(-1))
    syms, endl = EK.huff0_decode_chunks_shared(
        *(torch.from_numpy(a) for a in flat), torch.from_numpy(packed),
        k=E.HUFF_CKPT_K, max_bits=mb)
    want_s, want_e = jax_ep.huff0_decode_chunks_shared(
        *map(jnp.asarray, flat), jnp.asarray(packed), k=E.HUFF_CKPT_K,
        max_bits=mb, interpret=True)
    assert np.array_equal(syms.numpy(), np.asarray(want_s))
    assert np.array_equal(endl.numpy(), np.asarray(want_e))
    # the per-container decoder agrees on the same chunks
    per = ED.huff0_decode_chunks_ref(
        *(torch.from_numpy(a) for a in _with_edge_chunks(args)))
    assert np.array_equal(per[0].numpy().reshape(N * C, -1), syms.numpy())


@pytest.mark.parametrize("engine", ["shared", "table"])
def test_decompress_batch_roundtrip(engine, encoded):
    pc, pa = encoded["port"]
    if engine == "shared" and not encoded["shared"]:
        with pytest.raises(ValueError, match="shared"):
            H.decompress_4x_batch(pc, accel=pa, engine=engine, device="cpu")
        return
    got = H.decompress_4x_batch(pc, accel=pa, engine=engine, device="cpu")
    for row, c, g in zip(encoded["arr"], pc, got):
        assert (g is None) == (c is None)
        if c is not None:
            assert g == row.tobytes()
    host = H.decompress_4x_batch(pc, device="cpu")
    assert host == got


@pytest.mark.parametrize("L", [97, 1000, 4001])
def test_foreign_containers_through_make_accel(L):
    data = corpus.make_block("text", np.random.default_rng(L)).tobytes()
    conts = [jax_h.compress_4x(data[i * L:(i + 1) * L]) for i in range(3)]
    conts.insert(1, None)
    accel = H.make_accel(conts)
    assert np.array_equal(accel["ckpt"], jax_h.make_accel(conts)["ckpt"])
    got = H.decompress_4x_batch(conts, accel=accel, device="cpu")
    assert got[1] is None
    for i, j in ((0, 0), (2, 1), (3, 2)):
        assert got[i] == data[j * L:(j + 1) * L]
        assert H.decompress_4x(conts[i]) == got[i]


def test_read_table_matches_jax():
    arr = _rows(4096, seed=5)
    for max_log in (8, 11):
        conts = H.compress_4x_batch(arr, max_log=max_log, device="cpu")
        assert sum(c is not None for c in conts) >= 6
        for c in filter(None, conts):
            pos = 2                       # uvarint of 4096
            got, want = HT.read_table(c, pos), jax_h.read_table(c, pos)
            assert got[2:] == want[2:]
            assert np.array_equal(got[0], want[0])
            assert np.array_equal(got[1], want[1])


def _outcome(fn):
    try:
        return fn()
    except (jax_h.CorruptError, HT.CorruptError):
        return "corrupt"


def test_corrupted_containers_agree_with_jax():
    """Seeded flips of the first bytes of each stream (the bits its last
    chunk decodes): the port's engines and the JAX device decode give the
    same bytes or both raise CorruptError (the consumption check); some
    flips must raise."""
    arr = _rows(8192, seed=6)[:1]
    conts, accel = H.compress_4x_batch(arr, return_accel=True, device="cpu")
    blob = conts[0]
    _, _, _, pos = HT.read_table(blob, 2)
    sizes = [int.from_bytes(blob[pos + 2 * q:pos + 2 * q + 2], "little")
             for q in range(3)]
    starts = pos + 6 + np.concatenate([[0], np.cumsum(sizes)])
    rng = np.random.default_rng(6)
    raised = 0
    for k in [int(s0) + j for s0 in starts for j in (0, 1)]:
        bad = bytearray(blob)
        bad[k] ^= 1 + int(rng.integers(0, 255))
        bad = [bytes(bad)]
        want = _outcome(lambda: jax_h.decompress_4x_batch(bad, accel=accel))
        for engine in ("table", "shared"):
            got = _outcome(lambda: H.decompress_4x_batch(
                bad, accel=dict(accel, shared=True), engine=engine,
                device="cpu"))
            assert got == want, (k, engine)
        raised += want == "corrupt"
    assert raised >= 3


def test_single_symbol_batch_gives_none():
    arr = np.zeros((3, 4096), np.uint8)
    conts, accel = H.compress_4x_batch(arr, return_accel=True,
                                       shared_table=True, max_log=8,
                                       device="cpu")
    assert conts == [None, None, None]
    assert H.decompress_4x_batch(conts, accel=accel, device="cpu") == [
        None, None, None]


def test_no_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    arr = _rows(4096, seed=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        H.compress_4x_batch(arr)
    conts, accel = H.compress_4x_batch(arr, return_accel=True, device="cpu")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        H.decompress_4x_batch(conts, accel=accel)


def _xla_holds(d) -> bool:
    """Whether the reference's per-container scan reads the class as the
    plain version does: 52-byte windows, an 11-bit peek, nb below 16 (its
    float table packs sym * 16 + nb) and cursors up to the window's top
    (above it the scan reads its last halfword again)."""
    nb = d["tables"] >> 8
    return (d["windows"].shape[1] == ED.WIN and d["max_bits"] == 11
            and nb.max() < 16 and d["lbit"].max() <= 8 * ED.WIN)


@pytest.mark.parametrize("kind", corpus.HUFF0_CLASSES)
def test_hostile_chunks_match_jax(kind):
    """Each ``corpus.huff0_inputs`` class: the shared-table plain decode
    (its first table) equals JAX ``huff0_decode_chunks_shared(interpret=
    True)``, and where the reference's scan reads the class as the plain
    version does, the per-container plain decode (100 chunks a table, or
    the class's own rows) equals JAX ``huff0_decode_chunks``."""
    d = corpus.huff0_inputs(kind)
    k, mb = d["k"], d["max_bits"]
    flat = (d["windows"], d["lbit"], d["nsym"])
    got = EK.huff0_decode_chunks_shared(
        *map(torch.from_numpy, flat), torch.from_numpy(d["tables"][0]), k=k,
        max_bits=mb)
    want = jax_ep.huff0_decode_chunks_shared(
        *map(jnp.asarray, flat), jnp.asarray(d["tables"][0]), k=k,
        max_bits=mb, interpret=True)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    if not _xla_holds(d):
        return
    C = d["per_row"] or 100
    N = len(d["lbit"]) // C
    tabs = d["tables"] if len(d["tables"]) == N else np.repeat(
        d["tables"][:1], N, 0)
    args = (d["windows"].reshape(N, C, -1), d["lbit"].reshape(N, C),
            d["nsym"].reshape(N, C), tabs)
    syms, endl = ED.huff0_decode_chunks(*map(torch.from_numpy, args), k=k)
    want_s, want_e = jax_ed.huff0_decode_chunks(
        *map(jnp.asarray, args[:3] + (_jax_tables(tabs),)), k=k)
    # the scan's zero fill below bit 0 multiplies by a float power of two
    # built from the exponent field, which holds down to a cursor of about
    # -116: compare the chunks whose cursor stays above -100 (the cursor
    # only falls, so the end cursor is the lowest)
    held = endl.numpy() >= -100
    assert held.mean() > 0.5
    assert np.array_equal(syms.numpy().astype(np.int32)[held],
                          np.asarray(want_s)[held])
    assert np.array_equal(endl.numpy()[held], np.asarray(want_e)[held])
