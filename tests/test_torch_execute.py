"""The port's LZ execute (``compress_tpu_torch/ops/execute.py``,
``ops/exec_kern.py``) against the JAX package on the CPU, bit for bit
(tolerance 0: plans are integers, outputs bytes).

- ``plan_block_ops`` and ``pack_plans`` equal the JAX ones on seeded op
  lists and on the ops of real S2 blocks, at max_rounds 1, 2 and 4.
- ``execute_rounds`` on CPU tensors (its plain version) equals JAX
  ``execute_rounds`` (the XLA round graph) at arena classes M = 1, 2 and
  4, and JAX ``execute_rounds_pallas(interpret=True)`` at M = 1, on the
  same packed plans, the hand plans of ``tests/test_exec_pallas.py``
  included.
- The compact plan: ``pack_pieces`` equals ``compact_pieces`` of the
  slots of ``pack_plans`` of the same plans, and ``execute_pieces`` on CPU tensors
  (its plain version) equals ``execute_rounds_ref`` of the padded plan and
  the JAX XLA and Pallas executes, on seeded, text and rand4 plans at
  max_rounds 1, 2 and 4, every arena class, empty rounds, clipped caps and
  hostile pieces (sources below 0 and past the arena, dst rows outside
  it, overlapping copies at periods 1, 2 and 3)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from compress_tpu import s2 as jax_s2  # noqa: E402
from compress_tpu.ops import exec_pallas as jax_xp  # noqa: E402
from compress_tpu.ops import execute as jax_x  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch.ops import exec_kern  # noqa: E402
from compress_tpu_torch.ops import execute as X  # noqa: E402
from compress_tpu_torch.s2 import plan as S2P  # noqa: E402
from compress_tpu_torch.s2.device_dec import plan_blocks  # noqa: E402
from compress_tpu_torch.utils.varint import read_uvarint  # noqa: E402

OUT = X.OUT_BASE


def test_constants_match_jax():
    assert (X.ARENA_ROWS, X.OUT_BASE, X.HIST_BASE, X.BLOCK) == (
        jax_x.ARENA_ROWS, jax_x.OUT_BASE, jax_x.HIST_BASE, jax_x.BLOCK)


def _seeded_ops(seed, n_ops=300):
    """Decode-order ops with literal runs, short and overlapping copies,
    offsets reaching far back, capped at 64 KiB of output."""
    rng = np.random.default_rng(seed)
    kinds, lens, offs = [0], [int(rng.integers(1, 40))], [0]
    pos = lens[0]
    for _ in range(n_ops):
        if rng.random() < 0.3:
            k, ln, off = 0, int(rng.integers(1, 300)), 0
        else:
            ln = int(rng.integers(1, 200))
            off = int(rng.choice([1, 2, 3, int(rng.integers(1, pos + 1))]))
            k = 1
        if pos + ln > X.BLOCK:
            break
        kinds.append(k)
        lens.append(ln)
        offs.append(min(off, pos))
        pos += ln
    return kinds, lens, offs


def _block_ops(block: bytes):
    """(kinds, lens, offs) of an S2 block, from the port's tag parse."""
    dlen, pos = read_uvarint(block)
    kinds, lens, offs, _ = S2P._parse_tags(block[pos:], dlen, True)
    return kinds, lens, offs


@pytest.fixture(scope="module")
def op_lists():
    blocks = corpus.corpus_blocks(6, seed=41)
    out = {f"seeded{s}": _seeded_ops(s) for s in (1, 2)}
    for i in (0, 1, 5):   # text, rand4, period3
        name = corpus.CLASSES[i]
        out[name] = _block_ops(jax_s2.encode(blocks[i, :24000].tobytes()))
    return out


@pytest.mark.parametrize("max_rounds", [1, 2, 4])
@pytest.mark.parametrize("ops", ["seeded1", "seeded2", "text", "rand4",
                                 "period3"])
def test_plan_and_pack_match_jax(ops, max_rounds, op_lists):
    kinds, lens, offs = op_lists[ops]
    want = jax_x.plan_block_ops(kinds, lens, offs, max_rounds=max_rounds)
    got = X.plan_block_ops(kinds, lens, offs, max_rounds=max_rounds)
    assert got["n_rounds"] == want["n_rounds"] <= max_rounds + 1
    for key in ("src", "dst", "len", "round"):
        assert got[key].dtype == want[key].dtype
        assert np.array_equal(got[key], want[key]), key
    other = X.plan_block_ops(*op_lists["seeded1"], max_rounds=max_rounds)
    for plans in ([got], [got, other]):
        for a, b in zip(X.pack_plans(plans), jax_x.pack_plans(plans)):
            assert np.array_equal(np.asarray(a), np.asarray(b))


def test_pack_plans_capacity_overflow_raises():
    p = X.plan_block_ops(*_seeded_ops(3))
    with pytest.raises(ValueError, match="capacity"):
        X.pack_plans([p], round_caps=(1,) * p["n_rounds"])


def _hand_plans():
    """The hand plans of tests/test_exec_pallas.py: row-crossing
    unaligned sources, a copy whose aligned base is row -1, chained
    rounds; and a block of pad slots only."""
    return [
        dict(src=np.array([5, 200, OUT + 3, 6], np.int32),
             dst=np.array([OUT + 0, OUT + 10, OUT + 40, OUT + 56], np.int32),
             len=np.array([10, 20, 7, 6], np.int32),
             round=np.array([0, 0, 1, 0], np.int32), n_rounds=2),
        dict(src=np.array([0, OUT, OUT + 64], np.int32),
             dst=np.array([OUT, OUT + 64, OUT + 128], np.int32),
             len=np.array([64, 64, 64], np.int32),
             round=np.array([0, 1, 2], np.int32), n_rounds=3),
        dict(src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32),
             len=np.zeros(0, np.int32), round=np.zeros(0, np.int32),
             n_rounds=1),
    ]


def _run_port(lit, src, dst, length, caps):
    return X.execute_rounds(*(torch.from_numpy(np.ascontiguousarray(a))
                              for a in (lit, src, dst, length)), caps).numpy()


def _run_xla(lit, src, dst, length, caps):
    return np.asarray(jax_x.execute_rounds_jit(
        *(jnp.asarray(a) for a in (lit, src, dst, length)), caps))


def test_hand_plans_match_xla_and_pallas():
    rng = np.random.default_rng(1)
    lit = rng.integers(0, 256, (3, 512, 128)).astype(np.uint8)
    src, dst, length, caps = X.pack_plans(_hand_plans())
    got = _run_port(lit, src, dst, length, caps)
    assert got.shape == (3, 512, 128) and got.dtype == np.uint8
    assert np.array_equal(got, _run_xla(lit, src, dst, length, caps))
    pallas = np.asarray(jax_xp.execute_rounds_pallas(
        *(jnp.asarray(a) for a in (lit, src, dst, length)), caps,
        interpret=True))
    assert np.array_equal(got, pallas)
    assert not got[2].any()


def test_empty_rounds_and_clipped_caps_match_xla():
    """A round with no live piece, a cap of 0, and caps that run past the
    plan's rows (clipped, as the reference's slices are)."""
    rng = np.random.default_rng(2)
    lit = rng.integers(0, 256, (2, 512, 128)).astype(np.uint8)
    plans = _hand_plans()[:2]
    src, dst, length, caps = X.pack_plans(plans)
    pad = np.zeros((64, 2), np.int32)
    src = np.concatenate([src[:64], pad, src[64:]])
    dst = np.concatenate([dst[:64], pad + OUT, dst[64:]])
    length = np.concatenate([length[:64], pad, length[64:]])
    caps = (64, 64, 0) + caps[1:] + (100,)
    got = _run_port(lit, src, dst, length, caps)
    assert np.array_equal(got, _run_xla(lit, src, dst, length, caps))


@pytest.fixture(scope="module")
def s2_classes():
    """Planned S2 blocks of every arena class: two text blocks of 20 KiB
    (M = 1) and blocks of 65,537 (M = 2) and 200,000 bytes (M = 4)."""
    rng = np.random.default_rng(7)
    text = b"".join(corpus.make_block("text", rng).tobytes()
                    for _ in range(4))
    srcs = [text[:20000], text[30000:50000], text[:65537],
            (text[:3000] + rng.integers(0, 4, 7000, np.uint8).tobytes())
            * 20]
    results, classes = plan_blocks([jax_s2.encode(s) for s in srcs])
    assert all(r is None for r in results)
    return srcs, classes


@pytest.mark.parametrize("M", [1, 2, 4])
def test_execute_rounds_matches_xla_per_class(M, s2_classes):
    srcs, classes = s2_classes
    c = next(c for c in classes if c["M"] == M)
    args = (c["lit_rows"], *X.pack_plans(c["plans"]))
    got = _run_port(*args)
    assert got.shape == (len(c["index"]), 512 * M, 128)
    assert np.array_equal(got, _run_xla(*args))
    for k, i in enumerate(c["index"]):
        assert got[k].reshape(-1)[:len(srcs[i])].tobytes() == srcs[i]


def test_execute_rounds_matches_pallas_on_real_plans():
    rng = np.random.default_rng(9)
    text = corpus.make_block("text", rng).tobytes()
    srcs = [text[:3000], text[5000:7000], bytes(1500)]
    _, (c,) = plan_blocks([jax_s2.encode(s) for s in srcs])
    args = (c["lit_rows"], *X.pack_plans(c["plans"]))
    got = _run_port(*args)
    pallas = np.asarray(jax_xp.execute_rounds_pallas(
        *(jnp.asarray(a) for a in args[:4]), args[4], interpret=True))
    assert np.array_equal(got, pallas)
    for k, s in enumerate(srcs):
        assert got[k].reshape(-1)[:len(s)].tobytes() == s


@pytest.mark.parametrize("kind", corpus.EXEC_SUM_CLASSES)
def test_sum_plans_match_xla_and_need_the_sum(kind):
    """The plans on which a store differs from the reference's sum (a
    literal-half write, a byte written twice, a same-round read): the
    plain execute equals JAX's XLA execute on them, beside a planner
    block (``execute_rounds`` sends every padded plan to the sum kernel on
    CUDA tensors).  The literal
    bytes are below 64, so every sum stays below 256: the reference sums
    in a bf16/float arena and converts to uint8, which is exact there (past
    255 it saturates where the plain version wraps, ROADMAP.md queue 3)."""
    plans = [corpus.exec_sum_plans()[kind], corpus.exec_hostile_plans(1)[1]]
    rng = np.random.default_rng(4)
    lit = rng.integers(0, 64, (2, 512, 128)).astype(np.uint8)
    args = (lit, *X.pack_plans(plans))
    assert np.array_equal(_run_port(*args), _run_xla(*args))


def test_execute_rounds_rejects_bad_shapes():
    lit = torch.zeros((2, 500, 128), dtype=torch.uint8)
    z = torch.zeros((64, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        X.execute_rounds(lit, z, z, z, (64,))
    lit = torch.zeros((2, 512, 128), dtype=torch.uint8)
    with pytest.raises(ValueError):
        X.execute_rounds(lit, z[:, :1], z, z, (64,))


# ---- the compact plan ------------------------------------------------------

def _compact(src, dst, length, caps, rows):
    """``compact_pieces`` of a padded plan's slots (numpy in, tensors
    out)."""
    flat, nr = exec_kern._slots(*(torch.from_numpy(a) for a in (
        src, dst, length)), caps)
    return exec_kern.compact_pieces(*flat, src.shape[1], nr, rows)


def _run_pieces(lit, pieces, rstart):
    return X.execute_pieces(*(torch.from_numpy(np.ascontiguousarray(a))
                              for a in (lit, pieces, rstart))).numpy()


def _hold_compact(lit, plans, pallas=False):
    """pack_pieces == compact_pieces of pack_plans' slots; the compact
    execute equals
    the padded plain execute and JAX's XLA (and Pallas) executes."""
    rows = lit.shape[1]
    pieces, rstart = X.pack_pieces(plans, rows)
    padded = X.pack_plans(plans)
    cp, cr = _compact(*padded, rows)
    assert np.array_equal(pieces, cp.numpy())
    assert np.array_equal(rstart, cr.numpy())
    assert pieces.dtype == rstart.dtype == np.int32
    got = _run_pieces(lit, pieces, rstart)
    assert got.shape == lit.shape and got.dtype == np.uint8
    assert np.array_equal(got, _run_port(lit, *padded))
    assert np.array_equal(got, _run_xla(lit, *padded))
    if pallas:
        assert np.array_equal(got, np.asarray(jax_xp.execute_rounds_pallas(
            *(jnp.asarray(a) for a in (lit, *padded[:3])), padded[3],
            interpret=True)))
    return got


@pytest.mark.parametrize("max_rounds", [1, 2, 4])
@pytest.mark.parametrize("ops", ["seeded1", "text", "rand4"])
def test_compact_plan_matches_padded_and_jax(ops, max_rounds, op_lists):
    plans = [X.plan_block_ops(*op_lists[ops], max_rounds=max_rounds),
             X.plan_block_ops(*op_lists["seeded2"], max_rounds=max_rounds)]
    lit = np.random.default_rng(max_rounds).integers(
        0, 256, (2, 512, 128)).astype(np.uint8)
    _hold_compact(lit, plans, pallas=max_rounds == 4)


def test_compact_plan_hand_plans_match_pallas():
    lit = np.random.default_rng(1).integers(0, 256, (3, 512, 128)).astype(
        np.uint8)
    got = _hold_compact(lit, _hand_plans(), pallas=True)
    assert not got[2].any()


@pytest.mark.parametrize("M", [1, 2, 4])
def test_compact_plan_matches_xla_per_class(M, s2_classes):
    srcs, classes = s2_classes
    c = next(c for c in classes if c["M"] == M)
    got = _hold_compact(c["lit_rows"], c["plans"])
    assert np.array_equal(c["pieces"], X.pack_pieces(c["plans"], 512 * M)[0])
    for k, i in enumerate(c["index"]):
        assert got[k].reshape(-1)[:len(srcs[i])].tobytes() == srcs[i]


def test_compact_plan_of_empty_rounds_and_clipped_caps():
    """The compact plan of a padded plan with a round of pads only, a cap of 0
    and caps past the plan's rows equals the padded execute and XLA."""
    rng = np.random.default_rng(2)
    lit = rng.integers(0, 256, (2, 512, 128)).astype(np.uint8)
    src, dst, length, caps = X.pack_plans(_hand_plans()[:2])
    pad = np.zeros((64, 2), np.int32)
    src = np.concatenate([src[:64], pad, src[64:]])
    dst = np.concatenate([dst[:64], pad + OUT, dst[64:]])
    length = np.concatenate([length[:64], pad, length[64:]])
    caps = (64, 64, 0) + caps[1:] + (100,)
    pieces, rstart = _compact(src, dst, length, caps, 512)
    assert rstart.shape == (2, len(caps) + 1)
    assert (rstart[:, 1] == rstart[:, 2]).all()        # the pads' round
    got = _run_pieces(lit, pieces.numpy(), rstart.numpy())
    assert np.array_equal(got, _run_port(lit, src, dst, length, caps))
    assert np.array_equal(got, _run_xla(lit, src, dst, length, caps))


@pytest.mark.parametrize("M", [1, 2, 4])
def test_compact_plan_hostile_pieces(M):
    plans = corpus.exec_hostile_plans(M)
    lit = np.random.default_rng(M).integers(
        0, 256, (len(plans), 512 * M, 128)).astype(np.uint8)
    pieces, _ = X.pack_pieces(plans, 512 * M)
    # the dst rows outside the arena left no piece
    assert len(pieces) == sum(len(p["len"]) for p in plans) - 3
    got = _hold_compact(lit, plans, pallas=M == 1)
    for k, period in enumerate((1, 2, 3), start=1):
        row = got[k].reshape(-1)
        seed = lit[k].reshape(-1)[:period]
        assert row[:700 + period].tobytes() == (
            seed.tobytes() * 701)[:700 + period]


def test_compact_plan_rejects_literal_half_writes_and_bad_caps():
    p = dict(src=np.array([0], np.int32), dst=np.array([OUT - 128], np.int32),
             len=np.array([4], np.int32), round=np.array([0], np.int32),
             n_rounds=1)
    with pytest.raises(ValueError, match="literal half"):
        X.pack_pieces([p])
    padded = X.pack_plans([p])[:3]
    with pytest.raises(ValueError, match="literal half"):
        _compact(*padded, (64,), 512)
    with pytest.raises(ValueError, match="negative"):
        _compact(*padded, (64, -10, 64), 512)
    with pytest.raises(ValueError, match="round"):
        X.pack_pieces([dict(p, dst=np.array([OUT], np.int32),
                            round=np.array([1], np.int32))])


def test_execute_pieces_rejects_bad_shapes():
    lit = torch.zeros((2, 512, 128), dtype=torch.uint8)
    pieces = torch.zeros((4, 2), dtype=torch.int32)
    with pytest.raises(ValueError):
        X.execute_pieces(lit, pieces[:, :1], torch.zeros((2, 2),
                                                         dtype=torch.int32))
    with pytest.raises(ValueError):
        X.execute_pieces(lit, pieces, torch.zeros((3, 2), dtype=torch.int32))
    with pytest.raises(ValueError):
        X.execute_pieces(lit[:, :500], pieces,
                         torch.zeros((2, 2), dtype=torch.int32))
