"""PyTorch port of the S2 XLA engine (compress_tpu_torch/ops/lz2.py
``s2_encode_blocks``) against the JAX package's ``ops/lz2.py`` on the CPU,
with tolerance 0 (every value is an integer or a byte).

Each stage is fed the JAX stage's own inputs and its outputs are compared
at the boundary: ``_values``, ``_candidates_lengths``, ``_rle_lengths``,
``_chain_extend``, ``_topk_offsets``, ``_probe_offsets``, ``_parse`` (the
plain tile parse, also on hostile lengths), ``_find_parse``,
``_merge_tile_chains`` and ``_emit_batched``, at tiles 512 and 256 and
levels 1 and 2, on two seeded corpus blocks of each class.  Then
``s2_encode_blocks`` whole: (out, lens) equal byte for byte, every body
decodes with both packages' S2 decoders, and ``encode_blocks_np`` on the
CPU (the XLA engine, as the reference's on a CPU) equals the JAX
``encode_blocks_np``."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402
import torch  # noqa: E402

from compress_tpu import s2 as jax_s2  # noqa: E402
from compress_tpu.ops import lz2 as J  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch.ops import lz2  # noqa: E402
from compress_tpu_torch.s2 import block as port_block  # noqa: E402
from compress_tpu_torch.utils import varint  # noqa: E402

BS = lz2.B
NAMES = list(corpus.CLASSES)
TILES = [512, 256]
CASES = [(512, 1), (512, 2), (256, 1), (256, 2)]
IDS = [f"tile{t}-level{lv}" for t, lv in CASES]


@pytest.fixture(scope="module")
def blocks_np():
    """Two blocks of each class (seeded), the 16 rows of one launch."""
    return np.concatenate([corpus.corpus_blocks(len(NAMES), seed=41),
                           corpus.corpus_blocks(len(NAMES), seed=42)])


def _vjit(fn):
    return jax.jit(jax.vmap(fn))


def _np(x):
    return np.array(x)


def _t(x):
    return torch.from_numpy(np.asarray(x).astype(np.int64))


def _same(got, want):
    got = got if isinstance(got, (tuple, list)) else [got]
    want = want if isinstance(want, (tuple, list)) else [want]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        g = g.numpy() if isinstance(g, torch.Tensor) else np.asarray(g)
        w = np.asarray(w)
        assert g.shape == w.shape
        assert np.array_equal(g.astype(np.int64), w.astype(np.int64))


@pytest.fixture(scope="module")
def jax_find(blocks_np):
    """The JAX finder stages on the blocks (tile and level free)."""
    b = jnp.asarray(blocks_np)
    v32, words = _vjit(lambda x: J._values(x, BS))(b)
    off_s, L_s = _vjit(lambda v, w: J._candidates_lengths(v, w, BS))(
        v32, words)
    L_ext = _vjit(lambda o, L: J._chain_extend(o, L, BS))(off_s, L_s)
    off_r, L_r = _vjit(lambda x: J._rle_lengths(x, BS))(b)
    top = _vjit(lambda o, L: J._topk_offsets(o, L, BS))(off_s, L_ext)
    probe = _vjit(lambda x, t: J._probe_offsets(x, t, BS))(b, top)
    return dict(v32=v32, words=words, cand=(off_s, L_s), ext=L_ext,
                rle=(off_r, L_r), top=top, probe=probe)


def test_values(blocks_np, jax_find):
    v32, words = lz2._values(torch.from_numpy(blocks_np))
    _same([v32, *words], [jax_find["v32"], *jax_find["words"]])


def test_candidates_lengths(jax_find):
    got = lz2._candidates_lengths(_t(jax_find["v32"]),
                                  [_t(w) for w in jax_find["words"]])
    _same(got, jax_find["cand"])


def test_rle_lengths(blocks_np, jax_find):
    _same(lz2._rle_lengths(torch.from_numpy(blocks_np)), jax_find["rle"])


def test_chain_extend(jax_find):
    off_s, L_s = jax_find["cand"]
    got = lz2._chain_extend(_t(off_s), _t(L_s))
    _same(got, jax_find["ext"])
    assert (np.asarray(jax_find["ext"]) > lz2.L_CAP).any()


def test_topk_offsets(jax_find):
    got = lz2._topk_offsets(_t(jax_find["cand"][0]), _t(jax_find["ext"]))
    _same(got, jax_find["top"])


def test_topk_offsets_ties_keep_ascending_offsets():
    """Equal counts keep ascending offsets (the stable order)."""
    off = np.zeros((1, 4096), np.int64)
    off[0, ::64] = np.tile([9, 5, 7, 3], 16)
    L = np.full((1, 4096), 4, np.int64)
    want = J._topk_offsets(jnp.asarray(off[0], jnp.int32),
                           jnp.asarray(L[0], jnp.int32), 4096)
    got = lz2._topk_offsets(torch.from_numpy(off), torch.from_numpy(L))
    _same(got[0], want)
    assert got[0, :4].tolist() == [3, 5, 7, 9]


def test_probe_offsets(blocks_np, jax_find):
    got = lz2._probe_offsets(torch.from_numpy(blocks_np),
                             _t(jax_find["top"]))
    _same(got, jax_find["probe"])


PARSE_KINDS = ("every_4", "end_at_tile_end", "whole_tile", "raw_random")


def _hostile_L(kind: str, tile: int) -> np.ndarray:
    """(2, 4 * tile) per-position L (before the parse's cap)."""
    rng = np.random.default_rng([PARSE_KINDS.index(kind), tile])
    bs = 4 * tile
    r = np.arange(bs) % tile
    if kind == "every_4":
        return np.full((2, bs), 4, np.int32)
    if kind == "end_at_tile_end":
        L = np.zeros((2, bs), np.int32)
        L[:, r == tile - 20] = 20
        L[1, r == 0] = tile - 20
        return L
    if kind == "whole_tile":
        L = rng.integers(0, tile + 1, (2, bs)).astype(np.int32)
        L[:, r == 0] = tile
        return L
    return rng.integers(-5, tile + 6, (2, bs)).astype(np.int32)


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("kind", PARSE_KINDS)
def test_parse_hostile(kind, tile):
    L = _hostile_L(kind, tile)
    off = np.random.default_rng(7).integers(0, 999, L.shape).astype(np.int32)
    bs = L.shape[1]
    want = _vjit(lambda o, x: J._parse(o, x, bs, tile, cap=tile))(
        jnp.asarray(off), jnp.asarray(L))
    got = lz2._parse(torch.from_numpy(off).long(), torch.from_numpy(L).long(),
                     tile, cap=tile)
    _same(got, want)


@pytest.fixture(scope="module")
def jax_parsed(blocks_np):
    """The JAX engine's stages per (tile, level): parse, merge, emit."""
    b = jnp.asarray(blocks_np)
    out = {}
    for tile, level in CASES:
        parsed = _vjit(lambda x: J._find_parse(x, BS, tile, level))(b)
        merged = jax.jit(lambda *a: J._merge_tile_chains(*a, BS, tile))(
            *parsed)
        emitted = jax.jit(lambda x, *a: J._emit_batched(x, *a, BS, tile))(
            b, *merged)
        whole = J.s2_encode_blocks(b, tile=tile, level=level)
        out[(tile, level)] = (parsed, merged, emitted, whole)
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_find_parse(case, blocks_np, jax_parsed):
    tile, level = case
    got = lz2._find_parse(torch.from_numpy(blocks_np), tile, level)
    _same(got, jax_parsed[case][0])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_merge_tile_chains(case, jax_parsed):
    take, lit, L_t, off = (torch.from_numpy(_np(x))
                           for x in jax_parsed[case][0])
    got = lz2._merge_tile_chains(take, lit, L_t.long(), off.long(), case[0])
    _same(got, jax_parsed[case][1])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_emit_batched(case, blocks_np, jax_parsed):
    take, lit, L_t, off = (torch.from_numpy(_np(x))
                           for x in jax_parsed[case][1])
    got = lz2._emit_batched(torch.from_numpy(blocks_np), take, lit,
                            L_t.long(), off.long(), case[0])
    _same(got, jax_parsed[case][2])


@pytest.fixture(scope="module")
def port_whole(blocks_np):
    t = torch.from_numpy(blocks_np)
    return {c: lz2.s2_encode_blocks(t, tile=c[0], level=c[1]) for c in CASES}


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_s2_encode_blocks_matches_jax(case, jax_parsed, port_whole):
    out, lens = port_whole[case]
    assert out.dtype == torch.uint8 and lens.dtype == torch.int32
    _same([out, lens], jax_parsed[case][3])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bodies_decode_with_both_decoders(case, blocks_np, port_whole):
    out, lens = port_whole[case]
    hdr = bytearray()
    varint.put_uvarint(hdr, BS)
    for i, n in enumerate(lens.tolist()):
        block = bytes(hdr) + out[i, :n].numpy().tobytes()
        assert port_block.decode(block) == blocks_np[i].tobytes()
        assert jax_s2.decode(block) == blocks_np[i].tobytes()


def test_level2_not_larger(port_whole):
    for tile in TILES:
        assert int(port_whole[(tile, 2)][1].sum()) <= \
            int(port_whole[(tile, 1)][1].sum())


def test_encode_blocks_np_cpu_matches_jax(blocks_np, monkeypatch):
    """The CPU default is the XLA engine at level 1, as the reference's."""
    monkeypatch.delenv("COMPRESS_TPU_S2_ENGINE", raising=False)
    data = blocks_np.tobytes()
    want = [bytes(b) for b in J.encode_blocks_np(data)]
    assert lz2.encode_blocks_np(data, device="cpu") == want


def test_encode_blocks_np_chunks(blocks_np, monkeypatch):
    """Several launches give the bodies of one."""
    data = blocks_np[:5].tobytes()
    whole = lz2.encode_blocks_np(data, device="cpu")
    monkeypatch.setattr(lz2, "MAX_LAUNCH_BLOCKS", 2)
    assert lz2.encode_blocks_np(data, device="cpu") == whole


def test_engine_follows_device(monkeypatch):
    monkeypatch.delenv("COMPRESS_TPU_S2_ENGINE", raising=False)
    assert lz2._use_kernel_path(torch.device("cuda"))
    assert not lz2._use_kernel_path(torch.device("cpu"))
    monkeypatch.setenv("COMPRESS_TPU_S2_ENGINE", "xla")
    assert not lz2._use_kernel_path(torch.device("cuda"))


def test_kernel_path_failure_is_not_retried(blocks_np, monkeypatch):
    """A kernel path that raises is not retried on the XLA engine."""
    def boom(blocks):
        raise RuntimeError("kernel failed")

    def never(*a, **k):
        raise AssertionError("the XLA engine must not run")

    monkeypatch.setattr(lz2, "_use_kernel_path", lambda dev: True)
    monkeypatch.setattr(lz2, "s2_encode_blocks_kern", boom)
    monkeypatch.setattr(lz2, "s2_encode_blocks", never)
    with pytest.raises(RuntimeError, match="kernel failed"):
        lz2.encode_blocks_np(blocks_np[:1].tobytes(), device="cpu")


def test_bad_blocks_raise():
    with pytest.raises(ValueError):
        lz2.s2_encode_blocks(torch.zeros((1, 1000), dtype=torch.uint8))
    with pytest.raises(ValueError):
        lz2.s2_encode_blocks(torch.zeros((1, BS), dtype=torch.uint8),
                             level=3)
    with pytest.raises(ValueError):
        lz2.tile_parse(torch.zeros((1, 1000), dtype=torch.int32), 512)
