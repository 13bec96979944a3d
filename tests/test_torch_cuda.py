"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, bit for bit (tolerance 0: integers and bytes), on one block of
every seeded corpus class (the zstd kernels also on a replica job, whose
long-range matches reach past the block), and the finder and the
literal lookup also on hostile inputs (``corpus.finder_block``, batches of
1, 133 and 512 blocks; odd row lengths, every byte value, misaligned
rows), the parse kernels (zstd parse, S2 emit) on ``corpus.parse_inputs``
and batches of 1, 133 and 512 blocks, also at caps other than the
finder's, the chain kernels (repeat scan, FSE chain) on batches of 1, 133
and 512 blocks and on ``corpus.rep_inputs`` / ``corpus.fse_inputs``, and
the LZ execute on compact and padded plans of every arena class, on
``corpus.exec_hostile_plans`` and, through its sum kernel, on
``corpus.exec_sum_plans``, and the huff0 chunk and sequence decoders on
every class of ``corpus.huff0_inputs`` / ``corpus.zseq_inputs`` in every
mode (shared table, a table per row, the per-container and per-item
entries; every k from 1 to 8 and both repeat-code-3 rules for the
sequences, and the chunks that enter with a repeat offset of INT32_MIN),
with a profiler trace that shows each entry launching its kernel and
nothing else, and the multi-block history execute on
``corpus.history_streams``, on ``corpus.hist_plans`` (histories of 1, 5,
8 and 128 blocks), on a group of frames of 1 to 16 blocks, on launches
of 1, 8 and 40 frames (more clusters than the card holds at once), at
every cluster size the card takes (and one it refuses, which raises) and
in twenty repeated launches, with the accel and multi-block accel decode
routes end to end; the FSE batch encode chain and chunk decode on
``corpus.fse_enc_inputs`` / ``corpus.fse_dec_inputs`` (and tables of any
int32 value), the encode chain also on every corpus class, at row
lengths 2, 18 and 16386 and table logs 1 to 12, with the rows it sends
to each route counted, batches of 1, 7 and 1025 rows and twenty
repeated launches, the chunk decode also on tables of any int32 entry
(``corpus.FSE_DEC_WILD``) at k = 2, 6, 32 and 64, on batches of 1, 7 and
1028 rows of 1, 255, 257 and 512 chunks with rows all live, all dead and
mixed and the chunks on each route counted, with ``fse.compress_batch`` /
``decompress_batch`` end to end; CRC-32C and
xxHash64 on rows of many lengths, prefixes, seeds, batches of 1 and 7 and
misaligned rows, CRC-32C also on one row of 16 MiB, batches of 257 and
1024 rows and lengths one either side of a whole number of its 256
chunks, xxHash64 also on rows that are not a whole number of its
stages in batches of 1, 255, 257 and 1024 rows; the byte histograms
(``byte_histograms`` at batches of 1, 7, 1024 and 4097 rows of 2, 16383,
16 KiB and 64 KiB bytes, every corpus class, all-zeros and all-255 rows,
masks all false, all true, a prefix and random, misaligned and strided
views, rows of 65,536 equal bytes in batches of 1 and 4097, rows whose
one thread counts 255, 256 and 257 equal bytes, and ``histogram256_torch`` on every dtype it reads, 16 MiB of
zeros and an empty input, against their plain versions and
``torch.bincount``), each with its launch count and twenty repeats; ``compress_device`` on
inputs that are not whole jobs; and the two XLA-graph encoders: the tile parse on hostile lengths
(every position 4, matches that end at a tile's end, whole-tile matches,
raw values, values near INT32_MAX, the S2 engine's own) at tiles 1 to
700 on its warp route and 4096 and the whole 64 KiB block on its chunked
route, in batches of 1, 65 and 256 rows, the v1 FSE scan on n_seqs of
0, 1 and MS, one to three RLE streams, an of table whose clamped index
passes 255, broken tables on its exact route, a route that changes from
chunk to chunk, several jobs' tables in one launch (the 8 x 64 geometry,
uneven rows, part-full CTAs), both with the tiles or rows on each route
equal to the CPU models' (``tests/test_torch_tileparse_model.py``,
``tests/test_torch_zdevfse_model.py``), the repeat scan at v1's shapes,
and both engines and ``compress_device``'s v1 on the card against the
CPU; the block-parallel engine
(``parallel``) on one NCCL rank and on two gloo ranks sharing the card,
against the unsharded calls; and the host core (``_native``) built on
the card's machine, each entry against its plain Python version (the
checksums also against the checksum kernels' rows, job assembly on a job
the v2 kernels encoded); the stream tier around device-made data: the
port's S2 Reader, index and ReadSeeker on ``s2_stream_encode_device``'s
stream, its compressed chunks through ``decode_blocks_device`` equal to
the Reader's chunks, and the zstd stream Reader over ``compress_device``'s
frames; the deflate family and the CLIs around the card: ``s2c -device``
equal to ``s2_stream_encode_device``'s stream and its index (the tile
parse launched), ``zstdio -accel`` decoded by ``decompress_frames_device``
with no host walk and no host frame, and the deflate, inflate, gzip and
zlib round trips on the host core built on the card's machine; and the
two per-row table builds (``zdev._huff_build``, ``_normalize_count``)
on every class of ``corpus.huff_build_hists`` / ``normalize_hists`` at
maxlog 1-15, NSYM 1-1024 and logs 1-30 in int32 and int64, on keys and
remainders past 2^54 (``corpus.huff_build_wide_hists`` /
``normalize_wide_hists``), on the
counts the v2, v1, huff0 and FSE batch paths build tables of, with each
row's walk steps equal to the CPU models'
(``tests/test_torch_tablebuild_model.py``), one launch a call with no
host sync, and twenty repeats.
Without a card every test here skips.

The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from compress_tpu_torch import corpus, fse, huff0
from compress_tpu_torch import zstd as zstd_host
from compress_tpu_torch.fse import core as fse_core
from compress_tpu_torch.ops import (checksum, entropy, entropy_dec,
                                    entropy_kern, exec_kern, execute, lz2,
                                    lzemit2,
                                    lzkern, zdev, zenc2, zparse, zseq_kern,
                                    zseqenc)
from compress_tpu_torch.s2 import block as s2_block
from compress_tpu_torch.utils import histogram
from compress_tpu_torch.utils.crc import crc32c
from compress_tpu_torch.s2.device_dec import decode_blocks_device as \
    s2_decode_blocks_device
from compress_tpu_torch.s2.device_dec import plan_blocks
from compress_tpu_torch.utils.varint import put_uvarint
from compress_tpu_torch.zstd import device as zdevice
from compress_tpu_torch.zstd import encoder as zencoder
from compress_tpu_torch.zstd import accel as zaccel
from compress_tpu_torch.zstd import device_dec as zdevice_dec
from compress_tpu_torch.zstd import seqdev as zseqdev
from compress_tpu_torch.zstd import seqs as zseqs
from compress_tpu_torch.zstd.device_dec import decompress_frames_device


@pytest.fixture(scope="module")
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def blocks_np():
    out = corpus.corpus_blocks(len(corpus.CLASSES), seed=31)
    out[corpus.CLASSES.index("gate")] = corpus.make_block(
        "gate", np.random.default_rng(0))
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("slim", [False, True], ids=["cap10", "slim"])
def test_finder_kernel_matches_plain(cuda_device, slim, blocks_np):
    t = torch.from_numpy(blocks_np).to(cuda_device)
    before = lzkern.find_matches_blocks.launches
    got = lzkern.find_matches_blocks(t, slim=slim)
    want = lzkern.find_matches_blocks_ref(t, slim=slim)
    torch.cuda.synchronize()
    assert lzkern.find_matches_blocks.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("slim", [False, True], ids=["cap10", "slim"])
def test_emit_kernel_matches_plain(cuda_device, slim, blocks_np):
    t = torch.from_numpy(blocks_np).to(cuda_device)
    off, L = lzkern.find_matches_blocks_ref(t, slim=slim)
    cap = lzkern.L_CAP_SLIM if slim else lzkern.L_CAP
    before = lzemit2.emit_blocks.launches
    got = lzemit2.emit_blocks(t, off, L, cap=cap)
    want = lzemit2.emit_blocks_ref(t, off, L, cap=cap)
    torch.cuda.synchronize()
    assert lzemit2.emit_blocks.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_encode_on_cuda_matches_cpu(cuda_device, blocks_np):
    """The entry's kernel path on the card equals the same path's plain
    versions on the CPU."""
    data = blocks_np.tobytes()
    assert lz2.encode_blocks_np(data) == lz2.s2_encode_blocks_kern(
        torch.from_numpy(blocks_np))


@pytest.mark.cuda
def test_kernels_reject_bad_inputs(cuda_device, blocks_np):
    t = torch.from_numpy(blocks_np).to(cuda_device)
    with pytest.raises(ValueError):
        lzkern.find_matches_blocks(t.to(torch.int32))
    off, L = lzkern.find_matches_blocks(t)
    with pytest.raises(ValueError):
        lzemit2.emit_blocks(t, off.to(torch.int64), L)
    with pytest.raises(ValueError):
        lzemit2.emit_blocks(t, off.cpu(), L)


ZJOB = 128 << 10


@pytest.fixture(scope="module")
def zstd_data():
    return corpus.replica_jobs(2, ZJOB, seed=8).tobytes()


def _zstd_stages(data, dev):
    """The v2 encoder's (blocks, off, L) on ``dev``, as its parse sees them."""
    src = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    jobs, pre, hp = zdevice.launch_inputs(src, 0, len(data) // ZJOB, ZJOB)
    return zenc2._merged_matches(jobs.to(dev), pre.to(dev), hp.to(dev))[:3]


@pytest.mark.cuda
def test_zstd_kernels_match_plain(cuda_device, zstd_data, blocks_np):
    blocks, off, L = _zstd_stages(zstd_data, cuda_device)
    for a, b in zip(lzkern.find_matches_blocks(blocks),
                    lzkern.find_matches_blocks_ref(blocks)):
        assert torch.equal(a, b)
    extra = torch.from_numpy(blocks_np).to(cuda_device)
    eo, eL = lzkern.find_matches_blocks_ref(extra)
    blocks = torch.cat([blocks, extra])
    off, L = torch.cat([off, eo]), torch.cat([L, eL])
    counts = [f.launches for f in (zparse.parse_blocks, zseqenc.rep_scan,
                                   zseqenc.fse_chain, zenc2._litlut)]
    got = zparse.parse_blocks(blocks, off, L)
    want = zparse.parse_blocks_ref(blocks, off, L)
    ll, ml, of, lits, n, lc = want
    rep = zseqenc.rep_scan(of, ll, n)
    rep_want = zseqenc.rep_scan_ref(of, ll, n)
    pk_ll, pk_of, pk_ml, tables, *_ = zenc2._codes_stage(ll, ml, rep_want, n)
    chain = zseqenc.fse_chain(pk_ll, pk_of, pk_ml, n, tables)
    chain_want = zseqenc.fse_chain_ref(pk_ll, pk_of, pk_ml, n, tables)
    tab = torch.randint(0, 1 << 20, (blocks.shape[0], 2, 128),
                        dtype=torch.int32, device=cuda_device)
    lut = zenc2._litlut(lits, tab)
    lut_want = zenc2._litlut_ref(lits, tab)
    torch.cuda.synchronize()
    for a, b in zip([*got, rep, *chain, *lut],
                    [*want, rep_want, *chain_want, *lut_want]):
        assert torch.equal(a, b)
    assert [f.launches for f in (zparse.parse_blocks, zseqenc.rep_scan,
                                 zseqenc.fse_chain, zenc2._litlut)] == [
        c + 1 for c in counts]


@pytest.mark.cuda
def test_compress_device_on_cuda_matches_cpu(cuda_device, zstd_data):
    assert zdevice.compress_device(zstd_data, job=ZJOB) == \
        zdevice.compress_device(zstd_data, job=ZJOB, device="cpu",
                                engine="v2")


@pytest.mark.cuda
def test_zstd_kernels_reject_bad_inputs(cuda_device, zstd_data):
    blocks, off, L = _zstd_stages(zstd_data, cuda_device)
    with pytest.raises(ValueError):
        zparse.parse_blocks(blocks, off.to(torch.int64), L)
    with pytest.raises(ValueError):
        zparse.parse_blocks(blocks, off.cpu(), L)
    ll, ml, of, lits, n, lc = zparse.parse_blocks(blocks, off, L)
    with pytest.raises(ValueError):
        zseqenc.rep_scan(of, ll, n.to(torch.int64))
    with pytest.raises(ValueError):
        zseqenc.fse_chain(of, of, of, n, torch.zeros(
            (3, 128), dtype=torch.int64, device=cuda_device))
    with pytest.raises(ValueError):
        zenc2._litlut(lits.to(torch.int32), torch.zeros(
            (lits.shape[0], 2, 128), dtype=torch.int32, device=cuda_device))


# ---- the sequence-encode chains (repeat scan, FSE chain) -------------------

def _on(dev, *arrays):
    """numpy arrays or tensors as tensors on dev."""
    return [torch.as_tensor(a).to(dev) for a in arrays]


def _hold_rep(of, ll, n, dev):
    t = _on(dev, of, ll, n)
    before = zseqenc.rep_scan.launches
    got = zseqenc.rep_scan(*t)
    want = zseqenc.rep_scan_ref(*t)
    torch.cuda.synchronize()
    assert zseqenc.rep_scan.launches == before + 1
    assert torch.equal(got, want)
    return want


def _hold_fse(chain, dev):
    """The kernel, and the kernel with the clamped re-walk everywhere,
    against the plain version."""
    t = _on(dev, *chain)
    before = zseqenc.fse_chain.launches
    got = zseqenc.fse_chain(*t)
    got_clamped = zseqenc.fse_chain(*t, clamped_only=True)
    want = zseqenc.fse_chain_ref(*t)
    torch.cuda.synchronize()
    assert zseqenc.fse_chain.launches == before + 2
    for k, (a, b, c) in enumerate(zip(got, got_clamped, want)):
        assert torch.equal(a, c) and torch.equal(b, c), k


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 133, 512])
def test_chain_kernels_batches(cuda_device, nb):
    """One block, more blocks than the card has SMs, and the zstd launch's
    512 blocks: the sequences of corpus blocks (the parse of the plain
    finder's matches) through both chain kernels."""
    blocks = np.resize(corpus.corpus_blocks(min(nb, 64), seed=nb + 1),
                       (nb, lzkern.BS))
    t = torch.from_numpy(blocks).to(cuda_device)
    ll, ml, of, _, n, _ = zparse.parse_blocks(
        t, *lzkern.find_matches_blocks_ref(t))
    rep = _hold_rep(of, ll, n, cuda_device)
    pk_ll, pk_of, pk_ml, tables, *_ = zenc2._codes_stage(ll, ml, rep, n)
    _hold_fse((pk_ll, pk_of, pk_ml, n, tables), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", corpus.REP_CLASSES)
def test_rep_kernel_hostile(cuda_device, kind):
    """Small offset alphabets with runs of ll = 0, n_seqs 0-4, MAXSEQ and
    out of range, and blocks with a live offset of 0, -5, INT32_MIN or
    within 3 of INT32_MAX (the serial route; off + 3 wraps as in int32)
    or of INT32_MAX - 3 (the scan) among ordinary blocks."""
    _hold_rep(*corpus.rep_inputs(kind), cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", corpus.FSE_CLASSES)
def test_fse_kernel_hostile(cuda_device, kind):
    """Random deltas and tables at n_seqs 0-4, MAXSEQ, past it and
    negative; a doped RLE stream; a permutation table under which no two
    trajectories meet (the re-walk goes fully serial)."""
    _hold_fse(corpus.fse_inputs(kind), cuda_device)


# ---- hostile inputs for the parse kernels (zparse, emit) -------------------

def _hold_parse(blocks, off, L, dev):
    """zparse at cap 10 and emit at the finder's two caps against their
    plain versions."""
    t = [torch.from_numpy(np.ascontiguousarray(a)).to(dev)
         for a in (blocks, off, L)]
    before = (zparse.parse_blocks.launches, lzemit2.emit_blocks.launches)
    got = [*zparse.parse_blocks(*t)]
    want = [*zparse.parse_blocks_ref(*t)]
    for cap in (lzkern.L_CAP, lzkern.L_CAP_SLIM):
        got += lzemit2.emit_blocks(*t, cap=cap)
        want += lzemit2.emit_blocks_ref(*t, cap=cap)
    torch.cuda.synchronize()
    assert (zparse.parse_blocks.launches, lzemit2.emit_blocks.launches) == (
        before[0] + 1, before[1] + 2)
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), k


@pytest.mark.cuda
@pytest.mark.parametrize("kind", corpus.PARSE_CLASSES)
def test_parse_kernels_hostile_blocks(cuda_device, kind):
    """All zeros (every position chains, the offset-1 probe everywhere),
    long chains at cap 10, the most sequences the gate allows (85 a tile),
    no op at all."""
    blk, off, L = corpus.parse_inputs(kind)
    _hold_parse(blk[None], off[None], L[None], cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 133, 512])
def test_parse_kernels_batches(cuda_device, nb):
    """One block, more blocks than the card has SMs, and the zstd launch's
    512 blocks: corpus blocks with the plain finder's (off, L), the hostile
    parse inputs among them."""
    blocks = np.resize(corpus.corpus_blocks(min(nb, 64), seed=nb),
                       (nb, lzkern.BS))
    t = torch.from_numpy(blocks).to(cuda_device)
    off, L = (a.cpu().numpy() for a in lzkern.find_matches_blocks_ref(t))
    for i, kind in enumerate(corpus.PARSE_CLASSES):
        blocks[(5 * i + 2) % nb], off[(5 * i + 2) % nb], L[(5 * i + 2) % nb] \
            = corpus.parse_inputs(kind)
    _hold_parse(blocks, off, L, cuda_device)


@pytest.mark.cuda
def test_parse_kernels_take_unaligned_inputs(cuda_device, blocks_np):
    """Inputs that do not start on a 16-byte boundary are copied first:
    both parse kernels give their plain versions' outputs."""
    t = torch.from_numpy(blocks_np).to(cuda_device)
    off, L = lzkern.find_matches_blocks(t)

    def shifted(a):
        buf = torch.zeros(a.numel() + 1, dtype=a.dtype, device=cuda_device)
        out = buf[1:].view(a.shape)
        out.copy_(a)
        return out

    t1, off1 = shifted(t), shifted(off)
    assert t1.data_ptr() % 16 and off1.data_ptr() % 16
    got = [*zparse.parse_blocks(t1, off1, L), *lzemit2.emit_blocks(t1, off1, L)]
    want = [*zparse.parse_blocks_ref(t, off, L),
            *lzemit2.emit_blocks_ref(t, off, L)]
    torch.cuda.synchronize()
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), k


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [1, 8, 16, 17, 100, 600, 70000])
def test_parse_kernels_any_cap(cuda_device, cap, blocks_np):
    """zparse and emit at a cap other than the finder's (the run-time cap
    instantiation) against their plain versions: the hostile parse inputs,
    the chains and all-zeros inputs at this cap, and two corpus blocks with
    the plain finder's (off, L)."""
    ins = [corpus.parse_inputs(k) for k in corpus.PARSE_CLASSES]
    ins += [corpus.parse_inputs(k, cap) for k in ("chains", "all_zeros")]
    t = torch.from_numpy(blocks_np[:2])
    off, L = lzkern.find_matches_blocks_ref(t)
    ins += [(blocks_np[i], off[i].numpy(), L[i].numpy()) for i in range(2)]
    blocks, off, L = (torch.from_numpy(np.stack(a)).to(cuda_device)
                      for a in zip(*ins))
    before = (zparse.parse_blocks.any_cap_launches,
              lzemit2.emit_blocks.any_cap_launches)
    got = [*zparse.parse_blocks(blocks, off, L, cap=cap),
           *lzemit2.emit_blocks(blocks, off, L, cap=cap)]
    want = [*zparse.parse_blocks_ref(blocks, off, L, cap=cap),
            *lzemit2.emit_blocks_ref(blocks, off, L, cap=cap)]
    torch.cuda.synchronize()
    assert (zparse.parse_blocks.any_cap_launches,
            lzemit2.emit_blocks.any_cap_launches) == (before[0] + 1,
                                                      before[1] + 1)
    for k, (a, b) in enumerate(zip(got, want)):
        assert torch.equal(a, b), k


@pytest.mark.cuda
@pytest.mark.parametrize("kind", corpus.EXEC_SUM_CLASSES)
def test_exec_rounds_sums_where_a_store_differs(cuda_device, kind):
    """execute_rounds on padded plans that only the reference's sum gets
    right (a plain store would not): the sum kernel, equal to the plain
    version, beside a planner block on the same launch."""
    plan = corpus.exec_sum_plans()[kind]
    planned = corpus.exec_hostile_plans(1)[1]
    src, dst, length, caps = execute.pack_plans([plan, planned])
    lit = np.random.default_rng(3).integers(0, 256, (2, 512, 128), np.uint8)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (lit, src, dst, length)]
    before = execute.execute_rounds.launches
    got = execute.execute_rounds(*args, caps)
    want = execute.execute_rounds_ref(*args, caps)
    torch.cuda.synchronize()
    assert execute.execute_rounds.launches == before + 1
    assert torch.equal(got, want)
    if kind == "literal_half":
        # round 1 adds output bytes 5-8 (literal bytes 8-11) to literal
        # bytes 7-10, which round 2 copies to output bytes 45-48
        lb = lit[0, 0].astype(np.int64)
        assert got[0, 0, 45:49].tolist() == ((lb[7:11] + lb[8:12])
                                             & 255).tolist()


# ---- hostile inputs for the finder and the literal lookup -----------------

def _hold_finder(t, slim):
    got = lzkern.find_matches_blocks(t, slim=slim)
    want = lzkern.find_matches_blocks_ref(t, slim=slim)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("slim", [False, True], ids=["cap10", "slim"])
@pytest.mark.parametrize("kind", corpus.FINDER_CLASSES)
def test_finder_kernel_hostile_blocks(cuda_device, kind, slim):
    """All-zeros (one offset-1 chain), no repeated word, one pair at the
    largest offset (65532), suffix reads past the block end, and every
    digit pass with all positions but one in one bin."""
    blk = torch.from_numpy(corpus.finder_block(kind)[None].copy())
    _hold_finder(blk.to(cuda_device), slim)


@pytest.mark.cuda
@pytest.mark.parametrize("slim", [False, True], ids=["cap10", "slim"])
@pytest.mark.parametrize("nb", [1, 133, 512])
def test_finder_kernel_batches(cuda_device, nb, slim):
    """One block, more than one wave of clusters, and the zstd launch's
    512 blocks; the hostile blocks sit among the corpus blocks."""
    blocks = np.resize(corpus.corpus_blocks(min(nb, 64), seed=nb),
                       (nb, lzkern.BS))
    for i, kind in enumerate(corpus.FINDER_CLASSES):
        blocks[(7 * i + 3) % nb] = corpus.finder_block(kind)
    _hold_finder(torch.from_numpy(blocks).to(cuda_device), slim)


def _hold_litlut(lits, tab):
    before = zenc2._litlut.launches
    got = zenc2._litlut(lits, tab)
    want = zenc2._litlut_ref(lits, tab)
    torch.cuda.synchronize()
    assert zenc2._litlut.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def _litlut_tables(rng, R, dev):
    """Random packed entries over the whole int32 range (the kernel and
    the plain version must agree on the sign of e >> 16 too)."""
    tab = rng.integers(-(1 << 31), 1 << 31, (R, 2, 128), dtype=np.int64)
    return torch.from_numpy(tab.astype(np.int32)).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("bs", [4, 20, 65540])
def test_litlut_kernel_odd_lengths(cuda_device, bs, R):
    """Row lengths that are multiples of 4 but not of 16: scalar heads
    and tails on every row but the first."""
    rng = np.random.default_rng(bs + R)
    lits = torch.from_numpy(rng.integers(0, 256, (R, bs), dtype=np.uint8))
    _hold_litlut(lits.to(cuda_device), _litlut_tables(rng, R, cuda_device))


@pytest.mark.cuda
def test_litlut_kernel_every_byte(cuda_device):
    """Every byte value in every row, each row in its own order."""
    R, bs = 5, 1 << 16
    rng = np.random.default_rng(3)
    lits = np.stack([rng.permutation(np.arange(bs) % 256) for _ in range(R)])
    _hold_litlut(torch.from_numpy(lits.astype(np.uint8)).to(cuda_device),
                 _litlut_tables(rng, R, cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("start", [4, 1])
@pytest.mark.parametrize("bs", [65536, 65540])
def test_litlut_kernel_misaligned_input(cuda_device, start, bs):
    """A contiguous ``lits`` view that starts ``start`` bytes into a larger
    buffer: 4 takes the scalar head and the 16-byte body, 1 (no aligned
    16-byte output possible) the scalar loop alone.  The kernel takes both;
    no ValueError."""
    R = 3
    rng = np.random.default_rng(start)
    buf = torch.from_numpy(rng.integers(0, 256, R * bs + 64, dtype=np.uint8))
    buf = buf.to(cuda_device)
    lits = buf[start:start + R * bs].view(R, bs)
    assert lits.is_contiguous() and lits.data_ptr() % 16 == start
    _hold_litlut(lits, _litlut_tables(rng, R, cuda_device))


# ---- decode: the LZ execute kernel and the huff0 chunk kernel -------------

def _s2_block(ops, n: int) -> bytes:
    """An S2 block of n bytes from (literal bytes, copy length, offset)
    ops: literal tags and 4-byte-offset copy tags (lengths 1-64), which
    reach any offset a block of up to 256 KiB can hold."""
    out = bytearray()
    put_uvarint(out, n)
    for lit, ml, off in ops:
        if lit:
            x = len(lit) - 1
            if x < 60:
                out.append(x << 2)
            else:
                nb = (x.bit_length() + 7) // 8
                out.append((59 + nb) << 2)
                out += x.to_bytes(nb, "little")
            out += lit
        while ml > 0:
            take = min(ml, 64)
            out.append(3 | ((take - 1) << 2))
            out += off.to_bytes(4, "little")
            ml -= take
    return bytes(out)


def _seeded_s2(n: int, seed: int) -> bytes:
    """A seeded S2 block of n bytes: literal runs, overlapping short-offset
    copies (pieces that read the previous round's output) and far copies."""
    rng = np.random.default_rng(seed)
    ops, pos = [], 0
    while pos < n:
        lit = rng.integers(0, 256, int(rng.integers(1, 200)),
                           np.uint8).tobytes()[:n - pos]
        pos += len(lit)
        ml = min(int(rng.integers(1, 2000)), n - pos)
        off = int(rng.choice([1, 2, 3, 7, int(rng.integers(1, pos + 1))]))
        ops.append((lit, ml, min(off, pos)))
        pos += ml
    return _s2_block(ops, n)


@pytest.fixture(scope="module")
def s2_dec_blocks(blocks_np):
    """The port's own encode of every corpus class (64 KiB, M = 1) and
    seeded blocks of every arena class (M = 1, 2 and 4)."""
    hdr = bytearray()
    put_uvarint(hdr, lz2.B)
    bodies = lz2.s2_encode_blocks_kern(torch.from_numpy(blocks_np))
    return ([bytes(hdr) + b for b in bodies]
            + [_seeded_s2(n, n) for n in (5000, 65536, 65537, 131072,
                                          200000, 262144)])


@pytest.mark.cuda
def test_exec_kernel_matches_plain(cuda_device, s2_dec_blocks):
    """``execute_rounds`` of the padded plan: compacted on the card, then
    the sum kernel."""
    _, classes = plan_blocks(s2_dec_blocks)
    assert sorted(c["M"] for c in classes) == [1, 2, 4]
    for c in classes:
        src, dst, length, caps = execute.pack_plans(c["plans"])
        args = [torch.from_numpy(a).to(cuda_device)
                for a in (c["lit_rows"], src, dst, length)]
        before = execute.execute_rounds.launches
        got = execute.execute_rounds(*args, caps)
        want = execute.execute_rounds_ref(*args, caps)
        torch.cuda.synchronize()
        assert execute.execute_rounds.launches == before + 1
        assert torch.equal(got, want), c["M"]


def _hold_pieces(lit, plans, dev):
    """The exec kernel on the compact plan against its plain version and
    the padded plain execute."""
    pieces, rstart = execute.pack_pieces(plans, lit.shape[1])
    args = [torch.from_numpy(a).to(dev) for a in (lit, pieces, rstart)]
    before = execute.execute_pieces.launches
    got = execute.execute_pieces(*args)
    want = execute.execute_pieces_ref(*args)
    padded = execute.pack_plans(plans)
    want_padded = execute.execute_rounds_ref(
        *(torch.from_numpy(a).to(dev) for a in (lit, *padded[:3])),
        padded[3])
    torch.cuda.synchronize()
    assert execute.execute_pieces.launches == before + 1
    assert torch.equal(got, want)
    assert torch.equal(got, want_padded)


@pytest.mark.cuda
def test_exec_pieces_kernel_matches_plain(cuda_device, s2_dec_blocks):
    """The compact plans the S2 decode sends, at M = 1, 2 and 4."""
    _, classes = plan_blocks(s2_dec_blocks)
    assert sorted(c["M"] for c in classes) == [1, 2, 4]
    for c in classes:
        _hold_pieces(c["lit_rows"], c["plans"], cuda_device)


@pytest.mark.cuda
@pytest.mark.parametrize("M", [1, 2, 4])
def test_exec_pieces_kernel_hostile_plans(cuda_device, M):
    """Sources below and past the arena, dst rows outside it, pieces past
    their row end, overlapping copies at periods 1, 2 and 3."""
    plans = corpus.exec_hostile_plans(M)
    lit = np.random.default_rng(M).integers(
        0, 256, (len(plans), 512 * M, 128), np.uint8)
    _hold_pieces(lit, plans, cuda_device)


@pytest.mark.cuda
def test_exec_pieces_kernel_edges(cuda_device):
    """No piece and no round; rstart rows past P and decreasing (every
    round empty after the clamps the plain version applies too) beside a
    valid one; no block."""
    rng = np.random.default_rng(11)
    lit = torch.from_numpy(rng.integers(0, 256, (3, 512, 128), np.uint8))
    pieces, rstart = execute.pack_pieces(corpus.exec_hostile_plans(1)[1:4])
    P = len(pieces)
    rstart[1] = P + 9
    rstart[2, 1:] = rstart[2, 0] - np.arange(1, rstart.shape[1])
    cases = [(np.zeros((0, 2), np.int32), np.zeros((3, 1), np.int32)),
             (pieces, rstart)]
    for pc, rs in cases:
        args = [t.to(cuda_device) for t in (
            lit, torch.from_numpy(pc), torch.from_numpy(rs))]
        got = execute.execute_pieces(*args)
        want = execute.execute_pieces_ref(*args)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    empty = [lit[:0].to(cuda_device), torch.from_numpy(pieces).to(
        cuda_device), torch.zeros((0, 2), dtype=torch.int32,
                                  device=cuda_device)]
    assert execute.execute_pieces(*empty).shape == (0, 512, 128)


@pytest.mark.cuda
def test_exec_kernel_hostile_plans(cuda_device):
    """Pad slots, a round of pads only, a cap of 0, caps past the plan's
    rows, unaligned row-crossing sources and chained rounds."""
    out = execute.OUT_BASE
    plans = [
        dict(src=np.array([5, 200, out + 3, 6], np.int32),
             dst=np.array([out, out + 10, out + 40, out + 56], np.int32),
             len=np.array([10, 20, 7, 6], np.int32),
             round=np.array([0, 0, 1, 0], np.int32), n_rounds=2),
        dict(src=np.array([0, out, out + 64, out + 100], np.int32),
             dst=np.array([out, out + 64, out + 128, out + 250], np.int32),
             len=np.array([64, 64, 64, 100], np.int32),
             round=np.array([0, 1, 2, 3], np.int32), n_rounds=4),
        dict(src=np.zeros(0, np.int32), dst=np.zeros(0, np.int32),
             len=np.zeros(0, np.int32), round=np.zeros(0, np.int32),
             n_rounds=1),
    ]
    src, dst, length, caps = execute.pack_plans(plans)
    pad = np.zeros((64, 3), np.int32)
    src, dst, length = (np.concatenate([a[:64], pad + fill, a[64:]])
                        for a, fill in ((src, 0), (dst, out), (length, 0)))
    caps = (64, 64, 0) + caps[1:] + (100,)
    lit = np.random.default_rng(5).integers(0, 256, (3, 512, 128), np.uint8)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (lit, src, dst, length)]
    got = execute.execute_rounds(*args, caps)
    assert torch.equal(got, execute.execute_rounds_ref(*args, caps))
    assert not got[2].any()
    empty = [args[0][:0]] + [a[:, :0].contiguous() for a in args[1:]]
    assert execute.execute_rounds(*empty, caps).shape == (0, 512, 128)


@pytest.mark.cuda
def test_s2_decode_on_cuda_matches_cpu(cuda_device, s2_dec_blocks, blocks_np):
    stats = {}
    got = s2_decode_blocks_device(s2_dec_blocks, stats=stats)
    assert got == s2_decode_blocks_device(s2_dec_blocks, device="cpu")
    assert got == [s2_block.decode(b) for b in s2_dec_blocks]
    assert got[:len(corpus.CLASSES)] == [b.tobytes() for b in blocks_np]
    assert stats["host"] == 0 and sorted(stats["classes"]) == [1, 2, 4]


def _chunks(nc: int, win: int, k: int, seed: int):
    """Random windows with cursors anywhere in the window (the top
    included) and pad chunks (lbit 8 * win, nsym 0), nsym from 0 to k."""
    rng = np.random.default_rng(seed)
    windows = rng.integers(0, 256, (nc, win), np.uint8)
    lbit = rng.integers(0, 8 * win + 1, nc).astype(np.int32)
    nsym = rng.integers(0, k + 1, nc).astype(np.int32)
    pad = rng.random(nc) < 0.1
    lbit[pad], nsym[pad] = 8 * win, 0
    return windows, lbit, nsym


def _table(max_bits: int, seed: int) -> np.ndarray:
    """A packed table (sym | nb << 8) of random symbols and lengths."""
    rng = np.random.default_rng(seed)
    size = 1 << max_bits
    return (rng.integers(0, 256, size)
            | (rng.integers(1, max_bits + 1, size) << 8)).astype(np.int32)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [32, 20, 7, 64])
@pytest.mark.parametrize("max_bits", [1, 8, 11])
def test_huff0_kernel_shared_matches_plain(cuda_device, k, max_bits):
    chunks = _chunks(1000, entropy_dec.WIN, k, seed=max_bits + k)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (*chunks, _table(max_bits, k))]
    before = entropy_kern.huff0_decode_chunks_shared.launches
    got = entropy_kern.huff0_decode_chunks_shared(*args, k=k,
                                                  max_bits=max_bits)
    want = entropy_kern.huff0_decode_chunks_shared_ref(*args, k=k,
                                                       max_bits=max_bits)
    torch.cuda.synchronize()
    assert entropy_kern.huff0_decode_chunks_shared.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [512, 100, 3])
def test_huff0_kernel_per_container_matches_plain(cuda_device, C):
    """One 2048-entry table per container of C chunks; C = 100 and 3 put
    several containers in one CTA of the kernel."""
    N = 6
    w, lb, ns = _chunks(N * C, entropy_dec.WIN, 32, seed=C)
    rng = np.random.default_rng(C)
    sym = rng.integers(0, 256, (N, 2048))
    nb = rng.integers(1, 12, (N, 2048))
    tables = (sym | nb << 8).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda_device) for a in (
        w.reshape(N, C, -1), lb.reshape(N, C), ns.reshape(N, C), tables)]
    before = entropy_dec.huff0_decode_chunks.launches
    got = entropy_dec.huff0_decode_chunks(*args)
    want = entropy_dec.huff0_decode_chunks_ref(*args)
    torch.cuda.synchronize()
    assert entropy_dec.huff0_decode_chunks.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shared", [True, False], ids=["shared", "table"])
def test_huff0_roundtrip_on_cuda_matches_cpu(cuda_device, shared, blocks_np):
    if shared:       # one code for all rows: text rows, as the bench has
        rng = np.random.default_rng(2)
        rows = np.concatenate([corpus.make_block("text", rng)
                               for _ in range(2)]).reshape(-1, 16384)
    else:
        rows = blocks_np.reshape(-1, 16384)
    max_log = 8 if shared else 11
    conts, accel = huff0.compress_4x_batch(rows, return_accel=True,
                                           shared_table=shared,
                                           max_log=max_log)
    want = huff0.compress_4x_batch(rows, return_accel=True,
                                   shared_table=shared, max_log=max_log,
                                   device="cpu")
    assert conts == want[0] and np.array_equal(accel["ckpt"], want[1]["ckpt"])
    engine = "shared" if shared else "table"
    got = huff0.decompress_4x_batch(conts, accel=accel, engine=engine)
    assert got == huff0.decompress_4x_batch(conts, accel=accel, engine=engine,
                                            device="cpu")
    for row, c, g in zip(rows, conts, got):
        assert g == (None if c is None else row.tobytes())
    assert sum(c is not None for c in conts) >= len(rows) // 2


@pytest.mark.cuda
def test_decode_kernels_reject_bad_inputs(cuda_device):
    lit = torch.zeros((2, 512, 128), dtype=torch.uint8, device=cuda_device)
    z = torch.zeros((64, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        execute.execute_rounds(lit, z.to(torch.int64), z, z, (64,))
    with pytest.raises(ValueError):
        execute.execute_rounds(lit, z.cpu(), z, z, (64,))
    rs = torch.zeros((2, 2), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        execute.execute_pieces(lit, z[:, :1].contiguous(), rs)
    with pytest.raises(ValueError):
        execute.execute_pieces(lit, z.to(torch.int64), rs)
    with pytest.raises(ValueError):
        execute.execute_pieces(lit, z, rs.cpu())
    w, lb, ns = (torch.from_numpy(a).to(cuda_device)
                 for a in _chunks(10, entropy_dec.WIN, 32, seed=0))
    tab = torch.from_numpy(_table(8, 0)).to(cuda_device)
    with pytest.raises(ValueError):
        entropy_kern.huff0_decode_chunks_shared(w, lb, ns, tab, max_bits=9)
    with pytest.raises(ValueError):
        entropy_kern.huff0_decode_chunks_shared(w[:, :50].contiguous(), lb,
                                                ns, tab)
    with pytest.raises(ValueError):
        entropy_kern.huff0_decode_chunks_shared(w, lb.to(torch.int64), ns,
                                                tab)


def _seq_chunks(nc: int, win: int, seed: int, logs=(9, 8, 9)):
    """Random sequence chunks: windows, cursors anywhere in the window (the
    top included), pad chunks (lbit 8 * win, nsym 0), nsym from 0 to 8,
    states below 2^log, repeat offsets with r1 = 1 among them."""
    windows, lbit, nsym = _chunks(nc, win, 8, seed)
    rng = np.random.default_rng(seed + 1)
    states = np.stack([rng.integers(0, 1 << lg, nc) for lg in logs],
                      1).astype(np.int32)
    reps = rng.integers(1, 1 << 17, (nc, 3)).astype(np.int32)
    reps[rng.random(nc) < 0.3, 0] = 1
    return windows, lbit, nsym, states, reps


def _random_table_set(seed: int) -> np.ndarray:
    """A table set of FSE tables from random histograms at the largest
    logs (9, 8, 9), whose codes reach the largest extras (ll 35, ml 52,
    offset 31)."""
    rng = np.random.default_rng(seed)
    rows = []
    for max_sym, log in ((35, 9), (31, 8), (52, 9)):
        hist = rng.integers(1, 50, max_sym + 1)
        norm = fse_core.normalize_count(hist, log, int(hist.sum()), max_sym)
        rows.append(zseq_kern.state_row(*fse_core.build_dtable(norm, log)))
    return zseq_kern.table_set(*rows)


@pytest.mark.cuda
def test_zseq_kernel_shared_matches_plain(cuda_device):
    chunks = _seq_chunks(3000, zseq_kern.WIN, seed=5, logs=(6, 5, 6))
    last = (np.random.default_rng(6).random(3000) < 0.2).astype(np.int32)
    args = [torch.from_numpy(a).to(cuda_device)
            for a in (*chunks, last, zseq_kern.pack_tables())]
    before = zseq_kern.zseq_decode_chunks_shared.launches
    got = zseq_kern.zseq_decode_chunks_shared(*args)
    want = zseq_kern.zseq_decode_chunks_shared_ref(*args)
    torch.cuda.synchronize()
    assert zseq_kern.zseq_decode_chunks_shared.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("C", [512, 100, 3])
@pytest.mark.parametrize("resolve", [False, True], ids=["ofv", "rep"])
def test_zseq_kernel_per_item_matches_plain(cuda_device, C, resolve):
    """One table set per item of C chunks; C = 100 and 3 put several
    items in one CTA of the kernel."""
    N = 5
    w, lb, ns, st, rp = _seq_chunks(N * C, entropy_dec.ZWIN, seed=C)
    nore = np.minimum(ns, np.random.default_rng(C).integers(0, 9, N * C))
    tables = np.stack([_random_table_set(C + i) for i in range(N)])
    t = [torch.from_numpy(a.reshape(N, C)).to(cuda_device)
         for a in (lb, st[:, 0], st[:, 1], st[:, 2], ns,
                   nore.astype(np.int32))]
    wt = torch.from_numpy(w.reshape(N, C, -1)).to(cuda_device)
    tt = torch.from_numpy(tables).to(cuda_device)
    if resolve:
        r = [torch.from_numpy(rp[:, j].reshape(N, C)).to(cuda_device)
             for j in range(3)]
        fn, ref = (entropy_dec.zseq_decode_chunks_rep,
                   entropy_dec.zseq_decode_chunks_rep_ref)
        args = (wt, *t, *r, tt)
    else:
        fn, ref = (entropy_dec.zseq_decode_chunks,
                   entropy_dec.zseq_decode_chunks_ref)
        args = (wt, *t, tt)
    before = fn.launches
    (got, got_e), (want, want_e) = fn(*args), ref(*args)
    torch.cuda.synchronize()
    assert fn.launches == before + 1
    assert torch.equal(got_e, want_e)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_zstd_frame_decode_on_cuda_matches_cpu(cuda_device, blocks_np):
    """Text frames of the port's encoder (own and predefined tables) take
    the device route; the other classes give raw, RLE and non-4X blocks
    that go to the host decoder."""
    rng = np.random.default_rng(4)
    texts = [corpus.make_block("text", rng).tobytes()[:20000]
             for _ in range(4)]
    frames = [zencoder.compress(t, level=1) for t in texts[:2]]
    with zencoder.predef_seq_tables():
        frames += [zencoder.compress(t, level=1) for t in texts[2:]]
    data = texts + [b.tobytes()[:20000] for b in blocks_np[1:4]]
    frames += [zencoder.compress(d, level=1) for d in data[4:]]
    stats = {}
    got = decompress_frames_device(frames, stats=stats)
    assert got == decompress_frames_device(frames, device="cpu") == data
    routes = [zdevice_dec._route(f)[0] for f in frames]
    assert routes[:4] == ["dev"] * 4
    assert stats["routes"] == {k: routes.count(k) for k in set(routes)}


@pytest.mark.cuda
def test_zseq_kernel_rejects_bad_inputs(cuda_device):
    w, lb, ns, st, rp = (torch.from_numpy(a).to(cuda_device) for a in
                         _seq_chunks(10, zseq_kern.WIN, seed=0))
    last = torch.zeros_like(lb)
    tab = torch.from_numpy(zseq_kern.pack_tables()).to(cuda_device)
    with pytest.raises(ValueError):
        zseq_kern.zseq_decode_chunks_shared(w, lb, ns, st, rp, last, tab[:-1])
    with pytest.raises(ValueError):
        zseq_kern.zseq_decode_chunks_shared(w[:, :78].contiguous(), lb, ns,
                                            st, rp, last, tab)
    with pytest.raises(ValueError):
        zseq_kern.zseq_decode_chunks_shared(w, lb.to(torch.int64), ns, st,
                                            rp, last, tab)
    with pytest.raises(ValueError):
        zseq_kern.zseq_decode_chunks_shared(w, lb, ns, st, rp, last,
                                            tab.cpu())


def _huff0_rows(d, per_row: int):
    """The class's tables as one row per ``per_row`` chunks (its own rows
    where it has them, else its table repeated)."""
    nc = d["windows"].shape[0]
    rows = -(-nc // per_row)
    tabs = d["tables"]
    return tabs if len(tabs) == rows else np.repeat(tabs[:1], rows, 0)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", corpus.HUFF0_CLASSES)
def test_huff0_kernel_hostile(cuda_device, kind):
    """Every hostile class through the shared-table entry, the kernel
    with a table per 100 chunks (and per the class's own rows), and,
    where the peek is 11 bits, the per-container entry (the table engine
    and the zstd literals)."""
    d = corpus.huff0_inputs(kind)
    k, mb = d["k"], d["max_bits"]
    w, lb, ns = (torch.from_numpy(d[key]).to(cuda_device)
                 for key in ("windows", "lbit", "nsym"))
    tab0 = torch.from_numpy(d["tables"][0]).to(cuda_device)
    before = entropy_kern.huff0_decode_chunks_shared.launches
    got = entropy_kern.huff0_decode_chunks_shared(w, lb, ns, tab0, k=k,
                                                  max_bits=mb)
    want = entropy_kern.huff0_decode_chunks_shared_ref(w, lb, ns, tab0, k=k,
                                                       max_bits=mb)
    torch.cuda.synchronize()
    assert entropy_kern.huff0_decode_chunks_shared.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    for per_row in sorted({100, d["per_row"]} - {0}):
        tabs = torch.from_numpy(_huff0_rows(d, per_row)).to(cuda_device)
        got = entropy_kern.launch(w, lb, ns, tabs, per_row, k, mb)
        want = entropy_kern.decode_chunks_plain(w, lb, ns, tabs, per_row, k,
                                                mb)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), per_row
        nc = w.shape[0]
        if mb == 11 and nc % per_row == 0:
            N = nc // per_row
            args = (w.view(N, per_row, -1), lb.view(N, per_row),
                    ns.view(N, per_row), tabs)
            before = entropy_dec.huff0_decode_chunks.launches
            got = entropy_dec.huff0_decode_chunks(*args, k=k)
            want = entropy_dec.huff0_decode_chunks_ref(*args, k=k)
            torch.cuda.synchronize()
            assert entropy_dec.huff0_decode_chunks.launches == before + 1
            for a, b in zip(got, want):
                assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", corpus.ZSEQ_CLASSES)
def test_zseq_kernel_hostile(cuda_device, kind):
    """Every hostile class through its entry point (shared, or per item
    with and without the repeat offsets), then the kernel itself at every
    k from 1 to 8, under both repeat-code-3 rules, with one table set and
    with the class's per-row sets, against ``decode_plain``."""
    d = corpus.zseq_inputs(kind)
    t = {key: torch.from_numpy(d[key]).to(cuda_device)
         for key in ("windows", "lbit", "nsym", "states", "reps", "tables")}
    if d["shared"]:
        last = torch.from_numpy(d["last"]).to(cuda_device)
        args = (t["windows"], t["lbit"], t["nsym"], t["states"], t["reps"],
                last, t["tables"][0])
        before = zseq_kern.zseq_decode_chunks_shared.launches
        got = zseq_kern.zseq_decode_chunks_shared(*args)
        want = zseq_kern.zseq_decode_chunks_shared_ref(*args)
        torch.cuda.synchronize()
        assert zseq_kern.zseq_decode_chunks_shared.launches == before + 1
        for a, b in zip(got, want):
            assert torch.equal(a, b)
        nore = t["nsym"] - (last > 0).to(torch.int32)
    else:
        nore = torch.from_numpy(d["nore"]).to(cuda_device)
        C = d["per_row"]
        N = t["lbit"].shape[0] // C
        cols = [x.view(N, C) for x in (t["lbit"], *t["states"].unbind(1),
                                       t["nsym"], nore)]
        cols = [c.contiguous() for c in cols]
        reps = [x.contiguous().view(N, C) for x in t["reps"].unbind(1)]
        wv = t["windows"].view(N, C, -1)
        for fn, ref, extra in (
                (entropy_dec.zseq_decode_chunks_rep,
                 entropy_dec.zseq_decode_chunks_rep_ref, reps),
                (entropy_dec.zseq_decode_chunks,
                 entropy_dec.zseq_decode_chunks_ref, [])):
            before = fn.launches
            (got, got_e) = fn(wv, *cols, *extra, t["tables"])
            (want, want_e) = ref(wv, *cols, *extra, t["tables"])
            torch.cuda.synchronize()
            assert fn.launches == before + 1
            assert torch.equal(got_e, want_e)
            for a, b in zip(got, want):
                assert torch.equal(a, b)
    nore = nore.to(torch.int32).contiguous()
    for per_row, tabs in ((0, t["tables"][:1]),
                          (d["per_row"], t["tables"])):
        for k in range(1, 9):
            for floor in (False, True):
                got = zseq_kern.launch(
                    t["windows"], t["lbit"], t["nsym"], nore,
                    t["states"].unbind(1), t["reps"].unbind(1), tabs,
                    per_row, k, floor)
                want = zseq_kern.decode_plain(
                    t["windows"], t["lbit"], t["nsym"], nore, t["states"],
                    t["reps"], tabs, per_row, k, floor)
                torch.cuda.synchronize()
                for a, b in zip(got, want):
                    assert torch.equal(a, b), (per_row, k, floor)


@pytest.mark.cuda
def test_decode_kernels_one_launch_no_other_work(cuda_device):
    """On int32 inputs the sequence and huff0 entries launch their kernel
    and nothing else (no stack, cast or copy kernel in a profiler trace),
    and their outputs are views of one allocation."""
    from torch.profiler import ProfilerActivity, profile

    d = corpus.zseq_inputs("per_row_300")
    t = {key: torch.from_numpy(d[key]).to(cuda_device)
         for key in ("windows", "lbit", "nsym", "nore", "tables")}
    N, C = len(d["tables"]), d["per_row"]
    cols = [torch.from_numpy(np.ascontiguousarray(x.reshape(N, C))).to(
        cuda_device) for x in (d["lbit"], *d["states"].T, d["nsym"],
                               d["nore"], *d["reps"].T)]
    h = corpus.huff0_inputs("per_row_300")
    hw = [torch.from_numpy(h[key]).to(cuda_device)
          for key in ("windows", "lbit", "nsym", "tables")]
    hn = hw[0].shape[0] // 300
    calls = [lambda: entropy_dec.zseq_decode_chunks_rep(
        t["windows"].view(N, C, -1), *cols, t["tables"]),
        lambda: entropy_dec.huff0_decode_chunks(
            hw[0].view(hn, 300, -1), hw[1].view(hn, 300),
            hw[2].view(hn, 300), hw[3])]
    for call in calls:
        call()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            out = call()
            torch.cuda.synchronize()
        names = {e.name for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA}
        assert len(names) == 1 and "decode_kernel" in names.pop()
        flat = [x for x in (*out[0], out[1]) if x is not None] \
            if isinstance(out[0], tuple) else list(out)
        bases = {x.untyped_storage().data_ptr() for x in flat}
        assert len(bases) == 1


@pytest.mark.cuda
def test_zseq_kernel_repeatable(cuda_device):
    """Tiles that span two table sets and CTAs that keep a set staged for
    their next tile: twenty launches give the plain version's outputs
    each time (a slot restaged while another warp still read it would
    show here)."""
    d = corpus.zseq_inputs("per_row_300")
    reps = 12
    t = {key: torch.from_numpy(np.concatenate([d[key]] * reps)).to(
        cuda_device) for key in ("windows", "lbit", "nsym", "nore", "states",
                                  "reps", "tables")}
    args = (t["windows"], t["lbit"], t["nsym"], t["nore"],
            t["states"].unbind(1), t["reps"].unbind(1), t["tables"], 300, 8,
            True)
    want = zseq_kern.decode_plain(
        t["windows"], t["lbit"], t["nsym"], t["nore"], t["states"],
        t["reps"], t["tables"], 300, 8, True)
    for _ in range(20):
        got = zseq_kern.launch(*args)
        for a, b in zip(got, want):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["rep3_r0_1", "carried_nonpositive"])
def test_zseq_kernel_int32_min_floor(cuda_device, kind):
    """The per-item entry on the chunks that enter with a repeat offset of
    INT32_MIN: repeat code 3 under the floor gives INT32_MAX there (r1 - 1
    wrapped in int32, as the XLA scan), as the plain version does."""
    d = corpus.zseq_inputs(kind)
    enters = (d["reps"] == -(1 << 31)).any(axis=1)
    assert enters.sum() > 10
    C = d["per_row"]
    N = len(d["lbit"]) // C
    cols = [torch.from_numpy(np.ascontiguousarray(x.reshape(N, C))).to(
        cuda_device) for x in (d["lbit"], *d["states"].T, d["nsym"],
                               d["nore"], *d["reps"].T)]
    args = (torch.from_numpy(d["windows"]).to(cuda_device).view(N, C, -1),
            *cols, torch.from_numpy(d["tables"]).to(cuda_device))
    (got, got_e), (want, want_e) = (
        entropy_dec.zseq_decode_chunks_rep(*args),
        entropy_dec.zseq_decode_chunks_rep_ref(*args))
    torch.cuda.synchronize()
    assert torch.equal(got_e, want_e)
    for a, b in zip(got, want):
        assert torch.equal(a, b)
    off = want[3].cpu().numpy().reshape(N * C, -1)[enters]
    if kind == "rep3_r0_1":
        assert (off == (1 << 31) - 1).any()


def _hist_ops_plans(n_blocks: int, hb: int, seed: int) -> list:
    """Plans of a frame of n_blocks seeded 64 KiB blocks (literal runs,
    short and overlapping copies, copies up to the history's far end)
    planned with their history."""
    rng = np.random.default_rng(seed)
    hist_cap = hb << 16
    plans = []
    for k in range(n_blocks):
        avail = min(k << 16, hist_cap)
        kinds, lens, offs, pos = [], [], [], 0
        while True:
            if rng.random() < 0.3 or pos + avail == 0:
                op = (0, int(rng.integers(1, 300)), 0)
            else:
                far = int(rng.integers(1, pos + avail + 1))
                op = (1, int(rng.integers(3, 400)),
                      int(rng.choice([1, 2, 3, far, far])))
            if pos + op[1] > 1 << 16:
                break
            kinds.append(op[0])
            lens.append(op[1])
            offs.append(op[2])
            pos += op[1]
        if k < n_blocks - 1:     # every non-final block makes 64 KiB
            kinds.append(0)
            lens.append((1 << 16) - pos)
            offs.append(0)
        dst, src, ln, rnd = execute.plan_ops(kinds, lens, offs, 4,
                                             execute.OUT_BASE, avail,
                                             hist_cap)
        plans.append(dict(src=src.astype(np.int32), dst=dst.astype(np.int32),
                          len=ln.astype(np.int32),
                          round=rnd.astype(np.int32),
                          n_rounds=int(rnd.max()) + 1 if len(rnd) else 1))
    return plans


def _hold_hist(dev, plans_kb, hb, seed, repeat: int = 1, cluster=None):
    pieces, gstart = execute.pack_pieces_mb(plans_kb, hb << 16)
    K = gstart.shape[1]
    lit = np.random.default_rng(seed).integers(
        0, 256, (len(plans_kb), K, 512, 128), np.uint8)
    args = [torch.from_numpy(a).to(dev) for a in (lit, pieces, gstart)]
    want = execute.execute_blocks_hist_ref(*args, hb * 512)
    before = execute.execute_blocks_hist.launches
    for _ in range(repeat):
        got = execute.execute_blocks_hist(*args, hb * 512, cluster=cluster)
        torch.cuda.synchronize()
        assert torch.equal(got, want)
    assert execute.execute_blocks_hist.launches == before + repeat
    return got


@pytest.mark.cuda
def test_exec_hist_kernel_history_streams(cuda_device):
    """Frames of ``corpus.history_streams`` through the port's multi-block
    accel encode: the kernel on their sidecars' plans."""
    plans_kb = []
    for d in corpus.history_streams(2, 6 << 16, seed=5):
        blob = zaccel.compress_accel(d, level=1, multi_block=True)
        side, _frame = zaccel.split_sidecar(blob)
        hb, accs = zaccel.parse_sidecar(side)
        plans_kb.append([zaccel.accel_plan(a, hb) for a in accs])
    assert hb == 5
    assert any((p["src"] >= execute.HIST_BASE).any()
               for pb in plans_kb for p in pb[1:])
    _hold_hist(cuda_device, plans_kb, hb, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("hb", [1, 5, 8, 128])
def test_exec_hist_kernel_hostile_plans(cuda_device, hb):
    """History reads before and across the frame's start, at the
    history's ends and into a short non-final block's zero tail."""
    _hold_hist(cuda_device, corpus.hist_plans(hb), hb, 2)


@pytest.mark.cuda
def test_exec_hist_kernel_frames_of_1_to_16_blocks(cuda_device):
    plans_kb = [_hist_ops_plans(n, 8, 40 + n) for n in range(1, 17)]
    _hold_hist(cuda_device, plans_kb, 8, 3)


@pytest.mark.cuda
def test_exec_hist_kernel_repeatable(cuda_device):
    """Twenty launches on the same inputs give the plain version's
    outputs each time (a history read that raced the store before it, or
    a remote write that raced the cluster barrier, would show here)."""
    plans_kb = [_hist_ops_plans(n, 2, 60 + n) for n in (3, 9, 12)]
    _hold_hist(cuda_device, plans_kb, 2, 4, repeat=20)


@pytest.mark.cuda
@pytest.mark.parametrize("frames", [1, 8, 40])
def test_exec_hist_kernel_frames_in_a_launch(cuda_device, frames):
    """One frame, phase 21's eight, and forty: more clusters than the
    card holds at once."""
    plans_kb = [_hist_ops_plans(1 + f % 4, 2, 80 + f) for f in range(frames)]
    _hold_hist(cuda_device, plans_kb, 2, 5)


@pytest.mark.cuda
@pytest.mark.parametrize("cluster", [1, 2, 4, 8, 16])
def test_exec_hist_kernel_cluster_sizes(cuda_device, cluster):
    """Every cluster size the card takes gives the plain version's
    output, on the history streams' kind of plan and on hostile ones."""
    plans_kb = [_hist_ops_plans(n, 8, 90 + n) for n in (2, 5, 16)]
    _hold_hist(cuda_device, plans_kb, 8, 6, cluster=cluster)
    _hold_hist(cuda_device, corpus.hist_plans(5), 5, 7, cluster=cluster)


@pytest.mark.cuda
def test_exec_hist_kernel_cluster_choice_and_refusal(cuda_device):
    """The wrapper's cluster size is one the card holds resident, and a
    cluster the card refuses (32 CTAs) raises, as does one that is not a
    power of two; the next launch runs."""
    from compress_tpu_torch import _cuda

    C = exec_kern.HIST_CLUSTER
    assert C in (8, 16)
    assert _cuda.library().ct_exec_hist_clusters(C) >= 1
    assert _cuda.library().ct_exec_hist_occupancy(C) >= 1
    plans_kb = [_hist_ops_plans(3, 2, 95)]
    pieces, gstart = execute.pack_pieces_mb(plans_kb, 2 << 16)
    lit = torch.zeros((1, gstart.shape[1], 512, 128), dtype=torch.uint8,
                      device=cuda_device)
    args = [lit] + [torch.from_numpy(a).to(cuda_device)
                    for a in (pieces, gstart)]
    before = execute.execute_blocks_hist.launches
    with pytest.raises(RuntimeError):
        execute.execute_blocks_hist(*args, 1024, cluster=32)
    with pytest.raises(ValueError):
        execute.execute_blocks_hist(*args, 1024, cluster=3)
    assert execute.execute_blocks_hist.launches == before
    _hold_hist(cuda_device, plans_kb, 2, 8)


@pytest.mark.cuda
def test_exec_hist_kernel_rejects_bad_inputs(cuda_device):
    lit = torch.zeros((2, 3, 512, 128), dtype=torch.uint8,
                      device=cuda_device)
    pieces = torch.zeros((0, 2), dtype=torch.int32, device=cuda_device)
    gstart = torch.zeros((2, 3, 3), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        execute.execute_blocks_hist(lit, pieces, gstart, 256)
    with pytest.raises(ValueError):
        execute.execute_blocks_hist(lit, pieces.to(torch.int64), gstart, 512)
    with pytest.raises(ValueError):
        execute.execute_blocks_hist(lit, pieces, gstart.cpu(), 512)
    assert not execute.execute_blocks_hist(lit, pieces, gstart, 512).any()


@pytest.mark.cuda
def test_accel_routes_on_cuda_make_no_host_walk(cuda_device, monkeypatch):
    """compress_accel streams, single-block and multi-block (histories of
    8 and 2 blocks), decode on the card with no host walk and no host
    frame, through one launch of each literal and execute kernel."""
    texts = [corpus.make_block("text", np.random.default_rng(s)).tobytes()
             for s in range(3)]
    datas = [texts[0][:30000], texts[1]]
    datas += corpus.history_streams(2, 5 << 16, seed=9)
    datas.append(b"".join(texts) + texts[0][:7000])
    blobs = [zaccel.compress_accel(d, level=1) for d in datas[:2]]
    blobs += [zaccel.compress_accel(d, level=1, multi_block=True)
              for d in datas[2:4]]
    blobs.append(zaccel.compress_accel(datas[4], level=1, multi_block=True,
                                       hist_blocks=2))
    items = [it for b in blobs for it in zaccel.split_stream_accel(b)]
    calls = {"walks": 0}

    def counted(fn):
        def f(*a, **kw):
            calls["walks"] += 1
            return fn(*a, **kw)
        return f

    monkeypatch.setattr(zdevice_dec, "_hwalk", counted(zdevice_dec._hwalk))
    monkeypatch.setattr(zseqdev, "seq_accel", counted(zseqdev.seq_accel))
    counters = (entropy_dec.huff0_decode_chunks, execute.execute_pieces,
                execute.execute_blocks_hist)
    before = [f.launches for f in counters]
    host_before = decompress_frames_device.host_frames
    stats = {}
    got = decompress_frames_device(items, stats=stats)
    torch.cuda.synchronize()
    assert [f.launches - b for f, b in zip(counters, before)] == [1, 1, 2]
    assert calls["walks"] == 0
    assert decompress_frames_device.host_frames == host_before
    assert stats["routes"] == {"accel": 2, "accel_mb": 3}
    assert got == datas


def _same(got, want):
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert torch.equal(a, b)


def _fse_enc(cuda_device, blocks, st, dnb, dfs):
    ts = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
          for a in (blocks, st, dnb, dfs)]
    before = entropy.fse_encode_chain.launches
    got = entropy.fse_encode_chain(*ts)
    assert entropy.fse_encode_chain.launches == before + 1
    _same(got, entropy.fse_encode_chain_ref(*ts))
    return ts, got


@pytest.mark.cuda
@pytest.mark.parametrize("kind", corpus.FSE_ENC_CLASSES + ("int32",))
def test_fse_encode_kernel_hostile(cuda_device, kind):
    if kind == "int32":
        rng = np.random.default_rng(5)
        big = np.iinfo(np.int32)
        ins = (rng.integers(0, 256, (5, 2050), dtype=np.uint8),
               *(rng.integers(big.min, big.max, (5, w), dtype=np.int32)
                 for w in (512, 256, 256)))
    else:
        ins = corpus.fse_enc_inputs(kind)
    _fse_enc(cuda_device, *ins)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7, 1025])
def test_fse_encode_kernel_batches(cuda_device, n, blocks_np):
    rows = np.tile(blocks_np.reshape(-1, 16384), (-(-n // 32), 1))[:n]
    t = torch.from_numpy(rows)
    st, dnb, dfs, _ = entropy._fse_tables_bytes(
        entropy.byte_histograms(t), 9)
    _fse_enc(cuda_device, rows, st, dnb, dfs)


@pytest.mark.cuda
def test_fse_encode_kernel_repeatable(cuda_device, blocks_np):
    rows = blocks_np.reshape(-1, 16384)[:32]
    t = torch.from_numpy(rows)
    tabs = entropy._fse_tables_bytes(entropy.byte_histograms(t), 9)[:3]
    ts, first = _fse_enc(cuda_device, rows, *tabs)
    for _ in range(20):
        _same(entropy.fse_encode_chain(*ts), first)


def _fse_routes(cuda_device, blocks, st, dnb, dfs, log=9):
    """The kernel's rows on the one-load step and on the exact step, with
    its output held against the plain version."""
    ts = [torch.from_numpy(np.ascontiguousarray(a)).to(cuda_device)
          for a in (blocks, st, dnb, dfs)]
    routes = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    got = entropy.fse_encode_chain(*ts, log, routes=routes)
    _same(got, entropy.fse_encode_chain_ref(*ts, log))
    return routes.tolist()


@pytest.mark.cuda
@pytest.mark.parametrize("kind", corpus.CLASSES)
def test_fse_encode_kernel_corpus_classes(cuda_device, kind):
    """Rows of 16 KiB of each corpus class take the one-load step."""
    rng = np.random.default_rng(corpus.CLASSES.index(kind) + 3)
    rows = np.stack([corpus.make_block(kind, rng) for _ in range(2)]
                    ).reshape(-1, 16384)
    tabs = entropy._fse_tables_bytes(
        entropy.byte_histograms(torch.from_numpy(rows)), 9)[:3]
    assert _fse_routes(cuda_device, rows, *tabs) == [len(rows), 0]


@pytest.mark.cuda
@pytest.mark.parametrize("kind", corpus.FSE_ENC_CLASSES + ("int32",))
def test_fse_encode_kernel_routes(cuda_device, kind):
    """Real tables take the one-load step, random and clip-edge tables
    the exact one."""
    if kind == "int32":
        rng = np.random.default_rng(6)
        big = np.iinfo(np.int32)
        ins = (rng.integers(0, 256, (5, 2050), dtype=np.uint8),
               *(rng.integers(big.min, big.max, (5, w), dtype=np.int32)
                 for w in (512, 256, 256)))
    else:
        ins = corpus.fse_enc_inputs(kind)
    n = len(ins[0])
    want = [n, 0] if kind in ("corpus", "nb_zero", "short") else [0, n]
    assert _fse_routes(cuda_device, *ins) == want


@pytest.mark.cuda
@pytest.mark.parametrize("L", [2, 18, 16386])
def test_fse_encode_kernel_row_lengths(cuda_device, L):
    """The smallest chain, a chain of 8 steps and one over 9 chunks whose
    last chunk holds two bytes (rows not a multiple of 16: byte copies)."""
    rng = np.random.default_rng(L)
    rows = np.stack([corpus.make_block(c, rng)[:L]
                     for c in ("text", "rand4", "period7")])
    tabs = entropy._fse_tables_bytes(
        entropy.byte_histograms(torch.from_numpy(rows)), 9)[:3]
    assert _fse_routes(cuda_device, rows, *tabs) == [3, 0]


@pytest.mark.cuda
@pytest.mark.parametrize("log", range(1, 13))
def test_fse_encode_kernel_logs(cuda_device, log):
    """Every table log the entry takes, with the tables the port builds
    at that log; rows 16 KiB long (whole chunks, 16-byte copies)."""
    rng = np.random.default_rng(log + 20)
    rows = np.stack([corpus.make_block(c, rng)[:16384]
                     for c in ("text", "rand4", "zeros", "rand256",
                               "period3")])
    tabs = entropy._fse_tables_bytes(
        entropy.byte_histograms(torch.from_numpy(rows)), log)[:3]
    fast, exact = _fse_routes(cuda_device, rows, *tabs, log=log)
    assert fast + exact == len(rows)


def _fse_dec_args(cuda_device, d):
    return [torch.from_numpy(np.ascontiguousarray(d[k])).to(cuda_device)
            for k in ("windows", "lbit", "st1", "st2", "npair", "nore1",
                      "nore2", "tables")]


def _fse_dec(cuda_device, d, k=32):
    args = _fse_dec_args(cuda_device, d)
    before = entropy_dec.fse_decode_chunks.launches
    got = entropy_dec.fse_decode_chunks(*args, k=k)
    assert entropy_dec.fse_decode_chunks.launches == before + 1
    _same(got, entropy_dec.fse_decode_chunks_ref(*args, k=k))
    return args, got


@pytest.mark.cuda
@pytest.mark.parametrize("kind", corpus.FSE_DEC_CLASSES)
def test_fse_decode_kernel_hostile(cuda_device, kind):
    _fse_dec(cuda_device, corpus.fse_dec_inputs(kind))


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 6, 64])
def test_fse_decode_kernel_other_k_and_cursors(cuda_device, k):
    """Other chunk lengths, and cursors far past the window's top and far
    below its bottom."""
    d = corpus.fse_dec_inputs("cursor_edges")
    d["lbit"][0] = np.resize([417, 1000, -5, -300, 1 << 20], d["lbit"][0].size)
    d["npair"][:] = k // 2
    d["nore1"][:] = k // 2
    _fse_dec(cuda_device, d, k)


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 7])
def test_fse_decode_kernel_batches(cuda_device, n):
    d = corpus.fse_dec_inputs("nb_zero")
    reps = -(-n // 3)
    for key in ("windows", "lbit", "st1", "st2", "npair", "nore1", "nore2",
                "tables"):
        d[key] = np.concatenate([d[key]] * reps)[:n]
    _fse_dec(cuda_device, d)


@pytest.mark.cuda
def test_fse_decode_kernel_repeatable(cuda_device):
    args, first = _fse_dec(cuda_device, corpus.fse_dec_inputs("state_edges"))
    for _ in range(20):
        _same(entropy_dec.fse_decode_chunks(*args), first)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [2, 6, 32, 64])
def test_fse_decode_kernel_wild_tables(cuda_device, k):
    """Table entries of any int32 value (nb 10-15, new states outside
    0..511) and cursors past both ends of the window and of int32."""
    d = corpus.fse_dec_inputs(corpus.FSE_DEC_WILD)
    d["npair"] = np.minimum(d["npair"], k // 2)
    _fse_dec(cuda_device, d, k)


FSE_TILE = 256      # chunks a CTA of the chunk decode


def _fse_dec_rows(N: int, C: int, seed: int, dead: str):
    """N rows of C chunks from the nb_zero class, their cursors anywhere
    around the window; ``dead`` "none", "all" or "mixed" (a dead row, a
    row whose first tile is live and the rest dead, a dead tile then
    live ones, single dead chunks)."""
    rng = np.random.default_rng(seed)
    d = corpus.fse_dec_inputs("nb_zero")
    idx = rng.integers(0, d["lbit"].shape[1], (N, C))
    rows = rng.integers(0, d["lbit"].shape[0], (N, C))
    out = {key: d[key][rows, idx] for key in ("windows", "lbit", "st1",
                                              "st2", "npair", "nore1",
                                              "nore2")}
    out["tables"] = d["tables"][rng.integers(0, 3, N)]
    out["lbit"] = rng.integers(-40, 500, (N, C)).astype(np.int32)
    if dead == "all":
        out["npair"][:] = 0
    elif dead == "mixed":
        out["npair"][::3] = 0
        out["npair"][1::3, FSE_TILE:] = 0
        out["npair"][2::3, :FSE_TILE] = 0
        out["npair"][:, 5::7] = 0
    return out


def _fse_routes_want(npair):
    N, C = npair.shape
    dead = sum(min(FSE_TILE, C - c0) for r in range(N)
               for c0 in range(0, C, FSE_TILE)
               if not (npair[r, c0:c0 + FSE_TILE] > 0).any())
    return [dead, N * C - dead]


@pytest.mark.cuda
@pytest.mark.parametrize("C", [1, 255, 257, 512])
@pytest.mark.parametrize("N", [1, 7, 1028])
def test_fse_decode_kernel_rows_and_routes(cuda_device, N, C):
    """Batches of 1, 7 and 1028 rows of 1, 255, 257 and 512 chunks (tiles
    cut short, rows not a multiple of 16 bytes apart at k = 6), rows all
    live, all dead and mixed, with the chunks on each route counted."""
    for dead, k in (("none", 32), ("all", 32), ("mixed", 32), ("mixed", 6)):
        d = _fse_dec_rows(N, C, N * 1000 + C, dead)
        d["npair"] = np.minimum(d["npair"], k // 2)
        args = _fse_dec_args(cuda_device, d)
        routes = torch.zeros(2, dtype=torch.int32, device=cuda_device)
        got = entropy_dec.fse_decode_chunks(*args, k=k, routes=routes)
        _same(got, entropy_dec.fse_decode_chunks_ref(*args, k=k))
        assert routes.tolist() == _fse_routes_want(d["npair"])


@pytest.mark.cuda
def test_fse_decode_kernel_routes_repeatable(cuda_device):
    """Twenty launches of a mixed batch give the same outputs and add the
    same route counts each time."""
    d = _fse_dec_rows(9, 600, 5, "mixed")
    args = _fse_dec_args(cuda_device, d)
    routes = torch.zeros(2, dtype=torch.int32, device=cuda_device)
    first = entropy_dec.fse_decode_chunks(*args, routes=routes)
    _same(first, entropy_dec.fse_decode_chunks_ref(*args))
    for _ in range(20):
        _same(entropy_dec.fse_decode_chunks(*args, routes=routes), first)
    assert routes.tolist() == [21 * v for v in _fse_routes_want(d["npair"])]
    with pytest.raises(ValueError):
        entropy_dec.fse_decode_chunks(*args, routes=routes[:1])


@pytest.mark.cuda
def test_fse_kernels_reject_bad_inputs(cuda_device):
    blocks, st, dnb, dfs = (torch.from_numpy(a).to(cuda_device)
                            for a in corpus.fse_enc_inputs("short"))
    with pytest.raises(ValueError):
        entropy.fse_encode_chain(blocks, st.to(torch.int64), dnb, dfs)
    with pytest.raises(ValueError):
        entropy.fse_encode_chain(blocks[:, :1], st, dnb, dfs)
    args = _fse_dec_args(cuda_device, corpus.fse_dec_inputs("nb_zero"))
    with pytest.raises(ValueError):
        entropy_dec.fse_decode_chunks(*args, k=3)
    args[7] = args[7][:, :256]
    with pytest.raises(ValueError):
        entropy_dec.fse_decode_chunks(*args)


@pytest.mark.cuda
def test_fse_batch_on_cuda_matches_cpu(cuda_device, blocks_np):
    rows = blocks_np.reshape(-1, 16384)[:24]
    enc_before = entropy.fse_encode_chain.launches
    conts = fse.compress_batch(rows)
    assert entropy.fse_encode_chain.launches == enc_before + 1
    assert conts == fse.compress_batch(rows, device="cpu")
    conts += [fse.compress(rows[0].tobytes(), table_log=11), None]
    accel = fse.make_accel(conts)
    dec_before = entropy_dec.fse_decode_chunks.launches
    fse.decompress_batch.host_containers = 0
    out = fse.decompress_batch(conts, accel=accel)
    assert entropy_dec.fse_decode_chunks.launches == dec_before + 1
    assert fse.decompress_batch.host_containers == 1
    want = [None if c is None else r.tobytes()
            for c, r in zip(conts, list(rows) + [rows[0], None])]
    assert out == want
    assert out == fse.decompress_batch(conts, accel=accel, device="cpu")


def _crc(cuda_device, rows, length=None):
    t = torch.from_numpy(np.ascontiguousarray(rows)).to(cuda_device)
    before = checksum.crc32c_batch.launches
    got = checksum.crc32c_batch(t, length)
    assert checksum.crc32c_batch.launches == before + 1
    _same([got], [checksum.crc32c_batch_ref(t, length)])
    return t, got


@pytest.mark.cuda
@pytest.mark.parametrize("n", [1, 31, 255, 256, 257, 512, 513, 1000, 4096,
                               65536, 100000])
def test_crc32c_kernel_matches_plain(cuda_device, n):
    rng = np.random.default_rng(n)
    rows = rng.integers(0, 256, (7, n), dtype=np.uint8)
    rows[1] = 0
    _, got = _crc(cuda_device, rows)
    assert got.tolist() == [_host_crc(r) for r in rows]


def _host_crc(row):
    return crc32c(row.tobytes())


@pytest.mark.cuda
@pytest.mark.parametrize("length", [0, 1, 2, 255, 256, 257, 4097,
                                    65536 - 4097, 65535])
def test_crc32c_kernel_prefix(cuda_device, length):
    rows = np.random.default_rng(length).integers(0, 256, (3, 65536),
                                                  dtype=np.uint8)
    _, got = _crc(cuda_device, rows, length)
    assert got.tolist() == [_host_crc(r[:length]) for r in rows]


@pytest.mark.cuda
def test_crc32c_kernel_batch_of_one_misaligned_and_repeatable(cuda_device):
    rows = np.random.default_rng(2).integers(0, 256, (1, 70001),
                                             dtype=np.uint8)
    t, first = _crc(cuda_device, rows)
    view = t.view(-1)[3:].view(1, -1)      # starts 3 bytes past a line
    got = checksum.crc32c_batch(view, 70000 - 5)
    _same([got], [checksum.crc32c_batch_ref(view, 70000 - 5)])
    strided = t.view(-1)[:70000].view(7, 10000)[:, 3:9001]
    _same([checksum.crc32c_batch(strided)],
          [checksum.crc32c_batch_ref(strided)])
    for _ in range(20):
        _same([checksum.crc32c_batch(t)], [first])


@pytest.mark.cuda
@pytest.mark.parametrize("B,n", [(1, 16 << 20), (257, 4097), (1024, 4096),
                                 (1024, 65536 - 1), (3, 256 * 7 - 1),
                                 (3, 256 * 7 + 1), (3, 256 * 300 - 1),
                                 (3, 256 * 300 + 1)])
def test_crc32c_kernel_batches_and_chunk_edges(cuda_device, B, n):
    """One row of 16 MiB (a thread walks 64 KiB), batches of 257 and 1024
    rows, and lengths one either side of a whole number of 256 chunks;
    twenty repeated launches equal the first."""
    rows = np.random.default_rng(B + n).integers(0, 256, (B, n),
                                                 dtype=np.uint8)
    rows[0, : n // 3] = 0
    t, first = _crc(cuda_device, rows)
    assert first[: min(B, 3)].tolist() == [_host_crc(r) for r in rows[:3]]
    for _ in range(20):
        _same([checksum.crc32c_batch(t)], [first])


def _hist_rows(N, L, seed):
    """N rows of L bytes: the corpus classes, all-zeros and all-255 rows,
    and random bytes."""
    rng = np.random.default_rng(seed)
    rows = rng.integers(0, 256, (N, L), dtype=np.uint8)
    kinds = len(corpus.CLASSES) + 2
    for i in range(min(N, kinds)):
        if i < len(corpus.CLASSES):
            blk = corpus.make_block(corpus.CLASSES[i], rng)
            rows[i] = np.resize(blk, L)
        else:
            rows[i] = 0 if i == len(corpus.CLASSES) else 255
    return rows


def _hist(t, mask=None):
    before = histogram.byte_histograms.launches
    got = histogram.byte_histograms(t, mask)
    assert histogram.byte_histograms.launches == before + 1
    want = histogram.byte_histograms_ref(t, mask)
    _same([got], [want])
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("L", [2, 16383, 16384, 65536])
@pytest.mark.parametrize("N", [1, 7, 1024, 4097])
def test_byte_histograms_kernel_matches_plain(cuda_device, N, L):
    """Every corpus class, all-zeros and all-255 rows and random rows, at
    batch sizes 1, 7, 1024 and 4097 and row lengths 2, 16383, 16 KiB and
    64 KiB; unmasked rows also equal torch.bincount row by row."""
    t = torch.from_numpy(_hist_rows(N, L, N * 7 + L)).to(cuda_device)
    got = _hist(t)
    assert int(got.sum()) == N * L
    for i in range(min(N, 12)):
        assert torch.equal(got[i], torch.bincount(
            t[i], minlength=256).to(torch.int32))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["false", "true", "prefix", "random"])
def test_byte_histograms_kernel_masks(cuda_device, kind):
    """Masks all false, all true, a prefix a row (the literal stage's) and
    random, on rows of 64 KiB (a zeros row puts 65,536 in one bin) and of
    16 KiB + 5, read in place and from views that start 3 bytes in."""
    for N, L in ((9, 65536), (33, 16389)):
        rng = np.random.default_rng(L + len(kind))
        t = torch.from_numpy(_hist_rows(N, L, L)).to(cuda_device)
        if kind == "prefix":
            m = (np.arange(L)[None, :] <
                 rng.integers(0, L + 1, (N, 1))).astype(bool)
            m[0] = True
        else:
            m = {"false": np.zeros((N, L), bool),
                 "true": np.ones((N, L), bool),
                 "random": rng.random((N, L)) < 0.5}[kind]
        mask = torch.from_numpy(m).to(cuda_device)
        got = _hist(t, mask)
        assert int(got.sum()) == int(m.sum())
        # misaligned views of the rows and of the mask, apart and together
        big = torch.zeros((N, L + 8), dtype=torch.uint8, device=cuda_device)
        big[:, 3:3 + L] = t
        bigm = torch.zeros((N, L + 8), dtype=torch.bool, device=cuda_device)
        bigm[:, 5:5 + L] = mask
        _hist(big[:, 3:3 + L], mask)
        _hist(t, bigm[:, 5:5 + L])
        _hist(big[:, 3:3 + L], bigm[:, 5:5 + L])
        bigm[:, 3:3 + L] = mask       # both 3 bytes in: read in place
        _hist(big[:, 3:3 + L], bigm[:, 3:3 + L])


@pytest.mark.cuda
def test_byte_histograms_kernel_views_and_repeats(cuda_device):
    """Rows at a stride that is not a multiple of 16, a transposed (not
    unit-stride) view, an empty batch and empty rows, and twenty repeated
    launches equal to the first."""
    rows = _hist_rows(64, 70000, 5)
    t = torch.from_numpy(rows).to(cuda_device)
    _hist(t[:, 7:16000])
    _hist(t[::3, 1:40001])
    _hist(t[:40, :40].t())
    _hist(t[:, :0])
    assert histogram.byte_histograms(t[:0]).shape == (0, 256)
    first = _hist(t)
    for _ in range(20):
        _same([histogram.byte_histograms(t)], [first])
    with pytest.raises(ValueError):
        histogram.byte_histograms(t.to(torch.int32))
    with pytest.raises(ValueError):
        histogram.byte_histograms(t, torch.ones(3, dtype=torch.bool,
                                                device=cuda_device))


@pytest.mark.cuda
@pytest.mark.parametrize("N", [1, 4097])
def test_byte_histograms_kernel_equal_byte_rows(cuda_device, N):
    """Rows of 65,536 equal bytes (row i all i % 256: 65,536 in one bin, a
    thread's counters merged between passes), unmasked, under an all-true
    and a prefix mask, read in place and from a view 5 bytes in at a row
    stride that is not a multiple of 16; two launches give equal
    outputs."""
    L = 1 << 16
    t = (torch.arange(N, device=cuda_device) % 256).to(torch.uint8)[
        :, None].expand(N, L).contiguous()
    got = _hist(t)
    assert (got.max(dim=1).values == L).all()
    _hist(t, torch.ones_like(t, dtype=torch.bool))
    cut = torch.from_numpy(np.random.default_rng(N).integers(
        0, L + 1, (N, 1))).to(cuda_device)
    prefix = torch.arange(L, device=cuda_device)[None, :] < cut
    _hist(t, prefix)
    big = torch.zeros((N, L + 21), dtype=torch.uint8, device=cuda_device)
    big[:, 5:5 + L] = t
    view = big[:, 5:5 + L]
    _same([_hist(view)], [got])
    bigm = torch.zeros_like(big, dtype=torch.bool)
    bigm[:, 5:5 + L] = prefix
    _hist(view, bigm[:, 5:5 + L])
    _same([histogram.byte_histograms(t)], [histogram.byte_histograms(t)])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [255, 256, 257])
def test_byte_histograms_kernel_one_thread_counts(cuda_device, n):
    """1024 rows of 64 KiB (the kernel's 64 threads a row) whose thread 0
    reads exactly n equal bytes first (of 7, 0 and 255 in turn; ``corpus
    .hist_thread_row``: 256 are its whole first pass, whose first byte
    goes to the totals), unmasked and under an all-true mask, then the
    first 3 rows and the first row alone (other layouts) and a view 3
    bytes in; two launches give equal outputs."""
    vals = (7, 0, 255)
    one = {v: corpus.hist_thread_row(n, value=v, seed=v) for v in vals}
    rows = np.stack([one[vals[i % 3]] for i in range(1024)])
    t = torch.from_numpy(rows).to(cuda_device)
    got = _hist(t)
    assert [int(got[i, v]) for i, v in enumerate(vals)] == [n] * 3
    _hist(t, torch.ones_like(t, dtype=torch.bool))
    _same([_hist(t[:3])], [got[:3]])
    _same([_hist(t[:1])], [got[:1]])
    big = torch.zeros((3, t.shape[1] + 3), dtype=torch.uint8,
                      device=cuda_device)
    big[:, 3:] = t[:3]
    _same([_hist(big[:, 3:])], [got[:3]])
    _same([histogram.byte_histograms(t)], [histogram.byte_histograms(t)])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.uint8, torch.int8, torch.int16,
                                   torch.int32, torch.int64])
def test_histogram256_kernel_dtypes(cuda_device, dtype):
    """Every dtype the kernel reads, with values outside 0..255 (not
    counted), at lengths that cut a 16-byte word, from views that start
    one element in and strided views; twenty repeated launches equal the
    first."""
    info = torch.iinfo(dtype)
    rng = np.random.default_rng(info.bits)
    for n in (1, 15, 4099, (1 << 20) + 3):
        x = rng.integers(max(info.min, -600), min(info.max, 600) + 1, n + 1)
        x[: n // 4] = 0
        t = torch.from_numpy(x).to(dtype).to(cuda_device)
        for v in (t, t[1:], t[::2]):
            before = histogram.histogram256_torch.launches
            got = histogram.histogram256_torch(v)
            assert histogram.histogram256_torch.launches == before + 1
            _same([got], [histogram.histogram256_torch_ref(v)])
    first = histogram.histogram256_torch(t)
    for _ in range(20):
        _same([histogram.histogram256_torch(t)], [first])


@pytest.mark.cuda
def test_histogram256_kernel_zeros_empty_and_bincount(cuda_device):
    """16 MiB of zeros (16,777,216 in one bin), an empty input (one launch,
    all zeros), a 2-D input and the corpus against torch.bincount; a dtype
    the kernel does not read raises."""
    z = torch.zeros(16 << 20, dtype=torch.uint8, device=cuda_device)
    got = histogram.histogram256_torch(z)
    assert int(got[0]) == 16 << 20 and int(got[1:].abs().sum()) == 0
    before = histogram.histogram256_torch.launches
    _same([histogram.histogram256_torch(z[:0])],
          [torch.zeros(256, dtype=torch.int32, device=cuda_device)])
    assert histogram.histogram256_torch.launches == before + 1
    c = torch.from_numpy(corpus.corpus_blocks(64, 3)).to(cuda_device)
    for x in (c, c[:, 5:], c.reshape(-1)[3:]):
        _same([histogram.histogram256_torch(x)],
              [torch.bincount(x.reshape(-1), minlength=256).to(torch.int32)])
    with pytest.raises(ValueError):
        histogram.histogram256_torch(c.to(torch.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [0, 12345, (1 << 64) - 1, 1 << 63],
                         ids=["0", "12345", "2^64-1", "2^63"])
@pytest.mark.parametrize("N", [32, 64, 544, 1024, 1056, 1184, 32768, 65536])
def test_xxh64_kernel_matches_plain(cuda_device, N, seed):
    from compress_tpu_torch.utils.xxhash64 import xxh64

    rows = np.random.default_rng(N).integers(0, 256, (7, N), dtype=np.uint8)
    t = torch.from_numpy(rows).to(cuda_device)
    before = checksum.xxh64_batch.launches
    got = checksum.xxh64_batch(t, seed)
    assert checksum.xxh64_batch.launches == before + 1
    _same([got], [checksum.xxh64_batch_ref(t, seed)])
    assert [lo | hi << 32 for lo, hi in got.tolist()] == \
        [xxh64(r.tobytes(), seed) for r in rows]


@pytest.mark.cuda
def test_xxh64_kernel_batch_of_one_misaligned_and_repeatable(cuda_device):
    rows = np.random.default_rng(3).integers(0, 256, (1, 4096 + 8),
                                             dtype=np.uint8)
    t = torch.from_numpy(rows).to(cuda_device)
    view = t.view(-1)[5:4101].view(1, 4096)
    got = checksum.xxh64_batch(view, 7)
    _same([got], [checksum.xxh64_batch_ref(view, 7)])
    for _ in range(20):
        _same([checksum.xxh64_batch(view, 7)], [got])
    with pytest.raises(ValueError):
        checksum.xxh64_batch(t[:, :48])


@pytest.mark.cuda
@pytest.mark.parametrize("n", [544, 4192, 65536 + 96])
@pytest.mark.parametrize("B", [1, 255, 257, 1024])
def test_xxh64_kernel_stages_and_batches(cuda_device, B, n):
    """Rows whose stripes are not a whole number of the kernel's stages
    (17, 131 and 2051 stripes of 32 bytes) in batches of 1, 255, 257 and
    1024 rows, seeds 0 and 2^64 - 1."""
    from compress_tpu_torch.utils.xxhash64 import xxh64

    rows = np.random.default_rng(B + n).integers(0, 256, (B, n),
                                                 dtype=np.uint8)
    rows[0] = 0
    t = torch.from_numpy(rows).to(cuda_device)
    for seed in (0, (1 << 64) - 1):
        got = checksum.xxh64_batch(t, seed)
        _same([got], [checksum.xxh64_batch_ref(t, seed)])
        assert [lo | hi << 32 for lo, hi in got[:3].tolist()] == \
            [xxh64(r.tobytes(), seed) for r in rows[:3]]


@pytest.mark.cuda
def test_xxh64_kernel_views_not_16_byte_aligned_and_repeatable(cuda_device):
    """A view that starts 8 bytes past a 16-byte boundary (read in place:
    the kernel loads 8-byte words), and twenty launches."""
    rows = np.random.default_rng(4).integers(0, 256, (1, 3 * 4096 + 64),
                                             dtype=np.uint8)
    t = torch.from_numpy(rows).to(cuda_device)
    view = t.view(-1)[8:8 + 2 * (4096 + 544)].view(2, -1)
    assert view.data_ptr() % 16 == 8
    got = checksum.xxh64_batch(view, 3)
    _same([got], [checksum.xxh64_batch_ref(view, 3)])
    for _ in range(20):
        _same([checksum.xxh64_batch(view, 3)], [got])


@pytest.mark.cuda
def test_compress_device_any_length_on_cuda(cuda_device):
    """A sub-job tail and an input shorter than a job: the frames equal
    the CPU ones and decode with the port's host decoder."""
    job = 128 << 10
    data = np.concatenate([corpus.replica_jobs(2, job, 5),
                           corpus.corpus_blocks(3, 5).reshape(-1)[
                               :150001]]).tobytes()
    for n, checksum_on in ((len(data), True), (job // 2 + 7, False),
                           (0, False)):
        frame = zdevice.compress_device(data[:n], job=job,
                                        checksum=checksum_on)
        assert frame == zdevice.compress_device(
            data[:n], job=job, checksum=checksum_on, device="cpu",
            engine="v2")
        assert zstd_host.decompress(frame) == data[:n]


# ---- the two XLA-graph encoders: tile parse, v1 FSE scan, engines ----------

TILE_PARSE_KINDS = ("every_4", "end_at_tile_end", "whole_tile", "raw_random",
                    "s2_path")


def _tile_parse_input(kind: str, tile: int, nb: int = 3) -> np.ndarray:
    """(nb, 8 * tile) int32 L_t: every position 4 (not capped at the tile
    end), matches that end exactly at a tile's end (reached by literals
    and by a jump), L_t = tile at each tile's start and capped values
    elsewhere, raw random values from -5 to tile + 5, and the S2 XLA
    engine's own capped L_t on corpus blocks."""
    bs = 8 * tile
    rng = np.random.default_rng([TILE_PARSE_KINDS.index(kind), tile])
    r = np.arange(bs) % tile
    if kind == "every_4":
        return np.full((nb, bs), 4, np.int32)
    if kind == "end_at_tile_end":
        L = np.zeros((nb, bs), np.int32)
        L[:, r == tile - 20] = 20
        L[1, r == 0] = tile - 20
        L[2, r == 5] = tile - 5
        return L
    if kind == "whole_tile":
        L = np.minimum(rng.integers(0, tile + 1, (nb, bs)), tile - r)
        L[:, r == 0] = tile
        return L.astype(np.int32)
    if kind == "raw_random":
        return rng.integers(-5, tile + 6, (nb, bs)).astype(np.int32)
    blocks = torch.from_numpy(corpus.corpus_blocks(nb, 9))
    take, lit, L_t, off = lz2._find_parse(blocks, tile, level=2)
    return L_t.to(torch.int32).numpy()


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [256, 512])
@pytest.mark.parametrize("kind", TILE_PARSE_KINDS)
def test_tile_parse_kernel_hostile(cuda_device, kind, tile):
    L = torch.from_numpy(_tile_parse_input(kind, tile))
    before = lz2.tile_parse.launches
    got = lz2.tile_parse(L.to(cuda_device), tile)
    want = lz2.tile_parse_ref(L, tile)
    torch.cuda.synchronize()
    assert lz2.tile_parse.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [1, 100, 700])
def test_tile_parse_kernel_other_tiles_and_batches(cuda_device, tile):
    rng = np.random.default_rng(tile)
    for nb in (1, 65):
        L = torch.from_numpy(rng.integers(0, 12, (nb, 3 * tile))
                             .astype(np.int32))
        for a, b in zip(lz2.tile_parse(L.to(cuda_device), tile),
                        lz2.tile_parse_ref(L, tile)):
            assert torch.equal(a.cpu(), b)


def _fse_scan_inputs(seed: int, nj: int = 3, nblk: int = 4,
                     ms: int = 2731, rle=(), hot_of: bool = False,
                     n_seqs=None):
    """The v1 FSE scan's inputs at v1's 16 KiB block: skewed random codes,
    per-job tables of logs 9/8/9 from ``zdev._fse_build`` (each job its
    own); ``rle`` lists (job, stream) pairs made RLE; ``hot_of`` moves
    the of deltas so that clamped indices pass 255 (the padded zeros)."""
    from compress_tpu_torch.ops import zdev

    rng = np.random.default_rng(seed)
    R = nj * nblk
    n = (rng.integers(0, ms + 1, R) if n_seqs is None
         else np.resize(np.asarray(n_seqs), R)).astype(np.int32)
    n_t = torch.from_numpy(n)
    is_seq = torch.arange(ms)[None, :] < n_t[:, None]
    codes = []
    for hi in (36, 21, 53):
        c = np.minimum(rng.geometric(rng.uniform(0.05, 0.5), (R, ms)) - 1,
                       hi - 1)
        codes.append(torch.where(is_seq, torch.from_numpy(c), 0)
                     .to(torch.int32))
    tabs = [zdev._fse_build(c, is_seq, nj, lg)
            for c, lg in zip(codes, zdev.FSE_LOGS)]
    st, dnb, dfs, logs, rle_t = (torch.stack([t[k] for t in tabs], dim=1)
                                 .contiguous()
                                 for k in ("st", "dnb", "dfs", "log", "rle"))
    for j, k in rle:
        rle_t[j, k] = True
        logs[j, k] = 0
    if hot_of:
        dfs[:, 1] += 200
    syms = torch.stack(codes, dim=1).contiguous()
    return syms, n_t, st, dnb, dfs, logs, rle_t


def _hold_fse_scan(dev, args):
    from compress_tpu_torch.ops import zdev

    before = zdev.fse_scan.launches
    got = zdev.fse_scan(*(a.to(dev) for a in args))
    want = zdev.fse_scan_ref(*args)
    torch.cuda.synchronize()
    assert zdev.fse_scan.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)


FSE_SCAN_CASES = {
    "n_seqs_0_1_ms": dict(n_seqs=[0, 1, 2731, 2, 3, 2730]),
    "random_n": dict(),
    "one_rle_stream": dict(rle=[(0, 1)]),
    "two_rle_streams": dict(rle=[(1, 0), (1, 2)]),
    "three_rle_streams": dict(rle=[(2, 0), (2, 1), (2, 2)]),
    "of_index_past_255": dict(hot_of=True),
    "past_ms": dict(n_seqs=[2731 + 5, 2731, 7]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", list(FSE_SCAN_CASES))
def test_fse_scan_kernel_hostile(cuda_device, case):
    args = _fse_scan_inputs(list(FSE_SCAN_CASES).index(case) + 40,
                            **FSE_SCAN_CASES[case])
    _hold_fse_scan(cuda_device, args)


@pytest.mark.cuda
@pytest.mark.parametrize("nj,nblk", [(1, 1), (8, 64), (5, 7)])
def test_fse_scan_kernel_jobs_in_one_launch(cuda_device, nj, nblk):
    """Several jobs with their own tables in one launch (8 x 64 is the
    default geometry's launch), and an odd number of rows a job."""
    args = _fse_scan_inputs(nj * 100 + nblk, nj=nj, nblk=nblk)
    assert nj == 1 or not torch.equal(args[2][0], args[2][1])
    _hold_fse_scan(cuda_device, args)


# The redesigned tile parse and FSE scan against their plain versions, with
# the rows and tiles on each route equal to the CPU models' counts
# (tests/test_torch_tileparse_model.py, tests/test_torch_zdevfse_model.py).


def _parse_routes(dev, L, tile):
    import test_torch_tileparse_model as tp_model

    routes = torch.zeros(2, dtype=torch.int32, device=dev)
    before = lz2.tile_parse.launches
    got = lz2.tile_parse(torch.from_numpy(L).to(dev), tile, routes=routes)
    want = lz2.tile_parse_ref(torch.from_numpy(L), tile)
    torch.cuda.synchronize()
    assert lz2.tile_parse.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    assert tuple(routes.tolist()) == tp_model.model_tile_parse(L, tile)[2]
    return tuple(routes.tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("nb", [1, 65, 256])
@pytest.mark.parametrize("tile", [1, 8, 31, 33, 100, 256, 512, 700, 1024,
                                  2048, 4096])
def test_tile_parse_routes_tiles_and_batches(cuda_device, tile, nb):
    """Tiles on the warp route up to its limit, 2048 positions (the one
    whose CTA needs more than 48 KiB of shared memory), and the chunked
    route past it (4096), in batches of 1, 65 and 256 rows of hostile
    lengths."""
    import test_torch_tileparse_model as tp_model

    kind = tp_model.KINDS[(tile + nb) % len(tp_model.KINDS)]
    rows = tp_model.hostile_lengths(kind, tile, nb=nb)
    L = rows[:, :4 * tile] if tile > 512 else rows
    routes = _parse_routes(cuda_device, np.ascontiguousarray(L), tile)
    n_tiles = L.size // tile
    assert routes == ((n_tiles, 0) if tile <= tp_model.TP_WARP_MAX
                      else (0, n_tiles))


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["raw_random", "near_int32_max"])
def test_tile_parse_whole_block_tile(cuda_device, blocks_np, kind):
    """A tile of the whole 64 KiB block: the chunked route in the kernel
    and through ``s2_encode_blocks``."""
    import test_torch_tileparse_model as tp_model

    L = np.resize(tp_model.hostile_lengths(kind, 256, nb=4), (3, lz2.B))
    assert _parse_routes(cuda_device, L.astype(np.int32), lz2.B) == (0, 3)
    t = torch.from_numpy(blocks_np[:2])
    out, lens = lz2.s2_encode_blocks(t.to(cuda_device), lz2.B, 1)
    want = lz2.s2_encode_blocks(t, lz2.B, 1)
    assert torch.equal(out.cpu(), want[0]) and torch.equal(lens.cpu(),
                                                           want[1])


@pytest.mark.cuda
@pytest.mark.parametrize("tile", [1024, 2048])
def test_s2_xla_engine_long_tiles_on_the_warp_route(cuda_device, blocks_np,
                                                    tile):
    """``s2_encode_blocks`` at the longest tiles of the warp route: the
    engine's parse on the card equals ``tile_parse_ref`` on its own L_t,
    every tile on the warp route, and the bodies equal the CPU's."""
    t = torch.from_numpy(blocks_np)
    take, lit, L_t, _ = lz2._find_parse(t.to(cuda_device), tile, level=1)
    L = L_t.to(torch.int32).cpu()
    want = lz2.tile_parse_ref(L, tile)
    assert torch.equal(take.cpu(), want[0]) and torch.equal(lit.cpu(),
                                                            want[1])
    assert _parse_routes(cuda_device, L.numpy(), tile) == (L.numel() // tile,
                                                           0)
    out, lens = lz2.s2_encode_blocks(t.to(cuda_device), tile, 1)
    want = lz2.s2_encode_blocks(t, tile, 1)
    assert torch.equal(out.cpu(), want[0]) and torch.equal(lens.cpu(),
                                                           want[1])


def _scan_routes(dev, args):
    import test_torch_zdevfse_model as zf_model
    from compress_tpu_torch.ops import zdev

    routes = torch.zeros(2, dtype=torch.int32, device=dev)
    before = zdev.fse_scan.launches
    got = zdev.fse_scan(*(a.to(dev) for a in args), routes=routes)
    want = zdev.fse_scan_ref(*args)
    torch.cuda.synchronize()
    assert zdev.fse_scan.launches == before + 1
    for a, b in zip(got, want):
        assert torch.equal(a.cpu(), b)
    model = zf_model.model_scan(*(a.numpy() for a in args))
    assert tuple(routes.tolist()) == model[3]
    return tuple(routes.tolist())


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["n_seqs_0_1_ms", "random_n",
                                  "three_rle_streams", "of_index_past_255",
                                  "past_ms"])
def test_fse_scan_routes_on_card_test_cases(cuda_device, case):
    import test_torch_zdevfse_model as zf_model

    args = zf_model.scan_inputs(list(zf_model.CASES).index(case) + 40,
                                **zf_model.CASES[case])
    routes = _scan_routes(cuda_device, args)
    assert (routes[1] > 0) == (case == "of_index_past_255")


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["switch", "state", "wrap_nb", "k0"])
def test_fse_scan_exact_route_on_broken_tables(cuda_device, name):
    import test_torch_zdevfse_model as zf_model

    assert _scan_routes(cuda_device, zf_model._broken(name))[1] >= 1


@pytest.mark.cuda
def test_fse_scan_switches_route_chunk_by_chunk(cuda_device):
    import test_torch_zdevfse_model as zf_model

    args = zf_model.scan_inputs(11, nj=1, nblk=2, n_seqs=[2000, 1500])
    args[0][:, 2, :] = torch.where(args[0][:, 2] == 40, 39, args[0][:, 2])
    args[0][0, 2, 1000] = 40
    args[3][0, 2, 40] = zf_model.I32_MAX - 700
    args[4][0, 2, 40] = 0
    assert _scan_routes(cuda_device, args) == (5, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("nj,nblk,uneven", [(8, 64, False), (8, 64, True),
                                            (1, 1, False), (3, 65, True),
                                            (2, 256, True)])
def test_fse_scan_geometries(cuda_device, nj, nblk, uneven):
    """The default launch (8 jobs x 64 blocks), one block, rows a job that
    leave a walk CTA part full (65, 256), and uneven rows: most blocks
    short, a few at or past MS, some empty."""
    import test_torch_zdevfse_model as zf_model

    n_seqs = None
    if uneven:
        rng = np.random.default_rng(nj * nblk)
        n_seqs = np.where(rng.random(nj * nblk) < 0.9,
                          rng.integers(0, 300, nj * nblk),
                          rng.choice([0, 1, 2731, 2740], nj * nblk))
    args = zf_model.scan_inputs(nj + nblk, nj=nj, nblk=nblk, n_seqs=n_seqs)
    routes = _scan_routes(cuda_device, args)
    assert routes == (zf_model._walked_rows(args), 0)


@pytest.mark.cuda
@pytest.mark.parametrize("ms", [2731, 1366])
def test_rep_scan_kernel_v1_shape(cuda_device, ms):
    of, ll, n = (torch.from_numpy(a) for a in corpus.v1_rep_inputs(ms, 3))
    got = zseqenc.rep_scan(*(a.to(cuda_device) for a in (of, ll, n)))
    torch.cuda.synchronize()
    assert torch.equal(got.cpu(), zseqenc.rep_scan_ref(of, ll, n))


@pytest.mark.cuda
def test_new_kernels_reject_bad_inputs(cuda_device):
    from compress_tpu_torch.ops import zdev

    L = torch.zeros((2, 1024), dtype=torch.int32, device=cuda_device)
    with pytest.raises(ValueError):
        lz2.tile_parse(L.to(torch.int64), 512)
    with pytest.raises(ValueError):
        lz2.tile_parse(L, 300)
    args = [a.to(cuda_device) for a in _fse_scan_inputs(1, nj=2, nblk=2)]
    with pytest.raises(ValueError):
        zdev.fse_scan(args[0].to(torch.int64), *args[1:])
    with pytest.raises(ValueError):
        zdev.fse_scan(args[0], args[1].cpu(), *args[2:])
    with pytest.raises(ValueError):
        zdev.fse_scan(args[0][:3], *args[1:])


@pytest.mark.cuda
@pytest.mark.parametrize("tile,level", [(512, 1), (512, 2), (256, 2)])
def test_s2_xla_engine_on_cuda_matches_cpu(cuda_device, blocks_np, tile,
                                           level):
    t = torch.from_numpy(blocks_np)
    before = lz2.tile_parse.launches
    out, lens = lz2.s2_encode_blocks(t.to(cuda_device), tile, level)
    assert lz2.tile_parse.launches == before + 1
    want = lz2.s2_encode_blocks(t, tile, level)
    assert torch.equal(out.cpu(), want[0]) and torch.equal(lens.cpu(),
                                                           want[1])


@pytest.mark.cuda
def test_s2_engine_switch_on_cuda(cuda_device, blocks_np, monkeypatch):
    """COMPRESS_TPU_S2_ENGINE=xla sends the card to the XLA engine, whose
    bodies equal the CPU default's and decode to their blocks."""
    data = blocks_np.tobytes()
    counts = (lz2.tile_parse.launches, lzkern.find_matches_blocks.launches)
    monkeypatch.setenv("COMPRESS_TPU_S2_ENGINE", "xla")
    bodies = lz2.encode_blocks_np(data)
    assert (lz2.tile_parse.launches,
            lzkern.find_matches_blocks.launches) == (counts[0] + 1,
                                                     counts[1])
    assert bodies == lz2.encode_blocks_np(data, device="cpu")
    hdr = bytearray()
    put_uvarint(hdr, lz2.B)
    for i, body in enumerate(bodies):
        assert s2_block.decode(bytes(hdr) + body) == \
            data[i * lz2.B:(i + 1) * lz2.B]


@pytest.mark.cuda
@pytest.mark.parametrize("level", [1, 2, 3])
def test_v1_engine_on_cuda_matches_cpu(cuda_device, level):
    """zstd_encode_jobs at job 64 KiB / block 16 KiB (MS = 2,731) with
    prefixes: every key of the dict equal, one launch of each kernel."""
    from compress_tpu_torch.ops import zdev

    job = 64 << 10
    jobs = np.ascontiguousarray(
        corpus.corpus_blocks(8, 12)[:, :job // 4].reshape(2, job))
    pre = np.zeros((2, job // 8), np.uint8)
    pre[1] = jobs[0, -job // 8:]
    hp = np.array([False, True])
    args = [torch.from_numpy(a) for a in (jobs, pre, hp)]
    fns = (lz2.tile_parse, zseqenc.rep_scan, zdev.fse_scan)
    counts = [f.launches for f in fns]
    got = zdev.zstd_encode_jobs(args[0].to(cuda_device), job=job,
                                block=16 << 10, prefixes=args[1].to(
                                    cuda_device),
                                has_prefix=args[2].to(cuda_device),
                                debug=True, level=level)
    assert [f.launches for f in fns] == [c + 1 for c in counts]
    want = zdev.zstd_encode_jobs(args[0], job=job, block=16 << 10,
                                 prefixes=args[1], has_prefix=args[2],
                                 debug=True, level=level)
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k].cpu(), want[k]), k


@pytest.mark.cuda
def test_compress_device_v1_on_cuda_matches_cpu(cuda_device):
    """engine="v1" on the card gives the CPU default's frame, which
    decodes with the port's host decoder."""
    job, block = 64 << 10, 16 << 10
    data = corpus.corpus_blocks(4, 6).reshape(-1)[:2 * job + 777].tobytes()
    frame = zdevice.compress_device(data, job=job, block=block,
                                    engine="v1", level=3)
    assert frame == zdevice.compress_device(data, job=job, block=block,
                                            device="cpu", level=3)
    assert zstd_host.decompress(frame) == data


# ---- the block-parallel engine on the card --------------------------------

PAR_JOB, PAR_BLOCK = 64 << 10, 16 << 10
PAR_BLOCKS = corpus.corpus_blocks(8, 41)
# 4 jobs and a tail: 2 jobs a rank on 2 ranks
PAR_DATA = corpus.corpus_blocks(4, 42).tobytes() + b"tail" * 1250
PAR_TEXTS = [corpus.make_block("text", np.random.default_rng(43 + i))
             .tobytes()[:30000 + 4000 * i] for i in range(5)]


def _par_items():
    return ([zaccel.compress_accel(t, level=1) for t in PAR_TEXTS[:3]]
            + [zencoder.compress(t, level=2) for t in PAR_TEXTS[3:]]
            + [zaccel.compress_accel(b"".join(corpus.history_streams(
                1, 3 << 16, 44)), level=1, multi_block=True)])


def _par_calls(items):
    from compress_tpu_torch.parallel import engine as pe

    return [(pe.encode_blocks_sharded, (PAR_BLOCKS,), {"level": 1}),
            (pe.encode_blocks_sharded, (PAR_BLOCKS,), {"level": 2}),
            (pe.zstd_encode_sharded, (PAR_DATA,),
             {"job": PAR_JOB, "block": PAR_BLOCK, "level": 2, "stats": {}}),
            (pe.zstd_decode_sharded, (items,), {})]


def _par_run(size: int, backend: str, device: str):
    from compress_tpu_torch.parallel import launch

    items = _par_items()
    return items, launch.run_ranks(launch.run_calls, size, backend, device,
                                   _par_calls(items), timeout=600)


@pytest.fixture(scope="module")
def nccl_world1(cuda_device):
    """One rank over NCCL (``cuda:0``)."""
    return _par_run(1, "nccl", "cuda")


@pytest.fixture(scope="module")
def gloo_two_on_one_card(cuda_device):
    """Two gloo ranks whose kernels both run on ``cuda:0``."""
    return _par_run(2, "gloo", "cuda:0")


def _held_against_unsharded(cuda_device, items, per_rank):
    blocks = torch.from_numpy(PAR_BLOCKS).to(cuda_device)
    for rank_results in per_rank:
        (ebs1, _), (ebs2, _), (frame, _), (dec, _) = rank_results
        for (out, lens), level in ((ebs1, 1), (ebs2, 2)):
            w_out, w_lens = lz2.s2_encode_blocks(blocks, level=level)
            assert torch.equal(out.cpu(), w_out.cpu())
            assert torch.equal(lens.cpu(), w_lens.cpu())
        assert frame == zdevice.compress_device(
            PAR_DATA, job=PAR_JOB, block=PAR_BLOCK, engine="v1", level=2)
        assert zstd_host.decompress(frame) == PAR_DATA
        assert dec == decompress_frames_device(items)
    assert dec == PAR_TEXTS + [zstd_host.decompress(items[-1])]


@pytest.mark.cuda
def test_sharded_world1_nccl_matches_unsharded(cuda_device, nccl_world1):
    """encode_blocks_sharded equals s2_encode_blocks, zstd_encode_sharded
    equals compress_device(engine="v1") and zstd_decode_sharded equals
    decompress_frames_device, on one NCCL rank."""
    items, per_rank = nccl_world1
    _held_against_unsharded(cuda_device, items, per_rank)
    assert per_rank[0][2][1]["halo"] is None


@pytest.mark.cuda
def test_sharded_two_gloo_ranks_on_one_card(cuda_device,
                                            gloo_two_on_one_card):
    """Both ranks return the same outputs, equal to the unsharded calls;
    rank 1 received the tail of rank 0's last job."""
    items, per_rank = gloo_two_on_one_card
    _held_against_unsharded(cuda_device, items, per_rank)
    assert per_rank[0][2][1]["halo"] is None
    assert per_rank[1][2][1]["halo"] == PAR_DATA[
        2 * PAR_JOB - PAR_JOB // 8:2 * PAR_JOB]


# ---- the host core on the card's machine ------------------------------------

@pytest.mark.cuda
def test_host_core_checksums_match_kernels_and_plain(cuda_device,
                                                     blocks_np):
    from compress_tpu_torch.utils import crc as crc_mod
    from compress_tpu_torch.utils import xxhash64 as xxh_mod

    rows = torch.from_numpy(blocks_np.copy()).to(cuda_device)
    crcs = checksum.crc32c_batch(rows).tolist()
    xxs = [lo | hi << 32 for lo, hi in checksum.xxh64_batch(rows, 5).tolist()]
    for r, c, x in zip(blocks_np, crcs, xxs):
        b = r.tobytes()
        assert c == crc_mod.crc32c(b) == crc_mod.crc32c_py(b)
        assert x == xxh_mod.xxh64(b, 5) == xxh_mod.xxh64_py(b, 5)
    whole = blocks_np.tobytes()
    assert crc_mod.crc32c(whole) == crc_mod.crc32c_py(whole)
    assert xxh_mod.xxh64(whole) == xxh_mod.xxh64_py(whole)


@pytest.mark.cuda
def test_host_core_s2_and_plan_match_plain(cuda_device, blocks_np):
    from compress_tpu_torch.s2 import device_dec as s2dd
    from compress_tpu_torch.s2 import plan as s2plan

    bodies = lz2.encode_blocks_np(blocks_np.tobytes())
    for r, body in zip(blocks_np, bodies):
        src = r.tobytes()
        assert s2_block.encode_body(src) == s2_block._encode_block_py(src)
        got = s2dd.native_plan(body, len(src))
        want = s2plan.build_plan(body, len(src))
        assert got[0] == want[0] and got[1] == want[1] and got[5] == want[5]
        assert all(np.array_equal(a, b) for a, b in zip(got[2:5], want[2:5]))
        assert s2_block._decode_block_py(len(src), body, 0) == src


@pytest.mark.cuda
def test_host_core_zstd_matches_plain(cuda_device):
    from compress_tpu_torch.zstd import sidecar

    texts = [corpus.make_block("text", np.random.default_rng(s)).tobytes()
             for s in range(3)]
    for level in (1, 2, 3, 4):
        frame = zencoder.compress(texts[level % 3], level=level,
                                  checksum=level % 2 == 1)
        assert zstd_host.decompress(frame) == texts[level % 3] == \
            zstd_host.decompress_py(frame)
        body = frame[zstd_host.parse_frame_header(frame).header_size:]
        assert zaccel.sidecar_payload(body) == sidecar.build_payload(body)
    frame = zencoder.compress_frame_bs(b"".join(texts), 1, 16, 2 << 16)
    body = frame[zstd_host.parse_frame_header(frame).header_size:]
    assert zaccel.sidecar_payload(body, hist_blocks=2) == \
        sidecar.build_payload(body, hist_blocks=2)
    assert zstd_host.decompress_py(frame) == b"".join(texts)


@pytest.mark.cuda
def test_host_core_assembles_a_v2_job_as_plain(cuda_device):
    job = 2 * zenc2.BLOCK
    data = corpus.replica_jobs(2, job, 3).tobytes()
    src = torch.frombuffer(bytearray(data), dtype=torch.uint8)
    jobs, prefixes, has_prefix = zdevice.launch_inputs(src, 0, 2, job)
    t = zenc2.zstd_encode_jobs_v2(jobs.to(cuda_device), job=job,
                                  prefixes=prefixes.to(cuda_device),
                                  has_prefix=has_prefix.to(cuda_device))
    t = {k: v.cpu().numpy() for k, v in t.items()}
    for j in range(2):
        jb = data[j * job:(j + 1) * job]
        assert zdevice._assemble_job(jb, t, j, zenc2.BLOCK) == \
            zdevice._assemble_job_py(jb, t, j, zenc2.BLOCK)


@pytest.mark.cuda
def test_host_core_entropy_matches_plain(cuda_device, blocks_np):
    from compress_tpu_torch.huff0 import batch as hbatch
    from compress_tpu_torch.huff0 import table as htable

    for r in blocks_np[:4]:
        data = r.tobytes()[:16384]
        buf = np.frombuffer(data, np.uint8)
        hist = np.bincount(buf, minlength=256).astype(np.int64)
        if (hist > 0).sum() < 2:
            continue
        nbits, mb = htable.build_nbits(hist, 11)
        assert np.array_equal(nbits, htable.package_merge_lengths_py(hist,
                                                                     11))
        try:
            table = htable.write_table(nbits, mb)
        except htable.IncompressibleError:
            with pytest.raises(htable.IncompressibleError):
                htable.write_table_py(nbits, mb)
            continue
        assert table == htable.write_table_py(nbits, mb)
        codes = htable.canonical_codes(nbits, mb)
        assert hbatch._encode_stream(buf, codes, nbits) == \
            hbatch._encode_stream_py(buf, codes, nbits)
        try:
            blob = fse.compress(data)
        except ValueError:
            continue
        assert fse.decompress(blob) == fse.decompress_py(blob) == data


# ---- the stream tier around device-made data -------------------------------

@pytest.fixture(scope="module")
def device_s2_stream(cuda_device, blocks_np):
    from compress_tpu_torch.parallel import engine as pe

    data = blocks_np.tobytes() + corpus.corpus_blocks(1, 27).tobytes()[:999]
    return data, pe.s2_stream_encode_device(data)


@pytest.mark.cuda
def test_stream_tier_reads_and_indexes_the_device_s2_stream(
        cuda_device, device_s2_stream):
    """The port's S2 Reader reads the device-made stream back; its index
    finds every chunk and the ReadSeeker reads at seeded offsets."""
    import io

    from compress_tpu_torch.s2 import index as s2_index
    from compress_tpu_torch.s2 import seek as s2_seek
    from compress_tpu_torch.s2 import stream as s2_stream

    data, stream = device_s2_stream
    assert s2_stream.Reader(io.BytesIO(stream)).read() == data
    assert s2_stream.decode_concurrent(stream) == data
    idx = s2_index.index_stream(stream)
    assert idx.total_uncompressed == len(data)
    assert len(idx.entries) == len(data) // (1 << 16) + 1
    rs = s2_seek.ReadSeeker(io.BytesIO(stream), idx)
    for off in np.random.default_rng(30).integers(0, len(data), 8).tolist():
        rs.seek(off)
        assert rs.read(4096) == data[off:off + 4096]


@pytest.mark.cuda
def test_stream_tier_device_decode_of_the_stream_chunks(cuda_device,
                                                        device_s2_stream):
    """The stream's compressed 64 KiB chunks are whole S2 blocks: through
    ``decode_blocks_device`` (one execute launch) they equal the Reader's
    chunks."""
    import io

    from compress_tpu_torch.s2 import stream as s2_stream

    data, stream = device_s2_stream
    r = s2_stream.Reader(io.BytesIO(stream))
    chunks = []
    while True:
        c = r.read(1 << 16)
        if not c:
            break
        chunks.append(c)
    pos, comp = len(s2_stream.MAGIC_CHUNK), []
    k = 0
    while pos < len(stream):
        kind = stream[pos]
        n = int.from_bytes(stream[pos + 1:pos + 4], "little")
        if kind == s2_stream.CHUNK_COMPRESSED:
            comp.append((k, stream[pos + 8:pos + 4 + n]))
        k += kind in (s2_stream.CHUNK_COMPRESSED,
                      s2_stream.CHUNK_UNCOMPRESSED)
        pos += 4 + n
    assert k == len(chunks) and comp
    before = execute.execute_pieces.launches
    out = s2_decode_blocks_device([p for _, p in comp])
    assert execute.execute_pieces.launches > before
    assert [chunks[i] for i, _ in comp] == out


@pytest.mark.cuda
def test_stream_tier_zstd_reader_over_device_frames(cuda_device):
    """``zstd.stream.Reader`` reads ``compress_device``'s frames (v2 on the
    card) in 1 MiB steps, and with a read-ahead thread."""
    import io

    from compress_tpu_torch.zstd import stream as zstd_stream

    data = corpus.replica_jobs(2, 1 << 20, 4).tobytes()
    frames = zdevice.compress_device(data, job=1 << 20)
    r = zstd_stream.Reader(io.BytesIO(frames))
    out = bytearray()
    while True:
        x = r.read(1 << 20)
        if not x:
            break
        out += x
    r.close()
    assert bytes(out) == data
    assert zstd_stream.Reader(io.BytesIO(frames), readahead=2).read() == data
    assert zstd_host.decode_concurrent(frames) == data


# ---- the deflate family and the CLIs around the card ------------------------

@pytest.mark.cuda
def test_s2c_device_equals_the_parallel_engine(cuda_device, blocks_np,
                                                tmp_path):
    """``s2c -device`` on the card writes ``s2_stream_encode_device``'s
    stream and the index ``index_stream`` builds from it; the parallel
    engine's XLA route launches the tile parse; ``s2d -offset`` seeks it."""
    from compress_tpu_torch.cli import s2c, s2d
    from compress_tpu_torch.ops import lz2
    from compress_tpu_torch.parallel import engine as pe
    from compress_tpu_torch.s2.index import index_stream

    data = blocks_np.tobytes() + corpus.corpus_blocks(1, 28).tobytes()[:4321]
    src = tmp_path / "in.bin"
    src.write_bytes(data)
    lz2.tile_parse.launches = 0
    assert s2c.main(["-device", "-q", str(src)]) == 0
    assert lz2.tile_parse.launches >= 1
    stream = pe.s2_stream_encode_device(data)
    got = (tmp_path / "in.bin.s2").read_bytes()
    assert got == stream + index_stream(stream).append_to()
    out = tmp_path / "back"
    for off in (0, 70_000, len(data) - 5):
        assert s2d.main(["-q", "-offset", str(off), "-o", str(out),
                         str(tmp_path / "in.bin.s2")]) == 0
        assert out.read_bytes() == data[off:]


@pytest.mark.cuda
def test_zstdio_accel_decodes_on_the_card(cuda_device, tmp_path):
    """``zstdio -accel`` items decode through ``decompress_frames_device``
    on the accel route: no host walk, no host frame, launches of the
    huff0 chunk and execute kernels."""
    from compress_tpu_torch.cli import zstdio
    from compress_tpu_torch.ops import entropy_dec, execute

    rng = np.random.default_rng(19)
    data = b"".join(corpus.make_block("text", rng).tobytes()
                    for _ in range(16))
    src = tmp_path / "t.bin"
    src.write_bytes(data)
    assert zstdio.main(["-accel", str(src)]) == 0
    blob = (tmp_path / "t.bin.zst").read_bytes()
    items = zaccel.split_stream_accel(blob)
    walks = []
    saved = zdevice_dec._hwalk
    zdevice_dec._hwalk = lambda *a, **k: walks.append(1) or saved(*a, **k)
    try:
        zdevice_dec.decompress_frames_device.host_frames = 0
        entropy_dec.huff0_decode_chunks.launches = 0
        execute.execute_pieces.launches = 0
        stats = {}
        out = decompress_frames_device(items, stats=stats)
    finally:
        zdevice_dec._hwalk = saved
    assert b"".join(out) == data
    assert set(stats["routes"]) == {"accel"} and not walks
    assert zdevice_dec.decompress_frames_device.host_frames == 0
    assert entropy_dec.huff0_decode_chunks.launches >= 1
    assert execute.execute_pieces.launches >= 1
    assert zstdio.main(["-d", "-o", str(tmp_path / "back"),
                        str(tmp_path / "t.bin.zst")]) == 0
    assert (tmp_path / "back").read_bytes() == data


@pytest.mark.cuda
def test_deflate_family_round_trips_on_the_host_core(cuda_device,
                                                     blocks_np):
    """deflate at every level, inflate, the streaming Writer and Reader,
    gzip and zlib on the host core built on the card's machine: every
    stream decodes with stdlib zlib and with the port's plain decoder."""
    import importlib
    import io
    import zlib as stdzlib

    from compress_tpu_torch import gzip as gz
    from compress_tpu_torch import zlib as zl

    D = importlib.import_module("compress_tpu_torch.flate.deflate")
    I = importlib.import_module("compress_tpu_torch.flate.inflate")
    data = blocks_np.tobytes()
    for level in (-2, 0, 1, 6, 9):
        blob = D.deflate(data, level)
        assert stdzlib.decompress(blob, wbits=-15) == data
        assert I.inflate(blob) == data
        assert I.inflate_py(blob) == data
        assert I.Reader(io.BytesIO(blob)).read() == data
    buf = io.BytesIO()
    w = D.Writer(buf, level=6)
    w.write(data[:300_000])
    w.flush()
    w.write(data[300_000:])
    w.close()
    assert stdzlib.decompress(buf.getvalue(), wbits=-15) == data
    assert I.ReaderPy(buf.getvalue()).read() == data
    g = gz.compress(data, 6, header=gz.Header(name="card"))
    assert gz.Reader(g).read() == data and gz.Reader(g).header.name == "card"
    z = zl.compress(data, 9)
    assert stdzlib.decompress(z) == data and zl.Reader(z).read() == data



# ---- rows b and c: the per-row table builds (csrc/tablebuild.cu) ----------


def _hold_huff(dev, hist, maxlog):
    before = zdev._huff_build.launches
    got = zdev._huff_build(hist.to(dev), maxlog)
    assert zdev._huff_build.launches == before + 1
    _same([g.cpu() for g in got], zdev._huff_build_ref(hist.cpu(), maxlog))


def _hold_norm(dev, hist, log):
    before = zdev._normalize_count.launches
    got = zdev._normalize_count(hist.to(dev), log)
    assert zdev._normalize_count.launches == before + 1
    _same([got.cpu()], [zdev._normalize_count_ref(hist.cpu(), log)])


def _huff_rows():
    return np.concatenate([corpus.huff_build_hists(k)
                           for k in corpus.HUFF_BUILD_CLASSES])


@pytest.mark.cuda
@pytest.mark.parametrize("maxlog", [8, 11])
@pytest.mark.parametrize("kind", corpus.HUFF_BUILD_CLASSES)
def test_huff_build_kernel_matches_plain(cuda_device, kind, maxlog):
    h = torch.from_numpy(corpus.huff_build_hists(kind))
    for t in (h, h.to(torch.int64)):
        _hold_huff(cuda_device, t, maxlog)


@pytest.mark.cuda
@pytest.mark.parametrize("maxlog", [1, 2, 5, 12, 15])
def test_huff_build_kernel_other_maxlogs(cuda_device, maxlog):
    _hold_huff(cuda_device, torch.from_numpy(_huff_rows()), maxlog)


@pytest.mark.cuda
@pytest.mark.parametrize("log", [5, 6, 7, 8, 9, 10, 11, 12])
@pytest.mark.parametrize("nsym", [64, 256])
def test_normalize_count_kernel_matches_plain(cuda_device, nsym, log):
    for kind in corpus.NORMALIZE_CLASSES:
        h = torch.from_numpy(corpus.normalize_hists(kind, nsym, log))
        for t in (h, h.to(torch.int64)):
            _hold_norm(cuda_device, t, log)


@pytest.mark.cuda
@pytest.mark.parametrize("nsym", [1, 31, 33, 1000])
def test_normalize_count_kernel_other_widths(cuda_device, nsym):
    rng = np.random.default_rng(nsym)
    h = rng.choice([0, 0, 1, 1, 2, 7, 300], (9, nsym)).astype(np.int32)
    h[0] = 0
    for log in (1, 4, 9, 20):
        _hold_norm(cuda_device, torch.from_numpy(h), log)


@pytest.mark.cuda
@pytest.mark.parametrize("maxlog", list(range(1, 16)))
def test_huff_build_kernel_wide_keys(cuda_device, maxlog):
    """Keys h << l of 2^54 and more in int64 rows
    (``corpus.huff_build_wide_hists``), which the sorted ranks compare
    exactly, and every hostile class in int32 and int64, at every maxlog;
    each row's walk steps equal to the CPU model's."""
    import test_torch_tablebuild_model as tb_model

    wide = corpus.huff_build_wide_hists()
    _hold_huff(cuda_device, torch.from_numpy(wide), maxlog)
    rows = torch.from_numpy(_huff_rows())
    for t in (rows, rows.to(torch.int64)):
        _hold_huff(cuda_device, t, maxlog)
    stats = torch.zeros((len(wide), 2), dtype=torch.int64,
                        device=cuda_device)
    zdev._huff_build(torch.from_numpy(wide).to(cuda_device), maxlog,
                     stats=stats)
    assert np.array_equal(stats[:, 0].cpu().numpy(),
                          tb_model.model_huff_build(wide, maxlog)[3])


@pytest.mark.cuda
@pytest.mark.parametrize("nsym", [1, 63, 64, 255, 256, 1000, 1024])
def test_normalize_count_kernel_widths(cuda_device, nsym):
    """NSYM 1 to 1024 (both CTA sizes, part-full runs): counts whose totals
    and remainders pass 2^54 (``corpus.normalize_wide_hists``, int64) at
    logs 1-30, and the deficit, ties and surplus classes in int32 and
    int64; each row's deficit steps equal to the CPU model's."""
    import test_torch_tablebuild_model as tb_model

    for log in (1, 5, 7, 9, 20, 30):
        wide = corpus.normalize_wide_hists(nsym, log)
        _hold_norm(cuda_device, torch.from_numpy(wide), log)
        stats = torch.zeros((len(wide), 2), dtype=torch.int64,
                            device=cuda_device)
        zdev._normalize_count(torch.from_numpy(wide).to(cuda_device), log,
                              stats=stats)
        assert np.array_equal(stats[:, 0].cpu().numpy(),
                              tb_model.model_normalize_count(wide, log)[1])
    # totals just below 2^21 at log 20: the last rows of the 32-bit packed
    # route
    rng = np.random.default_rng(nsym)
    top = rng.integers(0, (1 << 21) // nsym, (6, nsym)).astype(np.int64)
    top[:, 0] += (1 << 21) - 1 - top.sum(axis=1)
    top[1] = 0
    top[1, -1] = (1 << 21) - 1
    _hold_norm(cuda_device, torch.from_numpy(top), 20)
    if nsym < 2:
        return
    for log in (5, 9, 12):
        h = torch.from_numpy(np.concatenate(
            [corpus.normalize_hists(k, nsym, log)
             for k in ("deficit", "ties", "surplus")]))
        for t in (h, h.to(torch.int64)):
            _hold_norm(cuda_device, t, log)


@pytest.mark.cuda
def test_table_build_kernels_on_the_paths_counts(cuda_device, monkeypatch):
    """The counts that the four paths build tables of, captured on their
    way to the kernels: the v2 literal stage's and codes stage's (one
    4 MiB job), the v1 engine's per-block literals and per-job codes
    (level 2), the huff0 encoder's per-row and batch-wide counts and the
    FSE batch encoder's per-row counts; each kernel equals its plain
    version on every one."""
    calls = {"huff": [], "norm": []}

    def spy(key, orig):
        def f(*args, **kw):
            calls[key].append((args, kw))
            return orig(*args, **kw)
        f.launches = orig.launches
        return f

    huff_build, normalize_count = zdev._huff_build, zdev._normalize_count
    for mod in (zdev, zenc2, entropy):
        monkeypatch.setattr(mod, "_huff_build", spy("huff", huff_build))
    for mod in (zdev, entropy):
        monkeypatch.setattr(mod, "_normalize_count",
                            spy("norm", normalize_count))
    data = corpus.replica_jobs(1, 4 << 20, 6).tobytes()
    zdevice.compress_device(data)
    zdevice.compress_device(data[:2 << 20], engine="v1", level=2)
    rows = corpus.corpus_blocks(4, 2).reshape(-1, 1 << 14)
    huff0.compress_4x_batch(rows, shared_table=True, max_log=8)
    huff0.compress_4x_batch(rows, max_log=11)
    fse.compress_batch(rows)
    torch.cuda.synchronize()
    monkeypatch.undo()
    assert len(calls["huff"]) == 4 and len(calls["norm"]) == 3 + 3 + 1
    for args, kw in calls["huff"]:
        assert args[0].is_cuda
        _hold_huff(cuda_device, args[0], kw.get("maxlog", 11))
    for (hist, log), _ in calls["norm"]:
        assert hist.is_cuda
        _hold_norm(cuda_device, hist, log)


@pytest.mark.cuda
def test_table_build_walks_equal_the_models(cuda_device):
    """Each row's walk steps (``stats``) equal the numpy models' count
    (``tests/test_torch_tablebuild_model.py``): the kernels stop their
    walks and passes where the models do."""
    import test_torch_tablebuild_model as tb_model

    h = _huff_rows()
    for maxlog in (8, 11):
        stats = torch.zeros((len(h), 2), dtype=torch.int64,
                            device=cuda_device)
        zdev._huff_build(torch.from_numpy(h).to(cuda_device), maxlog,
                         stats=stats)
        st = stats.cpu().numpy()
        assert np.array_equal(st[:, 0],
                              tb_model.model_huff_build(h, maxlog)[3])
        assert (st[:, 1][st[:, 0] > 0] > 0).all()
    for nsym in (64, 256):
        n = np.concatenate([corpus.normalize_hists(k, nsym, 9)
                            for k in corpus.NORMALIZE_CLASSES])
        stats = torch.zeros((len(n), 2), dtype=torch.int64,
                            device=cuda_device)
        zdev._normalize_count(torch.from_numpy(n).to(cuda_device), 9,
                              stats=stats)
        st = stats.cpu().numpy()
        assert np.array_equal(st[:, 0],
                              tb_model.model_normalize_count(n, 9)[1])
        assert (st[:, 1][st[:, 0] > 0] > 0).all()


@pytest.mark.cuda
def test_table_build_kernels_one_launch_no_sync(cuda_device):
    """A call is one launch of its kernel (its launch counter) and no other
    device work (the ATen operations it dispatches are its output
    allocations alone), with no host sync (PyTorch's sync debug mode
    raises on one), and twenty calls give the same outputs."""
    from torch.utils._python_dispatch import TorchDispatchMode

    class _Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.seen = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.seen.append(str(func))
            return func(*args, **(kwargs or {}))

    h = torch.from_numpy(np.concatenate([_huff_rows()] * 64)).to(
        cuda_device, torch.int64)
    n = torch.from_numpy(corpus.normalize_hists("deficit", 256, 9)).to(
        cuda_device)
    calls = [(zdev._huff_build, lambda: zdev._huff_build(h, 11)),
             (zdev._normalize_count, lambda: [zdev._normalize_count(n, 9)])]
    for fn, call in calls:
        first = call()
        torch.cuda.synchronize()
        before = fn.launches
        ops = _Ops()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with ops:
                call()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        assert fn.launches == before + 1
        assert ops.seen and set(ops.seen) == {"aten.empty.memory_format"}
        for _ in range(20):
            _same(call(), first)


@pytest.mark.cuda
def test_table_build_kernels_reject_bad_inputs(cuda_device):
    h = torch.zeros((3, 256), dtype=torch.int64, device=cuda_device)
    for bad in (h.to(torch.int16), h[:, :255], h[0]):
        with pytest.raises(ValueError):
            zdev._huff_build(bad)
    for maxlog in (0, 16):
        with pytest.raises(ValueError):
            zdev._huff_build(h, maxlog)
    for stats in (torch.zeros((3, 2), dtype=torch.int64),
                  torch.zeros((3, 1), dtype=torch.int64, device=cuda_device),
                  torch.zeros((3, 2), dtype=torch.int32, device=cuda_device)):
        with pytest.raises(ValueError):
            zdev._huff_build(h, 11, stats=stats)
        with pytest.raises(ValueError):
            zdev._normalize_count(h, 9, stats=stats)
    for bad, log in ((h.to(torch.uint8), 9), (h, 0), (h, 31),
                     (torch.zeros((2, 1025), dtype=torch.int64,
                                  device=cuda_device), 9)):
        with pytest.raises(ValueError):
            zdev._normalize_count(bad, log)
    before = (zdev._huff_build.launches, zdev._normalize_count.launches)
    out = zdev._huff_build(h[:0])
    assert [tuple(t.shape) for t in out] == [(0, 256), (0,), (0,)]
    assert zdev._normalize_count(h[:0], 9).shape == (0, 256)
    assert (zdev._huff_build.launches,
            zdev._normalize_count.launches) == before
