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
``corpus.history_streams``, on ``corpus.hist_plans`` (histories of 1 and
128 blocks), on a group of frames of 1 to 16 blocks and in twenty
repeated launches, with the accel and multi-block accel decode routes
end to end; the FSE batch encode chain and chunk decode on
``corpus.fse_enc_inputs`` / ``corpus.fse_dec_inputs`` (and tables of any
int32 value), batches of 1 and 7 rows and twenty repeated launches, with
``fse.compress_batch`` / ``decompress_batch`` end to end; CRC-32C and
xxHash64 on rows of many lengths, prefixes, seeds, batches of 1 and 7 and
misaligned rows; ``compress_device`` on inputs that are not whole
jobs; and the two XLA-graph encoders: the tile parse on hostile lengths
(every position 4, matches that end at a tile's end, whole-tile matches,
raw values, the S2 engine's own) at tiles 256 and 512 and others, the v1
FSE scan on n_seqs of 0, 1 and MS, one to three RLE streams, an of table
whose clamped index passes 255 and several jobs' tables in one launch,
the repeat scan at v1's shapes, and both engines and ``compress_device``
's v1 on the card against the CPU.
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
                                    entropy_kern, execute, lz2, lzemit2,
                                    lzkern, zenc2, zparse, zseq_kern,
                                    zseqenc)
from compress_tpu_torch.s2 import block as s2_block
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
    assert stats["routes"]["dev"] == 4


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


def _hold_hist(dev, plans_kb, hb, seed, repeat: int = 1):
    pieces, gstart = execute.pack_pieces_mb(plans_kb, hb << 16)
    K = gstart.shape[1]
    lit = np.random.default_rng(seed).integers(
        0, 256, (len(plans_kb), K, 512, 128), np.uint8)
    args = [torch.from_numpy(a).to(dev) for a in (lit, pieces, gstart)]
    want = execute.execute_blocks_hist_ref(*args, hb * 512)
    before = execute.execute_blocks_hist.launches
    for _ in range(repeat):
        got = execute.execute_blocks_hist(*args, hb * 512)
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
@pytest.mark.parametrize("hb", [1, 128])
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
    outputs each time (a history read that raced the store before it
    would show here)."""
    plans_kb = [_hist_ops_plans(n, 2, 60 + n) for n in (3, 9, 12)]
    _hold_hist(cuda_device, plans_kb, 2, 4, repeat=20)


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
@pytest.mark.parametrize("n", [1, 7])
def test_fse_encode_kernel_batches(cuda_device, n, blocks_np):
    rows = blocks_np.reshape(-1, 16384)[:n]
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
