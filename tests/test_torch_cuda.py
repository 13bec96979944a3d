"""Card-only tests of the port's CUDA kernels (marker ``cuda``).

Each kernel is held against its plain PyTorch version on the same CUDA
tensors, bit for bit (tolerance 0: integers and bytes), on one block of
every seeded corpus class (the zstd kernels also on a replica job, whose
long-range matches reach past the block).  Without a card every test
here skips.

The file imports neither JAX nor the JAX package, so it also runs on a
machine that has only PyTorch and the CUDA toolkit:
``python -m pytest --noconftest -m cuda tests/test_torch_cuda.py``."""

import numpy as np
import pytest
import torch

from compress_tpu_torch import corpus
from compress_tpu_torch.ops import lz2, lzemit2, lzkern, zenc2, zparse, zseqenc
from compress_tpu_torch.zstd import device as zdevice


@pytest.fixture
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
def test_finder_kernel_matches_plain(slim, blocks_np, cuda_device):
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
def test_emit_kernel_matches_plain(slim, blocks_np, cuda_device):
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
def test_encode_on_cuda_matches_cpu(blocks_np, cuda_device):
    data = blocks_np.tobytes()
    assert lz2.encode_blocks_np(data) == lz2.encode_blocks_np(
        data, device="cpu")


@pytest.mark.cuda
def test_kernels_reject_bad_inputs(blocks_np, cuda_device):
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
def test_zstd_kernels_match_plain(zstd_data, blocks_np, cuda_device):
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
def test_compress_device_on_cuda_matches_cpu(zstd_data, cuda_device):
    assert zdevice.compress_device(zstd_data, job=ZJOB) == \
        zdevice.compress_device(zstd_data, job=ZJOB, device="cpu")


@pytest.mark.cuda
def test_zstd_kernels_reject_bad_inputs(zstd_data, cuda_device):
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
