"""The port's batched zstd frame decode
(``compress_tpu_torch/zstd/device_dec.py``) against the JAX package's
``decompress_frames_device`` on the CPU, byte for byte: one mixed batch of
plain frames (JAX native levels 1-4, ``zstandard``, the port's encoder
with and without predefined tables), accel frames (``compress_accel``), a
frame whose sidecar fails its CRC (plain route), raw, RLE and multi-block
frames (host route, counted in ``host_frames``) and multi-block accel
frames of JAX's and of the port's ``compress_accel`` (the history
executor)."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")
zstandard = pytest.importorskip("zstandard")
import torch  # noqa: E402

from compress_tpu import zstd as jax_z  # noqa: E402
from compress_tpu.zstd import device_dec as jax_dd  # noqa: E402
from compress_tpu.zstd import seqdev as jax_sd  # noqa: E402
from compress_tpu.zstd import seqs as jax_s  # noqa: E402
from compress_tpu_torch import corpus  # noqa: E402
from compress_tpu_torch.zstd import accel as A  # noqa: E402
from compress_tpu_torch.zstd import encoder as E  # noqa: E402
from compress_tpu_torch.zstd import seqdev as SD  # noqa: E402
from compress_tpu_torch.zstd.device_dec import (  # noqa: E402
    _route, decompress_frames_device)
from test_torch_jaxref import jax_native_core  # noqa: E402,F401


def _block(cls, n, seed):
    return corpus.make_block(cls, np.random.default_rng(seed)).tobytes()[:n]


def _corrupt_sidecar(blob: bytes) -> bytes:
    """Flip a payload byte of the leading sidecar: its CRC fails."""
    bad = bytearray(blob)
    bad[20] ^= 0x40
    return bytes(bad)


@pytest.fixture(scope="module")
def batch():
    """(items, inputs, expected route per item)."""
    items, datas, routes = [], [], []

    def add(frame, data, route):
        items.append(frame)
        datas.append(data)
        routes.append(route)

    for level in (1, 2, 3, 4):
        d = _block("text", 9000 + 2000 * level, level)
        add(jax_z.compress(d, level=level, checksum=level % 2 == 0), d, "dev")
    d = _block("text", 12000, 5)
    add(zstandard.ZstdCompressor(level=3).compress(d), d, "dev")
    d = _block("text", 16000, 6)
    add(E.compress(d, level=1), d, "dev")
    with E.predef_seq_tables():
        add(E.compress(d, level=2), d, "dev")
    d = _block("text", 20000, 7)
    acc = jax_z.compress_accel(d, level=1)
    add(acc, d, "accel")
    add(_corrupt_sidecar(acc), d, "dev")
    d = _block("rand256", 8000, 8)
    add(E.compress(d, level=1), d, "host")                 # raw block
    d = bytes(9000)
    add(E.compress(d, level=1), d, "host")                 # RLE literals
    d = b"".join(_block("text", 65536, s) for s in range(2)) + bytes(3000)
    add(E.compress(d, level=1), d, "host")                 # two blocks
    d = b"".join(_block("text", 65536, 10 + s) for s in range(2))
    add(jax_z.compress_accel(d, level=1, multi_block=True), d, "accel_mb")
    d = b"".join(_block("text", 65536, 20 + s) for s in range(2)) + d[:5000]
    add(A.compress_accel(d, level=1, multi_block=True), d, "accel_mb")
    return items, datas, routes


def test_decode_matches_jax_and_input(batch):
    items, datas, routes = batch
    before = decompress_frames_device.host_frames
    stats = {}
    got = decompress_frames_device(items, device="cpu", stats=stats)
    assert [_route(f)[0] for f in items] == routes
    assert got == datas
    assert got == jax_dd.decompress_frames_device(items)
    n_host = routes.count("host")
    assert decompress_frames_device.host_frames - before == n_host
    assert stats["host_frames"] == n_host
    assert stats["routes"] == {r: routes.count(r) for r in set(routes)}
    assert set(stats["s"]) >= {"lit_walk", "seq_walk", "exec", "host"}


def test_chunked_batches_match(batch, monkeypatch):
    items, datas, _ = batch
    from compress_tpu_torch.zstd import device_dec as DD

    monkeypatch.setattr(DD, "MAX_DEC_BATCH", 4)
    assert decompress_frames_device(items, device="cpu") == datas


@pytest.mark.parametrize("resolve", [False, True], ids=["ofv", "rep"])
def test_decode_sequences_device_matches_jax(batch, resolve):
    items, _, routes = batch
    seq = [_route(f)[1][4] for f, r in zip(items, routes) if r == "dev"]
    jseq = [(st, n, *(jax_s.STable(t.norm, t.log, t.mode, t.rle_symbol)
                      for t in tabs)) for st, n, *tabs in seq]
    got = SD.decode_sequences_device(seq, resolve=resolve, device="cpu")
    want = jax_sd.decode_sequences_device(jseq, resolve=resolve)
    for g, w in zip(got, want):
        assert len(g) == len(w)
        for x, y in zip(g, w):
            assert np.array_equal(x, y)


def test_no_device_raises_without_cuda(batch, monkeypatch):
    items, _, _ = batch
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        decompress_frames_device(items[:2])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        SD.decode_sequences_device([])
