"""The port's block-parallel engine (compress_tpu_torch/parallel) against
the JAX package's ``parallel`` on the CPU, with tolerance 0 (bytes and
integers).

The port's ranks are real processes: one group of 1, 2 and 4 gloo ranks
(``parallel.launch.run_ranks``, a ``file://`` rendezvous) runs every case
of this module once, and each test holds one case's results against JAX
on a mesh of the same size (``Mesh(jax.devices()[:size])`` over the 8
virtual CPU devices of tests/conftest.py) and holds every rank's result
equal:

- ``encode_blocks_sharded`` (levels 1 and 2, tile 256, 4 KiB blocks) and
  ``encode_step_stats``: ``out``, ``lens`` and ``total`` equal JAX's;
- ``s2_stream_encode_device`` with a mesh remainder block and a tail:
  equal to JAX's stream, read back by the JAX package's S2 Reader and by
  the port's own Reader, and indexed by the port's ``index_stream``
  equal to the JAX package's;
- ``zstd_encode_sharded`` at job 8 KiB / block 4 KiB, levels 1-3, with
  and without the checksum, on a multiple of size x job, on inputs whose
  leftover jobs go to the host matcher (with the window widened to them
  at size 4), below one job and empty: equal to JAX's frame (where the
  frame is the host encoder's, below one job, the port's Matcher path
  against JAX's with its native core patched out, and the ranks' frame,
  the ladder's, against JAX's unpatched), decoded by ``zstandard`` and
  the port's ``zstd.decompress``; the halo bytes each rank received;
- ``zstd_decode_sharded`` on 11 mixed accel and plain items and on
  multi-block accel streams: equal to JAX's and to the inputs;
- ``decode_blocks_device`` and ``zstd.decompress_accel`` with a mesh:
  equal to the calls without one;
- the dryrun twin ``parallel.dryrun.dryrun_multichip``.

Then: a one-rank mesh with no process group, ``shard_items``'s layout,
``block_mesh`` refusing NCCL with more ranks than cards, no card and no
device raising, a rank that raises failing the run, and the package-level
``zstd.compress_accel`` / ``decompress_accel`` against JAX's.  The run of
each group is bounded by ``run_ranks``'s own timeout, which kills the
ranks."""

import io
import types

import numpy as np
import pytest

jax = pytest.importorskip("jax")
zstandard = pytest.importorskip("zstandard")
import torch  # noqa: E402
from jax.sharding import Mesh  # noqa: E402

from compress_tpu import zstd as jax_zstd  # noqa: E402
from compress_tpu.parallel import engine as J  # noqa: E402
from compress_tpu.s2 import index as jax_index  # noqa: E402
from compress_tpu.s2.stream import Reader  # noqa: E402
from compress_tpu.zstd import encoder as jax_enc  # noqa: E402
from compress_tpu_torch import corpus, s2  # noqa: E402
from compress_tpu_torch import zstd as Z  # noqa: E402
from compress_tpu_torch.parallel import dryrun, launch  # noqa: E402
from compress_tpu_torch.parallel import engine as PE  # noqa: E402
from compress_tpu_torch.s2 import device_dec as SD  # noqa: E402
from compress_tpu_torch.s2 import index as S2I  # noqa: E402
from compress_tpu_torch.s2 import stream as S2S  # noqa: E402
from compress_tpu_torch.zstd import accel as A  # noqa: E402
from compress_tpu_torch.zstd import device as ZD  # noqa: E402
from compress_tpu_torch.zstd import device_dec as DD  # noqa: E402
from compress_tpu_torch.zstd import encoder as E  # noqa: E402
from test_torch_jaxref import jax_native_core  # noqa: E402,F401

SIZES = (1, 2, 4)
RUN_TIMEOUT_S = 300   # one group's run of every case
JOB, BLOCK = 8 << 10, 4 << 10
BS = 1 << 16

def _text(seed: int, n: int) -> bytes:
    return corpus.make_block("text",
                             np.random.default_rng(seed)).tobytes()[:n]


@pytest.fixture(scope="module")
def inp():
    """The module's inputs, made from seeds once per process (not at
    import: every test worker imports the module)."""
    i = types.SimpleNamespace()
    i.blocks8 = np.ascontiguousarray(corpus.corpus_blocks(8, 31)[:, :4096])
    i.blocks16 = np.ascontiguousarray(corpus.corpus_blocks(16, 32)[:, :4096])
    # 5 whole chunks (a mesh remainder at sizes 2 and 4) and a tail
    i.s2_data = (corpus.corpus_blocks(5, 33).tobytes()
                 + corpus.corpus_blocks(1, 34).tobytes()[:3000])
    # every corpus class in turn, 16 KiB each
    i.z_data = corpus.corpus_blocks(8, 35)[:, :16384].tobytes()
    # 11 items: accel frames, plain frames of the port's encoder (device
    # and host routes), a random block and an empty input
    i.dec_srcs = ([_text(40 + k, 9000 + 3000 * k) for k in range(5)]
                  + [_text(50 + k, 20000) for k in range(3)]
                  + [corpus.make_block("rand256", np.random.default_rng(60))
                     .tobytes()[:5000], _text(61, 200), b""])
    i.dec_items = ([A.compress_accel(x, level=1) for x in i.dec_srcs[:5]]
                   + [Z.compress(x, level=lv)
                      for x, lv in zip(i.dec_srcs[5:8], (1, 2, 3))]
                   + [A.compress_accel(x, level=1) for x in i.dec_srcs[8:]])
    i.mb_srcs = corpus.history_streams(3, 3 * BS, 36)
    i.mb_srcs[2] = i.mb_srcs[2][:2 * BS + 777]
    i.mb_items = [A.compress_accel(d, level=1, multi_block=True,
                                   hist_blocks=hb)
                  for d, hb in zip(i.mb_srcs, (8, 2, 1))]
    i.s2_srcs = [_text(70 + k, 7000 * (k + 1)) for k in range(5)]
    i.s2_blocks = [s2.encode(x) for x in i.s2_srcs]
    i.accel_blob = A.compress_accel(_text(80, 50000) + _text(81, 60000)
                                    + _text(82, 40000), level=2)
    return i


def _zn(case: str, size: int) -> int:
    """The input length of a zstd case at a mesh size."""
    return {"mult": 2 * size * JOB,               # k = 2 jobs a rank
            # leftover jobs: full = size (k = 1), 0, 1 and 3 leftover
            # jobs at sizes 1, 2 and 4 (the window is the leftover's there)
            "rest": (2 * size - 1) * JOB + 777,
            "small": JOB - 1, "empty": 0}[case]


# (case, level, checksum): every level and both checksum settings on the
# mesh paths; the host encoder's below one job and empty
Z_CASES = [("mult", 1, False), ("mult", 2, True), ("mult", 3, False),
           ("rest", 2, False), ("rest", 1, True), ("rest", 3, True),
           ("small", 2, False), ("small", 1, True), ("empty", 2, False),
           ("empty", 1, True)]
Z_IDS = [f"{c}-L{lv}{'-ck' if ck else ''}" for c, lv, ck in Z_CASES]
HALO_CASE = ("mult", 2, True)


def _calls(size: int, inp) -> dict:
    """Every case this module runs on the port's ranks: key -> (fn, args,
    kwargs) for ``launch.run_calls`` (``mesh=`` is added on each rank)."""
    calls = {("ebs", lv): (PE.encode_blocks_sharded, (inp.blocks8,),
                           {"tile": 256, "level": lv}) for lv in (1, 2)}
    calls["ess"] = (PE.encode_step_stats, (inp.blocks16,), {"tile": 256})
    calls["stream"] = (PE.s2_stream_encode_device, (inp.s2_data,), {})
    for case in Z_CASES:
        c, lv, ck = case
        calls[case] = (PE.zstd_encode_sharded, (inp.z_data[:_zn(c, size)],),
                       {"job": JOB, "block": BLOCK, "level": lv,
                        "checksum": ck, "stats": {}})
    calls["dec"] = (PE.zstd_decode_sharded, (inp.dec_items,), {})
    calls["dec_mb"] = (PE.zstd_decode_sharded, (inp.mb_items,), {})
    calls["s2dec"] = (SD.decode_blocks_device, (inp.s2_blocks,), {})
    calls["accel"] = (Z.decompress_accel, (inp.accel_blob,), {})
    calls["dryrun"] = (dryrun.dryrun_multichip, (), {})
    return calls


@pytest.fixture(scope="module", params=SIZES, ids=[f"size{s}" for s in SIZES])
def ranks(request, inp):
    """(size, {key: [rank 0's (result, stats), ...]}) of one group."""
    size = request.param
    calls = _calls(size, inp)
    per_rank = launch.run_ranks(launch.run_calls, size, "gloo", "cpu",
                                list(calls.values()),
                                timeout=RUN_TIMEOUT_S)
    return size, {key: [r[i] for r in per_rank]
                  for i, key in enumerate(calls)}


def _jax_mesh(size: int) -> Mesh:
    return Mesh(np.array(jax.devices()[:size]), ("data",))


def _one(results):
    """The result every rank returned (they must agree)."""
    first = results[0][0]
    for got, _stats in results[1:]:
        if isinstance(first, tuple):
            assert len(got) == len(first)
            for a, b in zip(got, first):
                assert torch.equal(torch.as_tensor(a), torch.as_tensor(b))
        else:
            assert got == first
    return first


def _np(x):
    return np.asarray(x).astype(np.int64)


# ---- S2 ------------------------------------------------------------------

@pytest.mark.parametrize("level", [1, 2])
def test_encode_blocks_sharded_matches_jax(inp, ranks, level):
    size, res = ranks
    out, lens = _one(res[("ebs", level)])
    want_out, want_lens = J.encode_blocks_sharded(inp.blocks8, _jax_mesh(size),
                                                  tile=256, level=level)
    assert np.array_equal(_np(out), _np(want_out))
    assert np.array_equal(_np(lens), _np(want_lens))


def test_encode_step_stats_matches_jax(inp, ranks):
    size, res = ranks
    out, lens, total = _one(res["ess"])
    w_out, w_lens, w_total = J.encode_step_stats(inp.blocks16, _jax_mesh(size),
                                                 tile=256)
    assert np.array_equal(_np(out), _np(w_out))
    assert np.array_equal(_np(lens), _np(w_lens))
    assert int(total) == int(w_total) == int(_np(lens).sum())


def test_s2_stream_matches_jax(inp, ranks):
    size, res = ranks
    got = _one(res["stream"])
    assert got == J.s2_stream_encode_device(inp.s2_data, _jax_mesh(size))
    assert Reader(io.BytesIO(got)).read() == inp.s2_data
    assert S2S.Reader(io.BytesIO(got)).read() == inp.s2_data
    idx = S2I.index_stream(got)
    assert idx.append_to() == jax_index.index_stream(got).append_to()
    assert idx.total_uncompressed == len(inp.s2_data)


# ---- zstd encode -----------------------------------------------------------

@pytest.mark.parametrize("case,native", [
    *(pytest.param(c, False, id=i) for c, i in zip(Z_CASES, Z_IDS)),
    *(pytest.param(c, True, id=f"native-{i}")
      for c, i in zip(Z_CASES, Z_IDS) if c[0] == "small")])
def test_zstd_encode_sharded_matches_jax(inp, ranks, case, native,
                                         monkeypatch):
    """Where the jobs do not fill the mesh (0 < n < size jobs) the frame is
    the host encoder's: the port's Matcher path equals the JAX package's
    with its native ladder patched out, and the ranks' frame (the ladder,
    ``native``) the unpatched one."""
    size, res = ranks
    c, level, checksum = case
    data = inp.z_data[:_zn(c, size)]
    got = _one(res[case])
    if 0 < len(data) < size * JOB and not native:
        monkeypatch.setattr(jax_enc, "_native_compress",
                            lambda *a, **k: None)
        assert got == E.compress(data, level=1, checksum=checksum)
        got = E.compress_matcher(data, level=1, checksum=checksum)
    want = J.zstd_encode_sharded(data, _jax_mesh(size), job=JOB, block=BLOCK,
                                 checksum=checksum, level=level)
    assert got == want
    assert zstandard.ZstdDecompressor().decompress(
        got, max_output_size=max(len(data), 1)) == data
    assert Z.decompress(got) == data


def test_halo_bytes(inp, ranks):
    """Rank r > 0 received the last job // 8 bytes of rank r - 1's last
    job; rank 0 received nothing."""
    size, res = ranks
    data = inp.z_data[:_zn(HALO_CASE[0], size)]
    k = 2
    pre = JOB // 8
    halos = [stats["halo"] for _frame, stats in res[HALO_CASE]]
    assert halos[0] is None
    for r in range(1, size):
        assert halos[r] == data[r * k * JOB - pre:r * k * JOB]


def test_sharded_frame_independent_of_size(inp, ranks):
    """Where the size divides the job count, the frame is the unsharded
    ``compress_device(engine="v1")``'s."""
    _size, res = ranks
    for case in Z_CASES[:3]:
        c, level, checksum = case
        data = inp.z_data[:_zn(c, _size)]
        assert _one(res[case]) == ZD.compress_device(
            data, job=JOB, block=BLOCK, level=level, checksum=checksum,
            engine="v1", device="cpu")


# ---- decode ----------------------------------------------------------------

def test_zstd_decode_sharded_matches_jax(inp, ranks):
    size, res = ranks
    got = _one(res["dec"])
    assert got == inp.dec_srcs
    assert got == J.zstd_decode_sharded(inp.dec_items, _jax_mesh(size))


def test_zstd_decode_sharded_multi_block_matches_jax(inp, ranks):
    size, res = ranks
    got = _one(res["dec_mb"])
    assert got == inp.mb_srcs
    assert got == J.zstd_decode_sharded(inp.mb_items, _jax_mesh(size))


def test_decode_blocks_device_with_mesh(inp, ranks):
    _size, res = ranks
    got = _one(res["s2dec"])
    assert got == inp.s2_srcs
    assert got == SD.decode_blocks_device(inp.s2_blocks, device="cpu")


def test_decompress_accel_with_mesh(inp, ranks):
    _size, res = ranks
    got = _one(res["accel"])
    assert got == Z.decompress_accel(inp.accel_blob, device="cpu")
    assert got == Z.decompress(inp.accel_blob)


def test_dryrun_multichip(ranks):
    size, res = ranks
    got = _one(res["dryrun"])
    assert got["blocks"] == 2 * size and got["items"] == size + 1
    # the JAX dryrun's input: a 61-byte motif repeated, cut at
    # size * JOB + 99 bytes (it is shorter where the repeats fall short)
    assert got["zstd_in"] == min(size * JOB + 99,
                                 61 * (size * JOB // 61 + 2))


# ---- in-process ------------------------------------------------------------

def test_one_rank_mesh_without_group(inp):
    mesh = PE.block_mesh(device="cpu")
    assert (mesh.group, mesh.rank, mesh.size, mesh.backend) == (None, 0, 1,
                                                                None)
    assert mesh.device == torch.device("cpu")
    out, lens = PE.encode_blocks_sharded(inp.blocks8, mesh, tile=256)
    w_out, w_lens = J.encode_blocks_sharded(inp.blocks8, _jax_mesh(1),
                                            tile=256)
    assert np.array_equal(_np(out), _np(w_out))
    assert np.array_equal(_np(lens), _np(w_lens))
    stats = {}
    data = inp.z_data[:3 * JOB + 5]
    frame = PE.zstd_encode_sharded(data, mesh, job=JOB, block=BLOCK,
                                   stats=stats)
    assert frame == J.zstd_encode_sharded(data, _jax_mesh(1), job=JOB,
                                          block=BLOCK)
    assert stats["halo"] is None
    assert PE.zstd_decode_sharded(inp.dec_items[:4], mesh) == inp.dec_srcs[:4]
    assert mesh.shift_right(torch.arange(3)) is None
    assert mesh.all_gather_object("x") == ["x"]


@pytest.mark.parametrize("n,size", [(11, 4), (11, 2), (3, 4), (0, 2),
                                    (8, 1)])
def test_shard_items_pads_as_put_sharded(n, size):
    """Ranks take ceil(n / size) slots each, in order; the padding slots
    of the last ranks hold no item."""
    per = -(-n // size)
    spans = [PE.shard_items(PE.BlockMesh(None, r, size, "gloo",
                                         torch.device("cpu")), n)
             for r in range(size)]
    assert [i for lo, hi in spans for i in range(lo, hi)] == list(range(n))
    assert all(hi - lo <= per for lo, hi in spans)
    assert spans[0] == (0, min(per, n))


def test_block_mesh_refuses_nccl_beyond_the_cards(monkeypatch):
    import torch.distributed as dist

    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_world_size", lambda group=None: 2)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 1)
    monkeypatch.setattr(dist, "get_backend", lambda group=None: "nccl")
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    with pytest.raises(RuntimeError, match="NCCL cannot put 2 ranks on 1"):
        PE.block_mesh()
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "1")   # one rank a host: allowed
    with pytest.raises(ValueError, match="NCCL needs a CUDA device"):
        PE.block_mesh(device="cpu")


def test_sharded_entries_raise_without_card_or_device(inp):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    for call in (lambda: PE.block_mesh(),
                 lambda: PE.encode_blocks_sharded(inp.blocks8),
                 lambda: PE.encode_step_stats(inp.blocks8),
                 lambda: PE.s2_stream_encode_device(b"tail only"),
                 lambda: PE.zstd_encode_sharded(b"short"),
                 lambda: PE.zstd_decode_sharded(inp.dec_items[:1]),
                 lambda: dryrun.dryrun_multichip()):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()


def test_mesh_device_conflict_raises(inp):
    mesh = PE.block_mesh(device="cpu")
    with pytest.raises(ValueError, match="not the mesh's"):
        DD.decompress_frames_device(inp.dec_items[:1], device="meta",
                                    mesh=mesh)


def test_run_ranks_fails_when_a_rank_raises(inp):
    """3 blocks do not divide over 2 ranks: each rank raises, and so does
    the run."""
    with pytest.raises(Exception, match="do not divide over a mesh of 2"):
        launch.run_ranks(launch.run_calls, 2, "gloo", "cpu",
                         [(PE.encode_blocks_sharded, (inp.blocks8[:3],), {})],
                         timeout=RUN_TIMEOUT_S)


# ---- the package-level accel wrappers -------------------------------------

@pytest.mark.parametrize("level,multi_block", [(1, False), (2, False),
                                               (1, True)])
def test_accel_wrappers_match_jax(level, multi_block):
    data = b"".join(corpus.history_streams(1, 2 * BS, 37))[:2 * BS - 99]
    blob = Z.compress_accel(data, level=level, multi_block=multi_block)
    assert blob == A.compress_accel(data, level=level,
                                    multi_block=multi_block)
    assert Z.decompress_accel(blob, device="cpu") == data
    assert jax_zstd.decompress_accel(blob) == data
    jblob = jax_zstd.compress_accel(data, level=level,
                                    multi_block=multi_block)
    assert Z.decompress_accel(jblob, device="cpu") == data


def test_decompress_accel_empty_blob():
    assert Z.decompress_accel(b"") == b"" == jax_zstd.decompress_accel(b"")
