"""Block-parallel compression over a process group (counterpart of the
JAX package's ``parallel/engine.py``).

The JAX engine shards the leading block (or job) axis over a ``Mesh``'s
"data" axis under one controller.  Here a mesh is a ``torch.distributed``
process group with one rank per device, and every function is SPMD: each
rank calls it with the same whole input, works on its contiguous share,
and the collectives hand every rank the same whole result.

- ``encode_blocks_sharded`` / ``encode_step_stats``: each rank runs the
  S2 XLA engine (``ops/lz2.s2_encode_blocks``) on its ``NB / size``
  blocks; ``all_gather`` returns the rows in block order, ``all_reduce``
  sums the compressed bytes (the reference's ``psum``).
- ``s2_stream_encode_device``: the framed .s2 stream of those blocks.
- ``zstd_encode_sharded``: each rank runs the v1 job engine
  (``ops/zdev.zstd_encode_jobs``) on its run of jobs and assembles their
  block bodies; the first job of rank r > 0 matches into the last
  ``job // 8`` bytes of rank r - 1's last job, sent over the group (the
  halo exchange; the reference's ``ppermute``).  The bodies are gathered
  in job order and every rank writes the same frame.
- ``zstd_decode_sharded``: ``decompress_frames_device`` with the mesh:
  each rank decodes its share of the items (``shard_items``), gathered in
  item order.

With NCCL the collective buffers live on each rank's card; with gloo they
live on the host (gloo's point-to-point takes CPU tensors only), so a
card's tensors are copied there and back.  Without an initialised
process group, ``block_mesh`` gives a one-rank mesh whose collectives are
identities (a group of one rank still runs them).
"""

from __future__ import annotations

import dataclasses
import os
import time

import numpy as np
import torch
import torch.distributed as dist

from compress_tpu_torch._cuda import resolve_device
from compress_tpu_torch.ops import lz2 as lz
from compress_tpu_torch.ops import zdev
from compress_tpu_torch.s2 import block as s2block
from compress_tpu_torch.s2 import stream as s2stream
from compress_tpu_torch.utils.crc import crc32c_masked
from compress_tpu_torch.utils.debuglog import dbg
from compress_tpu_torch.utils.varint import put_uvarint
from compress_tpu_torch.utils.xxhash64 import xxh64
from compress_tpu_torch.zstd import encoder as E
from compress_tpu_torch.zstd import frame as F
from compress_tpu_torch.zstd import device_dec
from compress_tpu_torch.zstd.device import (_assemble_job, emit_blocks,
                                            tail_bodies)


@dataclasses.dataclass(frozen=True)
class BlockMesh:
    """A 1-D data mesh: this rank's place in ``group`` and its device.
    ``group`` is None for a one-rank mesh without a process group."""

    group: object
    rank: int
    size: int
    backend: str | None
    device: torch.device

    @property
    def _on_host(self) -> bool:
        return self.backend is None or "nccl" not in self.backend

    def _buf(self, t: torch.Tensor) -> torch.Tensor:
        return t.cpu() if self._on_host else t.to(self.device)

    def _peer(self, r: int) -> int:
        return dist.get_global_rank(self.group, r)

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` (one shape on all ranks), concatenated along
        dim 0 in rank order, on this rank's device."""
        if self.group is None:
            return t.to(self.device)
        buf = self._buf(t.contiguous())
        parts = [torch.empty_like(buf) for _ in range(self.size)]
        dist.all_gather(parts, buf, group=self.group)
        return torch.cat(parts).to(self.device)

    def all_reduce_sum(self, t: torch.Tensor) -> torch.Tensor:
        if self.group is None:
            return t.to(self.device)
        buf = self._buf(t).clone()
        dist.all_reduce(buf, op=dist.ReduceOp.SUM, group=self.group)
        return buf.to(self.device)

    def all_gather_object(self, obj) -> list:
        """Every rank's picklable ``obj``, in rank order."""
        if self.group is None:
            return [obj]
        out = [None] * self.size
        dist.all_gather_object(out, obj, group=self.group)
        return out

    def shift_right(self, t: torch.Tensor) -> torch.Tensor | None:
        """Send ``t`` to rank + 1 and receive rank - 1's (same shape and
        type): the received tensor on this rank's device, None on rank 0.
        The last rank sends nothing."""
        if self.size == 1:
            return None
        buf = self._buf(t.contiguous())
        works = []
        if self.rank + 1 < self.size:
            works.append(dist.isend(buf, self._peer(self.rank + 1),
                                    group=self.group))
        got = None
        if self.rank > 0:
            got = torch.empty_like(buf)
            works.append(dist.irecv(got, self._peer(self.rank - 1),
                                    group=self.group))
        for w in works:
            w.wait()
        return None if got is None else got.to(self.device)


def _rank_device(device, local_rank: int) -> torch.device:
    """The device a rank runs on: ``cuda:{local_rank}`` unless the caller
    names a device (a bare "cuda" also takes the local rank's card)."""
    if device is None:
        resolve_device(None)               # raises without a card
        return torch.device("cuda", local_rank)
    dev = torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", local_rank)
    return dev


def block_mesh(group=None, device=None) -> BlockMesh:
    """The 1-D data mesh of ``group`` (the default group when None).
    Without an initialised process group: a one-rank mesh.

    ``device`` is ``cuda:{LOCAL_RANK}`` unless the caller names another
    (LOCAL_RANK as ``torchrun`` and ``parallel.launch.run_ranks`` set it,
    else the rank).  NCCL puts one rank on each card: more ranks on a host
    (LOCAL_WORLD_SIZE, else the group's size) than visible cards raise;
    run such ranks over gloo."""
    if not (dist.is_available() and dist.is_initialized()):
        if group is not None:
            raise RuntimeError("block_mesh: a group was given but "
                               "torch.distributed is not initialised")
        return BlockMesh(None, 0, 1, None, _rank_device(device, 0))
    size = dist.get_world_size(group)
    rank = dist.get_rank(group)
    backend = str(dist.get_backend(group))
    local_rank = int(os.environ.get("LOCAL_RANK", rank))
    if "nccl" in backend:
        local_size = int(os.environ.get("LOCAL_WORLD_SIZE", size))
        cards = torch.cuda.device_count()
        if local_size > cards:
            raise RuntimeError(
                f"block_mesh: NCCL cannot put {local_size} ranks on "
                f"{cards} visible CUDA card(s) (one rank a card); run them "
                "over gloo")
    dev = _rank_device(device, local_rank)
    if "nccl" in backend:
        if dev.type != "cuda":
            raise ValueError(f"block_mesh: NCCL needs a CUDA device, not "
                             f"{dev}")
        torch.cuda.set_device(dev)     # all_gather_object needs it
    return BlockMesh(group if group is not None else dist.group.WORLD,
                     rank, size, backend, dev)


def shard_items(mesh: BlockMesh, n: int) -> tuple[int, int]:
    """[lo, hi) of this rank's contiguous share of ``n`` independent items,
    as the reference's ``put_sharded`` lays them out: the batch padded to
    a multiple of the mesh size, ``ceil(n / size)`` slots a rank (the
    padding slots hold no item)."""
    per = -(-n // mesh.size)
    lo = min(mesh.rank * per, n)
    return lo, min(lo + per, n)


def _local_blocks(blocks, mesh: BlockMesh) -> torch.Tensor:
    """This rank's rows of (NB, bs) uint8 ``blocks`` (a tensor or an
    array) on its device."""
    nb = len(blocks)
    if nb % mesh.size:
        raise ValueError(f"{nb} blocks do not divide over a mesh of "
                         f"{mesh.size}")
    k = nb // mesh.size
    mine = blocks[mesh.rank * k:(mesh.rank + 1) * k]
    if not isinstance(mine, torch.Tensor):
        mine = torch.from_numpy(np.array(mine, np.uint8))
    return mine.to(mesh.device)


def _encode_local(local: torch.Tensor, tile: int, level: int):
    """The XLA engine on this rank's blocks, in launches of at most
    ``lz.MAX_LAUNCH_BLOCKS`` blocks."""
    outs, lens = [], []
    for c in range(0, local.shape[0], lz.MAX_LAUNCH_BLOCKS):
        o, n = lz.s2_encode_blocks(local[c:c + lz.MAX_LAUNCH_BLOCKS],
                                   tile=tile, level=level)
        outs.append(o)
        lens.append(n)
    return torch.cat(outs), torch.cat(lens)


def encode_blocks_sharded(blocks, mesh: BlockMesh | None = None,
                          tile: int = lz.TILE, level: int = 1):
    """Encode (NB, block_size) uint8 blocks sharded over the mesh.

    NB must divide by the mesh size.  Returns (out, lens) of all NB blocks
    in block order, on every rank, on its device; row i's body is
    ``out[i, :lens[i]]``.  level 2 is the better tier (chain extension and
    top-K offset probing)."""
    mesh = mesh or block_mesh()
    out, lens = _encode_local(_local_blocks(blocks, mesh), tile, level)
    return mesh.all_gather(out), mesh.all_gather(lens)


def encode_step_stats(blocks, mesh: BlockMesh | None = None,
                      tile: int = lz.TILE):
    """The sharded step with its collectives: the per-rank encode, the sum
    of compressed bytes over the ranks (throughput accounting) and the
    gather of the lengths (the ordered flusher's size table).  Returns
    (out, lens, total_bytes) for all blocks, on every rank."""
    mesh = mesh or block_mesh()
    out, lens = _encode_local(_local_blocks(blocks, mesh), tile, 1)
    total = mesh.all_reduce_sum(lens.sum())
    return mesh.all_gather(out), mesh.all_gather(lens), total


def s2_stream_encode_device(data, mesh: BlockMesh | None = None) -> bytes:
    """A complete .s2 framed stream: the whole 64 KiB chunks that divide
    over the mesh through the device encoder, the remainder chunks and
    the tail through the host codec; a masked CRC-32C a chunk, a chunk
    stored where its body is no smaller.  Every rank returns the same
    stream."""
    data = bytes(data)
    mesh = mesh or block_mesh()
    out = bytearray(s2stream.MAGIC_CHUNK)
    n = len(data)
    nb = n // lz.B
    bodies = []
    full = (nb // mesh.size) * mesh.size
    if full:
        arr = np.frombuffer(data, np.uint8, full * lz.B).reshape(-1, lz.B)
        enc, lens = encode_blocks_sharded(arr, mesh)
        enc, lens = enc.cpu().numpy(), lens.cpu().tolist()
        bodies += [enc[i, :lens[i]].tobytes() for i in range(full)]
    for i in range(full, nb):   # mesh remainder blocks on the host
        bodies.append(s2block.encode_body(data[i * lz.B:(i + 1) * lz.B]))
    tail = data[nb * lz.B:]
    if tail:
        bodies.append(s2block.encode_body(tail))

    pos = 0
    for body in bodies:
        chunk = data[pos:pos + lz.B]
        pos += len(chunk)
        crc = crc32c_masked(chunk).to_bytes(4, "little")
        payload = bytearray()
        put_uvarint(payload, len(chunk))
        payload += body
        if len(payload) >= len(chunk):   # store uncompressed
            out += b"\x01" + (len(chunk) + 4).to_bytes(3, "little") + crc
            out += chunk
        else:
            out += b"\x00" + (len(payload) + 4).to_bytes(3, "little") + crc
            out += payload
    return bytes(out)


# ---------------------------------------------------------------------------
# Sharded zstd job engine with the halo (overlap-prefix) exchange
# ---------------------------------------------------------------------------


def zstd_encode_sharded(data, mesh: BlockMesh | None = None,
                        job: int | None = None, block: int | None = None,
                        checksum: bool = False, level: int = 2,
                        stats: dict | None = None) -> bytes:
    """zstd-compress ``data`` with its whole jobs sharded over the mesh.

    ``full = (n // job // size) * size`` jobs go to the ranks, ``full /
    size`` each in job order; each job matches into the previous job's
    last ``job // 8`` bytes (a rank's first job receives them from the
    rank before it; global job 0 has none).  Each rank assembles its
    jobs' block bodies, the bodies are gathered in job order, and the
    leftover jobs and the sub-job tail go through the host matcher
    (``zstd/device.tail_bodies``).  With ``full == 0`` (the empty input
    too) the host encoder writes the frame.  Every rank returns the same
    frame.

    ``stats``, when given, receives ``halo`` (the bytes this rank
    received, None on rank 0) and the host-clock seconds of the halo
    exchange (``halo_s``), the encode (``encode_s``), the assembly
    (``assemble_s``) and the gather (``gather_s``)."""
    data = bytes(data)
    job = job or zdev.JOB
    block = block or zdev.BLOCK
    pre = job // 8
    mesh = mesh or block_mesh()
    dbg("engine", "zstd_encode_sharded n=%d mesh=%d job=%d block=%d",
        len(data), mesh.size, job, block)
    n = len(data)
    full = (n // job // mesh.size) * mesh.size
    if full == 0:
        return E.compress(data, level=1, checksum=checksum)

    # the leftover tail goes through the host matcher, which may match
    # anywhere within it: the declared window must cover it
    rest_len = n - full * job
    out = bytearray(F.write_frame_header(n, max(job + pre, rest_len), False,
                                         checksum))
    k = full // mesh.size
    lo = mesh.rank * k
    jobs = torch.frombuffer(bytearray(data[lo * job:(lo + k) * job]),
                            dtype=torch.uint8).view(k, job).to(mesh.device)
    t0 = time.perf_counter()
    halo = mesh.shift_right(jobs[-1, job - pre:])
    t1 = time.perf_counter()
    prefixes = torch.zeros((k, pre), dtype=torch.uint8, device=mesh.device)
    prefixes[1:] = jobs[:-1, job - pre:]
    has_prefix = torch.ones(k, dtype=torch.bool, device=mesh.device)
    if halo is None:
        has_prefix[0] = False
    else:
        prefixes[0] = halo
    t = zdev.zstd_encode_jobs(jobs, job=job, block=block, prefixes=prefixes,
                              has_prefix=has_prefix, level=level)
    t = {key: v.cpu().numpy() for key, v in t.items()}
    t2 = time.perf_counter()
    mine = []
    for j in range(k):
        mine += _assemble_job(data[(lo + j) * job:(lo + j + 1) * job], t,
                                 j, block)
    t3 = time.perf_counter()
    bodies = gather_items(mesh, mine)
    t4 = time.perf_counter()
    regens = [block] * len(bodies)
    tb, tr = tail_bodies(data[full * job:])
    emit_blocks(out, data, bodies + tb, regens + tr)
    if checksum:
        out += (xxh64(data) & 0xFFFFFFFF).to_bytes(4, "little")
    if stats is not None:
        stats.update(halo=None if halo is None else halo.cpu().numpy()
                     .tobytes(), halo_s=t1 - t0, encode_s=t2 - t1,
                     assemble_s=t3 - t2, gather_s=t4 - t3)
    return bytes(out)


def zstd_decode_sharded(frames, mesh: BlockMesh | None = None,
                        max_rounds: int = 4):
    """Batched device decode sharded over the mesh: the items are
    independent, so each rank decodes its share (``shard_items``) on its
    device and the outputs are gathered in item order.  Takes the items
    of ``zstd.device_dec.decompress_frames_device`` (accel-sidecar frames
    decode with no per-symbol host work)."""
    return device_dec.decompress_frames_device(
        frames, max_rounds, mesh=mesh or block_mesh())


def gather_items(mesh: BlockMesh, items: list) -> list:
    """Every rank's list of ``items``, concatenated in rank order."""
    return [x for part in mesh.all_gather_object(items) for x in part]


def map_sharded(mesh: BlockMesh, items, device, fn) -> list:
    """``fn(share, device)`` of this rank's share of the independent
    ``items`` (``shard_items``) on the mesh's device, gathered in item
    order on every rank.  A ``device`` other than the mesh's raises."""
    if device is not None and torch.device(device) != mesh.device:
        raise ValueError(f"device {device} is not the mesh's {mesh.device}")
    lo, hi = shard_items(mesh, len(items))
    return gather_items(mesh, fn(items[lo:hi], mesh.device))


__all__ = ["BlockMesh", "block_mesh", "shard_items", "gather_items",
           "map_sharded",
           "encode_blocks_sharded", "encode_step_stats",
           "s2_stream_encode_device", "zstd_encode_sharded",
           "zstd_decode_sharded"]
