"""Mesh-parallel engines on ``torch.distributed`` (counterpart of the JAX
package's ``parallel``): block and job shards over a process group with
one rank per device, an ordered gather of the per-rank outputs, the
collectives explicit (``all_reduce`` for the stats, ``all_gather`` for the
ordered flusher's bookkeeping, a point-to-point halo between neighbouring
ranks).  ``parallel.launch.run_ranks`` starts the ranks of one host;
``torchrun`` does too, with the group initialised by the caller."""

from compress_tpu_torch.parallel.engine import (
    BlockMesh,
    block_mesh,
    encode_blocks_sharded,
    encode_step_stats,
    s2_stream_encode_device,
    shard_items,
    zstd_decode_sharded,
    zstd_encode_sharded,
)

__all__ = [
    "BlockMesh",
    "block_mesh",
    "encode_blocks_sharded",
    "encode_step_stats",
    "s2_stream_encode_device",
    "shard_items",
    "zstd_decode_sharded",
    "zstd_encode_sharded",
]
