"""S2 of the port: the block codec on the host and the batched device
decode; the framed streams, seek index, dictionaries and LZ4 converter
are the sibling modules ``stream``, ``index``, ``seek``, ``dict`` and
``lz4convert``."""

from compress_tpu_torch.s2.block import (MAX_BLOCK_SIZE, CorruptError,
                                         concat_blocks, decode, decoded_len,
                                         encode, encode_best, encode_better,
                                         encode_snappy, encode_snappy_best,
                                         encode_snappy_better,
                                         estimate_block_size, max_encoded_len)
from compress_tpu_torch.s2.device_dec import decode_blocks_device

__all__ = ["CorruptError", "MAX_BLOCK_SIZE", "concat_blocks", "decode",
           "decode_blocks_device", "decoded_len", "encode", "encode_best",
           "encode_better", "encode_snappy", "encode_snappy_best",
           "encode_snappy_better", "estimate_block_size", "max_encoded_len"]
