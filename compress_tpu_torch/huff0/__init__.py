"""huff0 of the port: pure-Python table serialization and host decode,
and the 4X batch codec on the device."""

from compress_tpu_torch.huff0.batch import (compress_4x_batch, decompress_4x,
                                            decompress_4x_batch, make_accel,
                                            shared_packed_table)
from compress_tpu_torch.huff0.table import (CorruptError, IncompressibleError,
                                            read_table, write_table)

__all__ = ["compress_4x_batch", "decompress_4x", "decompress_4x_batch",
           "make_accel", "shared_packed_table", "CorruptError",
           "IncompressibleError", "read_table", "write_table"]
