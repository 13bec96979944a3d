"""huff0 of the port: pure-Python code lengths, table serialization and
host stream codec, and the 4X batch codec on the device."""

from compress_tpu_torch.huff0.batch import (compress_4x_batch, decompress_1x,
                                            decompress_4x,
                                            decompress_4x_batch, make_accel,
                                            shared_packed_table)
from compress_tpu_torch.huff0.table import (MAX_TABLELOG, CorruptError,
                                            IncompressibleError, UseRLEError,
                                            build_nbits, canonical_codes,
                                            read_table, write_table)

__all__ = ["compress_4x_batch", "decompress_1x", "decompress_4x",
           "decompress_4x_batch", "make_accel", "shared_packed_table",
           "MAX_TABLELOG", "CorruptError", "IncompressibleError",
           "UseRLEError", "build_nbits", "canonical_codes", "read_table",
           "write_table"]
