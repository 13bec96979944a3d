"""huff0 of the port: code lengths, table serialization and the host
stream codec (on the host core, each beside its Python plain version),
and the 4X batch codec on the device."""

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
