"""S2 block codec of the port on the host and the batched device
decode."""

from compress_tpu_torch.s2.block import CorruptError, decode, encode
from compress_tpu_torch.s2.device_dec import decode_blocks_device

__all__ = ["CorruptError", "decode", "decode_blocks_device", "encode"]
