"""flate of the port: DEFLATE (RFC 1951), the JAX package's ``flate`` byte
for byte.

Levels -2 (HuffmanOnly), 0 (store) and 1-9, custom windows, stateless
mode, the streaming ``deflate.Writer`` and ``inflate.Reader``, and the
resumable inflate with checkpoints (klauspost/compress ``flate``).  Levels
1-9 with the full window, the one-shot inflate and the streaming Reader
run on the host core (``_native``, ``flate.cpp``); the Python versions
beside them are the plain versions (``deflate_py``, ``inflate_py``,
``WriterPy``, ``ReaderPy``) and serve what the core does not take: level 0,
level -2, small windows, tiny inputs, dictionaries, checkpoints and
resumption.
"""

from compress_tpu_torch.flate.deflate import (
    BEST_COMPRESSION,
    BEST_SPEED,
    DEFAULT_COMPRESSION,
    HUFFMAN_ONLY,
    MAX_OFFSET,
    NO_COMPRESSION,
    deflate,
    stateless_deflate,
)
from compress_tpu_torch.flate.inflate import Checkpoint, InflateError, inflate

__all__ = [
    "deflate", "inflate", "stateless_deflate",
    "Checkpoint", "InflateError",
    "HUFFMAN_ONLY", "NO_COMPRESSION", "DEFAULT_COMPRESSION",
    "BEST_SPEED", "BEST_COMPRESSION", "MAX_OFFSET",
]
