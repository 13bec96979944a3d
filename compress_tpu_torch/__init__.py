"""PyTorch/CUDA port of compress_tpu's device encoders and decoders.

The JAX package ``compress_tpu`` is the reference; this package imports
nothing of it.  Entry points: ``compress_tpu_torch.ops.lz2.encode_blocks_np``
(S2 blocks), ``compress_tpu_torch.zstd.device.compress_device`` (zstd),
``compress_tpu_torch.s2.decode_blocks_device`` (S2 block decode),
``compress_tpu_torch.huff0.compress_4x_batch`` / ``decompress_4x_batch``
(huff0 4X) and ``compress_tpu_torch.zstd.device_dec.decompress_frames_device``
(zstd frames, with the accel sidecars that
``compress_tpu_torch.zstd.accel.compress_accel`` writes).
Its stages run as hand-written CUDA kernels (``csrc/``) on CUDA tensors
and as plain PyTorch versions on CPU tensors (``device="cpu"``).

The host tier beside them covers every module of the JAX package: the
host core (``_native``), S2, Snappy and zstd streams, dictionaries and
converters, the deflate family (``flate``, ``gzip``, ``zlib``, ``zip``),
the HTTP middleware (``gzhttp``), the command-line tools (``cli``), the
dictionary trainer (``dictbuilder``) and the compressibility estimate.
"""

from compress_tpu_torch.estimate import estimate, shannon_entropy_bits

__version__ = "0.1.0"

__all__ = [
    "estimate",
    "shannon_entropy_bits",
    "__version__",
]
