"""PyTorch/CUDA port of compress_tpu's device encoders.

The JAX package ``compress_tpu`` is the reference; this package imports
nothing of it.  Entry points: ``compress_tpu_torch.ops.lz2.encode_blocks_np``
(S2 blocks) and ``compress_tpu_torch.zstd.device.compress_device`` (zstd).
Its stages run as hand-written CUDA kernels (``csrc/``) on CUDA tensors
and as plain PyTorch versions on CPU tensors (``device="cpu"``).
"""
