"""Device S2 block encode (counterpart of the JAX package's ``ops/lz2.py``
kernel path, ``s2_encode_blocks_kern`` / ``encode_blocks_np``).

64 KiB blocks go through the match finder (``lzkern``), the parse+emit
stage (``lzemit2``) and the row assembly (``lzemit.assemble_bodies``),
and come out as S2 block bodies (without the uvarint length header).
"""

from __future__ import annotations

import torch

from compress_tpu_torch._cuda import resolve_device
from compress_tpu_torch.ops import lzemit2, lzkern

B = 1 << 16
TILE = 512
# blocks per launch: bounds the device memory of one chunk ((off, L)
# 512 KiB and output panels 66 KiB per block; the finder keeps its sort on
# chip)
MAX_LAUNCH_BLOCKS = 256


def s2_encode_blocks_kern(blocks: torch.Tensor) -> list[bytes]:
    """(NB, 65536) uint8 on its device -> list of S2 block bodies."""
    off, L = lzkern.find_matches_blocks(blocks)
    b0, b1, rl = lzemit2.emit_blocks(blocks, off, L)
    return lzemit2.assemble_bodies(b0, b1, rl)


def encode_blocks_np(data: bytes, device=None) -> list[bytes]:
    """Encode ``data`` (a multiple of 64 KiB) block by block.

    Runs on CUDA unless ``device`` names another device ("cpu" runs the
    plain PyTorch versions); raises when no card is present and no device
    was given."""
    dev = resolve_device(device)
    n = len(data)
    if n == 0 or n % B:
        raise ValueError(f"input length {n} is not a positive multiple of {B}")
    arr = torch.frombuffer(bytearray(data), dtype=torch.uint8).view(-1, B)
    bodies = []
    for c in range(0, arr.shape[0], MAX_LAUNCH_BLOCKS):
        chunk = arr[c:c + MAX_LAUNCH_BLOCKS].to(dev)
        bodies += s2_encode_blocks_kern(chunk)
    return bodies
