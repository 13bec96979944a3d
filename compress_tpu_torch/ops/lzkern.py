"""Exact match finder for 64 KiB blocks (counterpart of the JAX package's
``ops/lzkern.py``).

For every position p: ``off = p - c`` with c the nearest previous position
holding the same little-endian 4-byte word, and ``L = 4`` plus the equal
suffix bytes at offsets 4..cap-1 (cap 10, or 6 when ``slim``), read
wrapped past the block end, then ``L = min(L, BS - p)``.  Where there is
no match, and at the last 3 positions (as source or as candidate),
``off = L = 0``.

``find_matches_blocks`` launches the CUDA kernel (``csrc/lzkern.cu``) on a
CUDA tensor and runs ``find_matches_blocks_ref``, the plain PyTorch
version, on a CPU tensor.
"""

from __future__ import annotations

import torch

from compress_tpu_torch import _cuda

ROWS, LANES = 512, 128
BS = ROWS * LANES  # 64 KiB block
L_CAP = 10         # 4-byte seed + 6 carried suffix bytes
L_CAP_SLIM = 6

_SENT_BASE = BS - 3  # positions >= this never match


def find_matches_blocks_ref(blocks_u8: torch.Tensor, slim: bool = False):
    """Plain PyTorch finder: one sort of (v32 << 16 | pos) keys per block;
    the sorted predecessor with an equal word is the candidate."""
    cap = L_CAP_SLIM if slim else L_CAP
    b = blocks_u8.to(torch.int64)
    pos = torch.arange(BS, device=b.device)

    def byte_at(k):  # b[(p + k) % BS]
        return torch.roll(b, -k, dims=1)

    v32 = b | (byte_at(1) << 8) | (byte_at(2) << 16) | (byte_at(3) << 24)
    skey, order = torch.sort((v32 << 16) | pos, dim=1)
    same = torch.zeros_like(order, dtype=torch.bool)
    same[:, 1:] = (skey[:, 1:] >> 16) == (skey[:, :-1] >> 16)
    pred = torch.zeros_like(order)
    pred[:, 1:] = order[:, :-1]
    cand = torch.empty_like(order)
    cand.scatter_(1, order, torch.where(same, pred, -1))
    # a candidate precedes its source, so sources below _SENT_BASE never
    # see a candidate at or above it
    ok = (cand >= 0) & (pos < _SENT_BASE)
    c = cand.clamp(min=0)
    alive = ok
    L = torch.where(ok, 4, 0)
    for k in range(4, cap):
        alive = alive & (byte_at(k) == torch.gather(b, 1, (c + k) % BS))
        L = L + alive.to(torch.int64)
    L = torch.minimum(L, BS - pos)
    L = torch.where(L >= 4, L, 0)
    off = torch.where(L > 0, pos - c, 0)
    return off.to(torch.int32), L.to(torch.int32)


def find_matches_blocks(blocks_u8: torch.Tensor, slim: bool = False):
    """(NB, 65536) uint8 -> (off, L), each (NB, 65536) int32.

    A CUDA tensor goes through the CUDA kernel, a CPU tensor through the
    plain version.  ``slim`` caps the suffix at 6 (consumers must
    chain-extend at cap 6), as the JAX package's slim finder does."""
    if blocks_u8.dim() != 2 or blocks_u8.shape[1] != BS:
        raise ValueError(f"expected (NB, {BS}) blocks, got "
                         f"{tuple(blocks_u8.shape)}")
    if blocks_u8.device.type == "cpu":
        return find_matches_blocks_ref(blocks_u8, slim)
    nb = blocks_u8.shape[0]
    _cuda.require_cuda_input(blocks_u8, "blocks", torch.uint8, (nb, BS))
    dev = blocks_u8.device
    off = torch.empty((nb, BS), dtype=torch.int32, device=dev)
    L = torch.empty((nb, BS), dtype=torch.int32, device=dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.ct_find_matches(
            blocks_u8.data_ptr(), off.data_ptr(), L.data_ptr(), nb,
            L_CAP_SLIM if slim else L_CAP, _cuda.stream(dev))
    _cuda.check(rc, "find_matches_blocks")
    find_matches_blocks.launches += 1
    return off, L


find_matches_blocks.launches = 0
