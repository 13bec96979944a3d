"""Batched huff0 4X encode (counterpart of the JAX package's
``ops/entropy.py`` ``huff0_encode_blocks``).

All blocks of a batch share one length L (a multiple of 512): per-block
(or batch-shared) Kraft-repaired code lengths and canonical codes from
the ``zdev`` helpers, the 4 streams at descending half bases (stream 3
first), one bit-pack, and the decode checkpoints (the remaining-bit
offset of every stream at every HUFF_CKPT_K-th symbol).  The reference
computes this as XLA graphs with bf16 one-hot sums; here it is plain
PyTorch on whatever device the blocks are on, with integer histograms and
gathers giving the same integers.
"""

from __future__ import annotations

import torch

from compress_tpu_torch.ops.zdev import (_bitpack_rows, _canonical_codes_dev,
                                         _huff_build)

HUFF_CKPT_K = 32  # symbols per decode-checkpoint chunk (side channel)

_I32 = torch.int32
_I64 = torch.int64


def huff0_encode_blocks(blocks: torch.Tensor, shared_table: bool = False,
                        max_log: int = 11) -> dict:
    """(N, L) uint8 -> dict of int32 tensors (``ok`` bool): nbits (N, 256),
    max_bits (N,), ok (N,), stream_bits (N, 4), halves (N, ntiles * 384),
    n_halves (N,), ckpt (N, 4, 1 + ceil((seg - K + 1) / K)) with seg =
    ceil(L / 4).

    shared_table: one Huffman code from the batch-wide histogram for every
    block (the shared-table decode kernel needs it).  max_log: the code
    length cap (8 keeps the decode table at 256 entries)."""
    N, L = blocks.shape
    dev = blocks.device
    b = blocks.to(_I64)
    hist = torch.zeros((N, 256), dtype=_I64, device=dev)
    hist.scatter_add_(1, b, torch.ones_like(b))
    if shared_table:
        hist = hist.sum(dim=0, keepdim=True).expand(N, 256).contiguous()
    nbits, max_bits, ok = _huff_build(hist, maxlog=max_log)
    codes = _canonical_codes_dev(nbits, max_bits)
    code = torch.gather(codes.to(_I64), 1, b)
    nb = torch.gather(nbits.to(_I64), 1, b)

    seg = (L + 3) // 4
    q = torch.clamp(torch.arange(L, device=dev) // seg, max=3)
    cs = torch.cumsum(nb, dim=1)
    bq = torch.zeros((N, 4), dtype=_I64, device=dev)
    bq.scatter_add_(1, q.expand(N, L), nb)
    prev_bits = torch.cumsum(bq, dim=1) - bq
    c_in_q = cs - prev_bits[:, q]          # bits consumed up to symbol i
    sh = (bq + 16) >> 4
    sbase = torch.stack([sh[:, 1] + sh[:, 2] + sh[:, 3], sh[:, 2] + sh[:, 3],
                         sh[:, 3], torch.zeros_like(sh[:, 0])], dim=1)
    dest_bit = 16 * sbase[:, q] + (bq[:, q] - c_in_q)
    halves, n_halves = _bitpack_rows(
        torch.flip(code, [1]), torch.flip(nb, [1]), torch.flip(dest_bit, [1]),
        384, sbase[:, 0] + sh[:, 0], T=512)
    # remaining-bit offset of stream q at its symbols K-1, 2K-1, ... (the
    # last stream padded with its final count)
    K = HUFF_CKPT_K
    cpad = torch.cat([c_in_q, c_in_q[:, -1:].expand(N, 4 * seg - L)], dim=1)
    body = bq[:, :, None] - cpad.view(N, 4, seg)[:, :, K - 1::K]
    ckpt = torch.cat([bq[:, :, None], body], dim=2)
    return dict(nbits=nbits, max_bits=max_bits, ok=ok,
                stream_bits=bq.to(_I32), halves=halves, n_halves=n_halves,
                ckpt=ckpt.to(_I32))
