"""zstd parse + extract (counterpart of the JAX package's ``ops/zparse.py``).

From the finder's per-position (off, L), merged with the long-range
channel by the caller, per 64 KiB block:

  A-C. the S2 parse stages (``lzemit2.parse_stages``) with the zstd cost
       gate between the probes and the parse: minimum match 6, +1 at
       offset >= 1024, +2 at offset >= 64 KiB;
  D.   at every op: ll = the run of literals that ends just before it
       (across tiles), ml = its merged length, of = its offset;
  E.   (ll, ml, of) in position order in MAXSEQ slots, 0 past n_seqs;
  F.   the literal bytes in position order, 0 past lit_cnt.

The chain extension runs at the finder's suffix cap, 10 by default; any
positive cap is taken, as by the reference.  ``parse_blocks`` launches
the CUDA kernel (``csrc/zparse.cu``: cap 10 has its own instantiation,
any other cap the run-time one, whose launches
``parse_blocks.any_cap_launches`` counts) on CUDA tensors and runs
``parse_blocks_ref``, the plain PyTorch version, on CPU tensors.
"""

from __future__ import annotations

import torch

from compress_tpu_torch import _cuda
from compress_tpu_torch.ops.common import compact
from compress_tpu_torch.ops.lzemit import BS
from compress_tpu_torch.ops.lzemit2 import parse_stages
from compress_tpu_torch.ops.lzkern import L_CAP

SEQ_ROWS = 96              # 96 * 128 = 12288 >= the worst case 11008
MAXSEQ = SEQ_ROWS * 128

__all__ = ["parse_blocks", "parse_blocks_ref", "MAXSEQ"]


def _check_cap(cap: int) -> None:
    if cap < 1:
        raise ValueError(f"cap must be positive, got {cap}")


def parse_blocks_ref(blocks_u8: torch.Tensor, off: torch.Tensor,
                     L: torch.Tensor, cap: int = L_CAP):
    """Plain PyTorch parse + extract: the stages in order."""
    _check_cap(cap)
    i32 = torch.int32
    blk = blocks_u8.to(i32)
    take, lit, L2, off = parse_stages(blk, off.to(i32), L.to(i32), cap,
                                      zstd_gate=True)
    # ---- D. literal run ending at each position, by doubling ------------
    e = lit.to(i32)
    for k in range(17):
        s = 1 << k
        prev = torch.zeros_like(e)
        if s < BS:
            prev[:, s:] = e[:, :-s]
        e = e + torch.where(e == s, prev, 0)
    ll_at = torch.zeros_like(e)
    ll_at[:, 1:] = e[:, :-1]
    # ---- E, F. compaction in position order -------------------------------
    _, (ll, ml, of) = compact(take, [ll_at, L2, off])
    _, (lits,) = compact(lit, [blk])
    n_seqs = take.sum(dim=1, dtype=i32)
    lit_cnt = lit.sum(dim=1, dtype=i32)
    return (ll[:, :MAXSEQ].contiguous(), ml[:, :MAXSEQ].contiguous(),
            of[:, :MAXSEQ].contiguous(), lits.to(torch.uint8), n_seqs,
            lit_cnt)


def parse_blocks(blocks_u8: torch.Tensor, off: torch.Tensor, L: torch.Tensor,
                 cap: int = L_CAP):
    """(NB, 65536) u8 blocks + merged (off, L) -> per-block zstd parse
    (``cap``, the finder's suffix cap, for the chain extension):

    ll, ml, of: (NB, MAXSEQ) int32 sequence fields in sequence order;
    lits: (NB, 65536) u8 literals; n_seqs, lit_cnt: (NB,) int32.
    A CUDA tensor goes through the CUDA kernel (an input that is not
    16-byte aligned is copied first; the outputs share one allocation), a
    CPU tensor through the plain version."""
    if blocks_u8.dim() != 2 or blocks_u8.shape[1] != BS:
        raise ValueError(f"expected (NB, {BS}) blocks, got "
                         f"{tuple(blocks_u8.shape)}")
    if off.shape != blocks_u8.shape or L.shape != blocks_u8.shape:
        raise ValueError("off and L must have the blocks' shape")
    if off.device != blocks_u8.device or L.device != blocks_u8.device:
        raise ValueError("off and L must be on the blocks' device")
    _check_cap(cap)
    dev = blocks_u8.device
    if dev.type == "cpu":
        return parse_blocks_ref(blocks_u8, off, L, cap)
    # The checks and the one allocation are kept lean: the kernel takes
    # about half a millisecond, so the wrapper's host work is a visible
    # share of a call.
    if dev.type != "cuda":
        raise ValueError(f"parse_blocks: expected a CUDA tensor, got {dev}")
    if blocks_u8.dtype != torch.uint8 or off.dtype != torch.int32 \
            or L.dtype != torch.int32:
        raise ValueError("parse_blocks: expected uint8 blocks and int32 off "
                         "and L")
    if not (blocks_u8.is_contiguous() and off.is_contiguous()
            and L.is_contiguous()):
        raise ValueError("parse_blocks: expected contiguous tensors")
    blocks_u8, off, L = (_cuda.aligned(t) for t in (blocks_u8, off, L))
    ptrs = (blocks_u8.data_ptr(), off.data_ptr(), L.data_ptr())
    nb = blocks_u8.shape[0]
    # one allocation: ll, ml, of, then the literals, n_seqs and lit_cnt
    n_f = nb * MAXSEQ * 4
    buf = torch.empty(3 * n_f + nb * BS + 8 * nb, dtype=torch.uint8,
                      device=dev)
    p = buf.data_ptr()
    with torch.cuda.device(dev):
        rc = _cuda.library().ct_parse_blocks(
            *ptrs, p, p + n_f, p + 2 * n_f, p + 3 * n_f,
            p + 3 * n_f + nb * BS, p + 3 * n_f + nb * BS + 4 * nb, nb,
            min(cap, BS), _cuda.stream(dev))  # a cap >= BS never continues
    _cuda.check(rc, "parse_blocks")
    parse_blocks.launches += 1
    parse_blocks.any_cap_launches += cap != L_CAP
    ll, ml, of = buf[:3 * n_f].view(torch.int32).view(3, nb, MAXSEQ)
    n_seqs, lit_cnt = buf[3 * n_f + nb * BS:].view(torch.int32).view(2, nb)
    return ll, ml, of, buf[3 * n_f:3 * n_f + nb * BS].view(nb, BS), \
        n_seqs, lit_cnt


parse_blocks.launches = 0
parse_blocks.any_cap_launches = 0
