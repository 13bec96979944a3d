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

``parse_blocks`` launches the CUDA kernel (``csrc/zparse.cu``) on CUDA
tensors and runs ``parse_blocks_ref``, the plain PyTorch version, on CPU
tensors.
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


def parse_blocks_ref(blocks_u8: torch.Tensor, off: torch.Tensor,
                     L: torch.Tensor):
    """Plain PyTorch parse + extract: the stages in order."""
    i32 = torch.int32
    blk = blocks_u8.to(i32)
    take, lit, L2, off = parse_stages(blk, off.to(i32), L.to(i32), L_CAP,
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


def parse_blocks(blocks_u8: torch.Tensor, off: torch.Tensor, L: torch.Tensor):
    """(NB, 65536) u8 blocks + merged (off, L) -> per-block zstd parse
    (the finder's suffix cap 10 for the chain extension):

    ll, ml, of: (NB, MAXSEQ) int32 sequence fields in sequence order;
    lits: (NB, 65536) u8 literals; n_seqs, lit_cnt: (NB,) int32.
    A CUDA tensor goes through the CUDA kernel, a CPU tensor through the
    plain version."""
    if blocks_u8.dim() != 2 or blocks_u8.shape[1] != BS:
        raise ValueError(f"expected (NB, {BS}) blocks, got "
                         f"{tuple(blocks_u8.shape)}")
    if off.shape != blocks_u8.shape or L.shape != blocks_u8.shape:
        raise ValueError("off and L must have the blocks' shape")
    if off.device != blocks_u8.device or L.device != blocks_u8.device:
        raise ValueError("off and L must be on the blocks' device")
    if blocks_u8.device.type == "cpu":
        return parse_blocks_ref(blocks_u8, off, L)
    nb = blocks_u8.shape[0]
    _cuda.require_cuda_input(blocks_u8, "blocks", torch.uint8, (nb, BS))
    _cuda.require_cuda_input(off, "off", torch.int32, (nb, BS))
    _cuda.require_cuda_input(L, "L", torch.int32, (nb, BS))
    dev = blocks_u8.device
    fields = [torch.empty((nb, MAXSEQ), dtype=torch.int32, device=dev)
              for _ in range(3)]
    lits = torch.empty((nb, BS), dtype=torch.uint8, device=dev)
    n_seqs = torch.empty((nb,), dtype=torch.int32, device=dev)
    lit_cnt = torch.empty((nb,), dtype=torch.int32, device=dev)
    lib = _cuda.library()
    with torch.cuda.device(dev):
        rc = lib.ct_parse_blocks(
            blocks_u8.data_ptr(), off.data_ptr(), L.data_ptr(),
            *(f.data_ptr() for f in fields), lits.data_ptr(),
            n_seqs.data_ptr(), lit_cnt.data_ptr(), nb, L_CAP,
            _cuda.stream(dev))
    _cuda.check(rc, "parse_blocks")
    parse_blocks.launches += 1
    return (*fields, lits, n_seqs, lit_cnt)


parse_blocks.launches = 0
