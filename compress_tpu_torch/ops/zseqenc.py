"""zstd sequence-encode chains (counterpart of the JAX package's
``ops/zseqenc.py``): one serial chain per 64 KiB block.

1. ``rep_scan`` (forward): raw offsets become repeat codes 1-3 or
   off + 3 under the decoder's repeat-offset rules; the first 3 sequences
   of every block are plain off + 3, so each block's state is its own.
2. ``fse_chain`` (backward): the 3-stream FSE encode state chain over
   batch-shared log-7 tables, with per-sequence (delta_nb, delta_fs)
   packed in one int32 per stream; one fused (value, nbits) item per
   sequence (of | ml << nb_of | ll << (nb_of + nb_ml)) and the final
   states.  RLE streams are doped (dnb = dfs = -128, table all 128) so
   every step emits zero bits and keeps state 0.

Each wrapper launches its CUDA kernel (``csrc/zseqenc.cu``) on CUDA
tensors and runs its plain PyTorch version (``rep_scan_ref``,
``fse_chain_ref``) on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from compress_tpu_torch import _cuda

FSE_LOG = 7        # batch-shared accuracy log (ll/of/ml all <= 7)
SIZE = 1 << FSE_LOG

__all__ = ["rep_scan", "rep_scan_ref", "fse_chain", "fse_chain_ref",
           "pack_deltas", "doped_tables", "FSE_LOG", "SIZE"]


def _wrap32(x: torch.Tensor) -> torch.Tensor:
    """int64 values as int32 arithmetic leaves them (two's complement)."""
    return ((x + (1 << 31)) & 0xFFFFFFFF) - (1 << 31)


def rep_scan_ref(of_v: torch.Tensor, ll_v: torch.Tensor,
                 n_seqs: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch repeat-offset chain, all blocks in step; int32
    arithmetic as the reference's (off + 3 and r1 - 1 wrap, so an offset
    within 3 of INT32_MAX gives a negative value and moves no state)."""
    R, MS = of_v.shape
    dev = of_v.device
    r1 = torch.full((R,), 1, dtype=torch.int64, device=dev)
    r2 = torch.full_like(r1, 4)
    r3 = torch.full_like(r1, 8)
    out = torch.zeros((R, MS), dtype=torch.int32, device=dev)
    n = n_seqs.to(torch.int64)
    steps = int(n.max()) if R else 0
    for i in range(min(steps, MS)):
        off = of_v[:, i].to(torch.int64)
        off3 = _wrap32(off + 3)
        ll0 = ll_v[:, i] == 0
        live = i < n
        val = torch.where(
            ~ll0, torch.where(off == r1, 1, torch.where(
                off == r2, 2, torch.where(off == r3, 3, off3))),
            torch.where(off == r2, 1, torch.where(
                off == r3, 2, torch.where(
                    (off == _wrap32(r1 - 1)) & (off > 0), 3, off3))))
        if i < 3:
            val = off3
        swap = (~ll0 & (val == 2)) | (ll0 & (val == 1))
        rot = (~ll0 & (val == 3)) | (ll0 & (val == 2))
        push = (val > 3) | (ll0 & (val == 3))
        n1 = torch.where(swap, r2, torch.where(rot, r3, torch.where(push, off,
                                                                    r1)))
        n2 = torch.where(swap | rot | push, r1, r2)
        n3 = torch.where(rot | push, r2, r3)
        r1 = torch.where(live, n1, r1)
        r2 = torch.where(live, n2, r2)
        r3 = torch.where(live, n3, r3)
        out[:, i] = torch.where(live, val, 0).to(torch.int32)
    return out


def _require(dev, tensors, what: str) -> None:
    """CUDA, int32 and contiguous, each of ``tensors``."""
    if dev.type != "cuda":
        raise ValueError(f"{what}: expected CUDA tensors, got {dev}")
    for t in tensors:
        if t.dtype != torch.int32 or not t.is_contiguous():
            raise ValueError(f"{what}: expected contiguous int32 tensors, "
                             f"got {t.dtype}")


def rep_scan(of_v: torch.Tensor, ll_v: torch.Tensor,
             n_seqs: torch.Tensor) -> torch.Tensor:
    """(R, MS) raw offsets + literal lengths + (R,) counts -> (R, MS) int32
    offset values (repeat codes applied), 0 past each block's n_seqs."""
    if of_v.dim() != 2 or ll_v.shape != of_v.shape \
            or n_seqs.shape != of_v.shape[:1]:
        raise ValueError("rep_scan: expected (R, MS) of, ll and (R,) n_seqs")
    if not (of_v.device == ll_v.device == n_seqs.device):
        raise ValueError("rep_scan: inputs on different devices")
    dev = of_v.device
    if dev.type == "cpu":
        return rep_scan_ref(of_v, ll_v, n_seqs)
    # lean checks: the kernel takes a few hundredths of a millisecond, so
    # the wrapper's host work is a large share of a call
    _require(dev, (of_v, ll_v, n_seqs), "rep_scan")
    R, MS = of_v.shape
    out = torch.empty((R, MS), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _cuda.library().ct_rep_scan(
            of_v.data_ptr(), ll_v.data_ptr(), n_seqs.data_ptr(),
            out.data_ptr(), R, MS, _cuda.stream(dev))
    _cuda.check(rc, "rep_scan")
    rep_scan.launches += 1
    return out


rep_scan.launches = 0


def _unpack(pk):
    return (pk >> 9) - 128, (pk & 511) - 128      # dnb, dfs


def fse_chain_ref(pk_ll, pk_of, pk_ml, n_seqs, tables):
    """Plain PyTorch FSE chain, all blocks in step (backward)."""
    R, MS = pk_ll.shape
    dev = pk_ll.device
    i64 = torch.int64
    tab = tables.to(i64)
    n = n_seqs.to(i64)
    st = [torch.zeros(R, dtype=i64, device=dev) for _ in range(3)]
    val = torch.zeros((R, MS), dtype=i64, device=dev)
    nbs = torch.zeros((R, MS), dtype=i64, device=dev)
    pks = [pk_ll.to(i64), pk_of.to(i64), pk_ml.to(i64)]
    steps = min(int(n.max()) if R else 0, MS)
    for i in range(steps - 1, -1, -1):
        is_init = i == n - 1
        is_live = i < n - 1
        res = []
        for k in range(3):
            dnb, dfs = _unpack(pks[k][:, i])
            nb = (st[k] + SIZE + dnb) >> 16
            nbc = torch.clamp(nb, 0, 16)
            mask = torch.bitwise_left_shift(torch.ones_like(nbc), nbc) - 1
            v = (st[k] + SIZE) & mask
            lu = torch.clamp(((st[k] + SIZE) >> nbc) + dfs, 0, SIZE - 1)
            enc = tab[k][lu] - SIZE
            nb0 = torch.clamp((dnb + (1 << 15)) >> 16, 0, 16)
            lu0 = torch.clamp((((nb0 << 16) - dnb) >> nb0) + dfs, 0, SIZE - 1)
            init = tab[k][lu0] - SIZE
            st[k] = torch.where(is_init, init, torch.where(is_live, enc, st[k]))
            res.append((v, nb))
        (v_ll, n_ll), (v_of, n_of), (v_ml, n_ml) = res
        vv = (v_of | (v_ml << torch.clamp(n_of, 0, 16))
              | (v_ll << torch.clamp(n_of + n_ml, 0, 26))) & 0xFFFFFFFF
        vv = torch.where(vv >= (1 << 31), vv - (1 << 32), vv)
        val[:, i] = torch.where(is_live, vv, 0)
        nbs[:, i] = torch.where(is_live, n_of + n_ml + n_ll, 0)
    fin = torch.stack(st, dim=1)
    return val.to(torch.int32), nbs.to(torch.int32), fin.to(torch.int32)


def fse_chain(pk_ll, pk_of, pk_ml, n_seqs, tables, *,
              clamped_only: bool = False):
    """Backward FSE encode chain over batch-shared log-7 tables.

    pk_*: (R, MS) int32 packed (dnb + 128) << 9 | (dfs + 128) per stream;
    tables: (3, 128) int32 state tables (ll, of, ml rows, RLE streams doped
    by the caller).  Returns (val, nb) each (R, MS) int32, the fused state
    write per sequence, and fin (R, 3) int32, the final states (ll, of, ml)
    biased by -128.  ``clamped_only`` makes the kernel re-walk with the
    step's clamps where it would step without them (the same results; it
    times the route the kernel's check avoids)."""
    R, MS = pk_ll.shape
    ins = (pk_ll, pk_of, pk_ml)
    if any(t.shape != (R, MS) for t in ins) or n_seqs.shape != (R,) \
            or tables.shape != (3, SIZE):
        raise ValueError("fse_chain: expected (R, MS) fields, (R,) n_seqs "
                         "and (3, 128) tables")
    if any(t.device != pk_ll.device for t in (*ins, n_seqs, tables)):
        raise ValueError("fse_chain: inputs on different devices")
    dev = pk_ll.device
    if dev.type == "cpu":
        return fse_chain_ref(pk_ll, pk_of, pk_ml, n_seqs, tables)
    _require(dev, (*ins, n_seqs, tables), "fse_chain")
    # one allocation: val, nb, then fin
    buf = torch.empty(2 * R * MS + 3 * R, dtype=torch.int32, device=dev)
    p = buf.data_ptr()
    with torch.cuda.device(dev):
        rc = _cuda.library().ct_fse_chain(
            pk_ll.data_ptr(), pk_of.data_ptr(), pk_ml.data_ptr(),
            n_seqs.data_ptr(), tables.data_ptr(), p, p + 4 * R * MS,
            p + 8 * R * MS, R, MS, int(clamped_only), _cuda.stream(dev))
    _cuda.check(rc, "fse_chain")
    fse_chain.launches += 1
    val, nb = buf[:2 * R * MS].view(2, R, MS)
    return val, nb, buf[2 * R * MS:].view(R, 3)


fse_chain.launches = 0


def pack_deltas(dnb, dfs):
    """delta_nb / delta_fs -> packed (dnb + 128) << 9 | (dfs + 128)."""
    return ((dnb + 128) << 9) | (dfs + 128)


def doped_tables(tabs):
    """Batch-shared tables from ``zdev._fse_build`` outputs (nj = 1, log 7):
    (3, 128) state tables and per-symbol packed deltas (3, 64), with RLE
    streams doped so the chain emits zero bits."""
    st = np.zeros((3, SIZE), np.int32)
    pk = np.zeros((3, 64), np.int32)
    for k, t in enumerate(tabs):
        if bool(np.asarray(t["rle"])[0]):
            st[k, :] = SIZE
            pk[k, :] = int(pack_deltas(-SIZE, -SIZE))
        else:
            st[k, :] = np.asarray(t["st"])[0][:SIZE]
            dnb = np.asarray(t["dnb"])[0].astype(np.int64)
            dfs = np.asarray(t["dfs"])[0].astype(np.int64)
            pk[k, :] = pack_deltas(dnb, dfs).astype(np.int32)
    return st, pk
