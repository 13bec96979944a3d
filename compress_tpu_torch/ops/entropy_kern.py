"""Chunked huff0 decode with a batch-shared table (counterpart of the JAX
package's ``ops/entropy_pallas.py`` ``huff0_decode_chunks_shared``).

Each chunk is K symbols of one of a container's 4 streams, cut at an
encoder checkpoint.  Per chunk, from the window-local cursor ``lbit``,
``nsym`` <= k times: peek the ``max_bits`` bits below the cursor
(zero-padded below bit 0; window bytes past its end read 0), look up
``sym | nb << 8`` in the table, emit ``sym`` and subtract ``nb``.
Inactive steps emit 0 and keep the cursor.

``huff0_decode_chunks_shared`` launches the CUDA kernel
(``csrc/huff0dec.cu``) on CUDA tensors and runs
``huff0_decode_chunks_shared_ref`` on CPU tensors.  The same kernel, with
one 2048-entry table per container, serves ``ops/entropy_dec.py``.  On
CUDA tensors a call is one launch and one allocation (symbols and end
cursors are views of it).
"""

from __future__ import annotations

import torch

from compress_tpu_torch import _cuda

__all__ = ["huff0_decode_chunks_shared", "huff0_decode_chunks_shared_ref"]

_I64 = torch.int64


def decode_chunks_plain(windows, lbit, nsym, tabs, per_row: int, k: int,
                        max_bits: int):
    """Plain PyTorch chunk decode, all chunks in step: windows (NC, win)
    uint8, lbit/nsym (NC,), tabs (rows, 2^max_bits) packed entries, chunk
    c reading row c // per_row (row 0 when per_row is 0).  Returns (syms
    (NC, k) uint8, end cursors (NC,) int32)."""
    nc, win = windows.shape
    dev = windows.device
    w = windows.to(_I64)
    if win % 2:
        w = torch.nn.functional.pad(w, (0, 1))
    nh = w.shape[1] // 2
    # halfwords, plus one zero halfword that every index past the window
    # reads
    hw = torch.cat([w[:, 0::2] | (w[:, 1::2] << 8),
                    torch.zeros((nc, 1), dtype=_I64, device=dev)], dim=1)
    size = 1 << max_bits
    tab = tabs.to(_I64).reshape(-1)
    row = (torch.arange(nc, device=dev) // per_row if per_row
           else torch.zeros(nc, dtype=_I64, device=dev))
    row_base = row * size
    lbp = lbit.to(_I64)
    ns = nsym.to(_I64)
    syms = torch.zeros((nc, k), dtype=torch.uint8, device=dev)
    for i in range(k):
        bp = lbp - max_bits
        bpc = bp.clamp(min=0)
        hsel = bpc >> 4
        s = bpc & 15
        h0 = torch.gather(hw, 1, hsel.clamp(max=nh)[:, None])[:, 0]
        h1 = torch.gather(hw, 1, (hsel + 1).clamp(max=nh)[:, None])[:, 0]
        w32 = (h0 >> s) | (h1 << (16 - s))
        # a zero-pad shift of mb or more leaves no peek bits
        peek = (w32 << (bpc - bp).clamp(max=31)) & (size - 1)
        e = tab[row_base + peek]
        active = i < ns
        syms[:, i] = torch.where(active, e & 255, 0).to(torch.uint8)
        lbp = torch.where(active, lbp - (e >> 8), lbp)
    return syms, lbp.to(torch.int32)


def launch(windows, lbit, nsym, tabs, per_row: int, k: int, max_bits: int):
    """Run ``csrc/huff0dec.cu`` on CUDA tensors (arguments as for
    ``decode_chunks_plain``, the windows (..., win) with NC rows and lbit,
    nsym NC contiguous int32); returns (syms (..., k), end cursors (...))
    shaped like the windows' leading dimensions, views of one allocation.
    Its checks read only shapes, types and devices."""
    win = windows.shape[-1]
    lead = windows.shape[:-1]
    nc = windows.numel() // win if win else 0
    rows = -(-nc // per_row) if per_row else 1
    gd = windows.get_device()
    if gd < 0 or windows.dtype != torch.uint8 \
            or not windows.is_contiguous():
        raise ValueError("windows: expected a contiguous CUDA uint8 tensor")
    for name, t, n in (("lbit", lbit, nc), ("nsym", nsym, nc),
                       ("tables", tabs, rows << max_bits)):
        if t.dtype != torch.int32 or t.numel() != n \
                or t.get_device() != gd or not t.is_contiguous():
            raise ValueError(f"{name}: expected {n} contiguous int32 on "
                             f"cuda:{gd}, got {tuple(t.shape)} {t.dtype} "
                             f"on {t.device}")
    if win % 4 or win > 64 or win < 4:
        raise ValueError("windows: expected a width that is a multiple of "
                         f"4 up to 64 bytes, got {win}")
    if not 1 <= max_bits <= 11 or k < 1:
        raise ValueError(f"expected 1 <= max_bits <= 11 and k >= 1, got "
                         f"{max_bits}, {k}")
    windows = _cuda.aligned(windows)
    sym_bytes = -(-nc * k // 16) * 16
    buf = torch.empty(sym_bytes + 4 * nc, dtype=torch.uint8,
                      device=windows.device)
    syms = buf[:nc * k].view(*lead, k)
    endl = buf[sym_bytes:].view(torch.int32).view(lead)
    args = (windows.data_ptr(), lbit.data_ptr(), nsym.data_ptr(),
            tabs.data_ptr(), per_row, nc, win, k, max_bits, syms.data_ptr(),
            endl.data_ptr(), torch._C._cuda_getCurrentRawStream(gd))
    lib = _cuda.library()
    if gd == torch.cuda.current_device():
        rc = lib.ct_huff0_decode(*args)
    else:
        with torch.cuda.device(gd):
            rc = lib.ct_huff0_decode(*args)
    _cuda.check(rc, "huff0 decode")
    return syms, endl


def _check(windows, lbit, nsym, table):
    if windows.dim() != 2 or lbit.shape != windows.shape[:1] \
            or nsym.shape != lbit.shape:
        raise ValueError("expected (NC, win) windows and (NC,) lbit, nsym")
    if any(t.device != windows.device for t in (lbit, nsym, table)):
        raise ValueError("huff0 decode: inputs on different devices")


def huff0_decode_chunks_shared_ref(windows, lbit, nsym, table_packed,
                                   k: int = 32, max_bits: int = 8):
    """Plain version of ``huff0_decode_chunks_shared``."""
    _check(windows, lbit, nsym, table_packed)
    return decode_chunks_plain(windows, lbit, nsym,
                               table_packed.reshape(1, -1), 0, k, max_bits)


def huff0_decode_chunks_shared(windows: torch.Tensor, lbit: torch.Tensor,
                               nsym: torch.Tensor, table_packed: torch.Tensor,
                               k: int = 32, max_bits: int = 8):
    """windows (NC, win) uint8; lbit, nsym (NC,) int32; table_packed
    (2^max_bits,) int32 entries sym | nb << 8, indexed by the max_bits bits
    [lbit - max_bits, lbit).  Returns (syms (NC, k) uint8, end lbit (NC,)
    int32)."""
    if table_packed.shape != (1 << max_bits,):
        raise ValueError(f"table_packed: expected ({1 << max_bits},), got "
                         f"{tuple(table_packed.shape)}")
    if windows.device.type == "cpu":
        return huff0_decode_chunks_shared_ref(windows, lbit, nsym,
                                              table_packed, k, max_bits)
    _check(windows, lbit, nsym, table_packed)
    out = launch(windows, lbit, nsym, table_packed.reshape(1, -1), 0, k,
                 max_bits)
    huff0_decode_chunks_shared.launches += 1
    return out


huff0_decode_chunks_shared.launches = 0
