"""Batched huff0 decode with one table per container (counterpart of the
JAX package's ``ops/entropy_dec.py``: ``WIN``, ``expand_table``,
``build_windows``, ``huff0_decode_chunks``).

The encoder's checkpoints (``ops/entropy.py`` ``ckpt``: the remaining-bit
offset of a stream every HUFF_CKPT_K symbols) cut each stream into chunks
that decode independently.  The host cuts each chunk's 52-byte window
(``build_windows``) and expands each container's table to 2048 int32
entries ``sym | nb << 8`` (``expand_table``: an 11-bit peek whatever its
max_bits; the reference packs float32 ``sym * 16 + nb`` as (64, 32) for
its lane gathers, which the kernel here does not need); the symbol loop
runs on the device, through the chunk kernel of ``ops/entropy_kern.py``
with a per-container table on CUDA tensors, and through
``huff0_decode_chunks_ref`` on CPU tensors.
"""

from __future__ import annotations

import numpy as np
import torch

from compress_tpu_torch.ops.entropy import HUFF_CKPT_K
from compress_tpu_torch.ops.entropy_kern import decode_chunks_plain, launch

WIN = 52          # window bytes per chunk (>= ceil(K*11/8) + peek slack)

__all__ = ["WIN", "expand_table", "build_windows", "huff0_decode_chunks",
           "huff0_decode_chunks_ref"]


def expand_table(sym_t, nb_t, max_bits: int):
    """Host: expand a 2^max_bits dtable to (2048,) int32 entries
    sym | nbits << 8, one per 11-bit peek."""
    idx = np.arange(2048) >> (11 - max_bits)
    return (sym_t[idx].astype(np.int32)
            | (nb_t[idx].astype(np.int32) << 8))


def build_windows(stream: bytes, ckpt: np.ndarray, nchunks: int,
                  win: int = WIN):
    """Host: per-chunk byte windows + window-local bit offsets.

    ckpt[c] = remaining-bit offset at the start of chunk c (descending).
    Returns (windows (nchunks, win) uint8, lbit (nchunks,) int32)."""
    ck = ckpt[:nchunks].astype(np.int64)
    wtop = (np.maximum(ck, 1) - 1) >> 3           # byte holding top bit
    wlo = wtop - (win - 1)
    buf = np.frombuffer(stream, np.uint8)
    padded = np.concatenate([np.zeros(win, np.uint8), buf])
    idx = wlo[:, None] + np.arange(win)[None, :] + win
    windows = padded[np.clip(idx, 0, len(padded) - 1)]
    windows[idx >= len(padded)] = 0
    lbit = (ck - 8 * wlo).astype(np.int32)
    return windows, lbit


def _check(windows, lbit, nsym, tables):
    N, C = lbit.shape
    if windows.dim() != 3 or windows.shape[:2] != (N, C) \
            or nsym.shape != (N, C) or tables.shape != (N, 2048):
        raise ValueError("expected (N, C, win) windows, (N, C) lbit and "
                         "nsym, (N, 2048) tables")
    if any(t.device != windows.device for t in (lbit, nsym, tables)):
        raise ValueError("huff0_decode_chunks: inputs on different devices")


def huff0_decode_chunks_ref(windows, lbit, nsym, tables,
                            k: int = HUFF_CKPT_K):
    """Plain version of ``huff0_decode_chunks``."""
    _check(windows, lbit, nsym, tables)
    N, C, win = windows.shape
    syms, endl = decode_chunks_plain(
        windows.reshape(N * C, win), lbit.reshape(-1), nsym.reshape(-1),
        tables, C, k, 11)
    return syms.view(N, C, k), endl.view(N, C)


def huff0_decode_chunks(windows: torch.Tensor, lbit: torch.Tensor,
                        nsym: torch.Tensor, tables: torch.Tensor,
                        k: int = HUFF_CKPT_K):
    """Decode up to k symbols per chunk.

    windows (N, C, WIN) uint8; lbit, nsym (N, C) int32 (window-local
    cursor, symbols in the chunk, 0 for pad chunks); tables (N, 2048)
    int32 per ``expand_table``.  Returns (syms (N, C, k) uint8, end
    lbit (N, C) int32)."""
    if windows.device.type == "cpu":
        return huff0_decode_chunks_ref(windows, lbit, nsym, tables, k)
    _check(windows, lbit, nsym, tables)
    N, C, win = windows.shape
    syms, endl = launch(windows.reshape(N * C, win), lbit.reshape(-1),
                        nsym.reshape(-1), tables, C, k, 11)
    huff0_decode_chunks.launches += 1
    return syms.view(N, C, k), endl.view(N, C)


huff0_decode_chunks.launches = 0
