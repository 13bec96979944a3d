"""Batched huff0 4X and raw FSE encode (counterpart of the JAX package's
``ops/entropy.py``: ``huff0_encode_blocks``, ``_fse_tables_bytes`` and
``fse_encode_blocks``).

All blocks of a batch share one length L (a multiple of 512): per-block
(or batch-shared) Kraft-repaired code lengths and canonical codes from
the ``zdev`` helpers, the 4 streams at descending half bases (stream 3
first), one bit-pack, and the decode checkpoints (the remaining-bit
offset of every stream at every HUFF_CKPT_K-th symbol).  The reference
computes this as XLA graphs with bf16 one-hot sums; here it is plain
PyTorch on whatever device the blocks are on, with integer histograms and
gathers giving the same integers; the per-row histograms
(``byte_histograms``, from ``utils/histogram.py``) are a CUDA kernel on
CUDA tensors.

FSE: per-block tables over the byte alphabet (``_fse_tables_bytes``, the
construction of ``zdev._fse_build`` at 256 symbols), then the classic
2-state interleaved chain (``fse/core.py`` ``encode_interleaved2``) from the
last symbol pair down, one bit-pack item per pair.  The chain is a CUDA
kernel (``csrc/fseenc.cu``: a lane a row walks a compact next-state table
with a one-load step, its warp writes the items) on CUDA tensors and
``fse_encode_chain_ref`` on CPU tensors; the reference runs it as a
``lax.scan`` with one-hot lookups.
"""

from __future__ import annotations

import torch

from compress_tpu_torch import _cuda
from compress_tpu_torch.ops.common import floor_log2, wrap32
from compress_tpu_torch.ops.zdev import (_bitpack_rows, _canonical_codes_dev,
                                         _huff_build, _normalize_count,
                                         _unsort)
from compress_tpu_torch.utils.histogram import (  # noqa: F401 (re-exported)
    byte_histograms, byte_histograms_ref)

FSE_LOG = 9       # fixed accuracy log for the batched device path
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
    hist = byte_histograms(blocks).to(_I64)
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


# ---------------------------------------------------------------------------
# raw FSE (2-state interleaved, byte alphabet)
# ---------------------------------------------------------------------------


def _fse_tables_bytes(hist: torch.Tensor, log: int):
    """Per-block encode tables over the 256-symbol byte alphabet: (state
    table (N, 1 << log), delta_nb (N, 256), delta_fs (N, 256), norm (N,
    256)), int32.  The spread routes the k-th slot of the co-prime walk to
    the symbol whose cumulative norm covers k; a slot's rank among its
    symbol's slots comes from a stable sort."""
    N = hist.shape[0]
    dev = hist.device
    size = 1 << log
    norm = _normalize_count(hist, log).to(_I64)
    cumul = torch.cumsum(norm, dim=1) - norm
    cum_incl = cumul + norm
    kk = torch.arange(size, device=dev, dtype=_I64)
    step = (size >> 1) + (size >> 3) + 3
    pk = (kk * step) % size
    sym_of_k = torch.searchsorted(cum_incl, kk.expand(N, size).contiguous(),
                                  right=True)
    spread = torch.zeros((N, size), dtype=_I64, device=dev)
    spread[:, pk] = sym_of_k
    order = torch.sort(spread, dim=1, stable=True).indices
    sym_s = torch.gather(spread, 1, order)
    first = torch.searchsorted(sym_s, sym_s)          # group start
    r_u = _unsort(order, kk - first)
    cumul_of_u = torch.gather(cumul, 1, spread)
    dest = torch.clamp(cumul_of_u + r_u, 0, size - 1)
    state_table = torch.zeros((N, size), dtype=_I64, device=dev)
    state_table.scatter_add_(1, dest, (size + kk).expand(N, size))
    maxbits = log - floor_log2(torch.clamp(norm - 1, min=1))
    delta_nb = torch.where(norm > 1, (maxbits << 16) - (norm << maxbits),
                           (log << 16) - size)
    delta_fs = cumul - norm
    return (state_table.to(_I32), delta_nb.to(_I32), delta_fs.to(_I32),
            norm.to(_I32))


def _chain_width(L: int) -> int:
    """Items a row: L / 2 - 1 state-write pairs and the flush, padded to a
    multiple of 512."""
    steps = L // 2 - 1
    return steps + 1 + (-(steps + 1)) % 512


def _chain_check(blocks, st, dnb, dfs, log: int):
    if blocks.dim() != 2 or blocks.dtype != torch.uint8:
        raise ValueError("fse_encode_chain: expected (N, L) uint8 blocks")
    N, L = blocks.shape
    if L < 2 or L % 2:
        raise ValueError(f"fse_encode_chain: row length {L} is not even "
                         "and at least 2")
    if not 1 <= log <= 12:
        raise ValueError(f"fse_encode_chain: log {log} outside 1..12")
    if st.shape != (N, 1 << log) or dnb.shape != (N, 256) \
            or dfs.shape != (N, 256):
        raise ValueError("fse_encode_chain: expected (N, 1 << log) state "
                         "and (N, 256) delta tables")
    if any(t.device != blocks.device for t in (st, dnb, dfs)):
        raise ValueError("fse_encode_chain: inputs on different devices")
    return N, L


def fse_encode_chain_ref(blocks, st, dnb, dfs, log: int = FSE_LOG):
    """Plain version of ``fse_encode_chain``."""
    N, L = _chain_check(blocks, st, dnb, dfs, log)
    size = 1 << log
    b = blocks.to(_I64)
    st, dnb, dfs = (t.to(_I64) for t in (st, dnb, dfs))

    def look(table, idx):
        return torch.gather(table, 1, idx[:, None])[:, 0]

    def first(x):
        d = look(dnb, x)
        nb = wrap32(d + (1 << 15)) >> 16
        im = wrap32((nb << 16) - d)
        lu = wrap32((im >> nb.clamp(0, 16)) + look(dfs, x))
        return look(st, lu.clamp(0, size - 1))

    def enc(s, x):
        nb = wrap32(s + look(dnb, x)) >> 16
        c = nb.clamp(0, 16)
        nxt = look(st, wrap32((s >> c) + look(dfs, x)).clamp(0, size - 1))
        return nxt, s & ((1 << c) - 1), c, nb

    s2 = first(b[:, L - 1])
    s1 = first(b[:, L - 2])
    vals, nbs = [], []
    for m in range(L // 2 - 2, -1, -1):
        s2, v2, c2, nb2 = enc(s2, b[:, 2 * m + 1])
        s1, v1, _, nb1 = enc(s1, b[:, 2 * m])
        vals.append(wrap32(v2 | (v1 << c2)))
        nbs.append(wrap32(nb1 + nb2))
    vals.append(wrap32((s2 - size) | ((s1 - size) << log)))
    nbs.append(torch.full_like(s1, 2 * log))
    pad = _chain_width(L) - len(vals)
    out_v = torch.cat([torch.stack(vals, 1), s1.new_zeros((N, pad))], 1)
    out_n = torch.cat([torch.stack(nbs, 1), s1.new_zeros((N, pad))], 1)
    return out_v.to(_I32), out_n.to(_I32)


def fse_encode_chain(blocks: torch.Tensor, st: torch.Tensor,
                     dnb: torch.Tensor, dfs: torch.Tensor,
                     log: int = FSE_LOG, *, routes: torch.Tensor | None = None):
    """The FSE chain of each row, from its first states to its flush.

    blocks (N, L) uint8, L even; st (N, 1 << log), dnb and dfs (N, 256)
    int32 (``_fse_tables_bytes``).  Returns (vals, nbs), each (N, W) int32
    with W = ``_chain_width(L)``: item j < L / 2 - 1 holds step j's two
    state writes (s2's bits low, then s1's), item L / 2 - 1 the flush of
    the final states, the rest 0.  A CUDA tensor goes through the kernel
    (``csrc/fseenc.cu``, one launch: a compact next-state table a row and
    a one-load step where the row's tables allow it, the exact step
    elsewhere), a CPU tensor through ``fse_encode_chain_ref``.  ``routes``,
    a (2,) int32 CUDA tensor, gets the kernel's count of rows on the
    one-load step and on the exact step added to it."""
    if blocks.device.type == "cpu":
        return fse_encode_chain_ref(blocks, st, dnb, dfs, log)
    N, L = _chain_check(blocks, st, dnb, dfs, log)
    dev = blocks.device
    for name, t, dtype, shape in (("blocks", blocks, torch.uint8, (N, L)),
                                  ("st", st, _I32, (N, 1 << log)),
                                  ("dnb", dnb, _I32, (N, 256)),
                                  ("dfs", dfs, _I32, (N, 256))):
        _cuda.require_cuda_input(t, f"fse_encode_chain: {name}", dtype, shape)
    if routes is not None:
        _cuda.require_cuda_input(routes, "fse_encode_chain: routes", _I32,
                                 (2,))
        if routes.device != dev:
            raise ValueError("fse_encode_chain: routes on another device")
    W = _chain_width(L)
    out = torch.empty((2, N, W), dtype=_I32, device=dev)
    ptr = out.data_ptr()
    with torch.cuda.device(dev):
        rc = _cuda.library().ct_fse_encode(
            blocks.data_ptr(), st.data_ptr(), dnb.data_ptr(), dfs.data_ptr(),
            N, L, log, W, ptr, ptr + 4 * N * W,
            None if routes is None else routes.data_ptr(), _cuda.stream(dev))
    _cuda.check(rc, "fse_encode_chain")
    fse_encode_chain.launches += 1
    return out[0], out[1]


fse_encode_chain.launches = 0


def fse_encode_blocks(blocks: torch.Tensor, log: int = FSE_LOG) -> dict:
    """(N, L) uint8, L even -> dict of int32 tensors: norm (N, 256),
    total_bits (N,), halves (N, W // 256 * 384), n_halves (N,), hist (N,
    256).  The bitstream equals ``fse/core.py`` ``encode_interleaved2``'s
    for the same norm and log; the host writes [uvarint n][ncount][stream]
    and the end marker."""
    N, L = blocks.shape
    if L % 2 or L < 2:
        raise ValueError(f"fse_encode_blocks: row length {L} is not even "
                         "and at least 2")
    hist = byte_histograms(blocks)
    st, dnb, dfs, norm = _fse_tables_bytes(hist, log)
    vals, nbs = fse_encode_chain(blocks, st, dnb, dfs, log)
    cum = torch.cumsum(nbs.to(_I64), dim=1)
    dest = cum - nbs
    total_bits = cum[:, -1]
    # one item = two state writes (<= 2 log bits): 256-item tiles bound the
    # per-tile span at 256 * 18 / 16 + 2 = 290 halves at log 9
    halves, n_halves = _bitpack_rows(vals, nbs, dest, 384,
                                     (total_bits + 16) >> 4, T=256)
    return dict(norm=norm, total_bits=total_bits.to(_I32), halves=halves,
                n_halves=n_halves, hist=hist)
