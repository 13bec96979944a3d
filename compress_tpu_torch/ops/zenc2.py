"""Device zstd encoder v2 (counterpart of the JAX package's ``ops/zenc2.py``).

Per launch of NJ jobs, each cut into 64 KiB blocks:

  1. ``lzkern``   match finder per block (CUDA kernel);
  2. ``_ldm_channel``  winnowed long-range matches over each job and its
     overlap prefix (plain PyTorch), merged where longer;
  3. ``zparse``   parse + gating + sequence/literal extraction (CUDA);
  4. ``zseqenc.rep_scan``  repeat offsets (CUDA);
  5. ``_codes_stage``  codes, batch-shared log-7 FSE tables, per-sequence
     packed deltas and extra bits (plain PyTorch);
  6. ``zseqenc.fse_chain``  the FSE state chain (CUDA);
  7. ``_literal_stage``  per-block Huffman tables, the code lookup
     (``_litlut``, CUDA) and the 4-stream bit-pack (plain PyTorch);
  8. ``_pack_stage``  the sequence bitstream (plain PyTorch).

The FSE tables are shared by all blocks of one launch: the host writes
them into each job's first sequence block and repeats them after.  The
output is the reference's dict, array for array (``zstd/device.py``
assembles frames from it).

Integer hash arithmetic wraps at 32 bits exactly as the reference's int32
does: it is computed in int64 and reduced explicitly.
"""

from __future__ import annotations

import torch

from compress_tpu_torch import _cuda
from compress_tpu_torch.ops import lzkern, zparse, zseqenc
from compress_tpu_torch.ops.common import mul32, wrap32
from compress_tpu_torch.ops.zdev import (_bitpack_rows, _canonical_codes_dev,
                                         _fse_build, _huff_build, _ll_code,
                                         _lut, _ml_code, _of_code)
from compress_tpu_torch.utils.histogram import byte_histograms
from compress_tpu_torch.zstd import seqs as S

BLOCK = 1 << 16         # 64 KiB zstd blocks
MAXSEQ = zparse.MAXSEQ  # 12288
SEQ_TO = 208            # per-128-item tile: <= ~43 seqs * 73 bits + slack
LIT_TO = 192            # per-256-literal tile: <= 256 * 11 bits + slack
FSE_LOG = zseqenc.FSE_LOG

LDM_STRIDE = 16         # one winnowing anchor per 16-byte window
LDM_MIN = 24            # minimum accepted long-range match length
_NW = 16                # verified words (64 bytes) per anchor

# 32-bit multipliers of the fingerprints (the reference's int32 constants)
_K1, _K2, _K3 = -1640531527, -2048144789, -1028477387

_I32 = torch.int32
_I64 = torch.int64


def _words(b: torch.Tensor) -> torch.Tensor:
    """Little-endian 32-bit word at every position of (nj, n) int64 bytes
    (unsigned value; the last 3 positions read past the end)."""
    return b[:, :-3] | (b[:, 1:-2] << 8) | (b[:, 2:-1] << 16) | (b[:, 3:] << 24)


def _ldm_channel(full: torch.Tensor, has_prefix: torch.Tensor, pre: int,
                 job: int):
    """Long-range match channel over each (prefix + job) span.

    Every 16-byte window picks one anchor, the first argmin of an 8-byte
    rolling fingerprint, so both copies of a repeat pick the same content
    positions whatever their alignment.  Anchors are stably sorted by a
    fingerprint of their next 64 bytes: an equal key just before an anchor
    is its nearest previous occurrence, verified 4 bytes at a time.  Two
    rounds of a reach-propagation heal (anchors inside an earlier anchor's
    verified span inherit its offset) and a same-offset chain link extend
    the matches; a match must reach no further back than the job's real
    history and be >= 24 bytes.  Returns per-byte (off, L) over the job
    region, (nj, job) int32 each, nonzero only at anchors."""
    nj, span = full.shape
    dev = full.device
    NS = span // LDM_STRIDE
    bp = torch.nn.functional.pad(full.to(_I64), (0, 96))
    wrd = _words(bp)                                   # (nj, span + 93)

    # winnowing: per-window first argmin of the 8-byte fingerprint
    h = (mul32(wrd[:, :span], _K1) ^ mul32(wrd[:, 4:span + 4], _K2)) \
        & 0x7FFFFFFF
    hw = h.view(nj, NS, LDM_STRIDE)
    t16 = torch.arange(LDM_STRIDE, device=dev)
    d = torch.where(hw == hw.amin(dim=2, keepdim=True), t16,
                    LDM_STRIDE).amin(dim=2)            # (nj, NS)
    a = torch.arange(NS, device=dev)[None, :] * LDM_STRIDE + d

    # the anchor's 16 words (64 bytes), as wrapped int32 values
    Ws = [wrap32(torch.gather(wrd, 1, a + 4 * j)) for j in range(_NW)]
    ha = mul32(Ws[0], _K1) ^ mul32(Ws[1], _K2)
    for k in range(1, 8):
        ha = mul32(ha, _K3) ^ mul32(Ws[2 * k], _K1) ^ mul32(Ws[2 * k + 1], _K2)
    order = torch.sort(wrap32(ha), dim=1, stable=True).indices
    hs = torch.gather(wrap32(ha), 1, order)
    a_s = torch.gather(a, 1, order)

    def prev(x, fill):
        return torch.cat([torch.full_like(x[:, :1], fill), x[:, :-1]], dim=1)

    live = (hs == prev(hs, -(1 << 31))) & (prev(a_s, 1 << 30) < a_s)
    lead = torch.zeros_like(a_s)
    for j in range(_NW):
        w_s = torch.gather(Ws[j], 1, order)
        live = live & (w_s == prev(w_s, -1))
        lead = lead + live.to(_I64)
    # back to anchor order, carrying the candidate position and length
    c = torch.empty_like(a).scatter_(1, order, prev(a_s, 0))
    L = torch.empty_like(a).scatter_(1, order, 4 * lead)
    L = torch.minimum(L, torch.clamp(span - a, min=0))
    off = torch.where(L > 0, a - c, 0)
    valid = L > 0

    def shl(x, s, fill):                               # x[i + s]
        return torch.cat([x[:, s:], torch.full_like(x[:, :s], fill)], dim=1)

    def shr(x, s, fill):                               # x[i - s]
        return torch.cat([torch.full_like(x[:, :s], fill), x[:, :-s]], dim=1)

    steps = [1 << k for k in range(18) if (1 << k) < NS]
    for _round in range(2):
        reach = torch.where(valid, a + L, -1)
        roff = off
        for s in steps:
            sh_r = shr(reach, s, -1)
            sh_o = shr(roff, s, 0)
            take = sh_r > reach
            reach = torch.where(take, sh_r, reach)
            roff = torch.where(take, sh_o, roff)
        heal = (reach - a > L) & (reach > a) & (roff > 0) & (a - roff >= 0)
        off = torch.where(heal, roff, off)
        L = torch.where(heal, reach - a, L)
        valid = valid | heal

        cont = ((shl(off, 1, -1) == off) & valid & (shl(L, 1, 0) > 0)
                & (shl(a, 1, 1 << 30) <= a + L))
        R_ = torch.where(cont, 0, a + L)
        B_ = ~cont
        for s in steps:
            R_ = torch.where(B_, R_, shl(R_, s, 0))
            B_ = B_ | shl(B_, s, True)
        L = torch.where(valid, R_ - a, 0)

    okpre = has_prefix.to(torch.bool)[:, None] | (a - off >= pre)
    L = torch.where(valid & okpre & (L >= LDM_MIN), L, 0)
    offv = torch.where(L > 0, off, 0)
    off_full = torch.zeros((nj, span), dtype=_I32, device=dev)
    L_full = torch.zeros((nj, span), dtype=_I32, device=dev)
    off_full.scatter_(1, a, offv.to(_I32))
    L_full.scatter_(1, a, L.to(_I32))
    return (off_full[:, pre:].contiguous(), L_full[:, pre:].contiguous())


def _litlut_ref(lits: torch.Tensor, packed_tab: torch.Tensor):
    """Plain PyTorch code lookup: e = table[lit], (e & 0xFFFF, e >> 16)."""
    R = lits.shape[0]
    e = torch.gather(packed_tab.reshape(R, 256).to(_I32), 1, lits.to(_I64))
    return e & 0xFFFF, e >> 16


def _litlut(lits: torch.Tensor, packed_tab: torch.Tensor):
    """lits (R, BS) u8 + packed per-block tables (R, 2, 128) int32
    (code | nb << 16, entry x at [x >> 7, x & 127]) -> (code, nb) each
    (R, BS) int32.  A CUDA tensor goes through the CUDA kernel
    (``csrc/litlut.cu``), a CPU tensor through ``_litlut_ref``.  BS is a
    multiple of 4; ``lits`` may start at any address."""
    if lits.dim() != 2 or packed_tab.shape != (lits.shape[0], 2, 128):
        raise ValueError("_litlut: expected (R, BS) lits and (R, 2, 128) "
                         "tables")
    dev = lits.device
    if packed_tab.device != dev:
        raise ValueError("_litlut: inputs on different devices")
    if dev.type == "cpu":
        return _litlut_ref(lits, packed_tab)
    # The checks and the one allocation are kept lean: at 64 KiB rows the
    # kernel takes about 0.1 ms, so the wrapper's host work is a large
    # share of a call.
    if dev.type != "cuda":
        raise ValueError(f"_litlut: expected a CUDA tensor, got {dev}")
    R, bs = lits.shape
    if lits.dtype != torch.uint8 or packed_tab.dtype != _I32:
        raise ValueError(f"_litlut: expected uint8 lits and int32 tables, "
                         f"got {lits.dtype} and {packed_tab.dtype}")
    if not (lits.is_contiguous() and packed_tab.is_contiguous()):
        raise ValueError("_litlut: expected contiguous tensors")
    if bs % 4:
        raise ValueError(f"_litlut: block size {bs} is not a multiple of 4")
    out = torch.empty((2, R, bs), dtype=_I32, device=dev)   # code, nbits
    ptr = out.data_ptr()
    with torch.cuda.device(dev):
        rc = _cuda.library().ct_litlut(
            lits.data_ptr(), packed_tab.data_ptr(), ptr, ptr + 4 * R * bs,
            R, bs, _cuda.stream(dev))
    _cuda.check(rc, "_litlut")
    _litlut.launches += 1
    return out[0], out[1]


_litlut.launches = 0


def _literal_tables(lits: torch.Tensor, lit_cnt: torch.Tensor, bs: int):
    """Per-block Huffman tables of the compacted literals: (is_lit (R, bs),
    nbits (R, 256), max_bits, huff_ok, packed (R, 2, 128) code | nb << 16)."""
    R = lits.shape[0]
    idx = torch.arange(bs, device=lits.device, dtype=_I64)[None, :]
    is_lit = idx < lit_cnt.to(_I64)[:, None]
    hist = byte_histograms(lits, is_lit).to(_I64)
    nbits_t, max_bits, huff_ok = _huff_build(hist)
    codes_t = _canonical_codes_dev(nbits_t, max_bits)
    packed_tab = (codes_t | (nbits_t << 16)).view(R, 2, 128).contiguous()
    return is_lit, nbits_t, max_bits, huff_ok, packed_tab


def _literal_stage(lits: torch.Tensor, lit_cnt: torch.Tensor, bs: int):
    """Per-block huff0 literal path on the compacted literals: table build,
    code lookup, 4-stream split and bit-pack.  Returns (nbits (R, 256),
    max_bits, huff_ok, stream bits (R, 4), halves, n_halves)."""
    R = lits.shape[0]
    dev = lits.device
    idx = torch.arange(bs, device=dev, dtype=_I64)[None, :]
    is_lit, nbits_t, max_bits, huff_ok, packed_tab = _literal_tables(
        lits, lit_cnt, bs)
    lcode, lnb = _litlut(lits.contiguous(), packed_tab)
    lnb = torch.where(is_lit, lnb.to(_I64), 0)
    lcode = torch.where(is_lit, lcode.to(_I64), 0)

    seg = (lit_cnt.to(_I64)[:, None] + 3) >> 2
    q = torch.clamp(idx // torch.clamp(seg, min=1), 0, 3)
    cs = torch.cumsum(lnb, dim=1)
    bq = torch.zeros((R, 4), dtype=_I64, device=dev).scatter_add_(1, q, lnb)
    prev_bits = torch.cumsum(bq, dim=1) - bq
    c_in_q = cs - torch.gather(prev_bits, 1, q)
    sh = (bq + 16) >> 4
    zero = torch.zeros_like(sh[:, 0])
    sbase = torch.stack([sh[:, 1] + sh[:, 2] + sh[:, 3], sh[:, 2] + sh[:, 3],
                         sh[:, 3], zero], dim=1)
    dest_bit = (16 * torch.gather(sbase, 1, q)
                + (torch.gather(bq, 1, q) - c_in_q))
    dest_bit = torch.where(is_lit, dest_bit, 0)
    lit_halves, lit_nh = _bitpack_rows(
        torch.flip(lcode, [1]), torch.flip(lnb, [1]),
        torch.flip(dest_bit, [1]), LIT_TO,
        region_end=sbase[:, 0] + sh[:, 0], T=256, max_item_bits=11)
    return nbits_t, max_bits, huff_ok, bq.to(_I32), lit_halves, lit_nh


def _codes_stage(ll_v, ml_v, of_v2, n_seqs):
    """Sequence codes, the batch-shared FSE tables (RLE streams doped),
    per-sequence packed deltas and the extra bits."""
    R, MS = ll_v.shape
    dev = ll_v.device
    si = torch.arange(MS, device=dev)[None, :]
    is_seq = si < n_seqs.to(_I64)[:, None]
    ll_c = torch.where(is_seq, _ll_code(ll_v), 0)
    ml_c = torch.where(is_seq, _ml_code(torch.clamp(ml_v, min=3)), 0)
    of_c = torch.where(is_seq, _of_code(torch.clamp(of_v2, min=1)), 0)

    codes = (ll_c, of_c, ml_c)
    tabs = [_fse_build(c, is_seq, 1, FSE_LOG) for c in codes]
    size = 1 << FSE_LOG
    st_rows, pks = [], []
    for t, c in zip(tabs, codes):
        rle = t["rle"][0]
        st_rows.append(torch.where(rle, size, t["st"][0][:size]))
        dnb_i = _lut(torch.where(rle, -size, t["dnb"][0]), c).to(_I64)
        dfs_i = _lut(torch.where(rle, -size, t["dfs"][0]), c).to(_I64)
        pks.append(zseqenc.pack_deltas(dnb_i, dfs_i).to(_I32))
    tables = torch.stack(st_rows, dim=0).to(_I32)

    llc = torch.clamp(ll_c, max=35)
    mlc = torch.clamp(ml_c, max=52)
    extras = [
        ll_v - _lut(S.LL_BASELINE, llc), _lut(S.LL_BITS, llc),
        ml_v - _lut(S.ML_BASELINE, mlc), _lut(S.ML_BITS, mlc),
        of_v2 - torch.bitwise_left_shift(torch.ones_like(of_c),
                                         torch.clamp(of_c, 0, 30)),
        of_c,
    ]
    extras = [torch.where(is_seq, x, 0).to(_I32) for x in extras]
    norm = torch.cat([t["norm"] for t in tabs], dim=0)            # (3, 64)
    rle3 = torch.stack([t["rle"][0] for t in tabs])
    rle_sym3 = torch.stack([t["rle_sym"][0] for t in tabs])
    return (*pks, tables, extras, norm, rle3, rle_sym3)


def _pack_stage(st_val, st_nb, st_fin, extras, rle3, n_seqs):
    """Per-sequence items in write order ([fused states, llx | mlx, ofx],
    last sequence first) plus the final-state flush, bit-packed."""
    R, MS = st_val.shape
    llx_v, llx_n, mlx_v, mlx_n, ofx_v, ofx_n = (
        torch.flip(x.to(_I64), [1]) for x in extras)
    x2_v = llx_v | (mlx_v << torch.clamp(llx_n, 0, 16))
    items_v = torch.stack([torch.flip(st_val.to(_I64), [1]), x2_v, ofx_v],
                          dim=2).view(R, MS * 3)
    items_n = torch.stack([torch.flip(st_nb.to(_I64), [1]), llx_n + mlx_n,
                           ofx_n], dim=2).view(R, MS * 3)

    has_seq = (n_seqs > 0)[:, None]
    log7 = torch.where(rle3, 0, FSE_LOG).to(_I64)           # ll, of, ml
    fin = st_fin.to(_I64)
    fl_v = (fin[:, 2] | (fin[:, 1] << log7[2])
            | (fin[:, 0] << (log7[2] + log7[1])))[:, None]
    fl_n = torch.where(has_seq, log7.sum(), 0)
    pad = (-(MS * 3 + 1)) % 512
    zeros = torch.zeros((R, pad), dtype=_I64, device=st_val.device)
    items_v = torch.cat([items_v, torch.where(has_seq, fl_v, 0), zeros], dim=1)
    items_n = torch.cat([items_n, fl_n, zeros], dim=1)
    cum = torch.cumsum(items_n, dim=1)
    total = cum[:, -1]
    seq_halves, seq_nh = _bitpack_rows(items_v, items_n, cum - items_n, SEQ_TO,
                                       region_end=(total + 16) >> 4, T=128)
    return seq_halves, seq_nh, total.to(_I32)


def _merged_matches(jobs: torch.Tensor, prefixes: torch.Tensor,
                    has_prefix: torch.Tensor):
    """(blocks (R, BLOCK) u8, off, L, use) of jobs (NJ, job): the finder's
    block-local matches, replaced by the long-range channel's job-wide
    ones where those are longer (``use``, bool)."""
    nj, job = jobs.shape
    R = nj * (job // BLOCK)
    blocks = jobs.reshape(R, BLOCK)
    off, L = lzkern.find_matches_blocks(blocks)
    full = torch.cat([prefixes, jobs], dim=1)
    off_l, L_l = (x.reshape(R, BLOCK) for x in
                  _ldm_channel(full, has_prefix, prefixes.shape[1], job))
    use = L_l > L
    return blocks, torch.where(use, off_l, off), torch.where(use, L_l, L), use


def zstd_encode_jobs_v2(jobs: torch.Tensor, *, job: int,
                        prefixes: torch.Tensor, has_prefix: torch.Tensor):
    """jobs: (NJ, job) uint8 on its device -> the reference's 18-array dict.

    The blocks are BLOCK bytes.  ``prefixes`` (NJ, PRE) uint8 is each
    job's overlap history and ``has_prefix`` (NJ,) says which is real."""
    nj = jobs.shape[0]
    nblk = job // BLOCK
    blocks, off, L, _ = _merged_matches(jobs, prefixes, has_prefix)

    ll_v, ml_v, of_raw, lits, n_seqs, lit_cnt = zparse.parse_blocks(
        blocks, off, L)
    of_v2 = zseqenc.rep_scan(of_raw, ll_v, n_seqs)
    (pk_ll, pk_of, pk_ml, tables, extras, norm, rle3,
     rle_sym3) = _codes_stage(ll_v, ml_v, of_v2, n_seqs)
    st_val, st_nb, st_fin = zseqenc.fse_chain(pk_ll, pk_of, pk_ml, n_seqs,
                                              tables)
    nbits_t, max_bits, huff_ok, bq, lit_halves, lit_nh = _literal_stage(
        lits, lit_cnt, BLOCK)
    seq_halves, seq_nh, seq_total_bits = _pack_stage(
        st_val, st_nb, st_fin, extras, rle3, n_seqs)

    log7 = torch.where(rle3, 0, FSE_LOG).to(_I32)
    return dict(
        n_seqs=n_seqs.reshape(nj, nblk),
        lit_cnt=lit_cnt.reshape(nj, nblk),
        ll=ll_v.reshape(nj, nblk, MAXSEQ),
        ml=ml_v.reshape(nj, nblk, MAXSEQ),
        ofv=of_v2.reshape(nj, nblk, MAXSEQ),
        nbits=nbits_t.reshape(nj, nblk, 256),
        max_bits=max_bits.reshape(nj, nblk),
        huff_ok=huff_ok.reshape(nj, nblk),
        stream_bits=bq.reshape(nj, nblk, 4),
        lit_halves=lit_halves.reshape(nj, nblk, -1),
        lit_nh=lit_nh.reshape(nj, nblk),
        seq_halves=seq_halves.reshape(nj, nblk, -1),
        seq_nh=seq_nh.reshape(nj, nblk),
        seq_total_bits=seq_total_bits.reshape(nj, nblk),
        fse_norm=norm[None].expand(nj, 3, 64),
        fse_log=log7[None].expand(nj, 3),
        fse_rle=rle3[None].expand(nj, 3),
        fse_rle_sym=rle_sym3[None].expand(nj, 3),
    )
