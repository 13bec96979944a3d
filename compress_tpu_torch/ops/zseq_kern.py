"""Chunked zstd sequence decode with a batch-shared table set (counterpart
of the JAX package's ``ops/zseq_pallas.py``: ``K``, ``WIN``,
``pack_tables``, ``zseq_decode_chunks_shared``, ``_skip_literals``,
``seq_section``, ``prep_frames``).

A chunk is up to K sequences of one block's sequence section, cut at a
checkpoint (bit offset, 3 FSE states, 3 repeat offsets every K
sequences).  Per sequence the kernel looks up the three states, reads the
extra bits (offset, match, literal length), forms the values, resolves
the repeat offset in the carry and reloads the states (ll, ml, of) except
after the block's last sequence.

One integer table layout serves both this shared mode and the per-item
mode of ``ops/entropy_dec.py``: a set of ZTAB int32 words, three 512-entry
state rows (ll, of, ml; ``sym | nb << 6 | new_state << 10``) then two
64-entry code rows (ll, ml; ``xbits | baseline << 5``).  An offset code's
extra bits are the code and its value 1 << code plus them.

``zseq_decode_chunks_shared`` launches the CUDA kernel
(``csrc/zseqdec.cu``) on CUDA tensors and runs
``zseq_decode_chunks_shared_ref`` on CPU tensors.  ``launch`` is the one
entry to the kernel for both modes: it reads the states and repeat
offsets as the callers hold them (three arrays, or strided views of an
(NC, 3) array), takes ``last`` in place of the reload limit where asked,
writes of_val and the resolved offset only where wanted, and returns
views of one allocation; for int32 inputs it does no device work but the
launch.  ``prep_frames`` builds
its inputs from single-block predefined-table frames that carry a sidecar
with sequence checkpoints.
"""

from __future__ import annotations

import numpy as np
import torch

from compress_tpu_torch import _cuda
from compress_tpu_torch.fse import core as fse_core

K = 8        # sequences per chunk
WIN = 80     # window bytes per chunk (8 sequences of <= 72 bits + slack)
ZTAB = 3 * 512 + 2 * 64
LL_ROW, OF_ROW, ML_ROW, LLX_ROW, MLX_ROW = 0, 512, 1024, 1536, 1600

__all__ = ["K", "WIN", "ZTAB", "state_row", "table_set", "pack_tables",
           "zseq_decode_chunks_shared", "zseq_decode_chunks_shared_ref",
           "seq_section", "prep_frames"]

_I64 = torch.int64
_I32_MIN, _I32_MAX = -(1 << 31), (1 << 31) - 1


def _pow2(n: torch.Tensor) -> torch.Tensor:
    return torch.ones_like(n) << n


def state_row(spread, nb, new_state) -> np.ndarray:
    """One FSE decode table (up to 512 states) as a 512-entry int32 row
    ``sym | nb << 6 | new_state << 10`` (zero past the table)."""
    n = len(spread)
    row = np.zeros(512, np.int32)
    row[:n] = (np.asarray(spread, np.int64)
               | (np.asarray(nb, np.int64) << 6)
               | (np.asarray(new_state, np.int64) << 10))
    return row


def _code_rows() -> np.ndarray:
    # imported here: the zstd package imports huff0, which imports this
    # module
    from compress_tpu_torch.zstd import seqs as S

    rows = np.zeros((2, 64), np.int32)
    for row, bits, base in ((rows[0], S.LL_BITS, S.LL_BASELINE),
                            (rows[1], S.ML_BITS, S.ML_BASELINE)):
        row[:len(bits)] = bits | (base << 5)
    return rows.reshape(-1)


def table_set(ll_row, of_row, ml_row) -> np.ndarray:
    """The (ZTAB,) int32 table set of three state rows."""
    return np.concatenate([ll_row, of_row, ml_row, _code_rows()]).astype(
        np.int32)


def pack_tables() -> np.ndarray:
    """The predefined tables as one (ZTAB,) int32 table set."""
    from compress_tpu_torch.zstd import seqs as S

    rows = [state_row(*fse_core.build_dtable(norm, log)) for norm, log in (
        (S.PREDEF_LL_NORM, S.PREDEF_LL_LOG),
        (S.PREDEF_OF_NORM, S.PREDEF_OF_LOG),
        (S.PREDEF_ML_NORM, S.PREDEF_ML_LOG))]
    return table_set(*rows)


def decode_plain(windows, lbit, nsym, nore, states, reps, tabs,
                 per_row: int, k: int, rep3_floor: bool):
    """Plain PyTorch chunk decode, all chunks in step: windows (NC, win)
    uint8; lbit, nsym, nore (NC,); states (NC, 3) in ll, of, ml order;
    reps (NC, 3); tabs (rows, ZTAB), chunk c reading row c // per_row (row
    0 when per_row is 0).  Returns (ll, ml, of_val, off) (NC, k) int32 and
    the end cursors (NC,) int32."""
    nc, win = windows.shape
    dev = windows.device
    w = windows.to(_I64)
    if win % 4:
        w = torch.nn.functional.pad(w, (0, 4 - win % 4))
    ww = w.shape[1] // 4
    # 32-bit words, plus one zero word that every index past the window
    # reads
    words = torch.cat([w[:, 0::4] | (w[:, 1::4] << 8) | (w[:, 2::4] << 16)
                       | (w[:, 3::4] << 24),
                       torch.zeros((nc, 1), dtype=_I64, device=dev)], dim=1)

    def read(lbp, n):
        bp = lbp - n
        bpc = bp.clamp(min=0)
        wi = bpc >> 5
        lo = torch.gather(words, 1, wi.clamp(max=ww)[:, None])[:, 0]
        hi = torch.gather(words, 1, (wi + 1).clamp(max=ww)[:, None])[:, 0]
        s = bpc & 31
        v = (lo >> s) | ((hi & (_pow2(s) - 1)) << (32 - s))
        zs = bpc - bp
        z = torch.where(zs >= 32, 0, v << zs.clamp(max=31))
        return z & (_pow2(n.clamp(max=32)) - 1)

    tab = tabs.to(_I64).reshape(-1)
    row = (torch.arange(nc, device=dev) // per_row if per_row
           else torch.zeros(nc, dtype=_I64, device=dev))
    base = row * ZTAB
    lbp = lbit.to(_I64)
    ns, nr = nsym.to(_I64), nore.to(_I64)
    s_ll, s_of, s_ml = (states[:, j].to(_I64) for j in range(3))
    r0, r1, r2 = (reps[:, j].to(_I64) for j in range(3))
    outs = [torch.zeros((nc, k), dtype=torch.int32, device=dev)
            for _ in range(4)]
    for i in range(k):
        e_ll = tab[base + LL_ROW + (s_ll & 511)]
        e_of = tab[base + OF_ROW + (s_of & 511)]
        e_ml = tab[base + ML_ROW + (s_ml & 511)]
        of_c = e_of & 63
        x_ml = tab[base + MLX_ROW + (e_ml & 63)]
        x_ll = tab[base + LLX_ROW + (e_ll & 63)]
        cur = lbp
        of_x = read(cur, of_c)
        cur = cur - of_c
        ml_x = read(cur, x_ml & 31)
        cur = cur - (x_ml & 31)
        ll_x = read(cur, x_ll & 31)
        cur = cur - (x_ll & 31)
        # values and repeat offsets in 64 bits; the outputs keep the low
        # 32 bits
        of_val = torch.where(of_c > 0, _pow2(of_c.clamp(max=31)) + of_x, 1)
        ml = (x_ml >> 5) + ml_x
        ll = (x_ll >> 5) + ll_x
        # repeat-offset resolution in the carry
        is_long = of_val > 3
        code = of_val - 1 + (ll == 0).to(_I64)
        # the floor of the XLA scan: r0 - 1 in int32 (INT32_MIN wraps to
        # INT32_MAX), then at least 1
        rep3 = (torch.where(r0 == _I32_MIN, _I32_MAX, (r0 - 1).clamp(min=1))
                if rep3_floor else r0 - 1)
        off = torch.where(is_long, of_val - 3, torch.where(
            code == 0, r0, torch.where(code == 1, r1, torch.where(
                code == 2, r2, rep3))))
        n_r2 = torch.where(is_long | (code >= 2), r1, r2)
        n_r1 = torch.where(is_long | (code >= 1), r0, r1)
        n_r0 = torch.where(is_long | (code >= 1), off, r0)
        # state reloads: ll, ml, of; none at or past nore
        active = i < ns
        upd = active & (i < nr)
        nb_ll = torch.where(upd, (e_ll >> 6) & 15, 0)
        nb_ml = torch.where(upd, (e_ml >> 6) & 15, 0)
        nb_of = torch.where(upd, (e_of >> 6) & 15, 0)
        n_ll = (e_ll >> 10) + read(cur, nb_ll)
        cur = cur - nb_ll
        n_ml = (e_ml >> 10) + read(cur, nb_ml)
        cur = cur - nb_ml
        n_of = (e_of >> 10) + read(cur, nb_of)
        cur = cur - nb_of
        for out, v in zip(outs, (ll, ml, of_val, off)):
            out[:, i] = torch.where(active, v, 0).to(torch.int32)
        lbp = torch.where(active, cur, lbp)
        s_ll = torch.where(upd, n_ll, s_ll)
        s_ml = torch.where(upd, n_ml, s_ml)
        s_of = torch.where(upd, n_of, s_of)
        r0 = torch.where(active, n_r0, r0)
        r1 = torch.where(active, n_r1, r1)
        r2 = torch.where(active, n_r2, r2)
    return (*outs, lbp.to(torch.int32))


def _rows_of(t: torch.Tensor, nc: int, gd: int, name: str):
    """(tensor, element stride) of a per-chunk int32 array on card gd
    that the kernel reads at chunk * stride: ``t`` itself where it is
    int32 and either contiguous or 1-D (a column of an (NC, 3) array),
    else a contiguous int32 copy (other integer types)."""
    if t.get_device() != gd:
        raise ValueError(f"{name}: expected a tensor on cuda:{gd}, got "
                         f"{t.device}")
    if t.numel() != nc:
        raise ValueError(f"{name}: expected {nc} elements, got "
                         f"{tuple(t.shape)}")
    if t.dtype == torch.int32:
        if t.is_contiguous():
            return t, 1
        if t.dim() == 1 and t.stride(0) > 0:
            return t, t.stride(0)
    return t.reshape(-1).to(torch.int32).contiguous(), 1


def _three(cols, nc: int, gd: int, names):
    """Three per-chunk arrays read with one stride (copied to contiguous
    int32 where their strides differ) and that stride."""
    got = [_rows_of(t, nc, gd, n) for t, n in zip(cols, names)]
    stride = got[0][1]
    if any(st != stride for _t, st in got):
        got = [(t.reshape(-1).to(torch.int32).contiguous(), 1)
               for t, _st in got]
        stride = 1
    return [t for t, _st in got], stride


def launch(windows, lbit, nsym, nore, states, reps, tabs, per_row: int,
           k: int, rep3_floor: bool, nore_is_last: bool = False,
           want_ofv: bool = True, want_off: bool = True):
    """Run ``csrc/zseqdec.cu`` on CUDA tensors: windows (..., win) uint8
    with NC rows ((NC, win), or (N, C, win) for NC = N * C); lbit, nsym
    NC int32 (any shape, contiguous); nore NC integers, or ``last`` with
    ``nore_is_last`` (nore = nsym - (last > 0)); states (sll, sof, sml)
    and reps (r1, r2, r3) three NC-element integer arrays each, read in
    place where int32 and contiguous or 1-D (the columns of an (NC, 3)
    array), reps None for 1, 4, 8; tabs (rows, ZTAB) int32 as for
    ``decode_plain``.  One launch and no other device work for int32
    inputs; every output comes from one allocation.  Returns (ll, ml,
    of_val, off) shaped (..., k) like the windows' leading dimensions
    (of_val and off None where not wanted) and the end cursors shaped
    like them."""
    win = windows.shape[-1]
    lead = windows.shape[:-1]
    nc = windows.numel() // win if win else 0
    gd = windows.get_device()
    if gd < 0 or windows.dtype != torch.uint8 \
            or not windows.is_contiguous():
        raise ValueError("windows: expected a contiguous CUDA uint8 tensor")
    if win % 4 or win > 96 or win < 4:
        raise ValueError("windows: expected a width that is a multiple of "
                         f"4 up to 96 bytes, got {win}")
    if not 1 <= k <= 8:
        raise ValueError(f"expected 1 <= k <= 8, got {k}")
    rows = -(-nc // per_row) if per_row else 1
    if tabs.dtype != torch.int32 or tabs.shape != (rows, ZTAB) \
            or tabs.get_device() != gd or not tabs.is_contiguous():
        raise ValueError(f"tables: expected contiguous ({rows}, {ZTAB}) "
                         "int32 on the windows' device")
    for name, t in (("lbit", lbit), ("nsym", nsym)):
        if t.dtype != torch.int32 or t.numel() != nc \
                or t.get_device() != gd or not t.is_contiguous():
            raise ValueError(f"{name}: expected {nc} contiguous int32 on "
                             "the windows' device")
    nore, nstride = _rows_of(nore, nc, gd, "last" if nore_is_last
                             else "nore")
    if nstride != 1:
        nore = nore.contiguous()
    st, st_stride = _three(states, nc, gd, ("sll", "sof", "sml"))
    if reps is None:
        rp, rp_stride = (None, None, None), 0
    else:
        rp, rp_stride = _three(reps, nc, gd, ("r1", "r2", "r3"))
    windows = _cuda.aligned(windows)
    tabs = _cuda.aligned(tabs)
    n_out = 2 + want_ofv + want_off
    buf = torch.empty(n_out * nc * k + nc, dtype=torch.int32,
                      device=windows.device)
    outs = buf[:n_out * nc * k].view(n_out, *lead, k).unbind(0)
    endl = buf[n_out * nc * k:].view(lead)
    ll, ml = outs[0], outs[1]
    ofv = outs[2] if want_ofv else None
    off = outs[-1] if want_off else None
    cur = torch.cuda.current_device()
    args = (windows.data_ptr(), lbit.data_ptr(), nsym.data_ptr(),
            nore.data_ptr(), *(t.data_ptr() for t in st),
            *(None if t is None else t.data_ptr() for t in rp),
            tabs.data_ptr(), win, int(nore_is_last), st_stride, rp_stride,
            per_row, nc, k, int(rep3_floor), ll.data_ptr(), ml.data_ptr(),
            None if ofv is None else ofv.data_ptr(),
            None if off is None else off.data_ptr(), endl.data_ptr(),
            torch._C._cuda_getCurrentRawStream(gd))
    lib = _cuda.library()
    if gd == cur:
        rc = lib.ct_zseq_decode(*args)
    else:
        with torch.cuda.device(gd):
            rc = lib.ct_zseq_decode(*args)
    _cuda.check(rc, "zseq decode")
    return ll, ml, ofv, off, endl


def _shared_check(windows, lbit, nsym, states, reps, last, tables):
    nc = windows.shape[0]
    if windows.dim() != 2 \
            or any(t.shape != (nc,) for t in (lbit, nsym, last)) \
            or states.shape != (nc, 3) or reps.shape != (nc, 3):
        raise ValueError("expected (NC, win) windows, (NC,) lbit, nsym, "
                         "last and (NC, 3) states, reps")
    if tables.shape != (ZTAB,):
        raise ValueError(f"tables: expected ({ZTAB},), got "
                         f"{tuple(tables.shape)}")
    if any(t.device != windows.device
           for t in (lbit, nsym, states, reps, last, tables)):
        raise ValueError("zseq decode: inputs on different devices")


def _shared_args(windows, lbit, nsym, states, reps, last, tables):
    _shared_check(windows, lbit, nsym, states, reps, last, tables)
    # no reload after the block's last sequence
    nore = (nsym - (last > 0).to(nsym.dtype)).to(torch.int32)
    return (windows, lbit, nsym, nore, states, reps, tables.reshape(1, -1),
            0, K, False)


def zseq_decode_chunks_shared_ref(windows, lbit, nsym, states, reps, last,
                                  tables):
    """Plain version of ``zseq_decode_chunks_shared``."""
    ll, ml, _ofv, off, endl = decode_plain(
        *_shared_args(windows, lbit, nsym, states, reps, last, tables))
    return ll, ml, off, endl


def zseq_decode_chunks_shared(windows: torch.Tensor, lbit: torch.Tensor,
                              nsym: torch.Tensor, states: torch.Tensor,
                              reps: torch.Tensor, last: torch.Tensor,
                              tables: torch.Tensor):
    """windows (NC, WIN) uint8; lbit, nsym, last (NC,) int32 (last > 0 on
    a block's final chunk); states (NC, 3) int32 in ll, of, ml order;
    reps (NC, 3) int32; tables (ZTAB,) int32 (``pack_tables``).  Returns
    (ll, ml, off) each (NC, K) int32 and the end cursors (NC,) int32.  On
    CUDA tensors one launch reads every input in place: the kernel takes
    ``last`` and applies the reload rule itself, and writes no of_val."""
    if windows.device.type == "cpu":
        return zseq_decode_chunks_shared_ref(windows, lbit, nsym, states,
                                             reps, last, tables)
    _shared_check(windows, lbit, nsym, states, reps, last, tables)
    ll, ml, _ofv, off, endl = launch(
        windows, lbit, nsym, last, states.unbind(1), reps.unbind(1),
        tables.reshape(1, -1), 0, K, False, nore_is_last=True,
        want_ofv=False)
    zseq_decode_chunks_shared.launches += 1
    return ll, ml, off, endl


zseq_decode_chunks_shared.launches = 0


# ---------------------------------------------------------------------------
# Host prep: single-block predefined-table frames -> kernel batch tensors
# ---------------------------------------------------------------------------


def _skip_literals(body: bytes) -> int:
    """The offset of the sequences section (a literals-section header
    parse; no decoding)."""
    from compress_tpu_torch.zstd import block as B

    lit_type, sf = body[0] & 3, (body[0] >> 2) & 3
    if lit_type in (B.LIT_RAW, B.LIT_RLE):
        regen, hdr = B.raw_lit_size(body, 0, sf)
        return hdr + (regen if lit_type == B.LIT_RAW else 1)
    _regen, comp, hdr = B.huff_lit_sizes(body, 0, sf)
    return hdr + comp


def seq_section(body: bytes):
    """(bitstream bytes, nseq) of a predefined-table sequences section."""
    pos = _skip_literals(body)
    b0 = body[pos]
    pos += 1
    if b0 < 128:
        nseq = b0
    elif b0 < 255:
        nseq = ((b0 - 128) << 8) + body[pos]
        pos += 1
    else:
        nseq = int.from_bytes(body[pos:pos + 2], "little") + 0x7F00
        pos += 2
    if nseq == 0:
        return b"", 0
    if body[pos] != 0:
        raise ValueError("not a predefined-table sequence section")
    return body[pos + 1:], nseq


def prep_frames(frames):
    """Host prep of a batch of single-block predefined-table frames, each
    preceded by a sidecar with sequence checkpoints.  Returns (windows,
    lbit, nsym, states, reps, last, metas) numpy arrays for
    ``zseq_decode_chunks_shared``; metas holds (nseq, nchunks) per
    frame."""
    from compress_tpu_torch.ops import entropy_dec as ED
    from compress_tpu_torch.zstd import accel as AC
    from compress_tpu_torch.zstd.frame import parse_frame_header

    wins, lbits, nsyms, sts, rps, lasts, metas = [], [], [], [], [], [], []
    for blob in frames:
        side, rest = AC.split_sidecar(bytes(blob))
        if side is None:
            raise ValueError("frame carries no sidecar")
        a = AC.parse_sidecar(side)[1][0]
        h = parse_frame_header(rest)
        stream, nseq = seq_section(rest[h.header_size + 3:])
        nch = len(a.seq_bits)
        if nch != -(-nseq // K):
            raise ValueError(f"{nch} sequence checkpoints for {nseq} "
                             "sequences")
        w, lb = ED.build_windows(stream, a.seq_bits.astype(np.int64), nch,
                                 win=WIN)
        wins.append(w)
        lbits.append(lb)
        nsyms.append(np.minimum(nseq - K * np.arange(nch), K).astype(np.int32))
        sts.append(a.seq_states.astype(np.int32))
        rps.append(a.seq_reps.astype(np.int32))
        lf = np.zeros(nch, np.int32)
        lf[-1] = 1
        lasts.append(lf)
        metas.append((nseq, nch))
    return (np.concatenate(wins), np.concatenate(lbits).astype(np.int32),
            np.concatenate(nsyms), np.concatenate(sts), np.concatenate(rps),
            np.concatenate(lasts), metas)
