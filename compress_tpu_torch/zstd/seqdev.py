"""Device zstd sequence decode: the host glue around the sequence kernel
(counterpart of the JAX package's ``zstd/seqdev.py``: ``pack_table``,
``seq_accel``, ``decode_sequences_device``).

Each block's sequences section is parsed on the host (headers and table
construction are byte work); the per-sequence bit chain runs on the
device as one chunked decode over every chunk of every block at once
(``ops/entropy_dec.zseq_decode_chunks(_rep)``).  The checkpoints (bit
offset, 3 states and 3 repeat offsets every ZSEQ_K sequences) come from
one host walk (``seq_accel``).

Outputs equal ``zstd/seqs.decode_sequences``: (ll, ml, of_value)
triples, with ``resolve=True`` also the resolved offsets.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from compress_tpu_torch._cuda import resolve_device
from compress_tpu_torch.fse import core as fse_core
from compress_tpu_torch.ops import entropy_dec as ED
from compress_tpu_torch.ops import zseq_kern as ZK
from compress_tpu_torch.zstd import seqs as S

__all__ = ["pack_table", "seq_accel", "seq_walk", "prep_sequences",
           "decode_sequences_device"]


def pack_table(tab: S.STable) -> np.ndarray:
    """An STable as a 512-entry state row of the kernel's table set."""
    return ZK.state_row(tab.spread, tab.nb, tab.new_state)


def seq_accel(stream: bytes, n_seqs: int, t_ll: S.STable, t_of: S.STable,
              t_ml: S.STable, k: int | None = None,
              max_ofc: list | None = None):
    """One host walk recording (bitpos, s_ll, s_of, s_ml, r1, r2, r3)
    before the first sequence and every k sequences after it.

    max_ofc, when given, receives the largest offset code the stream uses;
    the walk stops (returns None) at the first code above 23, which sends
    the block to the host decoder (the reference's content gate)."""
    k = k or ED.ZSEQ_K
    br = fse_core.BitReaderReverse(stream)
    s_ll = br.read(t_ll.log)
    s_of = br.read(t_of.log)
    s_ml = br.read(t_ml.log)
    r1, r2, r3 = 1, 4, 8
    cks = [(br.bitpos, s_ll, s_of, s_ml, r1, r2, r3)]
    for i in range(n_seqs):
        of_c = int(t_of.spread[s_of])
        ml_c = int(t_ml.spread[s_ml])
        ll_c = int(t_ll.spread[s_ll])
        if max_ofc is not None and of_c > max_ofc[0]:
            max_ofc[0] = of_c
            if of_c > 23:
                return None
        of_x = br.read(of_c)
        br.read(int(S.ML_BITS[ml_c]))
        ll_x = br.read(int(S.LL_BITS[ll_c]))
        of_val = ((1 << of_c) + of_x) if of_c else 1
        ll0 = int(S.LL_BASELINE[ll_c]) == 0 and ll_x == 0
        if of_val > 3:
            r1, r2, r3 = of_val - 3, r1, r2
        else:
            code = of_val - 1 + (1 if ll0 else 0)
            if code == 1:
                r1, r2 = r2, r1
            elif code == 2:
                r1, r2, r3 = r3, r1, r2
            elif code == 3:
                r1, r2, r3 = max(r1 - 1, 1), r1, r2
        if i < n_seqs - 1:
            s_ll = int(t_ll.new_state[s_ll]) + br.read(int(t_ll.nb[s_ll]))
            s_ml = int(t_ml.new_state[s_ml]) + br.read(int(t_ml.nb[s_ml]))
            s_of = int(t_of.new_state[s_of]) + br.read(int(t_of.nb[s_of]))
        if (i + 1) % k == 0 and i + 1 < n_seqs:
            cks.append((br.bitpos, s_ll, s_of, s_ml, r1, r2, r3))
    return cks


def seq_walk(stream: bytes, n_seqs: int, t_ll: S.STable, t_of: S.STable,
             t_ml: S.STable, reps=(1, 4, 8), k: int | None = None):
    """The sidecar builder's walk of one sequences section (the rules of
    the reference's native ``side_block``, zstd_dec.cpp:1731-1805): from
    the repeat offsets ``reps`` the frame carries into the block, the
    checkpoints as ``seq_accel`` records them, every sequence's literal
    length, match length and resolved offset, and the repeat offsets after
    the section.  Returns (cks, lls, mls, offs, reps) with Python lists,
    or None where the section is not decoded exactly: an offset code above
    23 (or a code past its alphabet), a repeat offset that resolves to 0,
    or a bit stream not read to its end.  ``seq_accel`` instead floors
    repeat code 3 at 1 and reads any stream, as the reference's host walk
    does."""
    k = k or ED.ZSEQ_K
    try:
        br = fse_core.BitReaderReverse(stream)
    except ValueError:
        return None
    read = br.read
    ll_sym, of_sym, ml_sym = (t.spread.tolist() for t in (t_ll, t_of, t_ml))
    ll_nb, of_nb, ml_nb = (t.nb.tolist() for t in (t_ll, t_of, t_ml))
    ll_ns, of_ns, ml_ns = (t.new_state.tolist() for t in (t_ll, t_of, t_ml))
    llb, llx = S._LL_BASELINE, S._LL_BITS
    mlb, mlx = S._ML_BASELINE, S._ML_BITS
    s_ll = read(t_ll.log)
    s_of = read(t_of.log)
    s_ml = read(t_ml.log)
    r1, r2, r3 = reps
    cks = [(br.bitpos, s_ll, s_of, s_ml, r1, r2, r3)]
    lls, mls, offs = [], [], []
    for i in range(n_seqs):
        of_c = of_sym[s_of]
        ml_c = ml_sym[s_ml]
        ll_c = ll_sym[s_ll]
        if of_c > 23 or ml_c > S.MAX_ML_CODE or ll_c > S.MAX_LL_CODE:
            return None
        of_val = (1 << of_c) + read(of_c) if of_c else 1
        ml = mlb[ml_c] + read(mlx[ml_c])
        ll = llb[ll_c] + read(llx[ll_c])
        if of_val > 3:
            off = of_val - 3
            r1, r2, r3 = off, r1, r2
        else:
            code = of_val - 1 + (ll == 0)
            if code == 0:
                off = r1
            elif code == 1:
                off = r2
                r1, r2 = off, r1
            elif code == 2:
                off = r3
                r1, r2, r3 = off, r1, r2
            else:
                off = r1 - 1
                if off <= 0:
                    return None
                r1, r2, r3 = off, r1, r2
        lls.append(ll)
        mls.append(ml)
        offs.append(off)
        if i < n_seqs - 1:
            s_ll = ll_ns[s_ll] + read(ll_nb[s_ll])
            s_ml = ml_ns[s_ml] + read(ml_nb[s_ml])
            s_of = of_ns[s_of] + read(of_nb[s_of])
        if (i + 1) % k == 0 and i + 1 < n_seqs:
            cks.append((br.bitpos, s_ll, s_of, s_ml, r1, r2, r3))
    if br.bitpos != 0:   # an over-read leaves it below 0
        return None
    return cks, lls, mls, offs, (r1, r2, r3)


def prep_sequences(items, k: int | None = None):
    """Host prep of ``decode_sequences_device``: walk every item for its
    checkpoints and pack the batch.  Returns (metas, arrays, walk
    seconds): metas[i] is ("host", item) or ("dev", (n_seqs, nchunks));
    arrays holds the numpy inputs of ``zseq_decode_chunks_rep`` (windows
    (N, C, ZWIN) uint8; lbit, sll, sof, sml, nseq, nore, r1, r2, r3 (N, C)
    int32; tables (N, ZTAB) int32); pad chunks have lbit 8 * ZWIN and nseq
    0."""
    k = k or ED.ZSEQ_K
    metas, devs = [], []
    cmax = 1
    t_walk = 0.0
    for it in items:
        stream, n_seqs, t_ll, t_of, t_ml = it
        if n_seqs == 0:
            metas.append(("host", it))
            continue
        max_ofc = [0]
        t0 = time.perf_counter()
        cks = seq_accel(stream, n_seqs, t_ll, t_of, t_ml, k, max_ofc=max_ofc)
        t_walk += time.perf_counter() - t0
        if cks is None or max_ofc[0] > 23:
            metas.append(("host", it))
            continue
        ck = np.array(cks, np.int64)
        nch = len(ck)
        w, lb = ED.build_windows(stream, ck[:, 0], nch, win=ED.ZWIN)
        chunk = k * np.arange(nch)
        # the states stop reloading at the block's last sequence
        devs.append((len(metas), w, lb, ck, np.clip(n_seqs - chunk, 0, k),
                     np.clip(n_seqs - 1 - chunk, 0, k), ZK.table_set(
                         pack_table(t_ll), pack_table(t_of),
                         pack_table(t_ml))))
        metas.append(("dev", (n_seqs, nch)))
        cmax = max(cmax, nch)
    N = len(items)
    a = {"windows": np.zeros((N, cmax, ED.ZWIN), np.uint8),
         "lbit": np.full((N, cmax), 8 * ED.ZWIN, np.int32)}
    for key in ("sll", "sof", "sml", "nseq", "nore"):
        a[key] = np.zeros((N, cmax), np.int32)
    for key, v in (("r1", 1), ("r2", 4), ("r3", 8)):
        a[key] = np.full((N, cmax), v, np.int32)
    a["tables"] = np.zeros((N, ZK.ZTAB), np.int32)
    for i, w, lb, ck, nsq, nore, tabs in devs:
        nc = len(lb)
        a["windows"][i, :nc] = w
        a["lbit"][i, :nc] = lb
        for j, key in enumerate(("sll", "sof", "sml", "r1", "r2", "r3")):
            a[key][i, :nc] = ck[:, 1 + j]
        a["nseq"][i, :nc] = nsq
        a["nore"][i, :nc] = nore
        a["tables"][i] = tabs
    return metas, a, t_walk


def decode_sequences_device(items, k: int | None = None,
                            resolve: bool = False, device=None,
                            stats: dict | None = None):
    """Batched device decode of sequence sections.

    items: list of (stream bytes, n_seqs, t_ll, t_of, t_ml).  Returns one
    (lls, mls, ofvals) tuple of int64 arrays per item (as
    ``seqs.decode_sequences``), or (lls, mls, ofvals, offs) with
    ``resolve=True``: the repeat offsets then resolve on the device in the
    decode's carry, seeded by the checkpoints.  Items with no sequences,
    or whose stream uses an offset code above 23, take the host loop.
    One kernel launch for the batch; runs on CUDA unless ``device`` names
    another device (raises when no card is present and no device was
    given).  ``stats``, when given, receives the host walk's seconds
    (``walk_s``) and the items on each route."""
    dev = resolve_device(device)
    k = k or ED.ZSEQ_K
    metas, a, t_walk = prep_sequences(items, k)
    n_dev = sum(kind == "dev" for kind, _m in metas)
    if stats is not None:
        stats.update(walk_s=t_walk, device=n_dev, host=len(items) - n_dev)
    if n_dev:
        t = [torch.from_numpy(a[key]).to(dev) for key in (
            "windows", "lbit", "sll", "sof", "sml", "nseq", "nore")]
        tabs = torch.from_numpy(a["tables"]).to(dev)
        if resolve:
            r = [torch.from_numpy(a[key]).to(dev) for key in ("r1", "r2",
                                                              "r3")]
            cols, _ = ED.zseq_decode_chunks_rep(*t, *r, tabs, k=k)
        else:
            cols, _ = ED.zseq_decode_chunks(*t, tabs, k=k)
        cols = [c.cpu().numpy().astype(np.int64) for c in cols]
    out = []
    for i, (kind, m) in enumerate(metas):
        if kind == "host":
            stream, n_seqs, t_ll, t_of, t_ml = m
            trip = S.decode_sequences(stream, n_seqs, t_ll, t_of, t_ml)
            if resolve:
                from compress_tpu_torch.zstd.device_dec import _resolve_reps

                trip = (*trip, _resolve_reps(*trip))
            out.append(trip)
            continue
        n_seqs, nc = m
        out.append(tuple(c[i, :nc].reshape(-1)[:n_seqs] for c in cols))
    return out
