"""Batched device decode of zstd frames (counterpart of the JAX package's
``zstd/device_dec.py`` ``decompress_frames_device``).

Every heavy stage of a single-block frame (content up to 64 KiB) runs on
the device, one launch each for the whole batch:

  1. literals: the huff0 4X chunk decode (``ops/entropy_dec``
     ``huff0_decode_chunks``, one table per frame; ``csrc/huff0dec.cu``),
  2. sequences: the 3-state FSE chunk decode with the repeat offsets
     resolved in the carry (``zstd/seqdev``, ``csrc/zseqdec.cu``),
  3. LZ execute: the arena kernel (``ops/execute``, ``csrc/exec.cu``).

The host parses the sections (byte work).  A frame that carries an accel
sidecar (``zstd/accel.py``) takes its literal checkpoints and execute plan
from it ("accel" route: no per-symbol host work, no sequence decode); a
plain frame walks every literal stream (``_hwalk``) and sequence section
(``seqdev.seq_accel``) on the host for its checkpoints ("dev" route).  A
frame of 64 KiB blocks whose sidecar covers every block ("accel_mb"
route) decodes its blocks' literals in the same literal launch and runs
its plans through the history executor (``execute_blocks_hist``), one
launch per history size.  Other frames go to the port's host decoder
(``zstd.decompress``, "host" route), as in the reference: raw or RLE
blocks, more than one block without a sidecar, raw, RLE, 1X or treeless
literals without a sidecar, a literal section of fewer than 6 bytes, no
sequences, trailing non-skippable data, anything malformed, and a
sidecar whose plans ``accel_plan`` or ``pack_pieces_mb`` refuse.
``decompress_frames_device.host_frames`` counts the frames decoded on the
host.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from compress_tpu_torch._cuda import resolve_device
from compress_tpu_torch.fse import core as fse_core
from compress_tpu_torch.huff0.table import read_table
from compress_tpu_torch.ops import entropy_dec as ED
from compress_tpu_torch.ops import execute as X
from compress_tpu_torch.utils.debuglog import dbg
from compress_tpu_torch.zstd import accel as AC
from compress_tpu_torch.zstd import block as B
from compress_tpu_torch.zstd import seqdev
from compress_tpu_torch.zstd.frame import parse_frame_header

__all__ = ["MAX_DEC_BATCH", "decompress_frames_device"]

MAX_DEC_BATCH = 512  # frames per device dispatch; larger batches chunk

_LIT_K = 32          # literals per huff0 chunk


def _only_trailing_skippables(frame: bytes, end: int) -> bool:
    """True when frame[end:] is empty or only skippable frames: an item
    must be exactly one frame."""
    while end < len(frame):
        try:
            t = parse_frame_header(frame, end)
        except ValueError:
            return False
        if not t.skippable:
            return False
        end += t.header_size + t.skippable_size
    return end == len(frame)


def _parse_single_block(frame: bytes):
    """The body of a frame's only (compressed) block, or None."""
    try:
        h = parse_frame_header(frame)
    except ValueError:  # malformed: the host decoder decides
        return None
    if h.skippable:
        return None
    pos = h.header_size
    bh = int.from_bytes(frame[pos:pos + 3], "little")
    pos += 3
    last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
    if not last or btype != B.BLOCK_COMPRESSED:
        return None
    end = pos + bsize + (4 if h.has_checksum else 0)
    if not _only_trailing_skippables(frame, end):
        return None
    return frame[pos:pos + bsize]


def _parse_blocks(frame: bytes):
    """Structural multi-block walk: [(btype, header size field, body)] or
    None."""
    try:
        h = parse_frame_header(frame)
    except ValueError:
        return None
    if h.skippable:
        return None
    pos = h.header_size
    out = []
    while True:
        if pos + 3 > len(frame):
            return None
        bh = int.from_bytes(frame[pos:pos + 3], "little")
        pos += 3
        last, btype, bsize = bh & 1, (bh >> 1) & 3, bh >> 3
        if btype == 3 or bsize > (1 << 17):
            return None
        raw = 1 if btype == B.BLOCK_RLE else bsize
        if pos + raw > len(frame):
            return None
        out.append((btype, bsize, frame[pos:pos + raw]))
        pos += raw
        if last:
            break
    if not _only_trailing_skippables(frame, pos + (4 if h.has_checksum
                                                   else 0)):
        return None
    return out


def _parse_4x_literals(body: bytes):
    """A compressed 4X literals section: (regen, lens, streams, (sym_t,
    nb_t, max_bits), new_pos), or None for other shapes."""
    lit_type, sf = body[0] & 3, (body[0] >> 2) & 3
    if lit_type != B.LIT_COMPRESSED or sf == 0:
        return None
    regen, comp, pos = B.huff_lit_sizes(body, 0, sf)
    if regen < 6:
        return None  # 4 streams need 4 non-degenerate segments
    sec = body[pos:pos + comp]
    sym_t, nb_t, max_bits, tpos = read_table(sec, 0)
    sizes = [int.from_bytes(sec[tpos + 2 * q:tpos + 2 * q + 2], "little")
             for q in range(3)]
    sp = tpos + 6
    seg = (regen + 3) // 4
    lens = [seg, seg, seg, regen - 3 * seg]
    streams = []
    for q in range(4):
        size = sizes[q] if q < 3 else comp - sp
        streams.append(sec[sp:sp + size])
        sp += size
    return regen, lens, streams, (sym_t, nb_t, max_bits), pos + comp


def _parse_literals_any(body: bytes, prev_table=None):
    """Any literals section (accel route): (kind, regen, lens, streams,
    table, new_pos); kind 0 = 4X, 1 = raw (streams = the bytes), 2 = RLE
    (streams = 1 byte), 3 = 1X.  Treeless sections reuse prev_table and
    give None without one."""
    lit_type, sf = body[0] & 3, (body[0] >> 2) & 3
    if lit_type in (B.LIT_RAW, B.LIT_RLE):
        regen, pos = B.raw_lit_size(body, 0, sf)
        if lit_type == B.LIT_RAW:
            return 1, regen, None, body[pos:pos + regen], None, pos + regen
        return 2, regen, None, body[pos:pos + 1], None, pos + 1
    if lit_type == B.LIT_TREELESS:
        if prev_table is None:
            return None
        regen, comp, pos = B.huff_lit_sizes(body, 0, sf)
        sec = body[pos:pos + comp]
        if len(sec) != comp:
            return None
        if sf == 0:
            return 3, regen, [regen], [sec], prev_table, pos + comp
        # 4 streams need regen >= 6 (jump table + 4 non-degenerate
        # segments)
        if comp < 6 or regen < 6:
            return None
        sizes = [int.from_bytes(sec[2 * q:2 * q + 2], "little")
                 for q in range(3)]
        sp = 6
        seg = (regen + 3) // 4
        lens = [seg, seg, seg, regen - 3 * seg]
        streams = []
        for q in range(4):
            size = sizes[q] if q < 3 else comp - sp
            if size < 0 or sp + size > comp:
                return None
            streams.append(sec[sp:sp + size])
            sp += size
        return 0, regen, lens, streams, prev_table, pos + comp
    if lit_type != B.LIT_COMPRESSED:
        return None
    if sf == 0:  # 1 stream
        regen, comp, pos = B.huff_lit_sizes(body, 0, 0)
        sec = body[pos:pos + comp]
        sym_t, nb_t, max_bits, tpos = read_table(sec, 0)
        return (3, regen, [regen], [sec[tpos:]], (sym_t, nb_t, max_bits),
                pos + comp)
    r = _parse_4x_literals(body)
    if r is None:
        return None
    regen, lens, streams, table, spos = r
    return 0, regen, lens, streams, table, spos


def _resolve_reps(lls, mls, ofvals):
    """Repeat-offset resolution on the host (a per-sequence loop)."""
    r1, r2, r3 = 1, 4, 8
    offs = np.zeros(len(lls), np.int64)
    for i in range(len(lls)):
        ofv = int(ofvals[i])
        if ofv > 3:
            off = ofv - 3
            r1, r2, r3 = off, r1, r2
        else:
            if int(lls[i]) == 0:
                ofv += 1
            if ofv == 1:
                off = r1
            elif ofv == 2:
                off = r2
                r1, r2 = r2, r1
            elif ofv == 3:
                off = r3
                r1, r2, r3 = r3, r1, r2
            else:
                off = r1 - 1
                if off <= 0:
                    # corrupt: the host decoder rejects it too
                    raise ValueError("corrupt repeat offset")
                r1, r2, r3 = off, r1, r2
        offs[i] = off
    return offs


def _accel_lit_ok(lit, acc) -> bool:
    """Sanity-check a sidecar's literal checkpoints before trusting them:
    an inconsistent sidecar must send the frame to another route, never
    truncate the literal decode."""
    kind, regen, lens, streams, _table, _spos = lit
    if kind in (1, 2):
        return True  # raw / RLE carry no checkpoints
    if len(acc.lit_cks) != len(streams):
        return False
    for q, cks in enumerate(acc.lit_cks):
        want_nch = max(1, -(-lens[q] // _LIT_K)) if lens[q] > 0 else 1
        if len(cks) != want_nch:
            return False
        if len(cks) and (cks[0] > 8 * len(streams[q]) or cks[-1] < 0):
            return False
        if len(cks) > 1 and not (np.diff(cks) <= 0).all():
            return False  # bit offsets must be non-increasing
    return True


def _hwalk(stream: bytes, sym_t, nb_t, max_bits: int, out_len: int,
           k: int, strict: bool = False):
    """Host walk of one huff0 stream recording the remaining bits every k
    symbols.  With ``strict`` (the sidecar builder's rule) it returns None
    where a symbol remains to decode at bit 0."""
    br = fse_core.BitReaderReverse(stream)
    bitpos = br.bitpos
    data = stream
    cks = [bitpos]
    for i in range(out_len):
        bp = bitpos - max_bits
        if bp >= 0:
            b0 = bp >> 3
            chunk = int.from_bytes(data[b0:b0 + 9], "little")
            w = (chunk >> (bp & 7)) & ((1 << max_bits) - 1)
        else:
            if strict and bitpos <= 0:
                return None
            chunk = int.from_bytes(data[0:9], "little")
            w = (chunk << -bp) & ((1 << max_bits) - 1)
        nb = int(nb_t[w])
        if nb > bitpos:
            nb = bitpos
        bitpos -= nb
        if (i + 1) % k == 0 and i + 1 < out_len:
            cks.append(bitpos)
    return cks


def _prep_multiblock(frame: bytes, accs, hist_blocks: int):
    """Check a multi-block frame against its sidecar as the reference
    does and describe each block's literals (``_parse_literals_any``'s
    tuples): (lits, accs, hist_blocks), or None for the host decoder."""
    if hist_blocks < 1 or hist_blocks > 128:
        return None
    blocks = _parse_blocks(frame)
    if blocks is None or len(blocks) != len(accs):
        return None
    lits = []
    prev_table = None   # the Huffman table carried to treeless sections
    for (btype, bsize, body), acc in zip(blocks, accs):
        if acc is None:
            return None
        if btype == B.BLOCK_RAW:
            lit = (1, len(body), None, body, None, len(body))
        elif btype == B.BLOCK_RLE:
            lit = (2, bsize, None, body[:1], None, 1)
        else:
            lit = _parse_literals_any(body, prev_table)
            if lit is None:
                return None
            if lit[4] is not None:
                prev_table = lit[4]
        if lit[0] != acc.lit_kind or lit[1] != acc.regen \
                or not _accel_lit_ok(lit, acc):
            return None
        lits.append(lit)
    return lits, accs, hist_blocks


def _route(frame: bytes):
    """(route, payload) of one item: "accel_mb", "accel", "dev" or
    "host"."""
    side_payload, frame = AC.split_sidecar(frame)
    acc = None
    if side_payload is not None:
        try:
            hist_blocks, ab = AC.parse_sidecar(side_payload)
        except (ValueError, IndexError):
            hist_blocks, ab = 0, None
        if ab is not None and len(ab) == 1:
            acc = ab[0]
        elif ab is not None and len(ab) > 1:
            mb = _prep_multiblock(frame, ab, hist_blocks)
            if mb is not None:
                return "accel_mb", (*mb, frame)
    body = _parse_single_block(frame)
    if body is None:
        return "host", frame
    if acc is not None:
        lit = _parse_literals_any(body)
        if lit is not None and lit[0] == acc.lit_kind \
                and lit[1] == acc.regen and _accel_lit_ok(lit, acc):
            return "accel", (lit, acc, frame)
    lit = _parse_4x_literals(body)
    if lit is None:
        return "host", frame
    regen, lens, streams, table, spos = lit
    try:
        hist = B.History(window_size=1 << 16)
        q = spos
        b0 = body[q]
        q += 1
        if b0 == 0:
            return "host", frame
        if b0 < 128:
            n_seqs = b0
        elif b0 < 255:
            n_seqs = ((b0 - 128) << 8) + body[q]
            q += 1
        else:
            n_seqs = int.from_bytes(body[q:q + 2], "little") + 0x7F00
            q += 2
        modes = body[q]
        q += 1
        t_ll, q = B._read_table(body, q, (modes >> 6) & 3, "ll", hist, None)
        t_of, q = B._read_table(body, q, (modes >> 4) & 3, "of", hist, None)
        t_ml, q = B._read_table(body, q, (modes >> 2) & 3, "ml", hist, None)
    except (B.BlockError, ValueError):
        return "host", frame
    return "dev", (regen, lens, streams, table,
                   (body[q:], n_seqs, t_ll, t_of, t_ml))


def _literal_batch(metas, times):
    """Host half of the literal stage: the literals that need no decode
    ({key: bytes}; the key of a block of an "accel_mb" item is (meta
    index, block), of any other item its meta index), the queued items and
    their chunks, and the numpy inputs of ``huff0_decode_chunks`` (windows
    (N, C, WIN) uint8, lbit and nsym (N, C) int32, tables (N, 2048)
    int32), None when no item needs a decode."""
    decoded = {}
    items = []   # (key, [(stream, checkpoints, n_syms)], table)

    def from_sidecar(key, lit, acc):
        lkind, regen, lens, streams, table, _s = lit
        if lkind == 1:      # raw literals: the bytes ship in the frame
            decoded[key] = streams
        elif lkind == 2:    # RLE
            decoded[key] = streams * regen
        else:
            items.append((key, [(streams[q], acc.lit_cks[q], lens[q])
                                for q in range(len(streams))],
                          ED.expand_table(*table)))

    t0 = time.perf_counter()
    for i, (kind, m) in enumerate(metas):
        if kind == "dev":
            _regen, lens, streams, (sym_t, nb_t, max_bits), _seq = m
            trip = [(streams[q], np.array(_hwalk(
                streams[q], sym_t, nb_t, max_bits, lens[q], _LIT_K),
                np.int64), lens[q]) for q in range(4)]
            items.append((i, trip, ED.expand_table(sym_t, nb_t, max_bits)))
        elif kind == "accel":
            from_sidecar(i, m[0], m[1])
        elif kind == "accel_mb":
            lits, accs, _hb, _fr = m
            for k, (lit, acc) in enumerate(zip(lits, accs)):
                from_sidecar((i, k), lit, acc)
    t1 = time.perf_counter()
    times["lit_walk"] += t1 - t0
    if not items:
        return decoded, items, [], None
    built = []
    for _i, trip, _t in items:
        per = []
        for stream, cks, n_sym in trip:
            nch = len(cks)
            w, lb = ED.build_windows(stream, np.asarray(cks, np.int64), nch)
            ns = np.clip(n_sym - _LIT_K * np.arange(nch), 0, _LIT_K)
            per.append((w, lb, ns.astype(np.int32), n_sym))
        built.append(per)
    cmax = max(sum(len(p[1]) for p in per) for per in built)
    nd = len(items)
    windows = np.zeros((nd, cmax, ED.WIN), np.uint8)
    lbit = np.full((nd, cmax), 8 * ED.WIN, np.int32)
    nsym = np.zeros((nd, cmax), np.int32)
    tables = np.stack([t for (_i, _tr, t) in items])
    for j, per in enumerate(built):
        base = 0
        for w, lb, ns, _n in per:
            nc = len(lb)
            windows[j, base:base + nc] = w
            lbit[j, base:base + nc] = lb
            nsym[j, base:base + nc] = ns
            base += nc
    times["lit_prep"] += time.perf_counter() - t1
    return decoded, items, built, (windows, lbit, nsym, tables)


def _literals(metas, dev, times):
    """Decode every frame's Huffman literals in one chunk-kernel launch;
    returns {meta index: literal bytes}."""
    decoded, items, built, arrays = _literal_batch(metas, times)
    if arrays is None:
        return decoded
    t0 = time.perf_counter()
    syms, _ = ED.huff0_decode_chunks(
        *(torch.from_numpy(a).to(dev) for a in arrays), k=_LIT_K)
    syms = syms.cpu().numpy()
    times["lit_kernel"] += time.perf_counter() - t0
    for j, (i, _tr, _t) in enumerate(items):
        parts = []
        base = 0
        for _w, lb, _ns, n_sym in built[j]:
            nc = len(lb)
            parts.append(syms[j, base:base + nc].reshape(-1)[:n_sym]
                         .tobytes())
            base += nc
        decoded[i] = b"".join(parts)
    return decoded


def _op_plan(lits: bytes, lls, mls, offs, max_rounds: int):
    """The execute plan of one block's sequences: per sequence a literal
    run and a copy, then the trailing literals."""
    kinds_l, lens_l, offs_l = [], [], []
    for ll, ml, off in zip(lls.tolist(), mls.tolist(), offs.tolist()):
        if ll:
            kinds_l.append(0)
            lens_l.append(ll)
            offs_l.append(0)
        kinds_l.append(1)
        lens_l.append(ml)
        offs_l.append(off)
    consumed = int(np.sum(lls))
    if consumed < len(lits):
        kinds_l.append(0)
        lens_l.append(len(lits) - consumed)
        offs_l.append(0)
    return X.plan_block_ops(np.array(kinds_l), np.array(lens_l),
                            np.array(offs_l), max_rounds=max_rounds)


def _exec_batch(metas, lit_decoded, seq_out, max_rounds: int):
    """Host half of the execute stage: (plans, literal rows (B, 512, 128)
    uint8, the meta index of each plan, [(meta index, frame)] for the
    host decoder)."""
    plans, lit_rows, order, host = [], [], [], []
    seq_iter = iter(seq_out)
    for i, (kind, m) in enumerate(metas):
        if kind == "host":
            host.append((i, m))
            continue
        if kind == "accel_mb":
            continue
        lits = lit_decoded[i]
        if kind == "accel":
            try:
                plans.append(AC.accel_plan(m[1]))
            except ValueError:
                # inconsistent sidecar: decode the frame on the host
                host.append((i, m[2]))
                continue
        else:
            lls, mls, _ofvals, offs = next(seq_iter)
            plans.append(_op_plan(lits, lls, mls, offs, max_rounds))
        row = np.zeros(512 * 128, np.uint8)
        row[:len(lits)] = np.frombuffer(lits, np.uint8)
        lit_rows.append(row.reshape(512, 128))
        order.append(i)
    rows = (np.stack(lit_rows) if lit_rows
            else np.zeros((0, 512, 128), np.uint8))
    return plans, rows, order, host


def _mb_groups(metas, lit_decoded):
    """Host half of the multi-block execute: {hist_blocks: (meta indices,
    plans per frame, literal rows (B, K, 512, 128) uint8, pieces, gstart)}
    and [(meta index, frame)] for the host decoder (a sidecar whose plans
    ``accel_plan`` or ``pack_pieces_mb`` refuse)."""
    by_hb, host = {}, []
    for i, (kind, m) in enumerate(metas):
        if kind != "accel_mb":
            continue
        _lits, accs, hb, frame = m
        try:
            plans = [AC.accel_plan(a, hb) for a in accs]
        except ValueError:
            host.append((i, frame))
            continue
        by_hb.setdefault(hb, []).append((i, plans))
    groups = {}
    for hb, group in by_hb.items():
        plans_kb = [p for _i, p in group]
        try:
            pieces, gstart = X.pack_pieces_mb(plans_kb, hb << 16)
        except ValueError as e:
            # a packing the execute refuses: this group decodes on the
            # host; logged, as it usually means a packing regression
            dbg("device_dec", "multi-block group fell back to host: %s", e)
            host.extend((i, metas[i][1][3]) for i, _p in group)
            continue
        K = gstart.shape[1]
        rows = np.zeros((len(group), K, 512 * 128), np.uint8)
        for b, (i, plans) in enumerate(group):
            for k in range(len(plans)):
                lits = lit_decoded[(i, k)]
                rows[b, k, :len(lits)] = np.frombuffer(lits, np.uint8)
        groups[hb] = ([i for i, _p in group], plans_kb,
                      rows.reshape(len(group), K, 512, 128), pieces, gstart)
    return groups, host


def decompress_frames_device(frames, max_rounds: int = 4, device=None,
                             stats: dict | None = None, mesh=None):
    """Decode a batch of zstd items (each one frame, optionally preceded
    by skippable frames such as an accel sidecar and followed by
    skippable frames); returns a list of bytes, equal to
    ``zstd.decompress`` of each item.  Single-block frames, and
    multi-block frames with a sidecar, decode on the device (see the
    module doc for which shapes go to the host decoder, counted in
    ``decompress_frames_device.host_frames``).

    Runs on CUDA unless ``device`` names another device ("cpu" runs the
    plain PyTorch versions); raises when no card is present and no device
    was given.  ``stats``, when given, receives the count of items on each
    route and the host-clock seconds of each stage: ``parse`` (routing and
    section parse), ``lit_walk`` and ``seq_walk`` (the host checkpoint
    walks of the "dev" route), ``lit_prep`` (windows and tables),
    ``lit_kernel`` and ``seq`` (transfer, launch, result back; ``seq``
    without its walk), ``plan`` (the execute plans and their packing),
    ``exec`` and ``host`` (host-decoded items).  Batches beyond
    MAX_DEC_BATCH frames run in chunks.

    mesh: an optional ``parallel.BlockMesh``: each rank decodes its share
    of the items (``parallel.shard_items``) on the mesh's device and
    every rank returns the whole list, gathered in item order; ``stats``
    then holds this rank's share."""
    if mesh is not None:
        from compress_tpu_torch.parallel.engine import map_sharded

        return map_sharded(mesh, frames, device, lambda part, dev: (
            decompress_frames_device(part, max_rounds, dev, stats)))
    dev = resolve_device(device)
    if len(frames) > MAX_DEC_BATCH:
        out = []
        for lo in range(0, len(frames), MAX_DEC_BATCH):
            out.extend(decompress_frames_device(
                frames[lo:lo + MAX_DEC_BATCH], max_rounds, dev, stats))
        return out
    from compress_tpu_torch import zstd as Z

    times = dict.fromkeys(("parse", "lit_walk", "lit_prep", "lit_kernel",
                           "seq_walk", "seq", "plan", "exec", "host"), 0.0)
    t0 = time.perf_counter()
    metas = [_route(bytes(f)) for f in frames]
    times["parse"] += time.perf_counter() - t0

    lit_decoded = _literals(metas, dev, times)

    t0 = time.perf_counter()
    seq_items = [m[4] for kind, m in metas if kind == "dev"]
    seq_stats = {"walk_s": 0.0}
    # resolve=True: the repeat offsets resolve on the device, in the
    # decode's carry
    seq_out = (seqdev.decode_sequences_device(seq_items, resolve=True,
                                              device=dev, stats=seq_stats)
               if seq_items else [])
    times["seq_walk"] += seq_stats["walk_s"]
    times["seq"] += time.perf_counter() - t0 - seq_stats["walk_s"]

    results = [None] * len(frames)
    t0 = time.perf_counter()
    plans, lit_rows, order, host = _exec_batch(metas, lit_decoded, seq_out,
                                               max_rounds)
    if plans:
        pieces, rstart = X.pack_pieces(plans)
        t1 = time.perf_counter()
        times["plan"] += t1 - t0
        out = X.execute_pieces(*(torch.from_numpy(a).to(dev) for a in (
            lit_rows, pieces, rstart)))
        out = out.reshape(len(plans), -1).cpu().numpy()
        for j, i in enumerate(order):
            results[i] = out[j, :int(np.sum(plans[j]["len"]))].tobytes()
        times["exec"] += time.perf_counter() - t1
    else:
        times["plan"] += time.perf_counter() - t0

    # multi-block frames: one history launch per history size
    t0 = time.perf_counter()
    groups, mb_host = _mb_groups(metas, lit_decoded)
    host += mb_host
    times["plan"] += time.perf_counter() - t0
    for hb, (idx, plans_kb, rows, pieces, gstart) in groups.items():
        t0 = time.perf_counter()
        out = X.execute_blocks_hist(*(torch.from_numpy(a).to(dev) for a in (
            rows, pieces, gstart)), hb * 512)
        out = out.reshape(len(idx), -1).cpu().numpy()
        for b, (i, plans) in enumerate(zip(idx, plans_kb)):
            frame_out = out[b].reshape(-1, 512 * 128)
            results[i] = b"".join(
                frame_out[k, :int(np.sum(p["len"]))].tobytes()
                for k, p in enumerate(plans))
        times["exec"] += time.perf_counter() - t0

    t0 = time.perf_counter()
    for i, fr in host:
        results[i] = Z.decompress(fr)
    times["host"] += time.perf_counter() - t0
    decompress_frames_device.host_frames += len(host)
    if stats is not None:
        routes = stats.setdefault("routes", {})
        for kind, _m in metas:
            routes[kind] = routes.get(kind, 0) + 1
        stats["host_frames"] = stats.get("host_frames", 0) + len(host)
        st = stats.setdefault("s", {})
        for key, v in times.items():
            st[key] = st.get(key, 0.0) + v
    return results


decompress_frames_device.host_frames = 0
