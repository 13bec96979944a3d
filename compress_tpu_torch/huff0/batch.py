"""huff0 4X batch codec on the device (counterpart of the JAX package's
``huff0.compress_4x_batch``, ``make_accel``, ``_prep_decode_batch``,
``shared_packed_table`` and ``decompress_4x_batch``), with copies of its
host stream codec (``_encode_stream``, ``_decode_stream``,
``decompress_1x``, ``decompress_4x``).  As there, these run the host core
(``ct_huf0_encode_stream``, ``ct_huf0_decode_stream``,
``ct_huf0_decompress_body``) and, where it refuses an input, the Python
path, which gives the reference's precise error; the ``_py`` functions
are the Python paths alone, the plain versions.

Container: [uvarint n][table][jump6: the first three stream sizes]
[stream 1..4]; the input splits into 4 segments of ceil(n / 4) bytes (the
last takes the rest).  The device encoder also returns the decode
accelerator (``accel``): every stream's remaining-bit offset at every
K-th symbol, which lets the decoder cut each stream into chunks that
decode in parallel.
"""

from __future__ import annotations

import numpy as np
import torch

from compress_tpu_torch import _native
from compress_tpu_torch._cuda import resolve_device
from compress_tpu_torch.fse import core as fse_core
from compress_tpu_torch.huff0.table import (CorruptError, IncompressibleError,
                                            read_table, write_table)
from compress_tpu_torch.ops import entropy_dec as ED
from compress_tpu_torch.ops import entropy_kern as EK
from compress_tpu_torch.ops.entropy import HUFF_CKPT_K, huff0_encode_blocks
from compress_tpu_torch.utils.varint import put_uvarint, read_uvarint

__all__ = ["compress_4x_batch", "make_accel", "shared_packed_table",
           "decompress_4x_batch", "decompress_1x", "decompress_4x"]


def _peek(data: bytes, bitpos: int, max_bits: int) -> int:
    """The max_bits bits below bit ``bitpos`` (zero-padded below bit 0)."""
    bp = bitpos - max_bits
    if bp >= 0:
        chunk = int.from_bytes(data[bp >> 3:(bp >> 3) + 9], "little")
        return (chunk >> (bp & 7)) & ((1 << max_bits) - 1)
    chunk = int.from_bytes(data[0:9], "little")
    return (chunk << -bp) & ((1 << max_bits) - 1)


def _decode_stream(stream: bytes, sym_t, nb_t, max_bits: int,
                   out_len: int) -> np.ndarray:
    """Decode one stream (``ct_huf0_decode_stream``)."""
    if out_len and stream:
        st = np.ascontiguousarray(sym_t, np.uint8)
        nbt = np.ascontiguousarray(nb_t, np.uint8)
        sp, sn = _native.pad_scratch(stream)
        out = np.empty(out_len, np.uint8)
        if _native.library().ct_huf0_decode_stream(
                sp, sn, _native.ptr(st), _native.ptr(nbt), int(max_bits),
                _native.ptr(out), out_len) == 0:
            return out
    return _decode_stream_py(stream, sym_t, nb_t, max_bits, out_len)


def _decode_stream_py(stream: bytes, sym_t, nb_t, max_bits: int,
                      out_len: int) -> np.ndarray:
    """Decode one stream symbol by symbol (the reference's Python loop)."""
    br = fse_core.BitReaderReverse(stream)
    out = np.zeros(out_len, dtype=np.uint8)
    bitpos = br.bitpos
    data = br.data
    for i in range(out_len):
        window = _peek(data, bitpos, max_bits)
        out[i] = sym_t[window]
        bitpos -= int(nb_t[window])
        if bitpos < 0:
            raise CorruptError("stream overread")
    if bitpos != 0:
        raise CorruptError("stream not fully consumed")
    return out


def _encode_stream(data: np.ndarray, codes: np.ndarray,
                   nbits: np.ndarray) -> bytes:
    """One stream (``ct_huf0_encode_stream``)."""
    if len(data):
        d = np.ascontiguousarray(data, np.uint8)
        c = np.ascontiguousarray(codes, np.uint16)
        nb = np.ascontiguousarray(nbits, np.uint8)
        cap = 2 * len(d) + 64
        arr, dst = _native.out_buf(cap)
        r = _native.library().ct_huf0_encode_stream(
            _native.ptr(d), len(d), _native.ptr(c), _native.ptr(nb), dst, cap)
        if r >= 0:
            return arr[:r].tobytes()
    return _encode_stream_py(data, codes, nbits)


def _encode_stream_py(data: np.ndarray, codes: np.ndarray,
                      nbits: np.ndarray) -> bytes:
    """One stream: the symbols' codes written last symbol first (so that
    the decoder emits forward), LSB-first, then the 1-bit end marker.
    The reference's bit writer, vectorized: the same bytes."""
    seq = np.asarray(data, np.uint8)[::-1].astype(np.int64)
    c = np.asarray(codes, np.int64)[seq]
    nb = np.asarray(nbits, np.int64)[seq]
    j = np.arange(16)
    bits = ((c[:, None] >> j) & 1).astype(np.uint8)[j[None, :] < nb[:, None]]
    return np.packbits(np.append(bits, np.uint8(1)),
                       bitorder="little").tobytes()


def _decompress_body(blob: bytes, pos: int, n: int, fourx: int):
    """A container's table and streams decoded in one call of
    ``ct_huf0_decompress_body``, or None where it refuses them."""
    if n == 0:
        return None
    sp, sn = _native.pad_scratch(blob, pos)
    out = np.empty(n, np.uint8)
    r = _native.library().ct_huf0_decompress_body(sp, sn, fourx,
                                                  _native.ptr(out), n)
    return out.tobytes() if r == 0 else None


def decompress_1x(blob, max_size: int = 64 << 20) -> bytes:
    """Host decode of one 1X container ([uvarint n][table][stream])."""
    blob = bytes(blob)
    n, pos = read_uvarint(blob)
    if n > max_size:
        raise ValueError("decoded size exceeds limit")
    res = _decompress_body(blob, pos, n, 0)
    if res is not None:
        return res
    sym_t, nb_t, max_bits, pos = read_table(blob, pos)
    return _decode_stream(blob[pos:], sym_t, nb_t, max_bits, n).tobytes()


def _split(blob: bytes, pos: int, n: int):
    """(jump-table sizes, segment lengths, position after the jump table)."""
    sizes = [int.from_bytes(blob[pos + 2 * k:pos + 2 * k + 2], "little")
             for k in range(3)]
    seg = (n + 3) // 4
    return sizes, [seg, seg, seg, n - 3 * seg], pos + 6


def decompress_4x(blob, max_size: int = 64 << 20) -> bytes:
    """Host decode of one 4X container."""
    blob = bytes(blob)
    n, pos = read_uvarint(blob)
    if n > max_size:
        raise ValueError("decoded size exceeds limit")
    res = _decompress_body(blob, pos, n, 1)
    if res is not None:
        return res
    sym_t, nb_t, max_bits, pos = read_table(blob, pos)
    if pos + 6 > len(blob):
        raise CorruptError("jump table truncated")
    sizes, lens, pos = _split(blob, pos, n)
    if lens[3] < 0:
        raise CorruptError("invalid segment split")
    out = bytearray()
    for k in range(4):
        size = sizes[k] if k < 3 else len(blob) - pos
        if pos + size > len(blob):
            raise CorruptError("stream truncated")
        out += _decode_stream(blob[pos:pos + size], sym_t, nb_t, max_bits,
                              lens[k]).tobytes()
        pos += size
    return bytes(out)


def compress_4x_batch(blocks, return_accel: bool = False,
                      shared_table: bool = False, max_log: int = 11,
                      device=None):
    """Device-batched Compress4X over equal-length blocks.

    blocks: (N, L) uint8 array-like, L a multiple of 512.  Returns a list
    of containers, None where a block is incompressible or one symbol (the
    reference's error contract: the caller falls back); with
    ``return_accel`` also the decode accelerator {ckpt (N, 4, nck) int32,
    k, shared}.  Runs on CUDA unless ``device`` names another device;
    raises when no card is present and no device was given."""
    dev = resolve_device(device)
    arr = np.ascontiguousarray(blocks).astype(np.uint8)
    N, L = arr.shape
    t = {k: v.cpu().numpy() for k, v in huff0_encode_blocks(
        torch.from_numpy(arr).to(dev), shared_table=shared_table,
        max_log=max_log).items()}
    accel = {"ckpt": t["ckpt"], "k": HUFF_CKPT_K,
             "shared": bool(shared_table)}
    out = []
    cache: dict = {}
    for i in range(N):
        if not bool(t["ok"][i]):
            out.append(None)
            continue
        key = t["nbits"][i].tobytes()
        if key not in cache:
            try:
                cache[key] = write_table(t["nbits"][i].astype(np.int64),
                                         int(t["max_bits"][i]))
            except IncompressibleError:
                cache[key] = None
        table = cache[key]
        if table is None:
            out.append(None)
            continue
        bq = t["stream_bits"][i]
        sb = [(int(x) + 1 + 7) // 8 for x in bq]
        sh = [(int(x) + 16) >> 4 for x in bq]
        sbase = [sh[1] + sh[2] + sh[3], sh[2] + sh[3], sh[3], 0]
        hb = t["halves"][i].astype(np.uint16).tobytes()
        streams = []
        for q in range(4):
            sbytes = bytearray(hb[2 * sbase[q]:2 * sbase[q] + sb[q]])
            eos = int(bq[q])
            sbytes[eos >> 3] |= 1 << (eos & 7)
            streams.append(bytes(sbytes))
        if max(len(s) for s in streams[:3]) > 0xFFFF:
            out.append(None)
            continue
        blob = bytearray()
        put_uvarint(blob, L)
        blob += table
        for s in streams[:3]:
            blob += len(s).to_bytes(2, "little")
        for s in streams:
            blob += s
        out.append(bytes(blob) if len(blob) < L else None)
    if return_accel:
        return out, accel
    return out


def make_accel(containers, k: int | None = None):
    """Derive the decode accelerator of existing containers by one host
    walk (for containers not made by ``compress_4x_batch``)."""
    k = k or HUFF_CKPT_K
    rows = []
    cmax = 1
    for blob in containers:
        if blob is None:
            rows.append(None)
            continue
        blob = bytes(blob)
        n, pos = read_uvarint(blob)
        sym_t, nb_t, max_bits, pos = read_table(blob, pos)
        sizes, lens, pos = _split(blob, pos, n)
        qs = []
        for q in range(4):
            size = sizes[q] if q < 3 else len(blob) - pos
            data = blob[pos:pos + size]
            pos += size
            bitpos = fse_core.BitReaderReverse(data).bitpos
            cks = [bitpos]
            for j in range(lens[q]):
                bitpos -= int(nb_t[_peek(data, bitpos, max_bits)])
                if (j + 1) % k == 0:
                    cks.append(bitpos)
            qs.append(cks)
            cmax = max(cmax, len(cks))
        rows.append(qs)
    ckpt = np.zeros((len(containers), 4, cmax), np.int32)
    for i, qs in enumerate(rows):
        if qs is None:
            continue
        for q in range(4):
            ckpt[i, q, :len(qs[q])] = qs[q]
    return {"ckpt": ckpt, "k": k}


def _prep_decode_batch(containers, accel, max_size: int = 64 << 20):
    """Host prep of the device decode: parse the containers, expand their
    tables, cut every stream's chunk windows and pack the batch.  Returns
    ((windows (N, C, WIN) uint8, lbit (N, C) int32, nsym (N, C) int32,
    tables (N, 2048) int32 per ``expand_table``) CPU tensors, metas, cmax)
    with C =
    4 * cmax; pad chunks have nsym 0 and lbit 8 * WIN."""
    K = int(accel["k"])
    ckpt = np.asarray(accel["ckpt"])
    N = len(containers)
    metas = []
    cmax = 1
    for i, blob in enumerate(containers):
        if blob is None:
            metas.append(None)
            continue
        blob = bytes(blob)
        n, pos = read_uvarint(blob)
        if n > max_size:
            raise ValueError("decoded size exceeds limit")
        sym_t, nb_t, max_bits, pos = read_table(blob, pos)
        sizes, lens, pos = _split(blob, pos, n)
        table = ED.expand_table(sym_t, nb_t, max_bits)
        streams = []
        for q in range(4):
            size = sizes[q] if q < 3 else len(blob) - pos
            if pos + size > len(blob) or lens[3] < 0:
                raise CorruptError("stream truncated")
            streams.append(blob[pos:pos + size])
            pos += size
        wq, lq, nsq = [], [], []
        for q in range(4):
            nch = -(-lens[q] // K) if lens[q] else 0
            w, lb = ED.build_windows(streams[q], ckpt[i, q], max(nch, 1))
            ns = np.maximum(np.minimum(lens[q] - K * np.arange(max(nch, 1)),
                                       K), 0)
            wq.append(w)
            lq.append(lb)
            nsq.append(ns.astype(np.int32))
        metas.append((n, lens, table, wq, lq, nsq))
        cmax = max(cmax, max(len(x) for x in lq))
    C = 4 * cmax
    windows = np.zeros((N, C, ED.WIN), np.uint8)
    lbit = np.full((N, C), 8 * ED.WIN, np.int32)
    nsym = np.zeros((N, C), np.int32)
    tables = np.zeros((N, 2048), np.int32)
    for i, m in enumerate(metas):
        if m is None:
            continue
        _, _, table, wq, lq, nsq = m
        tables[i] = table
        for q in range(4):
            base = q * cmax
            nc = len(lq[q])
            windows[i, base:base + nc] = wq[q]
            lbit[i, base:base + nc] = lq[q]
            nsym[i, base:base + nc] = nsq[q]
    args = tuple(torch.from_numpy(a) for a in (windows, lbit, nsym, tables))
    return args, metas, cmax


def shared_packed_table(metas):
    """(packed (2^mb,) int32 sym | nb << 8, mb) from a shared-table batch's
    first decode meta (all its containers carry the same table)."""
    tab = next(m for m in metas if m is not None)[2]
    mb = int((tab >> 8).max())
    return tab[np.arange(1 << mb) << (11 - mb)], mb


def decompress_4x_batch(containers, accel=None, max_size: int = 64 << 20,
                        engine: str = "auto", device=None):
    """Decode a batch of 4X containers; None entries pass through as None.

    With ``accel`` (the encoder's checkpoints) the symbol loop runs on the
    device, one kernel launch for the batch; without it each container is
    decoded on the host.  engine: "shared" = the batch-shared-table chunk
    kernel (needs ``accel["shared"]``), "table" = the same kernel with one
    table per container, "auto" = "shared" when the batch was encoded with
    a shared table and the device is CUDA, else "table".  Runs on CUDA
    unless ``device`` names another device; raises when no card is present
    and no device was given.  A stream whose chunks do not end exactly at
    its start raises ``CorruptError``."""
    dev = resolve_device(device)
    if accel is None:
        return [None if c is None else decompress_4x(c, max_size)
                for c in containers]
    if engine not in ("auto", "shared", "table"):
        raise ValueError(f"unknown engine {engine!r}")
    if all(c is None for c in containers):
        return [None] * len(containers)
    K = int(accel["k"])
    ckpt = np.asarray(accel["ckpt"])
    args, metas, cmax = _prep_decode_batch(containers, accel, max_size)
    shared = engine == "shared" or (engine == "auto" and accel.get("shared")
                                    and dev.type == "cuda")
    windows, lbit, nsym, tables = (a.to(dev) for a in args)
    N, C, win = windows.shape
    if shared:
        if not accel.get("shared"):
            raise ValueError("the shared engine needs a shared-table accel")
        packed, mb = shared_packed_table(metas)
        syms, endl = EK.huff0_decode_chunks_shared(
            windows.reshape(N * C, win), lbit.reshape(-1), nsym.reshape(-1),
            torch.from_numpy(packed).to(dev), k=K, max_bits=mb)
    else:
        syms, endl = ED.huff0_decode_chunks(windows, lbit, nsym, tables, k=K)
    syms = syms.reshape(N, C * K).cpu().numpy()
    endl = endl.reshape(N, C).cpu().numpy()
    out = []
    for i, m in enumerate(metas):
        if m is None:
            out.append(None)
            continue
        n, lens, _, wq, lq, nsq = m
        parts = []
        for q in range(4):
            base = q * cmax
            nc = len(lq[q])
            parts.append(syms[i, base * K:base * K + lens[q]].tobytes())
            # consumption check: the last chunk must end exactly on the
            # stream's start (window-local: lbit - ckpt of that chunk)
            if lens[q]:
                expected = int(lq[q][nc - 1]) - int(ckpt[i, q][nc - 1])
                if int(endl[i, base + nc - 1]) != expected:
                    raise CorruptError("stream not fully consumed")
        out.append(b"".join(parts))
    return out
