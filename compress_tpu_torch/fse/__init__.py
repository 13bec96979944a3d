"""Standalone FSE (tANS) block codec of the port (counterpart of the JAX
package's ``fse/__init__.py``): the host codec ``compress`` /
``decompress`` (``decompress`` decodes a container in one call of the
host core's ``ct_fse_decompress_body``, and where it refuses the
container, in Python: ``decompress_py``), and the
batch codec on the device: ``compress_batch`` (``ops/entropy``
``fse_encode_blocks``), ``make_accel`` (a host walk that records the decode
checkpoints) and ``decompress_batch`` (``ops/entropy_dec``
``fse_decode_chunks``).

Container: ``[uvarint decoded length][NCount header][2-state interleaved
bitstream]``.  The device decode is specialised to table log 9, as the
reference's is: ``decompress_batch`` decodes containers of another log on
the host and counts them in ``decompress_batch.host_containers``.
"""

from __future__ import annotations

import numpy as np
import torch

from compress_tpu_torch import _native
from compress_tpu_torch._cuda import resolve_device
from compress_tpu_torch.fse import core
from compress_tpu_torch.ops import entropy as E
from compress_tpu_torch.ops import entropy_dec as ED
from compress_tpu_torch.utils.histogram import histogram256
from compress_tpu_torch.utils.varint import put_uvarint, read_uvarint

__all__ = ["compress", "decompress", "decompress_py", "compress_batch", "make_accel",
           "prep_decode_batch", "decompress_batch", "IncompressibleError",
           "UseRLEError", "core"]


class IncompressibleError(ValueError):
    """Input won't benefit from FSE (reference: ErrIncompressible)."""


class UseRLEError(ValueError):
    """Input is a single repeated symbol (reference: ErrUseRLE)."""


def compress(data, table_log: int = 0) -> bytes:
    """FSE-compress a byte block.  Raises UseRLEError /
    IncompressibleError as the reference's Compress contract does."""
    data = bytes(data)
    n = len(data)
    if n <= 1:
        raise IncompressibleError("input too small")
    if n > (2 << 30) - 1:
        raise ValueError("input too big, must be < 2GB")
    buf = np.frombuffer(data, dtype=np.uint8)
    hist = histogram256(buf)
    max_count = int(hist.max())
    max_symbol = int(np.nonzero(hist)[0][-1])
    if max_count == n:
        raise UseRLEError("single symbol")
    if max_count == 1 or max_count < (n >> 7):
        raise IncompressibleError("too well distributed")
    tl = core.optimal_table_log(table_log, n, max_symbol)
    norm = core.normalize_count(hist, tl, n, max_symbol)
    out = bytearray()
    put_uvarint(out, n)
    out += core.write_ncount(norm, tl)
    out += core.encode_interleaved2(buf, norm, tl)
    if len(out) >= n:
        raise IncompressibleError("did not compress")
    return bytes(out)


def decompress(blob, max_size: int = 64 << 20) -> bytes:
    """Decompress a container made by ``compress`` or ``compress_batch``."""
    blob = bytes(blob)
    n, pos = read_uvarint(blob)
    if n > max_size:
        raise ValueError("decoded size exceeds limit")
    if n >= 2:
        sp, sn = _native.pad_scratch(blob, pos)
        out = np.empty(n, np.uint8)
        if _native.library().ct_fse_decompress_body(sp, sn, _native.ptr(out),
                                                    n) == 0:
            return out.tobytes()
    norm, tl, pos = core.read_ncount(blob, pos, max_symbol=255)
    return core.decode_interleaved2(blob[pos:], norm, tl, n).tobytes()


def decompress_py(blob, max_size: int = 64 << 20) -> bytes:
    """``decompress`` in Python alone."""
    blob = bytes(blob)
    n, pos = read_uvarint(blob)
    if n > max_size:
        raise ValueError("decoded size exceeds limit")
    norm, tl, pos = core.read_ncount(blob, pos, max_symbol=255)
    return core.decode_interleaved2_py(blob[pos:], norm, tl, n).tobytes()


def compress_batch(blocks, table_log: int = E.FSE_LOG, device=None) -> list:
    """Device-batched FSE compress over equal-length blocks (L even).

    Same container as ``compress``; entries are None where the block is
    RLE or incompressible (the reference's contract).  Runs on CUDA unless
    ``device`` names another device; raises when no card is present and
    no device was given."""
    dev = resolve_device(device)
    arr = np.ascontiguousarray(blocks).astype(np.uint8)
    N, L = arr.shape
    t = {k: v.cpu().numpy() for k, v in E.fse_encode_blocks(
        torch.from_numpy(arr).to(dev), log=table_log).items()}
    out = []
    for i in range(N):
        top = int(t["hist"][i].max())
        if top in (L, 1) or top < (L >> 7):
            out.append(None)
            continue
        norm = t["norm"][i].astype(np.int64)
        nz = np.nonzero(norm)[0]
        header = core.write_ncount(norm[: nz[-1] + 1], table_log)
        tb = int(t["total_bits"][i])
        stream = bytearray(
            t["halves"][i].astype(np.uint16).tobytes()[:(tb + 1 + 7) // 8])
        stream[tb >> 3] |= 1 << (tb & 7)
        blob = bytearray()
        put_uvarint(blob, L)
        blob += header
        blob += stream
        out.append(bytes(blob) if len(blob) < L else None)
    return out


def make_accel(containers, k: int | None = None) -> dict:
    """Decode checkpoints of FSE containers by one host walk: per chunk of
    k symbols the (bit position, state 1, state 2) entry point.  Returns
    {"ckpt": (N, cmax, 3) int32, "k": k, "logs": (N,) int32}, zeros for
    None entries."""
    k = k or E.HUFF_CKPT_K
    if k % 2:
        raise ValueError(f"make_accel: k = {k} is odd")
    rows = []
    cmax = 1
    for blob in containers:
        if blob is None:
            rows.append(None)
            continue
        blob = bytes(blob)
        n, pos = read_uvarint(blob)
        norm, tl, pos = core.read_ncount(blob, pos, max_symbol=255)
        _, nb, new_state = core.build_dtable(norm, tl)
        nb, new_state = nb.tolist(), new_state.tolist()
        br = core.BitReaderReverse(blob[pos:])
        s1 = br.read(tl)
        s2 = br.read(tl)
        cks = [(br.bitpos, s1, s2)]
        last = n - 2
        for i in range(n):
            if i < last:
                if i & 1:
                    s2 = new_state[s2] + br.read(nb[s2])
                else:
                    s1 = new_state[s1] + br.read(nb[s1])
            if (i + 1) % k == 0 and i + 1 < n:
                cks.append((br.bitpos, s1, s2))
        rows.append((tl, cks))
        cmax = max(cmax, len(cks))
    ckpt = np.zeros((len(containers), cmax, 3), np.int32)
    logs = np.zeros(len(containers), np.int32)
    for i, r in enumerate(rows):
        if r is not None:
            logs[i] = r[0]
            ckpt[i, :len(r[1])] = r[1]
    return {"ckpt": ckpt, "k": k, "logs": logs}


def _prep(blob: bytes, ckpt: np.ndarray, K: int, max_size: int):
    """One log-9 container's decode inputs: (n, table, windows, lbit, st1,
    st2, npair, nore1, nore2)."""
    n, pos = read_uvarint(blob)
    if n > max_size:
        raise ValueError("decoded size exceeds limit")
    norm, tl, pos = core.read_ncount(blob, pos, max_symbol=255)
    table = ED.fse_table(*core.build_dtable(norm, tl))
    nch = -(-n // K)
    w, lb = ED.build_windows(blob[pos:], ckpt[:, 0].copy(), nch)
    base = K * np.arange(nch)
    npair = np.clip(n - base, 0, K) // 2
    # reload cutoffs: symbol 2m (state 1) reloads while 2m < n - 2, symbol
    # 2m + 1 (state 2) while 2m + 1 < n - 2; pair index local to the chunk
    nore1 = np.clip((n - 1) // 2 - base // 2, 0, K // 2)
    nore2 = np.clip((n - 2) // 2 - base // 2, 0, K // 2)
    return (n, table, w, lb, ckpt[:nch, 1], ckpt[:nch, 2], npair, nore1,
            nore2)


def prep_decode_batch(containers, accel, max_size: int = 64 << 20):
    """The host half of ``decompress_batch``: (metas, arrays).  metas holds
    each container's ``_prep`` tuple, or None for a container the device
    does not take (None, or a log other than 9); arrays are the chunk
    decode's inputs (windows, lbit, st1, st2, npair, nore1, nore2, tables)
    as numpy arrays, None when no container is left for the device."""
    K = int(accel["k"])
    ckpt = np.asarray(accel["ckpt"])
    logs = np.asarray(accel["logs"])
    metas = [None if blob is None or int(logs[i]) != 9
             else _prep(bytes(blob), ckpt[i], K, max_size)
             for i, blob in enumerate(containers)]
    live = [m for m in metas if m is not None]
    if not live:
        return metas, None
    N, cmax = len(containers), max(len(m[3]) for m in live)
    windows = np.zeros((N, cmax, ED.WIN), np.uint8)
    cur = np.zeros((6, N, cmax), np.int32)  # lbit st1 st2 npair nore1 nore2
    cur[0] = 8 * ED.WIN
    tables = np.zeros((N, ED.FSE_STATES), np.int32)
    for i, m in enumerate(metas):
        if m is not None:
            nc = len(m[3])
            tables[i] = m[1]
            windows[i, :nc] = m[2]
            for j in range(6):
                cur[j, i, :nc] = m[3 + j]
    return metas, (windows, *cur, tables)


def decompress_batch(containers, accel=None, max_size: int = 64 << 20,
                     device=None) -> list:
    """Decode a batch of FSE containers; None entries pass through as None.

    Without ``accel`` each container is decoded on the host.  With it
    (``make_accel``'s checkpoints) the interleaved state machine of every
    log-9 container runs on the device, one launch for the batch
    (``ops/entropy_dec.fse_decode_chunks``); containers of another log are
    decoded on the host and counted in ``decompress_batch.host_containers``.
    Runs on CUDA unless ``device`` names another device; raises when no
    card is present and no device was given."""
    dev = resolve_device(device)
    if accel is None:
        return [None if c is None else decompress(c, max_size)
                for c in containers]
    metas, arrays = prep_decode_batch(containers, accel, max_size)
    if arrays is not None:
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        syms = ED.fse_decode_chunks(*args, k=int(accel["k"]))[0]
        syms = syms.reshape(len(containers), -1).cpu().numpy()
    out = []
    for i, m in enumerate(metas):
        if m is not None:
            out.append(syms[i, :m[0]].tobytes())
        elif containers[i] is None:
            out.append(None)
        else:
            decompress_batch.host_containers += 1
            out.append(decompress(containers[i], max_size))
    return out


decompress_batch.host_containers = 0
