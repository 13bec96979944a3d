"""zstd frames from the device encoders (counterpart of the JAX package's
``zstd/device.py``).

The device produces, per block, the sequences, the literal count, the
huff0 4-stream literal halves and the FSE sequence-stream halves: the v2
encoder (``ops/zenc2.py``, 64 KiB blocks, FSE tables shared by a launch)
on CUDA, the v1 encoder (``ops/zdev.py``, 16 KiB blocks, FSE tables per
job) elsewhere, as the reference picks v2 on an accelerator and v1 on a
CPU.  This module is the host's byte plumbing, one assembly for both
engines' dicts (``_assemble_job``: the host core's
``ct_zstd_assemble_job``, as in the reference; ``_assemble_job_py`` is its
plain version): it picks raw, RLE or compressed per section, writes the
headers, splices the device streams and sets the end-of-stream bit of
each.

Repeat codes are emitted, but the first 3 sequences of every block are
plain off + 3 (``zseqenc.rep_scan``), so a block never needs another's
repeat state.  A job's first compressed block with sequences carries the
FSE tables, later ones repeat them.

An input shorter than one job goes through the host encoder
(``encoder.compress`` at level 1, the ladder); the sub-job tail after the device jobs
goes through the host matcher in blocks of ``encoder.BLOCK_SIZE`` with
rep-free offsets (``tail_bodies``), as in the reference.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from compress_tpu_torch import _native
from compress_tpu_torch._cuda import resolve_device
from compress_tpu_torch.fse import core as fse_core
from compress_tpu_torch.huff0.table import write_table
from compress_tpu_torch.ops import zdev, zenc2
from compress_tpu_torch.utils.xxhash64 import xxh64
from compress_tpu_torch.zstd import encoder as E
from compress_tpu_torch.zstd import frame as F
from compress_tpu_torch.zstd.encoder import (_lit_header, _lit_header_comp,
                                             _seq_count_header)

DEFAULT_JOB = 4 << 20


def _extract_literals(block: bytes, lls, mls, ns: int) -> bytes:
    """The per-sequence literal runs and the tail, gathered at once."""
    if ns == 0:
        return block
    lls = np.asarray(lls[:ns], np.int64)
    mls = np.asarray(mls[:ns], np.int64)
    starts = np.zeros(ns, np.int64)
    adv = lls + mls
    starts[1:] = np.cumsum(adv[:-1])
    tail_at = int(starts[-1] + adv[-1])
    total = int(lls.sum())
    if total == 0:
        return block[tail_at:]
    nz = lls > 0
    st = starts[nz]
    ln = lls[nz]
    base = np.repeat(st - (np.cumsum(ln) - ln), ln)
    idx = base + np.arange(total, dtype=np.int64)
    buf = np.frombuffer(block, np.uint8)
    return buf[idx].tobytes() + block[tail_at:]


_TABLE_CACHE: dict = {}  # nbits bytes -> serialized table (or None)


def _first_seq_hdr(t, j) -> bytes:
    """Modes byte + per-table extras for the job's first sequence block."""
    modes = []
    extras = []
    for k in range(3):
        norm = np.asarray(t["fse_norm"][j][k]).astype(np.int64)
        nz = np.nonzero(norm)[0]
        if bool(t["fse_rle"][j][k]) or nz.size == 0:
            # an all-zero norm only happens when no block of the launch has
            # sequences: the header is never read, but must not fail
            modes.append(1)
            extras.append(bytes([int(t["fse_rle_sym"][j][k])]))
        else:
            modes.append(2)
            extras.append(fse_core.write_ncount(norm[: nz[-1] + 1],
                                                int(t["fse_log"][j][k])))
    m = (modes[0] << 6) | (modes[1] << 4) | (modes[2] << 2)
    return bytes([m]) + b"".join(extras)


def _huff_table_blob(nbits, max_bits: int):
    key = nbits.tobytes()
    if key not in _TABLE_CACHE:
        try:
            _TABLE_CACHE[key] = write_table(nbits.astype(np.int64), max_bits)
        except Exception:  # noqa: BLE001 - any unwritable table: raw literals
            _TABLE_CACHE[key] = None
    return _TABLE_CACHE[key]


def _assemble_job(job_bytes: bytes, t, j: int, block: int):
    """Per-block bodies for job j, as ``_assemble_job_py`` gives them, from
    one call of ``ct_zstd_assemble_job``."""
    def i32(x):
        return np.ascontiguousarray(np.asarray(x), np.int32)

    nblk = len(job_bytes) // block
    arrs = [i32(t[k][j]) for k in (
        "n_seqs", "lit_cnt", "huff_ok", "nbits", "max_bits", "stream_bits",
        "lit_halves", "seq_halves", "seq_total_bits", "ll", "ml")]
    ns, lc, ok, nb, mb, sb, lh, sh, tb, ll, ml = arrs
    hdr = _first_seq_hdr(t, j)
    cap = len(job_bytes) + nblk * 64 + (1 << 16)
    oarr, out = _native.out_buf(cap)
    blk_len = (ctypes.c_longlong * nblk)()
    p = _native.ptr
    r = _native.library().ct_zstd_assemble_job(
        job_bytes, len(job_bytes), int(block), int(nblk),
        p(ns), p(lc), p(ok), p(nb), p(mb), p(sb), p(lh), lh.shape[-1],
        p(sh), sh.shape[-1], p(tb), p(ll), p(ml), ll.shape[-1], hdr,
        len(hdr), out, cap, blk_len)
    if r < 0:
        raise RuntimeError(f"ct_zstd_assemble_job refused job {j} ({r})")
    raw = oarr[:r].tobytes()
    res = []
    pos = 0
    for bl in blk_len:
        if bl == -1:
            res.append(None)
        elif bl == -2:
            res.append(("rle", raw[pos:pos + 1]))
            pos += 1
        else:
            res.append(raw[pos:pos + bl])
            pos += bl
    return res


def _assemble_job_py(job_bytes: bytes, t, j: int, block: int):
    """Per-block bodies for job j: bytes (compressed), ("rle", byte) or
    None (raw)."""
    nblk = len(job_bytes) // block
    first_hdr = _first_seq_hdr(t, j)
    tables_written = False

    out = []
    for b in range(nblk):
        blk = job_bytes[b * block : (b + 1) * block]
        if blk.count(blk[0]) == len(blk):
            out.append(("rle", blk[:1]))
            continue
        ns = int(t["n_seqs"][j][b])
        lc = int(t["lit_cnt"][j][b])
        lits = _extract_literals(blk, t["ll"][j][b], t["ml"][j][b], ns)
        assert len(lits) == lc, (len(lits), lc)

        # ---- literal section candidates -------------------------------
        lit_sec = _lit_header(0, lc) + lits
        if lc > 0 and lits.count(lits[0]) == lc:
            rle = _lit_header(1, lc) + lits[:1]
            if len(rle) < len(lit_sec):
                lit_sec = rle
        table_blob = None
        if bool(t["huff_ok"][j][b]):
            table_blob = _huff_table_blob(t["nbits"][j][b],
                                          int(t["max_bits"][j][b]))
        if table_blob is not None and lc >= 256:
            bq = t["stream_bits"][j][b]
            sb = [(int(x) + 1 + 7) // 8 for x in bq]          # incl. EOS bit
            sh = [(int(x) + 16) >> 4 for x in bq]
            sbase = [sh[1] + sh[2] + sh[3], sh[2] + sh[3], sh[3], 0]
            hb = t["lit_halves"][j][b].astype(np.uint16).tobytes()
            streams = []
            for q in range(4):
                sbytes = bytearray(hb[2 * sbase[q] : 2 * sbase[q] + sb[q]])
                eos = int(bq[q])
                sbytes[eos >> 3] |= 1 << (eos & 7)
                streams.append(bytes(sbytes))
            if max(len(s) for s in streams[:3]) <= 0xFFFF:
                body = table_blob
                body += b"".join(len(s).to_bytes(2, "little")
                                 for s in streams[:3])
                body += b"".join(streams)
                try:
                    comp = _lit_header_comp(2, 4, lc, len(body)) + body
                except OverflowError:
                    comp = None
                if comp is not None and len(comp) < len(lit_sec):
                    lit_sec = comp

        # ---- sequence section ------------------------------------------
        seq_sec = _seq_count_header(ns)
        if ns > 0:
            tb = int(t["seq_total_bits"][j][b])
            sb = (tb + 1 + 7) // 8
            sbytes = bytearray(
                t["seq_halves"][j][b].astype(np.uint16).tobytes()[:sb])
            sbytes[tb >> 3] |= 1 << (tb & 7)
            if not tables_written:
                seq_sec += first_hdr
            else:
                seq_sec += bytes([(3 << 6) | (3 << 4) | (3 << 2)])
            seq_sec += bytes(sbytes)

        body = lit_sec + seq_sec
        if len(body) < len(blk):
            out.append(body)
            # the decoder's FSE tables only change when a compressed block
            # with sequences is emitted
            tables_written = tables_written or ns > 0
        else:
            out.append(None)
    return out


def tail_bodies(tail: bytes):
    """Host-matcher encode of the sub-job tail (rep-free offset values):
    (bodies, regenerated sizes) in blocks of ``encoder.BLOCK_SIZE``."""
    bodies, regens = [], []
    if not tail:
        return bodies, regens
    matcher = E.Matcher(tail, 1)
    pos = 0
    while pos < len(tail):
        end = min(pos + E.BLOCK_SIZE, len(tail))
        lls, mls, offs, _ = matcher.next_block(pos, end)
        body = None
        if len(lls):
            lit_sec = E.encode_literals(
                _extract_literals(tail[pos:end], lls, mls, len(lls)))
            body = lit_sec + E.encode_sequences_section(lls, mls, offs + 3)
        bodies.append(body if body is not None and len(body) < end - pos
                      else None)
        regens.append(end - pos)
        pos = end
    return bodies, regens


def emit_blocks(out: bytearray, data: bytes, bodies, regens):
    """Write block headers + bodies; None = raw, ("rle", b) = RLE block."""
    off = 0
    for i, (body, regen) in enumerate(zip(bodies, regens)):
        last = i == len(bodies) - 1
        if body is None:
            bh = (1 if last else 0) | (0 << 1) | (regen << 3)
            out += bh.to_bytes(3, "little")
            out += data[off : off + regen]
        elif isinstance(body, tuple):  # ("rle", byte)
            bh = (1 if last else 0) | (1 << 1) | (regen << 3)
            out += bh.to_bytes(3, "little")
            out += body[1]
        else:
            bh = (1 if last else 0) | (2 << 1) | (len(body) << 3)
            out += bh.to_bytes(3, "little")
            out += body
        off += regen
    return out


def launch_inputs(src: torch.Tensor, c: int, hi: int, job: int):
    """(jobs (hi-c, job), prefixes (hi-c, job // 8), has_prefix (hi-c,)) of
    jobs c..hi-1 of the uint8 tensor ``src``: each job's overlap history
    is the previous job's tail (zeros, not real, for job 0)."""
    pre = job // 8
    jobs = src[c * job : hi * job].view(hi - c, job)
    prefixes = torch.zeros((hi - c, pre), dtype=torch.uint8)
    has_prefix = torch.zeros(hi - c, dtype=torch.bool)
    for j in range(max(c, 1), hi):
        prefixes[j - c] = src[j * job - pre : j * job]
        has_prefix[j - c] = True
    return jobs, prefixes, has_prefix


def compress_device(data, *, checksum: bool = False, job: int | None = None,
                    block: int | None = None, encode_fn=None,
                    max_launch_jobs: int = 8, level: int = 2,
                    engine: str = "auto", device=None) -> bytes:
    """Encode ``data`` as one zstd frame: every whole ``job``-byte job
    with a device encoder, the tail with the host matcher; an input
    shorter than one job with the host encoder.

    engine: "v2" = the kernel pipeline (``ops/zenc2.py``: 64 KiB blocks
    only, 4 MiB default job, long-range channel; ``level`` is not read),
    "v1" = the XLA-graph pipeline (``ops/zdev.py``: 16 KiB default blocks,
    1 MiB default job, ``level`` 1-3), "auto" = v2 on CUDA, v1 elsewhere,
    as the reference picks v2 on an accelerator and v1 on a CPU.
    encode_fn: an explicit encoder (called as v1's ``zstd_encode_jobs``;
    job and block default to v1's).  Each job matches into an overlap
    prefix of the previous job's last job // 8 bytes; up to
    ``max_launch_jobs`` jobs go in one launch (v2's share its FSE tables,
    v1's have their own).  Runs on CUDA unless ``device`` names another
    device ("cpu" runs the plain PyTorch versions); raises when no card is
    present and no device was given."""
    dev = resolve_device(device)
    data = bytes(data)
    if engine == "auto":
        engine = "v2" if dev.type == "cuda" else "v1"
    if engine not in ("v1", "v2"):
        raise ValueError(f"engine must be 'auto', 'v1' or 'v2', not {engine!r}")
    if encode_fn is None and engine == "v2":
        job = job or DEFAULT_JOB
        if block not in (None, zenc2.BLOCK) or job <= 0 or job % zenc2.BLOCK:
            raise ValueError(f"job ({job}) must be a positive multiple of the "
                             f"{zenc2.BLOCK}-byte block (block={block})")
        block = zenc2.BLOCK

        def encode_fn(jobs, *, job, block, prefixes, has_prefix, level):
            return zenc2.zstd_encode_jobs_v2(jobs, job=job, prefixes=prefixes,
                                             has_prefix=has_prefix)
    else:
        encode_fn = encode_fn or zdev.zstd_encode_jobs
        job = job or zdev.JOB
        block = block or zdev.BLOCK
        if job <= 0 or block <= 0 or job % block:
            raise ValueError(f"job ({job}) must be a positive multiple of "
                             f"the block ({block})")
    n = len(data)
    if n < job:
        return E.compress(data, level=1, checksum=checksum)
    n_jobs = n // job
    out = bytearray(F.write_frame_header(n, job + job // 8, False, checksum))
    src = torch.frombuffer(bytearray(data[:n_jobs * job]), dtype=torch.uint8)
    bodies = []
    for c in range(0, n_jobs, max_launch_jobs):
        hi = min(c + max_launch_jobs, n_jobs)
        jobs, prefixes, has_prefix = launch_inputs(src, c, hi, job)
        t = encode_fn(jobs.to(dev), job=job, block=block,
                      prefixes=prefixes.to(dev),
                      has_prefix=has_prefix.to(dev), level=level)
        t = {k: v.cpu().numpy() for k, v in t.items()}
        for j in range(hi - c):
            jb = data[(c + j) * job : (c + j + 1) * job]
            bodies += _assemble_job(jb, t, j, block)
    tail_b, tail_r = tail_bodies(data[n_jobs * job:])
    emit_blocks(out, data, bodies + tail_b,
                [block] * len(bodies) + tail_r)
    if checksum:
        out += (xxh64(data) & 0xFFFFFFFF).to_bytes(4, "little")
    return bytes(out)
