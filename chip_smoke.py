#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device paths on one GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with one CUDA card and ``nvcc``.  It builds the kernels from
``compress_tpu_torch/csrc`` and then drives four paths.

Device S2 block encode, on a 16 MiB seeded corpus (256 blocks of 64 KiB
mixing every class of ``compress_tpu_torch.corpus``):

1. prints the device (name, count, ``nvidia-smi`` name and power limit);
2. builds the kernels and prints the seconds it took, each kernel's
   registers and spills (ptxas), and the CTAs per SM of the exec, zstd
   parse, emit, repeat-scan, FSE-chain, huff0 chunk, sequence and
   history-execute kernels (the runtime's occupancy query; huff0 at
   52-byte windows with one 8-bit table and with 11-bit tables of 512
   chunks, sequences at 96-byte and 80-byte windows);
3. makes the corpus;
4. holds the finder kernel (cap 10 and the slim cap 6) against its plain
   PyTorch version on the card: (off, L) must be bit-identical;
5. holds the emit kernel against its plain version on the same (off, L):
   b0, b1 and rowlens must be bit-identical;
6. runs the main path, ``encode_blocks_np``, with the launch counters set
   to 0 just before and read just after; every body must decode with the
   port's S2 decoder to its input block; prints the ratio;
7. times each kernel and its plain version with CUDA events (median after
   a warm-up) and the whole path on the host clock; holds the finder
   against its plain version on 256 all-zeros, 256 ``rand4`` and 256
   ``rand256`` blocks too, and times it there (its sort's dependence on
   the data); times the finder and emit by device time too (see
   ``cuda_ms``);
8. traces one call with ``torch.profiler``.

zstd v2 device encode, on 32 MiB: 8 jobs of 4 MiB (one launch of 512
blocks at the default geometry: 64 KiB blocks, 512 KiB overlap prefix,
long-range channel on), each 2 MiB of corpus blocks followed by a copy of
them that starts an odd number of bytes in (``corpus.replica_jobs``):

9.  holds the finder, parse, repeat-offset, FSE-chain and literal-lookup
    kernels against their plain versions on the path's own intermediate
    tensors (``zenc2._merged_matches`` feeds the parse, as in the
    encoder): bit-identical;
10. runs ``zstd.device.compress_device`` with the launch counters set to 0
    just before and read just after, prints the frame size and ratio,
    walks the frame (magic, header, every block header, the last-block
    bit, regenerated sizes summing to the input) and decodes it with the
    port's host zstd decoder (``zstd.decompress``, timed), which must
    give the input back;
11. times each kernel, its plain version and the plain-PyTorch stages
    (long-range channel, codes, literal, pack) with CUDA events, the whole
    call on the host clock, and traces one call; prints the literal
    lookup's achieved GB/s beside its bound's, and times the finder, the
    parse, the literal lookup, ``torch.gather`` and a fill of the lookup's
    two outputs alone (the card's write rate on them) by device time too,
    and the repeat scan and the FSE chain by device time beside the
    longest chain.

Device batch decode of what the port encodes:

12. S2: plans the phase-6 bodies on the host (timed; every block must be
    plannable) into the compact plan (``execute.pack_pieces``) and holds
    the LZ execute kernel against its plain version on it;
13. runs ``s2.decode_blocks_device`` with the launch counter set to 0
    just before and read just after (one launch per arena class, no
    host-decoded block, every block equal to its input), times the kernel
    (also by device time), its plain version and the whole call, traces
    one call, and prints the bytes the call copies to the card (the
    compact plan must stay under 0.1 GB) with the copy's device ms from
    the trace, and the kernel's bound on live pieces beside the bound of
    the earlier exec kernel, which read the padded plan;
14. huff0 4X, shared engine: 16 MiB of seeded text as 1024 rows of
    16 KiB, ``compress_4x_batch(shared_table=True, max_log=8)``; holds the
    chunk kernel against its plain version on the prepared windows, runs
    ``decompress_4x_batch`` with the launch counter (one launch, every row
    equal to its input) and times encode, prep, kernel (also by device
    time, and with no symbols to decode) and call;
15. huff0 4X, table engine (one table per container): the phase-3 corpus
    as 1024 rows of 16 KiB at ``max_log=11``, the same checks and times.

Batched zstd frame decode (``zstd.device_dec.decompress_frames_device``):

16. frames: 128 seeded ``text`` blocks of 64 KiB, 64 encoded by the port's
    host encoder (``zstd.encoder.compress``, level 1) with its own table
    choice and 64 under ``predef_seq_tables()``, and 3 frames of shapes
    that go to the host decoder (a ``rand256`` block: a raw block; a
    ``zeros`` block: RLE literals; 192 KiB of text: two blocks); times the
    encode; every frame must decode to its input with ``zstd.decompress``;
17. holds the sequence kernel against its plain version in both modes:
    one table set per frame, on the tensors ``seqdev.prep_sequences``
    builds from the 128 text frames; the shared predefined table set, on
    the predefined frames' chunks (``seq_accel(k=8)`` checkpoints, 80-byte
    windows); bit-identical, and the decoded (ll, ml, offset) equal the
    host sequence decode;
18. runs ``decompress_frames_device`` on the 131 frames with the launch
    counters set to 0 just before and read just after (one launch each of
    the huff0 chunk, sequence and execute kernels; 3 host-decoded frames;
    every frame equal to its input), times each kernel and its plain
    version on the path's own inputs with CUDA events (the huff0, both
    sequence modes and exec by device time too, exec on the compact
    plan, the per-item sequences also with no sequences to decode), the host stages and the whole call on the host clock, and
    traces one call, listing every device item (no stack or cast kernel
    beside the three decode kernels).

20. the accel route: the 128 text blocks of phase 16, each through the
    port's ``zstd.accel.compress_accel(level=1)`` (one frame of one block
    and its sidecar; encoded in a pool of worker processes, the seconds
    of the calls and of ``build_sidecar`` alone printed with the sidecar
    bytes as a share of the frame bytes); runs
    ``decompress_frames_device`` on the split items with the launch
    counters set to 0 just before and read just after: every route
    ``accel``, no call of the host walks (``_hwalk``, ``seq_accel``),
    launches {huff0 1, exec 1, sequences 0}, every item equal to its
    input; times the whole call on the host clock (median of 2), prints
    its stages and traces one call;
21. the multi-block accel route: ``corpus.history_streams`` (8 streams of
    1 MiB, 4 if their encode takes over ``ENCODE_CUT_S``), each through
    ``compress_accel(level=1, multi_block=True, hist_blocks=8)``: one
    frame of 16 blocks of 64 KiB with 512 KiB of history; runs
    ``decompress_frames_device`` with the counters: every route
    ``accel_mb``, no host walk, no host frame, one launch each of the
    huff0 kernel and the history execute (``execute_blocks_hist``), every
    stream equal to its input; holds the history kernel against its
    plain version on the path's own packed plan, times both (the kernel
    by device time too), prints the history pieces and bytes, the
    kernel's bound and the whole call's GB/s of output (median of 2),
    and traces one call.

Inputs that are not whole jobs, the FSE batch codec and the checksums:

22. ``zstd.device.compress_device`` on the phase-10 corpus followed by a
    tail of 300,001 bytes (the tail through the host matcher) and on
    200,003 bytes (less than one job: the host encoder), with the launch
    counters set to 0 just before each call and read just after: the
    first call's counts equal phase 10's, the second's are 0; both frames
    decode to their input with the port's host decoder; prints both calls'
    host-clock times;
23. the FSE batch codec on the phase-3 corpus as 1024 rows of 16 KiB:
    holds the encode chain (``csrc/fseenc.cu``) against its plain version
    on the path's own tables; runs ``fse.compress_batch`` with the launch
    counter (one launch; prints the None rows and the ratio); adds 4 host
    ``fse.compress(table_log=11)`` containers; times ``make_accel`` (the
    first 256 rows only if the whole walk would take over 90 s); holds the
    chunk decode (``csrc/fsedec.cu``) against its plain version on the
    prepared windows; runs ``fse.decompress_batch`` with the counters (one
    launch, exactly the 4 log-11 containers on the host, every row equal
    to its input); times both kernels (also by device time), their plain
    versions, ``fse_encode_blocks``, both whole calls, the 16 MiB
    histogram (``histogram256_torch``, plain PyTorch, beside
    ``torch.bincount``) and the per-row histograms, and traces one call
    of each;
24. CRC-32C and xxHash64 (``csrc/checksum.cu``) of the phase-3 corpus (256
    rows of 64 KiB): holds ``crc32c_batch`` (whole rows and 65536 - 4097
    bytes) and ``xxh64_batch`` (seeds 0 and 2^64 - 1) against their plain
    versions and 8 rows against the host ``crc32c`` / ``xxh64``; one call
    of each with the launch counters; times both kernels (also by device
    time) and their plain versions, with their bounds.

The two XLA-graph encoders (the reference's CPU engines, which the port
also runs on the card):

25. the S2 XLA engine (``ops/lz2.s2_encode_blocks``) on the phase-3
    corpus at tile 512, levels 1 and 2, and at tile 256 (the parallel
    engine's tile), level 1: every body decodes with the port's S2 decoder
    to its block; holds the tile parse kernel (``csrc/tileparse.cu``)
    against its plain version on each call's own L_t; runs the entry,
    ``encode_blocks_np`` with ``COMPRESS_TPU_S2_ENGINE=xla``, with the
    launch counter set to 0 just before and read just after (one launch),
    whose bodies must equal the level-1 call's, and without the variable,
    whose bodies must equal phase 6's; prints the ratio beside the kernel
    path's; times the kernel (also by device time), its plain version and
    the whole call (host clock, median of 3), and traces one call;
26. the zstd v1 engine (``ops/zdev.zstd_encode_jobs``) through
    ``compress_device(engine="v1")`` on ``corpus.replica_jobs(8, 1 MiB)``
    (one launch of 8 jobs, 512 blocks of 16 KiB) at levels 1, 2 and 3,
    with the launch counters set to 0 just before each call and read just
    after (one launch each of the tile parse, the repeat scan and the FSE
    scan, ``csrc/zdevfse.cu``); every frame decodes with the port's host
    decoder to its input and the sizes are monotone (level 3 <= 2 <= 1);
    holds the three kernels against their plain versions on the level-2
    call's own inputs; times them (also by device time), their plain
    versions and the whole call (host clock, median of 2) with their
    bounds and the longest chain, and traces one call.

The routes no path sends, which take the inputs the reference takes
(run after every main path):

19. holds the zstd parse and the S2 emit at a cap other than the
    finder's (the run-time cap instantiation) on the hostile parse inputs
    (with chains at that cap) and two corpus blocks, and ``execute_rounds``
    on the padded plans only the reference's sum gets right (its sum
    kernel), against their plain versions; times them; their launches on
    the main paths above must be 0.

Then it prints one ``{"kernels": [...]}`` line with all the kernels (the
huff0 kernel once per engine, the sequence kernel once per mode, the
routes of phase 19 once each; the tile parse's row and the repeat scan's
also carry their phase-26 numbers as ``v1_*``).
Every comparison is exact (tolerance 0: all outputs are integers or
bytes).  Any failure raises and the exit code is not 0.  The last line
of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import json
import multiprocessing
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

N_BLOCKS = 256      # 16 MiB: one launch of MAX_LAUNCH_BLOCKS
TEXT_FRAMES = 128   # 64 KiB text frames for the zstd frame decode
ENCODE_CUT_S = 90   # half the frames encoded slower than this: keep half
HIST_STREAMS = 8    # 1 MiB streams of the multi-block accel route
HIST_BLOCKS = 8     # their history: compress_accel's default
SEED = 0
ZSTD_JOB = 4 << 20  # the v2 encoder's default job
ZSTD_JOBS = 8       # one launch of the default max_launch_jobs
TAIL_BYTES = 300_001   # phase 22: past the phase-10 jobs (3 host blocks)
SHORT_BYTES = 200_003  # phase 22: below one job (the host encoder)
FSE_HOST_LOG11 = 4     # phase 23: host containers of log 11 in the decode
FSE_ACCEL_CUT = 256    # phase 23: rows kept if make_accel would be slow
ACCEL_CUT_S = 90       # phase 23: make_accel's estimated seconds allowed
HBM_BYTES_PER_S = 3.35e12  # H100 SXM published memory rate
# CUDA-core rate (non-tensor) from the published H100 table; the integer
# work of these kernels is counted against it for the operations bound
CORE_OPS_PER_S = 67e12
SPIN_CYCLES = 2_000_000  # device spin before a call timed by device time
# batches of one block class that show the finder's dependence on the
# data: one digit everywhere, four digits, and random bytes (its slowest)
UNIFORM_CLASSES = ("zeros", "rand4", "rand256")


def _say(*parts) -> None:
    print(*parts, flush=True)


def cuda_ms(fn, reps: int, spin: bool = False) -> float:
    """Median milliseconds of fn() between CUDA events, after a warm-up.
    On an idle card the start event runs at once, so the time also holds
    the host work of fn() before its launch (a wrapper's Python checks,
    allocations and ctypes call).  With ``spin`` each timed call is queued
    behind a device spin of about a millisecond (``torch.cuda._sleep``),
    so the events time the device alone: device time."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        if spin:
            torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def host_ms(fn, reps: int) -> float:
    """Median milliseconds of fn() on the host clock, synchronised."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def trace_path(fn, warm: bool = True):
    """(device busy ms, wall ms, [(name, device ms)] largest first) of one
    call of fn under torch.profiler, after a warm-up call unless warm is
    False.  Copies to the card are named ``Memcpy HtoD ...``."""
    from torch.profiler import ProfilerActivity, profile

    if warm:
        fn()
        torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = (time.perf_counter() - t0) * 1e3
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.device_time_total / 1e3)
    ranked = sorted(by_name.items(), key=lambda kv: -kv[1])
    return sum(by_name.values()), wall, ranked


def bound(n_bytes: int, n_ops: int) -> tuple[float, str]:
    """(least milliseconds the card could take, what bounds it)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / CORE_OPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def max_abs_err(got, want) -> int:
    """Largest |kernel - plain| over a tuple of integer tensors."""
    return max(int((a.to(torch.int64) - b.to(torch.int64)).abs().max())
               for a, b in zip(got, want))


def _lit_section_len(body: bytes, block: int) -> int:
    """Bytes of a compressed block's literal section (RFC 8878 §3.1.1.3.1),
    checking that its regenerated size fits the block."""
    from compress_tpu_torch.zstd import block as B

    typ, fmt = body[0] & 3, (body[0] >> 2) & 3
    if typ < 2:                                          # raw or RLE
        regen, hdr = B.raw_lit_size(body, 0, fmt)
        size = hdr + (regen if typ == 0 else 1)
    else:                                                # Huffman
        regen, comp, hdr = B.huff_lit_sizes(body, 0, fmt)
        size = hdr + comp
    if regen > block or size >= len(body):
        raise AssertionError(f"literal section ({regen} bytes, {size} "
                             f"encoded) does not fit its block")
    return size


def walk_frame(fr: bytes, n: int, job: int, block: int) -> dict:
    """Walk a zstd frame's structure: magic, frame header (no checksum,
    content size n, window >= job + job / 8), then every block header up
    to the one with the last-block bit, which must end the frame.  Raw and
    RLE blocks carry their regenerated size; a compressed block's literal
    section must fit inside it and it regenerates one encoder block.
    Returns the count of each block type and the regenerated total."""
    if int.from_bytes(fr[:4], "little") != 0xFD2FB528:
        raise AssertionError("bad magic")
    fhd = fr[4]
    if fhd & 0x3F:
        raise AssertionError(f"unexpected frame header descriptor {fhd:#x}")
    wd = fr[5]
    window = (1 << ((wd >> 3) + 10)) * (8 + (wd & 7)) // 8
    if window < job + job // 8:
        raise AssertionError(f"window {window} below the job span")
    fcs_len = {0: 0, 1: 2, 2: 4, 3: 8}[fhd >> 6]
    fcs = int.from_bytes(fr[6:6 + fcs_len], "little") + (256 if fcs_len == 2
                                                         else 0)
    if fcs != n:
        raise AssertionError(f"content size {fcs} != {n}")
    pos = 6 + fcs_len
    counts = {"raw": 0, "rle": 0, "compressed": 0}
    total = 0
    while True:
        if pos + 3 > len(fr):
            raise AssertionError("frame ends inside a block header")
        bh = int.from_bytes(fr[pos:pos + 3], "little")
        last, typ, size = bh & 1, (bh >> 1) & 3, bh >> 3
        pos += 3
        if typ == 3 or size > 1 << 17:
            raise AssertionError(f"bad block header {bh:#x}")
        if typ == 0:
            counts["raw"] += 1
            total += size
            pos += size
        elif typ == 1:
            counts["rle"] += 1
            total += size
            pos += 1
        else:
            counts["compressed"] += 1
            _lit_section_len(fr[pos:pos + size], block)
            total += block
            pos += size
        if pos > len(fr):
            raise AssertionError("block runs past the frame")
        if last:
            break
    if pos != len(fr) or total != n:
        raise AssertionError(f"frame walk ends at {pos} of {len(fr)} bytes, "
                             f"regenerated {total} of {n}")
    return {**counts, "regenerated": total}


def _hold(name, got, want) -> int:
    """Require a kernel's outputs to equal its plain version's; return the
    max_abs_err (0)."""
    torch.cuda.synchronize()
    err = max_abs_err(got, want)
    same = all(torch.equal(a, b) for a, b in zip(got, want))
    _say(f"{name} vs plain: bit-identical={same} max_abs_err={err}")
    if not same:
        raise AssertionError(f"{name} kernel differs from its plain version")
    return err


def _say_trace(what: str, fn, warm: bool = True, every_name: bool = False):
    """Print one traced call's device busy time, idle share and largest
    items (every item with ``every_name``); return the device ms of its
    copies to the card (None when the profiler recorded no device
    time)."""
    busy, wall, by_name = trace_path(fn, warm)
    if busy > 0:
        h2d = sum(v for k, v in by_name if "HtoD" in k)
        _say(f"{what} trace: device busy {busy:.4f} ms of {wall:.4f} ms wall, "
             f"idle share {1 - busy / wall:.4f}; copies to the card "
             f"{h2d:.4f} ms; by name (ms): " + ", ".join(
                 f"{k[:60]} {v:.4f}"
                 for k, v in (by_name if every_name else by_name[:8])))
        return h2d
    _say(f"{what} trace: the profiler recorded no device time "
         "(not measured)")
    return None


def _exec_bounds(lit_rows, pieces, rstart, n_out: int):
    """The exec kernel's bound, and beside it the bound of the earlier
    kernel, which read the padded plan.

    The work, counted on the compact plan the kernel reads: each live
    piece (8 bytes) and the round offsets read once, the literal bytes
    that the pieces copy read once (each block's distinct source bytes in
    its literal rows; the planner's sources all lie inside the arena), the
    output rows written once, 8 integer operations per output byte.  The
    padded bound counts the reference's layout instead: every literal row
    read, the length of every slot of every block (the round caps
    ``pack_plans`` gives these plans), src and dst of the live slots."""
    from compress_tpu_torch.ops import execute as X

    B, half = lit_rows.shape[0], lit_rows.shape[1] * 128
    w = pieces.astype(np.int64)
    blk = np.repeat(np.arange(B), rstart[:, -1] - rstart[:, 0])
    s, d = w[:, 0], w[:, 1] & 0xFFFFFF
    n = np.minimum((w[:, 1] >> 24) + 1, 128 - (d & 127))
    if len(blk) != len(w) or (s < 0).any() or (s + n > 2 * half).any():
        raise AssertionError("exec bound: a plan that is not block-major or "
                             "reads outside its arena")
    # distinct literal bytes read: cover each source span's part below the
    # output half and count the covered bytes
    lo = blk * half + np.minimum(s, half)
    hi = blk * half + np.minimum(s + n, half)
    edge = (np.bincount(lo, minlength=B * half + 1)
            - np.bincount(hi, minlength=B * half + 1))
    lit_read = int(np.count_nonzero(np.cumsum(edge[:-1])))
    rows_b = lit_rows.size
    counts = np.diff(rstart.astype(np.int64), axis=1)
    slots = sum(X.default_round_caps(counts.max(axis=0))) if counts.size \
        else 0
    return (bound(lit_read + rows_b + pieces.nbytes + rstart.nbytes,
                  8 * n_out),
            bound(2 * rows_b + 4 * slots * B + 8 * len(w), 8 * n_out),
            slots, lit_read)


def zstd_path(dev) -> list:
    """Phases 9-11: the zstd v2 path.  Returns its kernels' JSON entries
    and the finder's numbers on this path (launches, times, error)."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch import zstd as Z
    from compress_tpu_torch.ops import lzkern, zenc2, zparse, zseqenc
    from compress_tpu_torch.zstd import device as zdevice

    job, blk = ZSTD_JOB, zenc2.BLOCK
    pre = job // 8
    t0 = time.perf_counter()
    data_np = corpus.replica_jobs(ZSTD_JOBS, job, SEED)
    data = data_np.tobytes()
    n = len(data)
    _say(f"zstd corpus: {ZSTD_JOBS} jobs x {job} bytes = {n} bytes, each "
         f"{job // 2} bytes of corpus blocks + an odd-shifted copy (seed {SEED}, "
         f"{time.perf_counter() - t0:.1f} s)")

    # ---- 9. the path's intermediate tensors; kernels vs plain versions ---
    src = torch.from_numpy(data_np)
    jobs, prefixes, has_prefix = zdevice.launch_inputs(src, 0, ZSTD_JOBS, job)
    jobs, prefixes = jobs.to(dev), prefixes.to(dev)
    has_prefix = has_prefix.to(dev)
    blocks, off, L, use = zenc2._merged_matches(jobs, prefixes, has_prefix)
    R = blocks.shape[0]

    errs = {}

    def hold(name, got, want):
        errs[name] = _hold(name, got, want)

    hold("find_matches", lzkern.find_matches_blocks(blocks),
         lzkern.find_matches_blocks_ref(blocks))
    parsed = zparse.parse_blocks(blocks, off, L)
    hold("parse_blocks", parsed, zparse.parse_blocks_ref(blocks, off, L))
    ll, ml, of, lits, n_seqs, lit_cnt = parsed
    rep = zseqenc.rep_scan(of, ll, n_seqs)
    hold("rep_scan", [rep], [zseqenc.rep_scan_ref(of, ll, n_seqs)])
    (pk_ll, pk_of, pk_ml, tables, extras, _, rle3,
     _) = zenc2._codes_stage(ll, ml, rep, n_seqs)
    chain_in = (pk_ll, pk_of, pk_ml, n_seqs, tables)
    chain = zseqenc.fse_chain(*chain_in)
    chain_want = zseqenc.fse_chain_ref(*chain_in)
    hold("fse_chain", chain, chain_want)
    hold("fse_chain (clamped walk)",
         zseqenc.fse_chain(*chain_in, clamped_only=True), chain_want)
    packed = zenc2._literal_tables(lits, lit_cnt, blk)[4]
    hold("litlut", zenc2._litlut(lits, packed),
         zenc2._litlut_ref(lits, packed))
    ns = n_seqs.to(torch.int64)
    sum_seqs, max_seqs = int(ns.sum()), int(ns.max())
    _say(f"zstd intermediates: {R} blocks, sequences {sum_seqs} (longest "
         f"chain {max_seqs}), literals {int(lit_cnt.sum())}; the long-range "
         f"channel won over the finder at {int(use.sum())} positions")

    # ---- 10. main path ------------------------------------------------------
    counted = {"find": lzkern.find_matches_blocks,
               "parse": zparse.parse_blocks, "rep": zseqenc.rep_scan,
               "fse": zseqenc.fse_chain, "litlut": zenc2._litlut}
    for f in counted.values():
        f.launches = 0
    t0 = time.perf_counter()
    frame = zdevice.compress_device(data, job=job)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counted.items()}
    _say(f"zstd main path launches: {launches} (first call {first_s:.2f} s)")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the zstd path did not run: "
                             f"{launches}")
    walk = walk_frame(frame, n, job, blk)
    _say(f"zstd frame: {len(frame)} bytes, ratio {len(frame) / n:.6f}; "
         f"walk {walk}")
    t0 = time.perf_counter()
    back = Z.decompress(frame)
    dec_s = time.perf_counter() - t0
    if back != data:
        raise AssertionError("the v2 frame does not decode to its input "
                             "with the port's host decoder")
    _say(f"zstd frame decoded by the port's host decoder (zstd.decompress):"
         f" equal to its {n}-byte input, {dec_s:.2f} s")

    # ---- 11. times ----------------------------------------------------------
    t = {
        "find": cuda_ms(lambda: lzkern.find_matches_blocks(blocks), 10),
        "parse": cuda_ms(lambda: zparse.parse_blocks(blocks, off, L), 10),
        "rep": cuda_ms(lambda: zseqenc.rep_scan(of, ll, n_seqs), 10),
        "fse": cuda_ms(lambda: zseqenc.fse_chain(*chain_in), 10),
        "litlut": cuda_ms(lambda: zenc2._litlut(lits, packed), 20),
    }
    plain = {
        "find": cuda_ms(lambda: lzkern.find_matches_blocks_ref(blocks), 2),
        "parse": cuda_ms(lambda: zparse.parse_blocks_ref(blocks, off, L), 2),
        "rep": cuda_ms(lambda: zseqenc.rep_scan_ref(of, ll, n_seqs), 1),
        "fse": cuda_ms(lambda: zseqenc.fse_chain_ref(*chain_in), 1),
        "litlut": cuda_ms(lambda: zenc2._litlut_ref(lits, packed), 20),
    }
    idx = lits.to(torch.int64)
    tab256 = packed.view(R, 256)
    lib_litlut = cuda_ms(lambda: torch.gather(tab256, 1, idx), 20)
    full = torch.cat([prefixes, jobs], dim=1)
    stages = {
        "ldm": cuda_ms(lambda: zenc2._ldm_channel(full, has_prefix, pre,
                                                  job), 3),
        "codes": cuda_ms(lambda: zenc2._codes_stage(ll, ml, rep, n_seqs), 3),
        "literal": cuda_ms(lambda: zenc2._literal_stage(lits, lit_cnt, blk),
                           3),
        "pack": cuda_ms(lambda: zenc2._pack_stage(*chain, extras, rle3,
                                                  n_seqs), 3),
        "encode_jobs": cuda_ms(lambda: zenc2.zstd_encode_jobs_v2(
            jobs, job=job, prefixes=prefixes, has_prefix=has_prefix), 3),
    }
    # device time (no host work) of the finder, the lookup and torch.gather,
    # and of a fill of the lookup's two outputs (the card's write rate)
    fill = torch.empty((2, R, blk), dtype=torch.int32, device=dev)
    dev_t = {
        "find": cuda_ms(lambda: lzkern.find_matches_blocks(blocks), 10, True),
        "parse": cuda_ms(lambda: zparse.parse_blocks(blocks, off, L), 10,
                         True),
        "litlut": cuda_ms(lambda: zenc2._litlut(lits, packed), 20, True),
        "rep": cuda_ms(lambda: zseqenc.rep_scan(of, ll, n_seqs), 10, True),
        "fse": cuda_ms(lambda: zseqenc.fse_chain(*chain_in), 10, True),
        "fse_clamped": cuda_ms(lambda: zseqenc.fse_chain(
            *chain_in, clamped_only=True), 10, True),
        "gather": cuda_ms(lambda: torch.gather(tab256, 1, idx), 20, True),
        "fill": cuda_ms(lambda: fill.fill_(7), 20, True),
    }
    del fill
    t_call = host_ms(lambda: zdevice.compress_device(data, job=job), 3)
    _say(f"zstd kernel times (ms, {R} blocks): " + ", ".join(
        f"{k} {v:.4f} (plain {plain[k]:.4f})" for k, v in t.items())
        + f"; torch.gather for litlut {lib_litlut:.4f}")
    _say("zstd stage times (ms, CUDA events): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()))
    _say(f"zstd whole call (host clock, ms): {t_call:.4f} "
         f"({n / (t_call * 1e-3) / 1e9:.4f} GB/s)")
    _say_trace("zstd", lambda: zdevice.compress_device(data, job=job))

    # bounds: each input read once, each output written once.  The chains
    # read only each block's own n_seqs entries; the operations are
    # generous per-position (64, parse) and per-sequence (24 repeat, 60
    # FSE) integer counts.  The chains are serial: their rows also give the
    # longest chain, which bounds them harder than either count.
    blk_b, seq_b = R * blk, R * zparse.MAXSEQ * 4
    b_find = bound(blk_b + 8 * blk_b, blk_b * 16)       # as in phase 7
    b_parse = bound(blk_b + 8 * blk_b + 3 * seq_b + blk_b + 8 * R, blk_b * 64)
    b_rep = bound(8 * sum_seqs + 4 * R + seq_b, 24 * sum_seqs)
    b_fse = bound(12 * sum_seqs + 3 * 128 * 4 + 4 * R + 2 * seq_b + 12 * R,
                  60 * sum_seqs)
    lut_bytes = blk_b + R * 1024 + 8 * blk_b
    b_lut = bound(lut_bytes, 4 * blk_b)
    lut_gbps = lut_bytes / (t["litlut"] * 1e-3) / 1e9
    lut_dev_gbps = lut_bytes / (dev_t["litlut"] * 1e-3) / 1e9
    _say(f"litlut: {lut_bytes} bytes moved in {t['litlut']:.4f} ms = "
         f"{lut_gbps:.1f} GB/s ({dev_t['litlut']:.4f} ms = "
         f"{lut_dev_gbps:.1f} GB/s device time) against "
         f"{HBM_BYTES_PER_S / 1e9:.0f} GB/s (bound {b_lut[0]:.4f} ms)")
    _say(f"timers (ms, events from an idle card / device time): litlut "
         f"{t['litlut']:.4f} / {dev_t['litlut']:.4f}, torch.gather "
         f"{lib_litlut:.4f} / {dev_t['gather']:.4f}, finder ({R} blocks) "
         f"{t['find']:.4f} / {dev_t['find']:.4f}, parse {t['parse']:.4f} / "
         f"{dev_t['parse']:.4f}, repeat scan {t['rep']:.4f} / "
         f"{dev_t['rep']:.4f}, FSE chain {t['fse']:.4f} / {dev_t['fse']:.4f} "
         f"(longest chain {max_seqs}; device time with the clamped re-walk "
         f"everywhere {dev_t['fse_clamped']:.4f}); a fill of the lookup's "
         f"two outputs alone {dev_t['fill']:.4f} device time")
    rows = [
        ("parse_blocks", "parse", "compress_tpu_torch/csrc/zparse.cu",
         "compress_tpu/ops/zparse.py:90", b_parse, None),
        ("rep_scan", "rep", "compress_tpu_torch/csrc/zseqenc.cu",
         "compress_tpu/ops/zseqenc.py:41", b_rep, None),
        ("fse_chain", "fse", "compress_tpu_torch/csrc/zseqenc.cu",
         "compress_tpu/ops/zseqenc.py:115", b_fse, None),
        ("litlut", "litlut", "compress_tpu_torch/csrc/litlut.cu",
         "compress_tpu/ops/zenc2.py:207", b_lut, lib_litlut),
    ]
    out = []
    for name, key, source, replaces, bnd, lib in rows:
        entry = {"name": name, "route": "cuda", "source": source,
                 "replaces": replaces, "launches": launches[key],
                 "max_abs_err": errs[name], "equal_to_plain": True,
                 "ms": t[key], "plain_ms": plain[key], "bound_ms": bnd[0],
                 "bound_by": bnd[1], "library_ms": lib}
        if key in ("rep", "fse"):
            entry["longest_chain"] = max_seqs
        if key in ("parse", "rep", "fse"):
            entry["device_ms"] = dev_t[key]
        if key == "fse":
            entry["clamped_walk_device_ms"] = dev_t["fse_clamped"]
        if key == "litlut":
            entry.update({"gbps": lut_gbps, "device_ms": dev_t["litlut"],
                          "library_device_ms": dev_t["gather"],
                          "output_fill_device_ms": dev_t["fill"]})
        out.append(entry)
    # the finder's row (phase 7, 256 blocks) gains this path's numbers
    find = {"zstd_launches": launches["find"], "zstd_ms": t["find"],
            "zstd_plain_ms": plain["find"], "zstd_bound_ms": b_find[0],
            "zstd_max_abs_err": errs["find_matches"],
            "zstd_device_ms": dev_t["find"]}
    return out, find, launches


def s2_decode_path(dev, data: bytes, bodies) -> dict:
    """Phases 12-13: device decode of the phase-6 S2 bodies.  Returns the
    exec kernel's JSON entry."""
    from compress_tpu_torch.ops import execute as X
    from compress_tpu_torch.ops import lz2
    from compress_tpu_torch.s2 import device_dec
    from compress_tpu_torch.utils.varint import put_uvarint

    hdr = bytearray()
    put_uvarint(hdr, lz2.B)
    blocks = [bytes(hdr) + b for b in bodies]
    want = [data[i * lz2.B:(i + 1) * lz2.B] for i in range(len(bodies))]

    # ---- 12. host plan; the exec kernel vs its plain version ---------------
    t0 = time.perf_counter()
    results, classes = device_dec.plan_blocks(blocks)
    plan_ms = (time.perf_counter() - t0) * 1e3
    n_host = sum(r is not None for r in results)
    _say(f"S2 decode plan (host): {len(blocks)} blocks in {plan_ms:.1f} ms; "
         f"{n_host} blocks refused by the planner")
    if n_host:
        raise AssertionError(f"{n_host} of the port's own blocks would take "
                             "the host route")
    args = {}
    err = 0
    for c in classes:
        a = [torch.from_numpy(c[k]).to(dev)
             for k in ("lit_rows", "pieces", "rstart")]
        args[c["M"]] = a
        err = max(err, _hold(f"exec (M={c['M']})", X.execute_pieces(*a),
                             X.execute_pieces_ref(*a)))

    # ---- 13. main path, times, trace ---------------------------------------
    X.execute_pieces.launches = 0
    stats = {}
    t0 = time.perf_counter()
    got = device_dec.decode_blocks_device(blocks, stats=stats)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = X.execute_pieces.launches
    _say(f"S2 decode main path: exec launches {launches}, blocks on the "
         f"device {stats['device']}, on the host {stats['host']}; classes "
         f"{stats['classes']} (first call {first_s:.2f} s)")
    if launches != len(classes) or launches < 1 or stats["host"]:
        raise AssertionError(f"S2 decode: {launches} exec launches for "
                             f"{len(classes)} arena classes, {stats['host']} "
                             "host-decoded blocks")
    bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
    if bad:
        raise AssertionError(f"S2 decode: blocks {bad[:8]} differ from their "
                             "input")
    _say(f"S2 decode: all {len(blocks)} blocks equal their input")

    a = args[classes[0]["M"]]
    t_kern = cuda_ms(lambda: X.execute_pieces(*a), 10)
    t_dev = cuda_ms(lambda: X.execute_pieces(*a), 10, True)
    t_plain = cuda_ms(lambda: X.execute_pieces_ref(*a), 2)
    t_call = host_ms(lambda: device_dec.decode_blocks_device(blocks), 2)
    _say(f"S2 decode times (ms): exec kernel {t_kern:.4f} ({t_dev:.4f} device "
         f"time; plain {t_plain:.4f}, CUDA events); whole call {t_call:.4f} "
         f"on the host clock ({len(data) / (t_call * 1e-3) / 1e9:.4f} GB/s), "
         f"of which the host plan {plan_ms:.4f}")
    h2d_ms = _say_trace("S2 decode",
                        lambda: device_dec.decode_blocks_device(blocks))
    plan_b = sum(v["plan_bytes"] for v in stats["classes"].values())
    lit_b = sum(c["lit_rows"].nbytes for c in classes)
    _say(f"S2 decode copies to the card: compact plan {plan_b} bytes "
         f"({plan_b / 1e9:.4f} GB) + literal rows {lit_b} bytes = "
         f"{(plan_b + lit_b) / 1e9:.4f} GB, "
         + (f"{h2d_ms:.4f} ms in the trace" if h2d_ms is not None
            else "ms not measured"))
    if plan_b >= 1e8:
        raise AssertionError(f"S2 decode plan of {plan_b} bytes")

    c0 = classes[0]
    n_live = len(c0["pieces"])
    bnd, bnd_pad, slots, lit_read = _exec_bounds(
        c0["lit_rows"], c0["pieces"], c0["rstart"], len(data))
    _say(f"exec bound: {n_live} live pieces of 8 bytes, {lit_read} literal "
         f"bytes read, {c0['lit_rows'].size} output bytes written -> "
         f"{bnd[0]:.4f} ms ({bnd[1]}); the earlier kernel's padded-plan "
         f"bound ({slots} slots a block) {bnd_pad[0]:.4f} ms")
    return {"name": "execute_pieces", "route": "cuda",
            "source": "compress_tpu_torch/csrc/exec.cu",
            "replaces": "compress_tpu/ops/exec_pallas.py:39",
            "launches": launches, "max_abs_err": err, "equal_to_plain": True,
            "ms": t_kern, "plain_ms": t_plain, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None, "device_ms": t_dev,
            "padded_bound_ms": bnd_pad[0], "pieces": n_live,
            "plan_bytes": plan_b, "h2d_ms": h2d_ms, "plan_ms": plan_ms,
            "call_ms": t_call}


def huff0_path(dev, blocks_np) -> list:
    """Phases 14-15: huff0 4X batch encode and device decode, the shared
    engine on 16 MiB of text and the per-container engine on the phase-3
    corpus, each as 1024 rows of 16 KiB.  Returns the huff0 kernel's JSON
    entries, one per engine."""
    from compress_tpu_torch import corpus, huff0
    from compress_tpu_torch.huff0 import batch as hb
    from compress_tpu_torch.ops import entropy_dec as ED
    from compress_tpu_torch.ops import entropy_kern as EK

    row = 16 << 10
    rng = np.random.default_rng(SEED)
    text = np.concatenate([corpus.make_block("text", rng)
                           for _ in range(N_BLOCKS)]).reshape(-1, row)
    engines = {"shared": (text, True, 8), "table": (
        blocks_np.reshape(-1, row), False, 11)}
    out = []
    for engine, (rows, shared, max_log) in engines.items():
        n_in = rows.size
        t0 = time.perf_counter()
        conts, accel = huff0.compress_4x_batch(
            rows, return_accel=True, shared_table=shared, max_log=max_log)
        torch.cuda.synchronize()
        t_enc = (time.perf_counter() - t0) * 1e3
        kept = [i for i, c in enumerate(conts) if c is not None]
        ratio = sum(len(conts[i]) for i in kept) / (len(kept) * row)
        _say(f"huff0 {engine}: {len(rows)} rows of {row} bytes ({n_in} "
             f"bytes, max_log {max_log}); {len(rows) - len(kept)} rows None; "
             f"ratio of the others {ratio:.6f}; encode {t_enc:.1f} ms "
             "(host clock, first call)")
        t0 = time.perf_counter()
        cpu_args, metas, _ = hb._prep_decode_batch(conts, accel)
        t_prep = (time.perf_counter() - t0) * 1e3
        windows, lbit, nsym, tables = (x.to(dev) for x in cpu_args)
        N, C, W = windows.shape
        none = torch.zeros_like(nsym)
        if shared:
            packed, mb = hb.shared_packed_table(metas)
            table = torch.from_numpy(packed).to(dev)
            kargs = (windows.reshape(N * C, W), lbit.reshape(-1),
                     nsym.reshape(-1), table)

            def kern(kargs=kargs, mb=mb):
                return EK.huff0_decode_chunks_shared(*kargs, max_bits=mb)

            def empty(kargs=kargs, mb=mb):
                return EK.huff0_decode_chunks_shared(
                    kargs[0], kargs[1], none.reshape(-1), kargs[3],
                    max_bits=mb)

            def plain(kargs=kargs, mb=mb):
                return EK.huff0_decode_chunks_shared_ref(*kargs, max_bits=mb)
            counter = EK.huff0_decode_chunks_shared
        else:
            mb = 11

            def kern():
                return ED.huff0_decode_chunks(windows, lbit, nsym, tables)

            def empty():
                return ED.huff0_decode_chunks(windows, lbit, none, tables)

            def plain():
                return ED.huff0_decode_chunks_ref(windows, lbit, nsym, tables)
            counter = ED.huff0_decode_chunks
        err = _hold(f"huff0 {engine} (peek {mb} bits)", kern(), plain())

        counter.launches = 0
        t0 = time.perf_counter()
        got = huff0.decompress_4x_batch(conts, accel=accel, engine=engine)
        torch.cuda.synchronize()
        first_ms = (time.perf_counter() - t0) * 1e3
        launches = counter.launches
        if launches != 1:
            raise AssertionError(f"huff0 {engine}: {launches} kernel launches")
        bad = [i for i in kept if got[i] != rows[i].tobytes()]
        if bad or any(got[i] is not None for i in range(len(rows))
                      if conts[i] is None):
            raise AssertionError(f"huff0 {engine}: rows {bad[:8]} differ from "
                                 "their input")
        t_kern = cuda_ms(kern, 20)
        t_dev = cuda_ms(kern, 20, True)
        # the same launch with no symbol to decode: the tiles' copies,
        # table staging and stores alone
        t_empty = cuda_ms(empty, 20, True)
        t_plain = cuda_ms(plain, 3)
        t_call = host_ms(lambda: huff0.decompress_4x_batch(
            conts, accel=accel, engine=engine), 2)
        nc = N * C
        live = int(nsym.sum())
        bnd = bound(nc * (W + 12) + int(table.numel() if shared
                                        else tables.numel()) * 4 + nc * 32,
                    8 * live)
        _say(f"huff0 {engine} decode: launches {launches}; all {len(kept)} "
             f"containers equal their input; {nc} chunks ({live} symbols); "
             f"kernel {t_kern:.4f} ms ({t_dev:.4f} device time, {t_empty:.4f}"
             f" with no symbols; plain {t_plain:.4f}, CUDA events), "
             f"bound {bnd[0]:.4f} ({bnd[1]}); host prep {t_prep:.1f} ms; "
             f"whole call {t_call:.4f} ms on the host clock "
             f"({len(kept) * row / (t_call * 1e-3) / 1e9:.4f} GB/s; first "
             f"{first_ms:.1f})")
        out.append({
            "name": ("huff0_decode_chunks_shared" if shared
                     else "huff0_decode_chunks"), "engine": engine,
            "route": "cuda", "source": "compress_tpu_torch/csrc/huff0dec.cu",
            "replaces": "compress_tpu/ops/entropy_pallas.py:36",
            "launches": launches, "max_abs_err": err, "equal_to_plain": True,
            "ms": t_kern, "plain_ms": t_plain, "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None, "device_ms": t_dev,
            "no_symbols_device_ms": t_empty, "peek_bits": mb,
            "chunks": nc, "encode_ms": t_enc, "prep_ms": t_prep,
            "call_ms": t_call, "none_rows": len(rows) - len(kept),
            "ratio": ratio})
    return out


def _host_seqs(item):
    """(ll, ml, resolved offset) of one sequence item, decoded on the
    host."""
    from compress_tpu_torch.zstd import seqs as S
    from compress_tpu_torch.zstd.device_dec import _resolve_reps

    lls, mls, ofv = S.decode_sequences(*item)
    return lls, mls, _resolve_reps(lls, mls, ofv)


def _zseq_bound(nc: int, win: int, tables: int, live: int, n_out: int):
    """Each chunk reads its window and 9 int32 of checkpoint (cursor, 3
    states, 3 repeat offsets, count, reload limit), the table sets are
    read once, each chunk writes n_out x 8 int32 (the function's outputs:
    4 per item, 3 shared) and its end cursor; a generous 100 integer
    operations a decoded sequence."""
    return bound(nc * (win + 36) + 4 * tables + nc * (n_out * 8 * 4 + 4),
                 100 * live)


def zstd_decode_path(dev):
    """Phases 16-18: the batched zstd frame decode.  Returns the sequence
    kernel's JSON entries (per-item and shared table) and this path's
    numbers for the huff0 and exec rows."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch import zstd as Z
    from compress_tpu_torch.ops import entropy_dec as ED
    from compress_tpu_torch.ops import execute as X
    from compress_tpu_torch.ops import zseq_kern as ZK
    from compress_tpu_torch.zstd import device_dec as DD
    from compress_tpu_torch.zstd import encoder as E
    from compress_tpu_torch.zstd import seqdev
    from compress_tpu_torch.zstd import seqs as S

    # ---- 16. frames --------------------------------------------------------
    rng = np.random.default_rng([SEED, 16])
    texts = [corpus.make_block("text", rng).tobytes()
             for _ in range(TEXT_FRAMES)]
    own, pre = [], []
    t0 = time.perf_counter()
    for j in range(TEXT_FRAMES // 2):
        own.append(E.compress(texts[2 * j], level=1))
        with E.predef_seq_tables():
            pre.append(E.compress(texts[2 * j + 1], level=1))
        if 2 * (j + 1) == TEXT_FRAMES // 2 \
                and time.perf_counter() - t0 > ENCODE_CUT_S:
            _say(f"zstd decode: half the text frames took more than "
                 f"{ENCODE_CUT_S} s to encode; the run keeps {2 * (j + 1)}")
            break
    n_own = len(own)
    text_data = texts[0:2 * n_own:2] + texts[1:2 * n_own:2]
    b = corpus.make_block
    host_data = [b("rand256", rng).tobytes(), b("zeros", rng).tobytes(),
                 b"".join(b("text", rng).tobytes() for _ in range(3))]
    frames = own + pre + [E.compress(d, level=1) for d in host_data]
    datas = text_data + host_data
    enc_s = time.perf_counter() - t0
    n_text = len(text_data)
    t0 = time.perf_counter()
    for f, d in zip(frames, datas):
        if Z.decompress(f) != d:
            raise AssertionError("a frame does not decode to its input with "
                                 "the port's host decoder")
    hdec_s = time.perf_counter() - t0
    n_out = sum(len(d) for d in datas)
    _say(f"zstd decode frames: {n_text} text frames of 64 KiB ({n_own} own "
         f"tables, {n_own} predefined) + 3 host-route frames (rand256, zeros,"
         f" 192 KiB text); {n_out} bytes -> {sum(len(f) for f in frames)} "
         f"(ratio {sum(len(f) for f in frames) / n_out:.6f}); host encode "
         f"{enc_s:.2f} s; every frame decodes to its input with "
         f"zstd.decompress ({hdec_s:.2f} s)")

    # ---- 17. sequence kernel vs plain, both modes ---------------------------
    metas = [DD._route(f) for f in frames[:n_text]]
    if any(kind != "dev" for kind, _m in metas):
        raise AssertionError("a text frame does not take the device route")
    items = [m[4] for _k, m in metas]
    t0 = time.perf_counter()
    smeta, a, walk_s = seqdev.prep_sequences(items)
    prep_s = time.perf_counter() - t0
    targs = [torch.from_numpy(a[k]).to(dev) for k in (
        "windows", "lbit", "sll", "sof", "sml", "nseq", "nore", "r1", "r2",
        "r3", "tables")]
    got, got_e = ED.zseq_decode_chunks_rep(*targs)
    want, want_e = ED.zseq_decode_chunks_rep_ref(*targs)
    err_item = _hold("zseq per-item tables", [*got, got_e], [*want, want_e])
    host = [_host_seqs(it) for it in items]
    ll, ml, _ofv, off = (x.cpu().numpy() for x in got)
    for i, (h, (_kind, (n, nc))) in enumerate(zip(host, smeta)):
        dec = [x[i, :nc].reshape(-1)[:n] for x in (ll, ml, off)]
        if not all(np.array_equal(x, y) for x, y in zip(dec, h)):
            raise AssertionError(f"text frame {i}: the per-item decode "
                                 "differs from the host sequence decode")
    live_i = int(a["nseq"].sum())
    nc_i = a["nseq"].size

    # shared table: the predefined frames' chunks, checkpoints from the
    # host walk (equal to a sidecar's, as the CPU tests show)
    pre_items = items[n_own:]
    predef = S.predef_tables()
    parts = []
    for st, n, *tabs in pre_items:
        if any(t.mode != S.MODE_PREDEFINED for t in tabs):
            raise AssertionError("a predefined-table frame has other tables")
        ck = np.array(seqdev.seq_accel(st, n, *predef, k=ZK.K), np.int64)
        w, lb = ED.build_windows(st, ck[:, 0], len(ck), win=ZK.WIN)
        last = np.zeros(len(ck), np.int32)
        last[-1] = 1
        parts.append((w, lb, np.minimum(n - ZK.K * np.arange(len(ck)), ZK.K),
                      ck[:, 1:4], ck[:, 4:7], last))
    sargs = [torch.from_numpy(np.concatenate(c).astype(
        np.uint8 if j == 0 else np.int32)).to(dev)
        for j, c in enumerate(zip(*parts))]
    sargs.append(torch.from_numpy(ZK.pack_tables()).to(dev))
    ZK.zseq_decode_chunks_shared.launches = 0
    got_s = ZK.zseq_decode_chunks_shared(*sargs)
    torch.cuda.synchronize()
    shared_launches = ZK.zseq_decode_chunks_shared.launches
    err_sh = _hold("zseq shared table", got_s,
                   ZK.zseq_decode_chunks_shared_ref(*sargs))
    ll, ml, off = (x.cpu().numpy() for x in got_s[:3])
    c0 = 0
    for (w, *_r), (st, n, *_t), h in zip(parts, pre_items, host[n_own:]):
        sl = slice(c0, c0 + len(w))
        dec = [x[sl].reshape(-1)[:n] for x in (ll, ml, off)]
        if not all(np.array_equal(x, y) for x, y in zip(dec, h)):
            raise AssertionError("the shared-table decode differs from the "
                                 "host sequence decode")
        c0 += len(w)
    nc_s = sargs[0].shape[0]
    live_s = int(sargs[2].sum())
    _say(f"zseq: per-item {tuple(a['windows'].shape[:2])} chunks ({live_i} "
         f"sequences; host walk {walk_s:.2f} s, prep {prep_s:.2f} s), shared "
         f"{nc_s} chunks ({live_s} sequences, launches {shared_launches}); "
         "both equal the host sequence decode")

    # ---- 18. the path ------------------------------------------------------
    counted = {"huff0": ED.huff0_decode_chunks,
               "zseq": ED.zseq_decode_chunks_rep, "exec": X.execute_pieces}
    for f in (*counted.values(), ED.zseq_decode_chunks,
              ZK.zseq_decode_chunks_shared):
        f.launches = 0
    DD.decompress_frames_device.host_frames = 0
    stats = {}
    t0 = time.perf_counter()
    out = DD.decompress_frames_device(frames, stats=stats)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counted.items()}
    other = (ED.zseq_decode_chunks.launches
             + ZK.zseq_decode_chunks_shared.launches)
    host_frames = DD.decompress_frames_device.host_frames
    _say(f"zstd decode main path launches: {launches}, other sequence "
         f"launches {other}, host frames {host_frames}; routes "
         f"{stats['routes']} (first call {first_s:.2f} s)")
    if any(v != 1 for v in launches.values()) or host_frames != 3:
        raise AssertionError(f"zstd decode: launches {launches}, host frames "
                             f"{host_frames}")
    bad = [i for i, (g, d) in enumerate(zip(out, datas)) if g != d]
    if bad:
        raise AssertionError(f"zstd decode: frames {bad[:8]} differ from "
                             "their input")
    _say(f"zstd decode: all {len(frames)} frames equal their input")

    # the path's own kernel inputs, rebuilt by its host halves
    metas_all = [DD._route(f) for f in frames]
    scratch = dict.fromkeys(("lit_walk", "lit_prep", "lit_kernel"), 0.0)
    _dec, _it, _built, larr = DD._literal_batch(metas_all, scratch)
    largs = [torch.from_numpy(x).to(dev) for x in larr]
    err_h = _hold("huff0 (zstd literals)", ED.huff0_decode_chunks(*largs),
                  ED.huff0_decode_chunks_ref(*largs))
    lit_dec = DD._literals(metas_all, dev, scratch)
    seq_out = seqdev.decode_sequences_device(items, resolve=True)
    plans, rows, _order, _host = DD._exec_batch(metas_all, lit_dec, seq_out,
                                                4)
    pieces, rstart = X.pack_pieces(plans)
    xargs = [torch.from_numpy(x).to(dev) for x in (rows, pieces, rstart)]
    err_x = _hold("exec (zstd)", X.execute_pieces(*xargs),
                  X.execute_pieces_ref(*xargs))

    t = {"huff0": cuda_ms(lambda: ED.huff0_decode_chunks(*largs), 20),
         "zseq": cuda_ms(lambda: ED.zseq_decode_chunks_rep(*targs), 20),
         "shared": cuda_ms(lambda: ZK.zseq_decode_chunks_shared(*sargs), 20),
         "exec": cuda_ms(lambda: X.execute_pieces(*xargs), 20)}
    plain = {"huff0": cuda_ms(lambda: ED.huff0_decode_chunks_ref(*largs), 2),
             "zseq": cuda_ms(lambda: ED.zseq_decode_chunks_rep_ref(*targs),
                             2),
             "shared": cuda_ms(lambda: ZK.zseq_decode_chunks_shared_ref(
                 *sargs), 2),
             "exec": cuda_ms(lambda: X.execute_pieces_ref(*xargs), 2)}
    t_exec_dev = cuda_ms(lambda: X.execute_pieces(*xargs), 20, True)
    t_dev = {"huff0": cuda_ms(lambda: ED.huff0_decode_chunks(*largs), 20,
                              True),
             "zseq": cuda_ms(lambda: ED.zseq_decode_chunks_rep(*targs), 20,
                             True),
             "shared": cuda_ms(lambda: ZK.zseq_decode_chunks_shared(*sargs),
                               20, True)}
    # the per-item launch with no sequence to decode: the tiles' copies,
    # table staging and stores alone
    no_seqs = [*targs[:5], torch.zeros_like(targs[5]), *targs[6:]]
    t_dev["zseq_no_sequences"] = cuda_ms(
        lambda: ED.zseq_decode_chunks_rep(*no_seqs), 20, True)
    stats = {}
    t0 = time.perf_counter()
    DD.decompress_frames_device(frames, stats=stats)
    torch.cuda.synchronize()
    t_call = (time.perf_counter() - t0) * 1e3
    _say("zstd decode kernel times (ms, CUDA events): " + ", ".join(
        f"{k} {v:.4f} (plain {plain[k]:.4f})" for k, v in t.items()))
    _say("zstd decode kernel device times (ms): " + ", ".join(
        f"{k} {v:.4f}" for k, v in t_dev.items()))
    _say(f"zstd decode whole call (host clock): {t_call:.4f} ms, "
         f"{n_out / (t_call * 1e-3) / 1e9:.4f} GB/s of output; stages (s): "
         + ", ".join(f"{k} {v:.4f}" for k, v in stats["s"].items()))
    h2d_ms = _say_trace("zstd decode",
                        lambda: DD.decompress_frames_device(frames),
                        warm=False, every_name=True)

    b_item = _zseq_bound(nc_i, ED.ZWIN, a["tables"].size, live_i, 4)
    b_sh = _zseq_bound(nc_s, ZK.WIN, ZK.ZTAB, live_s, 3)
    nc_h = largs[0].shape[0] * largs[0].shape[1]
    b_h = bound(nc_h * (ED.WIN + 8) + largs[3].numel() * 4 + nc_h * 36,
                8 * int(largs[2].sum()))
    n_dev_out = sum(int(np.sum(p["len"])) for p in plans)
    b_x, b_x_pad, _, _ = _exec_bounds(rows, pieces, rstart, n_dev_out)
    _say(f"zstd decode bounds (ms): huff0 {b_h[0]:.4f} (literal chunks "
         f"{tuple(largs[0].shape[:2])}), zseq per-item "
         f"{b_item[0]:.4f} ({b_item[1]}), shared {b_sh[0]:.4f}, exec "
         f"{b_x[0]:.4f} ({len(pieces)} live pieces; padded-plan bound "
         f"{b_x_pad[0]:.4f}); exec device time {t_exec_dev:.4f}; compact "
         f"plan {pieces.nbytes + rstart.nbytes} bytes")
    common = {"route": "cuda", "source": "compress_tpu_torch/csrc/zseqdec.cu",
              "replaces": "compress_tpu/ops/zseq_pallas.py:68",
              "library_ms": None, "equal_to_plain": True}
    rows_out = [
        {"name": "zseq_decode_chunks_rep", "mode": "per_item", **common,
         "launches": launches["zseq"], "max_abs_err": err_item,
         "ms": t["zseq"], "device_ms": t_dev["zseq"],
         "no_sequences_device_ms": t_dev["zseq_no_sequences"],
         "plain_ms": plain["zseq"], "bound_ms": b_item[0],
         "bound_by": b_item[1], "chunks": nc_i, "sequences": live_i,
         "also_serves": "compress_tpu/ops/entropy_dec.py:234"},
        {"name": "zseq_decode_chunks_shared", "mode": "shared", **common,
         "launches": shared_launches, "max_abs_err": err_sh,
         "ms": t["shared"], "device_ms": t_dev["shared"],
         "plain_ms": plain["shared"], "bound_ms": b_sh[0],
         "bound_by": b_sh[1], "chunks": nc_s, "sequences": live_s,
         "path": "phase 17: the predefined frames' chunks"},
    ]
    extra = {
        "huff0": {"zdec_launches": launches["huff0"], "zdec_ms": t["huff0"],
                  "zdec_plain_ms": plain["huff0"], "zdec_bound_ms": b_h[0],
                  "zdec_max_abs_err": err_h,
                  "zdec_device_ms": t_dev["huff0"]},
        "exec": {"zdec_launches": launches["exec"], "zdec_ms": t["exec"],
                 "zdec_plain_ms": plain["exec"], "zdec_bound_ms": b_x[0],
                 "zdec_max_abs_err": err_x, "zdec_device_ms": t_exec_dev,
                 "zdec_padded_bound_ms": b_x_pad[0]},
        "call": {"call_ms": t_call, "first_s": first_s, "encode_s": enc_s,
                 "host_decode_s": hdec_s, "stages_s": stats["s"],
                 "h2d_ms": h2d_ms},
    }
    return rows_out, extra, text_data


def _encode_accel(job):
    """Pool worker: one input through ``compress_accel(level=1)``.
    Returns (the stream, the call's seconds, the seconds of its
    ``build_sidecar`` calls, sidecar bytes, frame bytes)."""
    from compress_tpu_torch.zstd import accel as AC

    data, multi_block = job
    build, spent = AC.build_sidecar, [0.0]

    def timed(*a, **kw):
        t = time.perf_counter()
        try:
            return build(*a, **kw)
        finally:
            spent[0] += time.perf_counter() - t

    AC.build_sidecar = timed   # this worker's module only
    try:
        t0 = time.perf_counter()
        blob = AC.compress_accel(data, level=1, multi_block=multi_block,
                                 hist_blocks=HIST_BLOCKS)
        t_call = time.perf_counter() - t0
    finally:
        AC.build_sidecar = build
    items = AC.split_stream_accel(blob)
    payload, frame = AC.split_sidecar(items[0])
    if len(items) != 1 or payload is None:
        raise AssertionError("compress_accel did not give one frame after "
                             "its sidecar")
    return blob, t_call, spent[0], len(blob) - len(frame), len(frame)


def _encode_pool(pool, workers: int, jobs):
    """``_encode_accel`` of every job in the pool of ``workers``
    processes: the results in order and the wall seconds."""
    t0 = time.perf_counter()
    out = list(pool.map(_encode_accel, jobs,
                        chunksize=max(1, len(jobs) // (4 * workers))))
    return out, time.perf_counter() - t0


class _Walks:
    """Counts the calls of the host checkpoint walks while it is entered
    (the decode routes of phases 20-21 must make none)."""

    def __enter__(self):
        from compress_tpu_torch.zstd import device_dec as DD
        from compress_tpu_torch.zstd import seqdev

        self.n = 0
        self.saved = [(DD, "_hwalk", DD._hwalk),
                      (seqdev, "seq_accel", seqdev.seq_accel)]
        for mod, name, fn in self.saved:
            def counted(*a, _fn=fn, **kw):
                self.n += 1
                return _fn(*a, **kw)
            setattr(mod, name, counted)
        return self

    def __exit__(self, *exc):
        for mod, name, fn in self.saved:
            setattr(mod, name, fn)


def _accel_counters():
    from compress_tpu_torch.ops import entropy_dec as ED
    from compress_tpu_torch.ops import execute as X
    from compress_tpu_torch.ops import zseq_kern as ZK

    return {"huff0": ED.huff0_decode_chunks, "exec": X.execute_pieces,
            "exec_hist": X.execute_blocks_hist,
            "zseq": ED.zseq_decode_chunks_rep,
            "zseq_ofv": ED.zseq_decode_chunks,
            "zseq_shared": ZK.zseq_decode_chunks_shared}


def _decode_counted(items, want_routes: set):
    """One ``decompress_frames_device`` call of items with every launch
    counter set to 0 just before and the host walks counted: (outputs,
    launches, stats, first-call seconds); raises unless every route is
    in want_routes, no walk ran and no frame went to the host."""
    from compress_tpu_torch.zstd import device_dec as DD

    counted = _accel_counters()
    for f in counted.values():
        f.launches = 0
    DD.decompress_frames_device.host_frames = 0
    stats = {}
    with _Walks() as walks:
        t0 = time.perf_counter()
        out = DD.decompress_frames_device(items, stats=stats)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counted.items()}
    host = DD.decompress_frames_device.host_frames
    _say(f"  routes {stats['routes']}, host walks {walks.n}, host frames "
         f"{host}, launches {launches} (first call {first_s:.2f} s)")
    if set(stats["routes"]) != want_routes or walks.n or host:
        raise AssertionError(f"routes {stats['routes']}, walks {walks.n}, "
                             f"host frames {host}")
    return out, launches, stats, first_s


def _call_times(items, n_out: int, what: str):
    """The whole call on the host clock (median of 2), its stages and one
    traced call."""
    from compress_tpu_torch.zstd import device_dec as DD

    times, stats = [], {}
    for _ in range(2):
        st = {}
        t0 = time.perf_counter()
        DD.decompress_frames_device(items, stats=st)
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
        stats = st
    t_call = statistics.median(times)
    _say(f"{what} whole call (host clock): {t_call:.4f} ms (calls "
         f"{', '.join(f'{t:.4f}' for t in times)}), "
         f"{n_out / (t_call * 1e-3) / 1e9:.4f} GB/s of output; stages (s): "
         + ", ".join(f"{k} {v:.4f}" for k, v in stats["s"].items()))
    for _ in range(2):   # a second try where the profiler saw no device
        h2d = _say_trace(what, lambda: DD.decompress_frames_device(items),
                         warm=False, every_name=True)
        if h2d is not None:
            break
    return {"call_ms": t_call, "calls_ms": times, "stages_s": stats["s"],
            "h2d_ms": h2d}


def accel_paths(dev, texts, ctas: int) -> tuple:
    """Phases 20-21: the accel and multi-block accel routes (``ctas``: the
    history kernel's CTAs per SM, from phase 2).  Returns the history
    kernel's JSON entry and the launches and call numbers of both
    routes."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch.ops import execute as X
    from compress_tpu_torch.zstd import accel as AC
    from compress_tpu_torch.zstd import device_dec as DD

    # the encodes run in a pool of spawned worker processes (one per core,
    # at most 8), closed before the decodes
    workers = min(8, os.cpu_count() or 1)
    t0 = time.perf_counter()
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=workers,
            mp_context=multiprocessing.get_context("spawn")) as pool:
        enc20, wall20 = _encode_pool(pool, workers,
                                     [(t, False) for t in texts])
        streams = corpus.history_streams(HIST_STREAMS, 1 << 20, SEED)
        enc21, wall21 = _encode_pool(pool, workers,
                                     [(d, True) for d in streams])
    _say(f"accel encodes: a pool of {workers} worker processes, "
         f"{time.perf_counter() - t0:.2f} s from its start to its close")

    # ---- 20. the accel route ------------------------------------------------
    enc, wall = enc20, wall20
    blobs = [e[0] for e in enc]
    side_b, frame_b = sum(e[3] for e in enc), sum(e[4] for e in enc)
    _say(f"accel encode: {len(texts)} text frames of 64 KiB through "
         f"compress_accel(level=1): {wall:.2f} s wall in the pool, "
         f"{sum(e[1] for e in enc):.2f} s of calls, of which its "
         f"build_sidecar {sum(e[2] for e in enc):.2f} s; sidecars "
         f"{side_b} bytes, frames {frame_b} bytes (sidecar share "
         f"{side_b / frame_b:.4f} of the frame bytes)")
    items = [it for b in blobs for it in AC.split_stream_accel(b)]
    out, l20, _st, first20 = _decode_counted(items, {"accel"})
    if out != texts:
        raise AssertionError("accel route: an item differs from its input")
    if (l20["huff0"], l20["exec"], l20["exec_hist"]) != (1, 1, 0)             or l20["zseq"] + l20["zseq_ofv"] + l20["zseq_shared"]:
        raise AssertionError(f"accel route launches {l20}")
    _say(f"accel route: all {len(items)} items equal their input")
    call20 = _call_times(items, sum(len(t) for t in texts), "accel decode")

    # ---- 21. the multi-block accel route -------------------------------------
    enc, wall = enc21, wall21
    if wall > ENCODE_CUT_S:
        _say(f"multi-block encode took {wall:.2f} s, over {ENCODE_CUT_S} s: "
             f"the run keeps {HIST_STREAMS // 2} streams")
        streams, enc = streams[:HIST_STREAMS // 2], enc[:HIST_STREAMS // 2]
    side_b, frame_b = sum(e[3] for e in enc), sum(e[4] for e in enc)
    n_out = sum(len(d) for d in streams)
    _say(f"multi-block encode: {len(streams)} streams of 1 MiB through "
         f"compress_accel(level=1, multi_block=True, "
         f"hist_blocks={HIST_BLOCKS}): {wall:.2f} s wall in the pool, "
         f"{sum(e[1] for e in enc):.2f} s of calls, of which its "
         f"build_sidecar "
         f"{sum(e[2] for e in enc):.2f} s; sidecars {side_b} bytes, frames "
         f"{frame_b} bytes (ratio {frame_b / n_out:.6f}, sidecar share "
         f"{side_b / frame_b:.4f})")
    items = [it for e in enc for it in AC.split_stream_accel(e[0])]
    out, l21, _st, first21 = _decode_counted(items, {"accel_mb"})
    if out != streams:
        raise AssertionError("multi-block route: a stream differs from its "
                             "input")
    if (l21["huff0"], l21["exec"], l21["exec_hist"]) != (1, 0, 1):
        raise AssertionError(f"multi-block route launches {l21}")
    _say(f"multi-block route: all {len(items)} streams equal their input")

    # the path's own history execute inputs, rebuilt by its host halves
    metas = [DD._route(f) for f in items]
    scratch = dict.fromkeys(("lit_walk", "lit_prep", "lit_kernel"), 0.0)
    lit_dec = DD._literals(metas, dev, scratch)
    groups, host = DD._mb_groups(metas, lit_dec)
    if host or len(groups) != 1:
        raise AssertionError(f"multi-block groups {list(groups)}, host "
                             f"{host}")
    (hb, (_idx, plans_kb, rows, pieces, gstart)), = groups.items()
    hargs = [torch.from_numpy(a).to(dev) for a in (rows, pieces, gstart)]
    err = _hold("execute_blocks_hist",
                [X.execute_blocks_hist(*hargs, hb * 512)],
                [X.execute_blocks_hist_ref(*hargs, hb * 512)])
    t_k = cuda_ms(lambda: X.execute_blocks_hist(*hargs, hb * 512), 20)
    t_dev = cuda_ms(lambda: X.execute_blocks_hist(*hargs, hb * 512), 20,
                    True)
    t_plain = cuda_ms(lambda: X.execute_blocks_hist_ref(*hargs, hb * 512),
                      1)
    hist = pieces[:, 0] >= X.HIST_BASE
    w1 = pieces[:, 1].astype(np.int64) & 0xFFFFFFFF
    n = np.minimum((w1 >> 24) + 1, 128 - (w1 & 127))
    hist_bytes = int(n[hist].sum())
    # the literal bytes the local pieces read: each step's distinct
    # sources below the output half, counted as in _exec_bounds
    B_, K_ = gstart.shape[:2]
    step = np.repeat(np.arange(B_ * K_), np.diff(np.append(
        gstart[:, :, 0].reshape(-1), len(pieces))))
    s, lo_loc = pieces[:, 0].astype(np.int64), ~hist
    half = 512 * 128
    lo = step[lo_loc] * half + np.minimum(s[lo_loc], half)
    hi = step[lo_loc] * half + np.minimum(s[lo_loc] + n[lo_loc], half)
    edge = (np.bincount(lo, minlength=B_ * K_ * half + 1)
            - np.bincount(hi, minlength=B_ * K_ * half + 1))
    lit_read = int(np.count_nonzero(np.cumsum(edge[:-1])))
    b = bound(pieces.nbytes + gstart.nbytes + lit_read + hist_bytes
              + rows.size, 8 * rows.size)
    _say(f"history execute: {len(pieces)} live pieces, {int(hist.sum())} "
         f"history pieces reading {hist_bytes} bytes, {lit_read} literal "
         f"bytes read, {B_} frames x {K_} blocks; kernel {t_k:.4f} ms "
         f"(device time {t_dev:.4f}), plain {t_plain:.4f} ms, bound "
         f"{b[0]:.4f} ms ({b[1]}), CTAs per SM {ctas}, launches on the path "
         f"{l21['exec_hist']}")
    call21 = _call_times(items, n_out, "multi-block decode")
    row = {"name": "execute_blocks_hist", "route": "cuda",
           "source": "compress_tpu_torch/csrc/exec.cu",
           "replaces": "compress_tpu/ops/execute.py:414",
           "replaces_kind": "XLA lax.scan (no Pallas site)",
           "launches": l21["exec_hist"], "max_abs_err": err,
           "equal_to_plain": True, "ms": t_k, "device_ms": t_dev,
           "plain_ms": t_plain, "bound_ms": b[0], "bound_by": b[1],
           "library_ms": None, "ctas_per_sm": ctas,
           "pieces": int(len(pieces)), "history_pieces": int(hist.sum()),
           "history_bytes": hist_bytes, "frames": B_, "blocks": K_,
           "hist_blocks": hb, "call": call21, "first_s": first21}
    extra = {"huff0": {"accel_launches": l20["huff0"],
                       "accel_mb_launches": l21["huff0"]},
             "exec": {"accel_launches": l20["exec"]},
             "accel_call": {**call20, "first_s": first20}}
    return row, extra


def _route_counters():
    from compress_tpu_torch.ops import exec_kern, lzemit2, zparse

    return [(zparse.parse_blocks, "any_cap_launches"),
            (lzemit2.emit_blocks, "any_cap_launches"),
            (exec_kern.execute_rounds, "launches")]


def reset_route_counts() -> None:
    """Set the launch counts of the routes no path sends to 0."""
    for fn, attr in _route_counters():
        setattr(fn, attr, 0)


def route_counts() -> list:
    """Their launch counts (after the main paths: all must be 0)."""
    return [getattr(fn, attr) for fn, attr in _route_counters()]


def other_routes(dev, blocks_np, main_launches) -> list:
    """Phase 19: the run-time cap routes of the zstd parse and the S2 emit
    and the sum route of ``execute_rounds`` against their plain versions
    on small inputs; returns their JSON entries.  ``main_launches``: their
    launch counts over the main paths above, which send none of them."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch.ops import exec_kern, execute, lzemit2, lzkern
    from compress_tpu_torch.ops import zparse

    _say(f"other routes: launches on the main paths (parse any cap, emit "
         f"any cap, execute_rounds sums) {main_launches}")
    if any(main_launches):
        raise AssertionError("a main path took a route it does not need")
    cap = 17
    ins = [corpus.parse_inputs(k) for k in corpus.PARSE_CLASSES]
    ins += [corpus.parse_inputs(k, cap) for k in ("chains", "all_zeros")]
    t = torch.from_numpy(blocks_np[:2]).to(dev)
    off, L = lzkern.find_matches_blocks_ref(t)
    ins += [(blocks_np[i], off[i].cpu().numpy(), L[i].cpu().numpy())
            for i in range(2)]
    blocks, off, L = (torch.from_numpy(np.stack(a)).to(dev)
                      for a in zip(*ins))
    nb = blocks.shape[0]
    before = route_counts()
    err_p = _hold(f"parse_blocks (cap {cap}, {nb} blocks)",
                  zparse.parse_blocks(blocks, off, L, cap=cap),
                  zparse.parse_blocks_ref(blocks, off, L, cap=cap))
    err_e = _hold(f"emit_blocks (cap {cap}, {nb} blocks)",
                  lzemit2.emit_blocks(blocks, off, L, cap=cap),
                  lzemit2.emit_blocks_ref(blocks, off, L, cap=cap))
    plans = list(corpus.exec_sum_plans().values())
    plans.append(corpus.exec_hostile_plans(1)[1])
    rng = np.random.default_rng([SEED, 19])
    lit = rng.integers(0, 256, (len(plans), 512, 128), np.uint8)
    src, dst, length, caps = execute.pack_plans(plans)
    xargs = [torch.from_numpy(a).to(dev) for a in (lit, src, dst, length)]
    err_x = _hold(f"execute_rounds (sums, {len(plans)} blocks)",
                  exec_kern.execute_rounds(*xargs, caps),
                  exec_kern.execute_rounds_ref(*xargs, caps))
    took = [a - b for a, b in zip(route_counts(), before)]
    if took != [1, 1, 1]:
        raise AssertionError(f"the other routes launched {took} times")
    t = {"parse": cuda_ms(lambda: zparse.parse_blocks(blocks, off, L,
                                                      cap=cap), 5),
         "emit": cuda_ms(lambda: lzemit2.emit_blocks(blocks, off, L,
                                                     cap=cap), 5),
         "sum": cuda_ms(lambda: exec_kern.execute_rounds(*xargs, caps), 5)}
    plain = {"parse": cuda_ms(lambda: zparse.parse_blocks_ref(
                 blocks, off, L, cap=cap), 1),
             "emit": cuda_ms(lambda: lzemit2.emit_blocks_ref(
                 blocks, off, L, cap=cap), 1),
             "sum": cuda_ms(lambda: exec_kern.execute_rounds_ref(
                 *xargs, caps), 1)}
    _say("other routes (ms, kernel / plain): " + ", ".join(
        f"{k} {t[k]:.4f} / {plain[k]:.4f}" for k in t))
    # bounds as the main-path rows count them; the sums read each slot of
    # the padded plan, the literal rows and write the output rows
    blk_b = nb * lzkern.BS
    seq_b = nb * zparse.MAXSEQ * 4
    b_parse = bound(blk_b + 8 * blk_b + 3 * seq_b + blk_b + 8 * nb,
                    blk_b * 64)
    b_emit = bound(blk_b + 8 * blk_b + 2 * blk_b + nb * 512 * 4, blk_b * 64)
    b_sum = bound(2 * lit.nbytes + src.nbytes + dst.nbytes + length.nbytes,
                  8 * lit.size)
    csrc = "compress_tpu_torch/csrc/"
    rows = [("parse_blocks_any_cap", "parse", csrc + "zparse.cu",
             "compress_tpu/ops/zparse.py:90", b_parse, err_p, 0),
            ("emit_blocks_any_cap", "emit", csrc + "lzemit.cu",
             "compress_tpu/ops/lzemit2.py:102", b_emit, err_e, 1),
            ("execute_rounds_sum", "sum", csrc + "exec.cu",
             "compress_tpu/ops/exec_pallas.py:39", b_sum, err_x, 2)]
    return [{"name": name, "route": "cuda", "source": source,
             "replaces": replaces, "launches": main_launches[k],
             "max_abs_err": err, "equal_to_plain": True, "ms": t[key],
             "plain_ms": plain[key], "bound_ms": bnd[0], "bound_by": bnd[1],
             "library_ms": None, "path": "phase 19: no path sends it"}
            for name, key, source, replaces, bnd, err, k in rows]


def tail_path(zstd_launches: dict) -> None:
    """Phase 22: ``compress_device`` on inputs that are not whole jobs: the
    phase-10 corpus followed by a tail of TAIL_BYTES (the tail through the
    host matcher), and SHORT_BYTES (< one job: the host encoder).  Every
    frame must decode to its input with the port's host decoder; the first
    call's launch counts must equal phase 10's, the second's must be 0."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch import zstd as Z
    from compress_tpu_torch.ops import lzkern, zenc2, zparse, zseqenc
    from compress_tpu_torch.zstd import device as zdevice

    counted = {"find": lzkern.find_matches_blocks,
               "parse": zparse.parse_blocks, "rep": zseqenc.rep_scan,
               "fse": zseqenc.fse_chain, "litlut": zenc2._litlut}
    extra = corpus.corpus_blocks(8, SEED + 22).tobytes()
    data = (corpus.replica_jobs(ZSTD_JOBS, ZSTD_JOB, SEED).tobytes()
            + extra[:TAIL_BYTES])
    for what, src, want in (("tail", data, zstd_launches),
                            ("short", extra[:SHORT_BYTES],
                             {k: 0 for k in counted})):
        for f in counted.values():
            f.launches = 0
        t0 = time.perf_counter()
        frame = zdevice.compress_device(src)
        torch.cuda.synchronize()
        call_s = time.perf_counter() - t0
        launches = {k: f.launches for k, f in counted.items()}
        if launches != want:
            raise AssertionError(f"compress_device ({what}): launches "
                                 f"{launches}, expected {want}")
        t0 = time.perf_counter()
        back = Z.decompress(frame)
        dec_s = time.perf_counter() - t0
        if back != src:
            raise AssertionError(f"compress_device ({what}): the frame does "
                                 "not decode to its input")
        _say(f"compress_device, {what} ({len(src)} bytes, "
             f"{len(src) % ZSTD_JOB} past the last whole job): launches "
             f"{launches}; frame {len(frame)} bytes (ratio "
             f"{len(frame) / len(src):.6f}), call {call_s:.4f} s on the host "
             f"clock; decoded by the port's host decoder to its input "
             f"({dec_s:.2f} s)")


def fse_path(dev, blocks_np) -> tuple:
    """Phase 23: the FSE batch codec on the phase-3 corpus as 1024 rows of
    16 KiB.  Returns the two FSE kernels' JSON entries and the histogram's
    numbers."""
    from compress_tpu_torch import fse
    from compress_tpu_torch.ops import entropy as E
    from compress_tpu_torch.ops import entropy_dec as ED
    from compress_tpu_torch.utils.histogram import histogram256_torch

    row = 16 << 10
    rows = blocks_np.reshape(-1, row)
    N = len(rows)
    t = torch.from_numpy(rows).to(dev)
    # kernel 1 against its plain version on the path's own tables
    hist = E.byte_histograms(t)
    st, dnb, dfs, _ = E._fse_tables_bytes(hist, E.FSE_LOG)
    chain_in = (t, st, dnb, dfs)
    err_enc = _hold(f"fse_encode_chain ({N} rows of {row})",
                    E.fse_encode_chain(*chain_in),
                    E.fse_encode_chain_ref(*chain_in))
    E.fse_encode_chain.launches = 0
    t0 = time.perf_counter()
    conts = fse.compress_batch(rows)
    torch.cuda.synchronize()
    enc_first = (time.perf_counter() - t0) * 1e3
    enc_launches = E.fse_encode_chain.launches
    if enc_launches != 1:
        raise AssertionError(f"compress_batch: {enc_launches} launches")
    kept = [i for i, c in enumerate(conts) if c is not None]
    ratio = sum(len(conts[i]) for i in kept) / (len(kept) * row)
    t0 = time.perf_counter()
    host11 = [fse.compress(rows[i].tobytes(), table_log=11)
              for i in range(FSE_HOST_LOG11)]
    host_s = time.perf_counter() - t0
    _say(f"FSE compress_batch: {N} rows of {row} bytes, launches "
         f"{enc_launches}; {N - len(kept)} rows None; ratio of the others "
         f"{ratio:.6f}; first call {enc_first:.1f} ms; {FSE_HOST_LOG11} host "
         f"fse.compress(table_log=11) containers {host_s:.2f} s")

    decode = conts + host11
    want = [r.tobytes() for r in rows] + [rows[i].tobytes()
                                          for i in range(FSE_HOST_LOG11)]
    t0 = time.perf_counter()
    fse.make_accel(decode[:FSE_ACCEL_CUT])
    part_s = time.perf_counter() - t0
    estimate = part_s * len(decode) / FSE_ACCEL_CUT
    if estimate > ACCEL_CUT_S:
        decode = decode[:FSE_ACCEL_CUT] + host11
        want = want[:FSE_ACCEL_CUT] + want[N:]
        _say(f"FSE make_accel: {part_s:.1f} s for the first "
             f"{FSE_ACCEL_CUT} containers, {estimate:.1f} s estimated for "
             f"all: decoding the first {FSE_ACCEL_CUT} rows only (cut)")
    t0 = time.perf_counter()
    accel = fse.make_accel(decode)
    accel_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    metas, arrays = fse.prep_decode_batch(decode, accel)
    prep_ms = (time.perf_counter() - t0) * 1e3
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    err_dec = _hold(f"fse_decode_chunks ({arrays[0].shape[0]} x "
                    f"{arrays[0].shape[1]} chunks)", ED.fse_decode_chunks(
                        *args), ED.fse_decode_chunks_ref(*args))
    ED.fse_decode_chunks.launches = 0
    fse.decompress_batch.host_containers = 0
    t0 = time.perf_counter()
    got = fse.decompress_batch(decode, accel=accel)
    torch.cuda.synchronize()
    dec_first = (time.perf_counter() - t0) * 1e3
    dec_launches = ED.fse_decode_chunks.launches
    host_routed = fse.decompress_batch.host_containers
    if dec_launches != 1 or host_routed != FSE_HOST_LOG11:
        raise AssertionError(f"decompress_batch: {dec_launches} launches, "
                             f"{host_routed} containers on the host")
    bad = [i for i, (g, c) in enumerate(zip(got, decode))
           if (c is None and g is not None)
           or (c is not None and g != want[i])]
    if bad:
        raise AssertionError(f"decompress_batch: rows {bad[:8]} differ from "
                             "their input")
    n_dev = sum(m is not None for m in metas)
    _say(f"FSE decompress_batch: {len(decode)} entries, launches "
         f"{dec_launches}, {host_routed} log-11 containers on the host, "
         f"{n_dev} on the card, every container equal to its input; "
         f"make_accel {accel_s:.2f} s (host walk), prep {prep_ms:.1f} ms, "
         f"first call {dec_first:.1f} ms")

    t_enc = cuda_ms(lambda: E.fse_encode_chain(*chain_in), 10)
    t_enc_dev = cuda_ms(lambda: E.fse_encode_chain(*chain_in), 10, True)
    p_enc = cuda_ms(lambda: E.fse_encode_chain_ref(*chain_in), 1)
    t_dec = cuda_ms(lambda: ED.fse_decode_chunks(*args), 20)
    t_dec_dev = cuda_ms(lambda: ED.fse_decode_chunks(*args), 20, True)
    p_dec = cuda_ms(lambda: ED.fse_decode_chunks_ref(*args), 2)
    t_blocks = cuda_ms(lambda: E.fse_encode_blocks(t), 3)
    enc_call = host_ms(lambda: fse.compress_batch(rows), 2)
    dec_call = host_ms(lambda: fse.decompress_batch(decode, accel=accel), 2)
    # the histograms: plain PyTorch, torch.bincount the library call
    flat = t.reshape(-1)
    if not torch.equal(histogram256_torch(flat),
                       torch.bincount(flat, minlength=256).to(torch.int32)):
        raise AssertionError("histogram256_torch differs from torch.bincount")
    h_ms = cuda_ms(lambda: histogram256_torch(flat), 20)
    h_dev = cuda_ms(lambda: histogram256_torch(flat), 20, True)
    lib_ms = cuda_ms(lambda: torch.bincount(flat, minlength=256), 20)
    lib_dev = cuda_ms(lambda: torch.bincount(flat, minlength=256), 20, True)
    rows_ms = cuda_ms(lambda: E.byte_histograms(t), 20)
    rows_dev = cuda_ms(lambda: E.byte_histograms(t), 20, True)

    # bounds: kernel 1 reads the rows and tables once and writes the two
    # item arrays; 20 integer operations a symbol pair.  Kernel 2 reads the
    # windows, the six (N, C) int32 inputs and the tables once and writes
    # the symbols and end cursors; 30 operations a pair.  The chain is a
    # serial walk of L / 2 - 1 steps a row, which bounds it harder.
    W = E._chain_width(row)
    b_enc = bound(rows.size + 4 * N * (512 + 512) + 8 * N * W,
                  20 * N * (row // 2))
    nc = arrays[1].size
    b_dec = bound(arrays[0].size + 6 * 4 * nc + arrays[7].size * 4
                  + nc * (accel["k"] + 4), 30 * int(arrays[4].sum()))
    b_hist = bound(flat.numel() + 256 * 4, flat.numel())
    _say(f"FSE kernel times (ms, CUDA events): encode chain {t_enc:.4f} "
         f"({t_enc_dev:.4f} device time; plain {p_enc:.4f}; {row // 2 - 1} "
         f"dependent steps a row), bound {b_enc[0]:.4f} ({b_enc[1]}); chunk "
         f"decode {t_dec:.4f} ({t_dec_dev:.4f} device time; plain "
         f"{p_dec:.4f}; {nc} chunks), bound {b_dec[0]:.4f} ({b_dec[1]}); "
         f"fse_encode_blocks {t_blocks:.4f}")
    _say(f"FSE whole calls (host clock, ms): compress_batch {enc_call:.4f} "
         f"({rows.size / (enc_call * 1e-3) / 1e9:.4f} GB/s of input), "
         f"decompress_batch {dec_call:.4f} "
         f"({len(kept) * row / (dec_call * 1e-3) / 1e9:.4f} GB/s of output)")
    _say(f"histogram of {flat.numel()} bytes (ms): histogram256_torch "
         f"{h_ms:.4f} ({h_dev:.4f} device time), torch.bincount {lib_ms:.4f} "
         f"({lib_dev:.4f} device time), bound {b_hist[0]:.4f} "
         f"({b_hist[1]}); per-row histograms ({N} rows) {rows_ms:.4f} "
         f"({rows_dev:.4f} device time)")
    _say_trace("FSE encode", lambda: fse.compress_batch(rows))
    _say_trace("FSE decode", lambda: fse.decompress_batch(decode,
                                                          accel=accel))
    common = {"route": "cuda", "library_ms": None, "equal_to_plain": True}
    return [
        {"name": "fse_encode_chain", **common,
         "source": "compress_tpu_torch/csrc/fseenc.cu",
         "replaces": "compress_tpu/ops/entropy.py:223",
         "launches": enc_launches, "max_abs_err": err_enc, "ms": t_enc,
         "plain_ms": p_enc, "bound_ms": b_enc[0], "bound_by": b_enc[1],
         "device_ms": t_enc_dev, "rows": N, "row_bytes": row,
         "chain_steps": row // 2 - 1, "none_rows": N - len(kept),
         "ratio": ratio, "call_ms": enc_call, "first_call_ms": enc_first,
         "fse_encode_blocks_ms": t_blocks},
        {"name": "fse_decode_chunks", **common,
         "source": "compress_tpu_torch/csrc/fsedec.cu",
         "replaces": "compress_tpu/ops/entropy_dec.py:185",
         "launches": dec_launches, "max_abs_err": err_dec, "ms": t_dec,
         "plain_ms": p_dec, "bound_ms": b_dec[0], "bound_by": b_dec[1],
         "device_ms": t_dec_dev, "chunks": nc, "host_containers": host_routed,
         "make_accel_s": accel_s, "prep_ms": prep_ms, "call_ms": dec_call,
         "first_call_ms": dec_first}], {
        "histogram256_torch_ms": h_ms, "histogram256_torch_device_ms": h_dev,
        "bincount_ms": lib_ms, "bincount_device_ms": lib_dev,
        "bound_ms": b_hist[0], "row_histograms_ms": rows_ms,
        "row_histograms_device_ms": rows_dev}


def checksum_path(blocks) -> list:
    """Phase 24: CRC-32C and xxHash64 of the phase-3 corpus (256 rows of 64
    KiB on the card).  Returns the two kernels' JSON entries."""
    from compress_tpu_torch.ops import checksum as CK
    from compress_tpu_torch.utils.crc import crc32c
    from compress_tpu_torch.utils.xxhash64 import xxh64

    B, n = blocks.shape
    host = blocks[:8].cpu().numpy()
    errs = {}
    for length in (None, n - 4097):
        got = CK.crc32c_batch(blocks, length)
        errs[f"crc {length}"] = _hold(f"crc32c_batch (length {length})",
                                      [got], [CK.crc32c_batch_ref(blocks,
                                                                  length)])
        m = n if length is None else length
        if got[:8].tolist() != [crc32c(r[:m].tobytes()) for r in host]:
            raise AssertionError("crc32c_batch differs from the host crc32c")
    for seed in (0, (1 << 64) - 1):
        got = CK.xxh64_batch(blocks, seed)
        errs[f"xxh {seed}"] = _hold(f"xxh64_batch (seed {seed})", [got],
                                    [CK.xxh64_batch_ref(blocks, seed)])
        if [lo | hi << 32 for lo, hi in got[:8].tolist()] != \
                [xxh64(r.tobytes(), seed) for r in host]:
            raise AssertionError("xxh64_batch differs from the host xxh64")
    CK.crc32c_batch.launches = CK.xxh64_batch.launches = 0
    CK.crc32c_batch(blocks)
    CK.xxh64_batch(blocks)
    torch.cuda.synchronize()
    launches = {"crc": CK.crc32c_batch.launches,
                "xxh": CK.xxh64_batch.launches}
    if launches != {"crc": 1, "xxh": 1}:
        raise AssertionError(f"checksum launches {launches}")
    t = {"crc": cuda_ms(lambda: CK.crc32c_batch(blocks), 20),
         "xxh": cuda_ms(lambda: CK.xxh64_batch(blocks), 20)}
    dev_t = {"crc": cuda_ms(lambda: CK.crc32c_batch(blocks), 20, True),
             "xxh": cuda_ms(lambda: CK.xxh64_batch(blocks), 20, True)}
    plain = {"crc": cuda_ms(lambda: CK.crc32c_batch_ref(blocks), 2),
             "xxh": cuda_ms(lambda: CK.xxh64_batch_ref(blocks), 2)}
    # bounds: each byte read once, the digests written once; about 2
    # integer operations a byte for the CRC's table steps, 1 for xxHash64
    bnd = {"crc": bound(B * n + 8 * B, 2 * B * n),
           "xxh": bound(B * n + 16 * B, B * n)}
    _say(f"checksums ({B} rows of {n} bytes; ms, CUDA events): " + ", ".join(
        f"{k} {t[k]:.4f} ({dev_t[k]:.4f} device time; plain {plain[k]:.4f};"
        f" bound {bnd[k][0]:.4f}, {bnd[k][1]})" for k in t)
        + f"; launches {launches}; 8 rows equal the host crc32c / xxh64")
    rows = [("crc32c_batch", "crc", "compress_tpu/ops/checksum.py:84",
             ("crc None", "crc " + str(n - 4097))),
            ("xxh64_batch", "xxh", "compress_tpu/ops/checksum.py:242",
             ("xxh 0", f"xxh {(1 << 64) - 1}"))]
    return [{"name": name, "route": "cuda",
             "source": "compress_tpu_torch/csrc/checksum.cu",
             "replaces": replaces, "launches": launches[key],
             "max_abs_err": max(errs[e] for e in es), "equal_to_plain": True,
             "ms": t[key], "plain_ms": plain[key], "bound_ms": bnd[key][0],
             "bound_by": bnd[key][1], "library_ms": None,
             "device_ms": dev_t[key]}
            for name, key, replaces, es in rows]


class _Capture:
    """Record the arguments of each call of ``module.name`` (a kernel
    wrapper, called through its module) while the block runs.  The
    wrapper still runs; it counts its launches on the module's name, so
    the spy carries the count and hands it back on exit."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.calls = []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        orig, calls = self.orig, self.calls

        def spy(*args, **kw):
            calls.append(args)
            return orig(*args, **kw)

        spy.launches = orig.launches
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        self.orig.launches = getattr(self.module, self.name).launches
        setattr(self.module, self.name, self.orig)


def _decode_all(bodies, data: bytes, what: str) -> float:
    """Every S2 body must decode with the port's decoder to its 64 KiB
    block; returns the seconds it took."""
    from compress_tpu_torch.ops import lz2
    from compress_tpu_torch.s2 import decode
    from compress_tpu_torch.utils.varint import put_uvarint

    hdr = bytearray()
    put_uvarint(hdr, lz2.B)
    t0 = time.perf_counter()
    for i, body in enumerate(bodies):
        if decode(bytes(hdr) + body) != data[i * lz2.B:(i + 1) * lz2.B]:
            raise AssertionError(f"{what}: block {i} does not decode to its "
                                 "input")
    return time.perf_counter() - t0


def s2_xla_path(dev, data: bytes, blocks, kern_bodies) -> dict:
    """Phase 25: the S2 XLA engine on the phase-3 corpus.  Returns the tile
    parse kernel's JSON entry."""
    from compress_tpu_torch.ops import lz2

    nb = blocks.shape[0]
    cases = [(512, 1), (512, 2), (256, 1)]
    outs, parse_in = {}, {}
    for tile, level in cases:
        with _Capture(lz2, "tile_parse") as cap:
            out, lens = lz2.s2_encode_blocks(blocks, tile, level)
        torch.cuda.synchronize()
        L_t = cap.calls[0][0]
        parse_in[(tile, level)] = L_t
        bodies = [out[i, :n].cpu().numpy().tobytes()
                  for i, n in enumerate(lens.tolist())]
        dec_s = _decode_all(bodies, data, f"S2 XLA engine (tile {tile}, "
                                          f"level {level})")
        outs[(tile, level)] = bodies
        _say(f"S2 XLA engine, tile {tile}, level {level}: {nb} bodies decode "
             f"to their blocks ({dec_s:.1f} s); ratio "
             f"{sum(map(len, bodies)) / len(data):.6f}")
    errs = {c: _hold(f"tile_parse (tile {c[0]}, level {c[1]}, {nb} blocks)",
                     lz2.tile_parse(parse_in[c], c[0]),
                     lz2.tile_parse_ref(parse_in[c], c[0]))
            for c in cases}

    # main path: the entry with the reference's switch set
    prev = os.environ.get("COMPRESS_TPU_S2_ENGINE")
    os.environ["COMPRESS_TPU_S2_ENGINE"] = "xla"
    try:
        lz2.tile_parse.launches = 0
        bodies = lz2.encode_blocks_np(data)
        torch.cuda.synchronize()
        launches = lz2.tile_parse.launches
        t_call = host_ms(lambda: lz2.encode_blocks_np(data), 3)
        _say_trace("S2 XLA engine", lambda: lz2.encode_blocks_np(data))
    finally:
        if prev is None:
            del os.environ["COMPRESS_TPU_S2_ENGINE"]
        else:
            os.environ["COMPRESS_TPU_S2_ENGINE"] = prev
    if launches != 1:
        raise AssertionError(f"S2 XLA engine: tile_parse launches {launches}")
    if bodies != outs[(512, 1)]:
        raise AssertionError("encode_blocks_np with COMPRESS_TPU_S2_ENGINE="
                             "xla differs from s2_encode_blocks")
    if lz2.encode_blocks_np(data) != kern_bodies:
        raise AssertionError("encode_blocks_np without the switch differs "
                             "from the kernel path's bodies (phase 6)")
    r_xla = sum(map(len, bodies)) / len(data)
    r_kern = sum(map(len, kern_bodies)) / len(data)
    L_t = parse_in[(512, 1)]
    t_k = cuda_ms(lambda: lz2.tile_parse(L_t, 512), 20)
    t_dev = cuda_ms(lambda: lz2.tile_parse(L_t, 512), 20, True)
    t_plain = cuda_ms(lambda: lz2.tile_parse_ref(L_t, 512), 2)
    t_engine = cuda_ms(lambda: lz2.s2_encode_blocks(blocks), 3)
    # bound: each L_t read once (4 bytes), the two masks written once; a
    # few integer operations a position
    n_pos = L_t.numel()
    bnd = bound(6 * n_pos, 4 * n_pos)
    _say(f"S2 XLA engine whole call (encode_blocks_np, host clock, median "
         f"of 3): {t_call:.4f} ms ({len(data) / (t_call * 1e-3) / 1e9:.4f} "
         f"GB/s), s2_encode_blocks alone {t_engine:.4f} ms by CUDA events; "
         f"launches {{tile_parse {launches}}}; ratio {r_xla:.6f} against the "
         f"kernel path's {r_kern:.6f} ({(r_xla / r_kern - 1) * 100:+.3f}% "
         f"size); tile_parse {t_k:.4f} ms ({t_dev:.4f} device time), plain "
         f"{t_plain:.4f}, bound {bnd[0]:.4f} ({bnd[1]})")
    return {"name": "tile_parse", "route": "cuda",
            "source": "compress_tpu_torch/csrc/tileparse.cu",
            "replaces": "compress_tpu/ops/lz2.py:123",
            "launches": launches, "max_abs_err": max(errs.values()),
            "equal_to_plain": True, "ms": t_k, "plain_ms": t_plain,
            "bound_ms": bnd[0], "bound_by": bnd[1], "library_ms": None,
            "device_ms": t_dev, "call_ms": t_call, "engine_ms": t_engine,
            "ratio": r_xla, "kernel_path_ratio": r_kern}


def zstd_v1_path(dev) -> tuple:
    """Phase 26: the zstd v1 engine.  Returns the FSE scan's JSON entry,
    and the tile parse's and the repeat scan's numbers on this path."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch import zstd as Z
    from compress_tpu_torch.ops import lz2, zdev, zseqenc
    from compress_tpu_torch.zstd import device as zdevice

    job = zdev.JOB
    data = corpus.replica_jobs(ZSTD_JOBS, job, SEED).tobytes()
    n = len(data)
    counted = {"parse": (lz2, "tile_parse"), "rep": (zseqenc, "rep_scan"),
               "fse": (zdev, "fse_scan")}
    sizes, caps, launches = {}, {}, {}
    for level in (1, 2, 3):
        for mod, name in counted.values():
            getattr(mod, name).launches = 0
        with _Capture(lz2, "tile_parse") as c_p, \
                _Capture(zseqenc, "rep_scan") as c_r, \
                _Capture(zdev, "fse_scan") as c_f:
            t0 = time.perf_counter()
            frame = zdevice.compress_device(data, engine="v1", level=level)
            torch.cuda.synchronize()
            call_s = time.perf_counter() - t0
        launches[level] = {k: getattr(mod, name).launches
                           for k, (mod, name) in counted.items()}
        if launches[level] != {"parse": 1, "rep": 1, "fse": 1}:
            raise AssertionError(f"zstd v1 (level {level}): launches "
                                 f"{launches[level]}")
        caps[level] = (c_p.calls[0], c_r.calls[0], c_f.calls[0])
        t0 = time.perf_counter()
        if Z.decompress(frame) != data:
            raise AssertionError(f"zstd v1 (level {level}): the frame does "
                                 "not decode to its input")
        sizes[level] = len(frame)
        _say(f"zstd v1, level {level}: {ZSTD_JOBS} jobs x {job} bytes, frame "
             f"{len(frame)} bytes (ratio {len(frame) / n:.6f}), first call "
             f"{call_s:.2f} s; launches {launches[level]}; decoded by the "
             f"port's host decoder to its input "
             f"({time.perf_counter() - t0:.2f} s)")
    if not sizes[3] <= sizes[2] <= sizes[1]:
        raise AssertionError(f"zstd v1 sizes not monotone in level: {sizes}")

    # the kernels against their plain versions on the path's own inputs
    (L_t, tile), rep_in, fse_in = caps[2]
    err_parse = _hold("tile_parse (v1, level 2)", lz2.tile_parse(L_t, tile),
                      lz2.tile_parse_ref(L_t, tile))
    err_rep = _hold("rep_scan (v1, level 2)", [zseqenc.rep_scan(*rep_in)],
                    [zseqenc.rep_scan_ref(*rep_in)])
    err_fse = _hold("fse_scan (v1, level 2)", zdev.fse_scan(*fse_in),
                    zdev.fse_scan_ref(*fse_in))
    syms, n_seqs = fse_in[0], fse_in[1]
    R, _, MS = syms.shape
    ns = n_seqs.to(torch.int64)
    sum_seqs, max_seqs = int(ns.sum()), int(ns.max())
    t = {"parse": cuda_ms(lambda: lz2.tile_parse(L_t, tile), 20),
         "rep": cuda_ms(lambda: zseqenc.rep_scan(*rep_in), 20),
         "fse": cuda_ms(lambda: zdev.fse_scan(*fse_in), 20)}
    dev_t = {"parse": cuda_ms(lambda: lz2.tile_parse(L_t, tile), 20, True),
             "rep": cuda_ms(lambda: zseqenc.rep_scan(*rep_in), 20, True),
             "fse": cuda_ms(lambda: zdev.fse_scan(*fse_in), 20, True)}
    plain = {"parse": cuda_ms(lambda: lz2.tile_parse_ref(L_t, tile), 2),
             "rep": cuda_ms(lambda: zseqenc.rep_scan_ref(*rep_in), 1),
             "fse": cuda_ms(lambda: zdev.fse_scan_ref(*fse_in), 1)}
    t_call = host_ms(lambda: zdevice.compress_device(data, engine="v1"), 2)
    _say_trace("zstd v1", lambda: zdevice.compress_device(data, engine="v1"))
    # bounds: the parse as in phase 25; the repeat scan as in phase 11 at
    # MS = 2,731; the FSE scan reads each live sequence's three codes and
    # the jobs' tables once and writes its two (R, 3, MS) outputs and the
    # final states once, 20 integer operations a sequence and stream.  The
    # chains are serial: the longest chain bounds them harder.
    nj = fse_in[2].shape[0]
    b_parse = bound(6 * L_t.numel(), 4 * L_t.numel())
    b_rep = bound(8 * sum_seqs + 4 * R + 4 * R * MS, 24 * sum_seqs)
    b_fse = bound(12 * sum_seqs + 4 * R + nj * 3 * (512 + 128) * 4
                  + 2 * 4 * R * 3 * MS + 12 * R, 60 * sum_seqs)
    _say(f"zstd v1 whole call (compress_device, engine v1, level 2, host "
         f"clock, median of 2): {t_call:.4f} ms "
         f"({n / (t_call * 1e-3) / 1e9:.4f} GB/s); sizes by level {sizes}")
    _say(f"zstd v1 kernels ({R} blocks, MS {MS}, sequences {sum_seqs}, "
         f"longest chain {max_seqs}; ms, CUDA events / device time / plain "
         f"/ bound): " + ", ".join(
             f"{k} {t[k]:.4f} / {dev_t[k]:.4f} / {plain[k]:.4f} / "
             f"{b[0]:.4f} ({b[1]})"
             for k, b in (("parse", b_parse), ("rep", b_rep),
                          ("fse", b_fse))))
    row = {"name": "fse_scan", "route": "cuda",
           "source": "compress_tpu_torch/csrc/zdevfse.cu",
           "replaces": "compress_tpu/ops/zdev.py:445",
           "launches": launches[2]["fse"], "max_abs_err": err_fse,
           "equal_to_plain": True, "ms": t["fse"], "plain_ms": plain["fse"],
           "bound_ms": b_fse[0], "bound_by": b_fse[1], "library_ms": None,
           "device_ms": dev_t["fse"], "longest_chain": max_seqs,
           "call_ms": t_call, "sizes_by_level": sizes}
    extra = {"parse": {"v1_launches": launches[2]["parse"],
                       "v1_max_abs_err": err_parse, "v1_ms": t["parse"],
                       "v1_device_ms": dev_t["parse"],
                       "v1_plain_ms": plain["parse"],
                       "v1_bound_ms": b_parse[0]},
             "rep": {"v1_launches": launches[2]["rep"],
                     "v1_max_abs_err": err_rep, "v1_ms": t["rep"],
                     "v1_device_ms": dev_t["rep"], "v1_plain_ms": plain["rep"],
                     "v1_bound_ms": b_rep[0], "v1_longest_chain": max_seqs}}
    return row, extra


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from compress_tpu_torch import _cuda, corpus
    from compress_tpu_torch.ops import lz2, lzemit2, lzkern
    from compress_tpu_torch.s2 import decode
    from compress_tpu_torch.utils.varint import put_uvarint

    # ---- 1. device ---------------------------------------------------------
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    _say(f"device: {kind} (count {count}); torch {torch.__version__}, "
         f"CUDA {torch.version.cuda}")
    _say(f"nvidia-smi: {smi}")

    # ---- 2. build ----------------------------------------------------------
    t0 = time.perf_counter()
    _cuda.library()
    build_s = time.perf_counter() - t0
    _say(f"build: {build_s:.1f} s -> {_cuda.build().name}")
    for line in (_cuda.BUILD_DIR / "ptxas.log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            _say("  ptxas:", line.strip())
    lib = _cuda.library()
    ctas = {"execute_pieces": lib.ct_exec_occupancy(512),
            "parse_blocks": lib.ct_parse_occupancy(),
            "emit_blocks": lib.ct_emit_occupancy(),
            "rep_scan": lib.ct_rep_occupancy(),
            "fse_chain": lib.ct_fse_occupancy(),
            "huff0_decode": lib.ct_huff0_occupancy(0),
            # the table engine's containers: 512 chunks of 32 symbols
            "huff0_decode_per_row": lib.ct_huff0_occupancy(512),
            "zseq_decode": lib.ct_zseq_occupancy(96),
            "zseq_decode_shared": lib.ct_zseq_occupancy(80),
            "execute_blocks_hist": lib.ct_exec_hist_occupancy()}
    _say("CTAs per SM (occupancy query; exec at M = 1): " + ", ".join(
             f"{k} {v}" for k, v in ctas.items()))
    if min(ctas.values()) < 1:
        raise AssertionError(f"a kernel cannot be resident: {ctas}")

    reset_route_counts()

    # ---- 3. corpus ---------------------------------------------------------
    blocks_np = corpus.corpus_blocks(N_BLOCKS, SEED)
    data = blocks_np.tobytes()
    dev = torch.device("cuda")
    blocks = torch.from_numpy(blocks_np).to(dev)
    _say(f"corpus: {N_BLOCKS} blocks, {len(data)} bytes, classes "
         f"{', '.join(corpus.CLASSES)} in turn (seed {SEED})")

    # ---- 4. finder kernel vs plain version ---------------------------------
    found = {}
    for slim in (False, True):
        got = lzkern.find_matches_blocks(blocks, slim=slim)
        want = lzkern.find_matches_blocks_ref(blocks, slim=slim)
        torch.cuda.synchronize()
        err = max_abs_err(got, want)
        same = all(torch.equal(a, b) for a, b in zip(got, want))
        _say(f"finder (slim={slim}) vs plain: bit-identical={same} "
             f"max_abs_err={err} matches={int((got[1] > 0).sum())}")
        if not same:
            raise AssertionError(f"finder kernel (slim={slim}) differs from "
                                 "its plain version")
        found[slim] = (got, err)
    off, L = found[False][0]

    # ---- 5. emit kernel vs plain version -----------------------------------
    panels = lzemit2.emit_blocks(blocks, off, L)
    want = lzemit2.emit_blocks_ref(blocks, off, L)
    torch.cuda.synchronize()
    emit_err = max_abs_err(panels, want)
    same = all(torch.equal(a, b) for a, b in zip(panels, want))
    _say(f"emit vs plain: bit-identical={same} max_abs_err={emit_err} "
         f"body bytes={int(panels[2].sum())}")
    if not same:
        raise AssertionError("emit kernel differs from its plain version")

    # ---- 6. main path ------------------------------------------------------
    lzkern.find_matches_blocks.launches = 0
    lzemit2.emit_blocks.launches = 0
    bodies = lz2.encode_blocks_np(data)
    torch.cuda.synchronize()
    launches = {"find": lzkern.find_matches_blocks.launches,
                "emit": lzemit2.emit_blocks.launches}
    _say(f"main path launches: finder {launches['find']}, "
         f"emit {launches['emit']}")
    if min(launches.values()) < 1:
        raise AssertionError(f"a kernel of the main path did not run: "
                             f"{launches}")
    if len(bodies) != N_BLOCKS:
        raise AssertionError(f"{len(bodies)} bodies for {N_BLOCKS} blocks")
    hdr = bytearray()
    put_uvarint(hdr, lz2.B)
    t0 = time.perf_counter()
    for i, body in enumerate(bodies):
        if decode(bytes(hdr) + body) != data[i * lz2.B:(i + 1) * lz2.B]:
            raise AssertionError(
                f"block {i} ({corpus.CLASSES[i % len(corpus.CLASSES)]}) "
                "does not decode to its input")
    ratio = sum(len(b) for b in bodies) / len(data)
    _say(f"decode: all {N_BLOCKS} bodies decode to their input "
         f"({time.perf_counter() - t0:.1f} s); ratio {ratio:.6f}")

    # ---- 7. times ----------------------------------------------------------
    nb = N_BLOCKS
    t_find = cuda_ms(lambda: lzkern.find_matches_blocks(blocks), 20)
    t_find_dev = cuda_ms(lambda: lzkern.find_matches_blocks(blocks), 20, True)
    t_find_slim = cuda_ms(
        lambda: lzkern.find_matches_blocks(blocks, slim=True), 20)
    t_emit = cuda_ms(lambda: lzemit2.emit_blocks(blocks, off, L), 20)
    t_emit_dev = cuda_ms(lambda: lzemit2.emit_blocks(blocks, off, L), 20,
                         True)
    p_find = cuda_ms(lambda: lzkern.find_matches_blocks_ref(blocks), 3)
    p_find_slim = cuda_ms(
        lambda: lzkern.find_matches_blocks_ref(blocks, slim=True), 3)
    p_emit = cuda_ms(lambda: lzemit2.emit_blocks_ref(blocks, off, L), 3)
    uniform = {}
    rng = np.random.default_rng([SEED, 7])
    for cls in UNIFORM_CLASSES:
        ub = torch.from_numpy(np.stack([corpus.make_block(cls, rng)
                                        for _ in range(nb)])).to(dev)
        err = max(_hold(f"finder ({cls} x {nb}, slim={slim})",
                        lzkern.find_matches_blocks(ub, slim=slim),
                        lzkern.find_matches_blocks_ref(ub, slim=slim))
                  for slim in (False, True))
        uniform[cls] = (cuda_ms(lambda: lzkern.find_matches_blocks(ub), 20),
                        err)
    t_path = host_ms(lambda: lz2.encode_blocks_np(data), 5)
    # the whole path's parts on the host clock: input to the card, the two
    # kernels, row assembly (selection on the card, D2H, split)
    t_h2d = host_ms(lambda: torch.frombuffer(
        bytearray(data), dtype=torch.uint8).view(-1, lz2.B).to(dev), 5)
    t_kern_host = host_ms(lambda: lzemit2.emit_blocks(
        blocks, *lzkern.find_matches_blocks(blocks)), 5)
    t_asm = host_ms(lambda: lzemit2.assemble_bodies(*panels), 5)
    gbps_path = len(data) / (t_path * 1e-3) / 1e9
    gbps_kern = len(data) / ((t_find + t_emit) * 1e-3) / 1e9
    _say(f"times (ms, {nb} blocks): finder {t_find:.4f} ({t_find_dev:.4f} "
         f"device time; slim "
         f"{t_find_slim:.4f}), emit {t_emit:.4f} ({t_emit_dev:.4f} device "
         f"time); plain finder "
         f"{p_find:.4f} (slim {p_find_slim:.4f}), plain emit {p_emit:.4f}")
    _say(f"finder by data (ms, {nb} blocks, cap 10): mixed corpus "
         f"{t_find:.4f}, " + ", ".join(f"all {k} {v[0]:.4f}"
                                       for k, v in uniform.items()))
    _say(f"whole path (host clock, ms): {t_path:.4f} = input to card "
         f"{t_h2d:.4f} + kernels {t_kern_host:.4f} + assembly {t_asm:.4f} "
         f"(parts timed apart)")
    _say(f"throughput: kernels {gbps_kern:.4f} GB/s, whole path "
         f"{gbps_path:.4f} GB/s")

    # ---- 8. trace of one main-path call ----------------------------------
    _say_trace("S2 encode", lambda: lz2.encode_blocks_np(data))

    # bounds: each input read once, each output written once; operations:
    # a comparison sort's n log2 n compares (finder), and a generous 64
    # integer operations per position for the emit stages
    blk_b = nb * lz2.B
    find_bytes = blk_b + 2 * 4 * blk_b                  # u8 in; off, L out
    emit_bytes = blk_b + 2 * 4 * blk_b + 2 * blk_b + nb * 512 * 4
    find_bound = bound(find_bytes, blk_b * 16)
    emit_bound = bound(emit_bytes, blk_b * 64)
    kernels = [
        {"name": "find_matches_blocks", "route": "cuda",
         "source": "compress_tpu_torch/csrc/lzkern.cu",
         "replaces": "compress_tpu/ops/lzkern.py:224",
         "launches": launches["find"], "max_abs_err": found[False][1],
         "equal_to_plain": True, "ms": t_find, "plain_ms": p_find,
         "bound_ms": find_bound[0], "bound_by": find_bound[1],
         "library_ms": None,
         "slim_ms": t_find_slim, "slim_plain_ms": p_find_slim,
         "slim_max_abs_err": found[True][1], "device_ms": t_find_dev,
         **{f"{k}_ms": v[0] for k, v in uniform.items()},
         **{f"{k}_max_abs_err": v[1] for k, v in uniform.items()}},
        {"name": "emit_blocks", "route": "cuda",
         "source": "compress_tpu_torch/csrc/lzemit.cu",
         "replaces": "compress_tpu/ops/lzemit2.py:102",
         "launches": launches["emit"], "max_abs_err": emit_err,
         "equal_to_plain": True, "ms": t_emit, "plain_ms": p_emit,
         "bound_ms": emit_bound[0], "bound_by": emit_bound[1],
         "library_ms": None, "device_ms": t_emit_dev,
         "ctas_per_sm": ctas["emit_blocks"]},
    ]

    zstd_kernels, zstd_find, zstd_launches = zstd_path(dev)
    kernels[0].update(zstd_find)
    kernels += zstd_kernels
    kernels.append(s2_decode_path(dev, data, bodies))
    for row in kernels:
        if row["name"] in ("parse_blocks", "execute_pieces", "rep_scan",
                           "fse_chain"):
            row["ctas_per_sm"] = ctas[row["name"]]
    kernels += huff0_path(dev, blocks_np)
    for row, key in zip(kernels[-2:], ("huff0_decode",
                                       "huff0_decode_per_row")):
        row["ctas_per_sm"] = ctas[key]
    zseq_rows, zdec, texts = zstd_decode_path(dev)
    hist_row, acc = accel_paths(dev, texts, ctas["execute_blocks_hist"])
    for row in kernels:
        if row["name"] == "execute_pieces":
            row.update(zdec["exec"], **acc["exec"])
        elif row.get("engine") == "table":
            row.update(zdec["huff0"], **acc["huff0"])
    zseq_rows[0].update(zdec["call"])
    for row, key in zip(zseq_rows, ("zseq_decode", "zseq_decode_shared")):
        row["ctas_per_sm"] = ctas[key]
    kernels += zseq_rows
    hist_row["accel_call"] = acc["accel_call"]
    kernels.append(hist_row)
    tail_path(zstd_launches)
    fse_rows, hist_numbers = fse_path(dev, blocks_np)
    fse_rows[0]["histograms"] = hist_numbers
    kernels += fse_rows
    kernels += checksum_path(blocks)
    kernels.append(s2_xla_path(dev, data, blocks, bodies))
    fse_scan_row, v1 = zstd_v1_path(dev)
    kernels[-1].update(v1["parse"])
    for row in kernels:
        if row["name"] == "rep_scan":
            row.update(v1["rep"])
    kernels.append(fse_scan_row)
    kernels += other_routes(dev, blocks_np, route_counts())

    _say(smi)
    _say(json.dumps({"kernels": kernels}))
    _say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
