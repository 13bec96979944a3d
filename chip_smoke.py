#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's device paths on one GPU.

Usage: ``python3 chip_smoke.py`` from the repository root, on a machine
with one CUDA card, ``nvcc`` and ``g++``.  It builds the host core from
``compress_tpu_torch/_native/src`` and the kernels from
``compress_tpu_torch/csrc`` and then drives the paths below.

Device S2 block encode, on a 16 MiB seeded corpus (256 blocks of 64 KiB
mixing every class of ``compress_tpu_torch.corpus``):

1. prints the device (name, count, ``nvidia-smi`` name and power limit);
2. builds the host core (``compress_tpu_torch/_native``: ``g++``) and
   prints its seconds, its compiler line, the machine, the compiler's
   version and whether it took the BMI2 flags; builds the kernels and
   prints the seconds it took, each kernel's
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
    encoder), and the histogram kernel's masked route on the literal
    stage's literals and ``is_lit``: bit-identical;
10. runs ``zstd.device.compress_device`` with the launch counters set to 0
    just before and read just after (the histogram kernel's too: the
    literal stage's per-block counts; and the two table builds', whose
    inputs it keeps for phase 32: the Huffman build once, the count
    normalisation once for each of the three code kinds), prints the frame size and ratio,
    walks the frame (magic, header, every block header, the last-block
    bit, regenerated sizes summing to the input) and decodes it with the
    port's host zstd decoder (``zstd.decompress``, timed), which must
    give the input back;
11. times each kernel, its plain version and the plain-PyTorch stages
    (long-range channel, codes, literal, pack) with CUDA events, the whole
    call on the host clock, and traces one call; prints the literal
    lookup's achieved GB/s beside its bound's, and times the finder, the
    parse, the literal lookup, ``torch.gather``, a fill of the lookup's
    two outputs alone (the card's write rate on them) and the masked
    histograms of the literals by device time too, and the repeat scan and the FSE chain by device time beside the
    longest chain; and prints the literal stage's split
    (``tools/tablebuild_ab.literal_split``: the masked histograms, the
    Huffman build, the canonical codes, ``_litlut``, ``_bitpack_rows``,
    and the split and bit-pack) by CUDA events.

Device batch decode of what the port encodes:

12. S2: plans the phase-6 bodies on the host (timed; every block must be
    plannable) into the compact plan (``execute.pack_pieces``) and holds
    the LZ execute kernel against its plain version on it;
13. runs ``s2.decode_blocks_device`` with the launch counter set to 0
    just before and read just after (one launch per arena class, no
    host-decoded block, every block equal to its input), times the kernel
    (also by device time), its plain version and the whole call, traces
    one call (up to three where the profiler records no device time), and
    prints the bytes the call copies to the card (the
    compact plan must stay under 0.1 GB) with the copy's device ms from
    the trace, and the kernel's bound on live pieces beside the bound of
    the earlier exec kernel, which read the padded plan;
14. huff0 4X, shared engine: 16 MiB of seeded text as 1024 rows of
    16 KiB, ``compress_4x_batch(shared_table=True, max_log=8)``; holds the
    chunk kernel against its plain version on the prepared windows, runs
    ``decompress_4x_batch`` with the launch counter (one launch, every row
    equal to its input; the encode's one launch of the histogram kernel
    counted too, and the Huffman build's: one launch, its counts kept for
    phase 32) and times encode, prep, kernel (also by device time, and
    with no symbols to decode) and call;
15. huff0 4X, table engine (one table per container): the phase-3 corpus
    as 1024 rows of 16 KiB at ``max_log=11``, the same checks and times.

Batched zstd frame decode (``zstd.device_dec.decompress_frames_device``):

16. frames: 128 seeded ``text`` blocks of 64 KiB, 64 encoded by the port's
    host encoder (``zstd.encoder.compress``, level 1: the host core's
    ladder) with its own table
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
    the huff0 chunk, sequence and execute kernels; the host-decoded
    frames exactly those ``_route`` sends to the host, the 3 among them;
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
    its stages and traces one call (up to three, as phase 13);
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
    and traces one call (up to three, as phase 13).

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
    counter (one launch, and one of the count normalisation, whose counts
    phase 32 keeps; prints the None rows and the ratio); adds 4 host
    ``fse.compress(table_log=11)`` containers; times ``make_accel`` (the
    first 256 rows only if the whole walk would take over 90 s); holds the
    chunk decode (``csrc/fsedec.cu``) against its plain version on the
    prepared windows, with its routes (the chunks of tiles with no pair to
    decode, which must be the rows sent elsewhere, and the chunks walked);
    runs ``fse.decompress_batch`` with the counters (one launch, exactly
    the 4 log-11 containers on the host, every row equal to its input);
    times both kernels (also by device time), their plain versions,
    ``fse_encode_blocks`` and both whole calls, and traces one call of
    each (the decode's up to three times where the profiler records no
    device time); holds the histogram kernel (``csrc/histogram.cu``:
    ``byte_histograms`` and ``histogram256_torch``) against both plain
    versions and ``torch.bincount``, counts its launch in
    ``compress_batch`` (one), and times it (also by device time) on the
    1024 rows, on 1024 rows each of ``zeros``, ``rand4`` and ``rand256``
    alone, on the 1024 rows under a random and a prefix mask (the masked
    route, held against ``byte_histograms_ref`` too), and on the 16 MiB
    beside ``torch.bincount``, with the bound, and prints the per-row
    launch's threads, registers and shared bytes a CTA and its CTAs an SM
    (the occupancy query, ``ct_histogram_info``);
24. CRC-32C and xxHash64 (``csrc/checksum.cu``) of the phase-3 corpus (256
    rows of 64 KiB): holds ``crc32c_batch`` (whole rows and 65536 - 4097
    bytes) and ``xxh64_batch`` (seeds 0 and 2^64 - 1) against their plain
    versions and 8 rows against the host ``crc32c`` / ``xxh64``; one call
    of each with the launch counters; times both kernels (also by device
    time) and their plain versions, with their bounds; builds
    ``checksum.cu`` with ``-DCT_XXH64_CLOCK -DCT_CRC32C_CLOCK``
    (``tools/checksum_clock.py``) and prints xxHash64's cycles a round on
    its chain and the chain's floor beside the byte bound, and CRC-32C's
    cycles a CTA by part (table copy, walk, combine) beside its device
    time.

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
    path's; prints the tile parse's routes (the tiles on its warp and
    chunked routes), CTAs an SM and registers at tiles 512 and 256, and
    times it there (also by device time) beside its plain version and its
    bound; times the whole call (host clock, median of 3), and traces one
    call;
26. the zstd v1 engine (``ops/zdev.zstd_encode_jobs``) through
    ``compress_device(engine="v1")`` on ``corpus.replica_jobs(8, 1 MiB)``
    (one launch of 8 jobs, 512 blocks of 16 KiB) at levels 1, 2 and 3,
    with the launch counters set to 0 just before each call and read just
    after (one launch each of the tile parse, the repeat scan, the FSE
    scan, ``csrc/zdevfse.cu``, and the histogram kernel on the literals;
    one of the Huffman build and three of the count normalisation, whose
    counts phase 32 keeps);
    every frame decodes with the port's host
    decoder to its input and the sizes are monotone (level 3 <= 2 <= 1);
    holds the three kernels and the histogram kernel's masked route against
    their plain versions on the level-2 call's own inputs (the
    histogram's timed by device time too); prints the routes (tiles of the parse; rows of the
    FSE scan on its one-load and exact steps), CTAs an SM and registers of
    the parse and the FSE scan; times the three (also by device time),
    their plain versions and the whole call (host clock, median of 2) with
    their bounds and the longest chain, and traces one call.

The per-row table builds (``csrc/tablebuild.cu``), after phase 26:

32. holds the Huffman code-length build (``ops/zdev._huff_build``, row
    b) and the FSE count normalisation (``_normalize_count``, row c)
    against their plain versions on every input their paths called them
    with (phases 10, 14-15, 23 and 26, captured on the way), bit for bit;
    times each path's largest input by CUDA events and device time beside
    the plain version, with the bound and the serial walk (each row's
    walk steps and SM cycles from the kernels' ``stats``: the longest
    walk, the cycles a step and their product at the SM's largest clock)
    and beside a launch's floor (the device time of a one-element fill);
    prints the launches on each path and the registers and CTAs an SM of
    both kernels.

The block-parallel engine (``compress_tpu_torch/parallel``), after the
paths above:

27. one rank over NCCL (``init_process_group("nccl")`` at world size 1
    through a ``file://`` rendezvous): ``encode_blocks_sharded`` and
    ``encode_step_stats`` of the phase-3 corpus (equal to
    ``s2_encode_blocks``; the total is the lengths' sum);
    ``s2_stream_encode_device`` of the corpus and a 12,345-byte tail,
    read back to the input by the port's S2 ``Reader`` (each chunk's
    masked CRC-32C checked, no chunk over 64 KiB);
    ``zstd_encode_sharded`` of the phase-26 jobs and a 300,001-byte tail, equal to
    ``compress_device(engine="v1", level=2)`` byte for byte (its halo,
    encode, assembly and gather times, and one trace with its idle
    share); ``zstd_decode_sharded`` of phase 20's and 21's items and of
    16 of phase 16's plain frames, and ``decode_blocks_device`` of 32 of
    phase 6's bodies with the mesh, each equal to the unsharded call's
    output.  Each call runs with the launch counters of rows 6, 9-12, 17,
    18, b and c set to 0 just before and read just after; each of those
    kernels must launch.  Prints each sharded call's host-clock time
    beside the unsharded call's;
28. two gloo ranks (spawned processes, ``parallel.launch.run_ranks``)
    whose kernels both run on ``cuda:0``, the collectives through host
    tensors: ``zstd_encode_sharded`` of 4 jobs of 1 MiB and a tail (both
    ranks' frames equal ``compress_device(engine="v1")``'s; rank 1
    received the last 128 KiB of job 1), ``encode_step_stats`` of 64
    blocks, ``zstd_decode_sharded`` of 33 of phase 20's items (the
    padding path) and ``parallel.dryrun.dryrun_multichip``; prints each
    rank's times and launches (each rank's zstd call must launch the tile
    parse, the repeat scan, the FSE scan and the two table builds).  Both phases' numbers are printed as one
    ``{"sharded": ...}`` line before the kernels line.

The host core (``compress_tpu_torch/_native``), after phase 26:

29. holds each native entry against its plain Python version on this
    machine's host, with both times (host clock): the S2 plans of phase
    6's bodies (``native_plan`` / ``s2.plan.build_plan``, payload for
    payload); the sidecar payloads of 8 of phase 20's frames
    (``accel.sidecar_payload`` / ``sidecar.build_payload``); CRC-32C and
    xxHash64 of the phase-3 corpus, whole and as 256 rows (the rows also
    equal to ``crc32c_batch`` / ``xxh64_batch`` on the card); the host
    decode of phase 10's frame (``zstd.decompress`` / ``decompress_py``);
    ``zstd.compress`` at levels 1-4 on 8 of the text blocks, its frames
    decoded by the Python decoder (beside the ``Matcher``'s,
    ``compress_matcher``); job assembly on phase 26's first job
    (``device._assemble_job`` / ``_assemble_job_py``).

The stream tier (``s2/stream.py``, ``index.py``, ``seek.py``,
``zstd/stream.py``, ``zstd/dict.py``, ``zstd/snappy_convert.py``: host
code around device-made data), after phase 19:

30. ``parallel.s2_stream_encode_device`` of the phase-3 corpus and a
    12,345-byte tail (one rank: the tile parse and the XLA engine's
    stages on the card), read back by the port's S2 ``Reader``, indexed
    by ``index_stream`` and seeked by ``ReadSeeker`` at 8 seeded offsets
    (4 KiB each); its compressed 64 KiB chunks (whole S2 blocks) through
    ``s2.decode_blocks_device``, equal to the Reader's chunks; the S2
    ``Writer(add_index=True)`` at levels 1-3 with 1 and 4 workers (equal
    bytes, read back); ``compress_device`` (v2) of 8 jobs of 1 MiB read
    by the zstd ``Reader`` in 1 MiB steps; the zstd ``Writer`` at levels
    1-4 with checksums and once with a dictionary that ``build_dict`` made
    from 32 seeded 4 KiB samples, each read back by the ``Reader``, by
    ``decompress(dicts=...)`` and (the four without a dictionary, with the
    device frames) by ``decode_concurrent``; ``snappy_convert.convert`` of
    a snappy-mode S2 stream of 4 MiB, decoded by ``zstd.decompress``.
    Prints each call's host seconds and bytes and the launches it made
    (counters set to 0 just before and read just after, under the
    kernels line's names: the tile parse, the execute and the v2
    kernels, each must launch), and one ``{"stream_tier": ...}`` line
    before the kernels line.  It adds no kernel.

The deflate family and the applications (``flate``, ``gzip``, ``zlib``,
``zip``, ``gzhttp``, ``cli``, ``dictbuilder``, ``estimate``: host code on
the host core around device-made data), after phase 30:

31. ``s2c -device -index`` of the phase-3 corpus as a file (the parallel
    engine on the card: the tile parse), read back by ``s2d`` and by
    ``s2d -offset`` at 4 seeded offsets; ``s2sx`` of its first 4 MiB,
    the extractor run in a subprocess; ``zstdio -accel`` of 128 text
    blocks (8 MiB), its items through ``decompress_frames_device`` (every
    route ``accel``, no host walk, no host frame: the huff0 chunk and
    execute kernels), read back by ``zstdio -d``; ``deflate`` of the
    corpus at levels 1, 6 and 9 read back by the port's ``inflate`` and by
    stdlib ``zlib``; the gzip and zlib ``Writer`` and ``Reader`` on the
    corpus and a one-shot ``gzip.decompress`` of 1 MiB (the Python
    inflater, as in the reference); a zip archive of the device-made
    ``.s2`` stream as deflate, zstd and stored entries, a zstd entry that
    ``compress_device`` made (its v2 kernels, the finder among them) and
    an entry of a method registered for the run whose compressor is the
    device S2 block encoder (finder and emit) and whose decompressor is
    ``decode_blocks_device`` (execute), read by the port's ``zip.Reader``
    and (deflate and stored) by stdlib ``zipfile``; ``gzhttp`` serving a
    4 MiB body with gzip and with zstd, decoded by ``Transport``;
    ``estimate`` and ``shannon_entropy_bits`` of each corpus class; raw
    and zstd dictionaries from 32 seeded 4 KiB text samples, used by a
    zstd frame.  Prints each call's host seconds and bytes and the
    launches under the phase (counters set to 0 just before and read just
    after, under the kernels line's names; the finder, emit, tile parse,
    execute and huff0 chunk kernels must each launch), and one
    ``{"deflate_tier": ...}`` line before the kernels line.  It adds no
    kernel.

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
also carry their phase-26 numbers as ``v1_*``, and the rows of the
sharded paths' kernels their phase-27 launches as ``sharded_launches``).
Every comparison is exact (tolerance 0: all outputs are integers or
bytes).  Any failure raises and the exit code is not 0.  The last line
of standard output is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import concurrent.futures
import ctypes
import io
import json
import multiprocessing
import os
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

REPO = pathlib.Path(__file__).resolve().parent
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
DEC_TILE = 256         # phase 23: chunks a CTA of the chunk decode
ACCEL_CUT_S = 90       # phase 23: make_accel's estimated seconds allowed
HIST_CLUSTERS = (1, 8, 16)  # phase 21: cluster sizes of the history execute
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
    events = prof.events()
    for e in events:
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.device_time_total / 1e3)
    trace_path.events = len(events)     # all the profiler recorded
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


def _say_trace(what: str, fn, warm: bool = True, every_name: bool = False,
               tries: int = 1):
    """Print one traced call's device busy time, idle share and largest
    items (every item with ``every_name``); return the device ms of its
    copies to the card (None when the profiler recorded no device
    time).  A call whose trace holds no device time is traced again, up
    to ``tries`` calls (``PERF.md`` §7: the profiler sometimes keeps a
    trace's CPU events and loses its device events)."""
    for _ in range(tries):
        busy, wall, by_name = trace_path(fn, warm)
        if busy > 0:
            h2d = sum(v for k, v in by_name if "HtoD" in k)
            _say(f"{what} trace: device busy {busy:.4f} ms of {wall:.4f} ms "
                 f"wall, idle share {1 - busy / wall:.4f}; copies to the "
                 f"card {h2d:.4f} ms; by name (ms): " + ", ".join(
                     f"{k[:60]} {v:.4f}"
                     for k, v in (by_name if every_name else by_name[:8])))
            return h2d
        _say(f"{what} trace: the profiler recorded no device time "
             f"({trace_path.events} events in all; not measured)")
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
    """Phases 9-11: the zstd v2 path.  Returns its kernels' JSON entries,
    the finder's numbers on this path (launches, times, error), the
    launches, the histogram kernel's masked numbers on its literals, and
    the frame with its input (for phase 29)."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch import zstd as Z
    from compress_tpu_torch.ops import lzkern, zenc2, zparse, zseqenc
    from compress_tpu_torch.tools import tablebuild_ab as TB
    from compress_tpu_torch.utils import histogram as H
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
    lit_tabs = zenc2._literal_tables(lits, lit_cnt, blk)
    is_lit, packed = lit_tabs[0], lit_tabs[4]
    hold("litlut", zenc2._litlut(lits, packed),
         zenc2._litlut_ref(lits, packed))
    hold("byte_histograms (masked: literals, is_lit)",
         [H.byte_histograms(lits, is_lit)],
         [H.byte_histograms_ref(lits, is_lit)])
    ns = n_seqs.to(torch.int64)
    sum_seqs, max_seqs = int(ns.sum()), int(ns.max())
    _say(f"zstd intermediates: {R} blocks, sequences {sum_seqs} (longest "
         f"chain {max_seqs}), literals {int(lit_cnt.sum())}; the long-range "
         f"channel won over the finder at {int(use.sum())} positions")

    # ---- 10. main path ------------------------------------------------------
    counted = {"find": lzkern.find_matches_blocks,
               "parse": zparse.parse_blocks, "rep": zseqenc.rep_scan,
               "fse": zseqenc.fse_chain, "litlut": zenc2._litlut,
               "hist": H.byte_histograms}
    for f in counted.values():
        f.launches = 0
    t0 = time.perf_counter()
    with _TableCapture("zstd_v2") as tables:
        frame = zdevice.compress_device(data, job=job)
        torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    launches = {k: f.launches for k, f in counted.items()}
    launches.update(tables.run["launches"])
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
        "hist": cuda_ms(lambda: H.byte_histograms(lits, is_lit), 20, True),
    }
    hist_plain = cuda_ms(lambda: H.byte_histograms_ref(lits, is_lit), 3)
    del fill
    split = TB.literal_split(lits, lit_cnt, blk)
    TABLE_RUNS["zstd_v2"]["literal_split"] = split
    t_call = host_ms(lambda: zdevice.compress_device(data, job=job), 3)
    _say(f"zstd kernel times (ms, {R} blocks): " + ", ".join(
        f"{k} {v:.4f} (plain {plain[k]:.4f})" for k, v in t.items())
        + f"; torch.gather for litlut {lib_litlut:.4f}")
    _say("zstd stage times (ms, CUDA events): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stages.items()))
    _say(f"zstd literal stage split ({R} blocks; ms, CUDA events, "
         f"tools/tablebuild_ab.literal_split): " + ", ".join(
             f"{k} {v:.4f}" for k, v in split.items()))
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
         f"two outputs alone {dev_t['fill']:.4f} device time; masked "
         f"byte_histograms of the literals ({R} rows of {blk}, "
         f"{int(lit_cnt.sum())} bytes counted) {dev_t['hist']:.4f} device "
         f"time (plain {hist_plain:.4f})")
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
    # the histogram kernel's masked route on the literal stage's inputs
    hist = {"v2_masked_max_abs_err":
            errs["byte_histograms (masked: literals, is_lit)"],
            "v2_masked_device_ms": dev_t["hist"],
            "v2_masked_plain_ms": hist_plain, "v2_masked_rows": R}
    return out, find, launches, hist, (frame, data)


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
                        lambda: device_dec.decode_blocks_device(blocks),
                        tries=3)
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
    from compress_tpu_torch.utils import histogram as H

    row = 16 << 10
    rng = np.random.default_rng(SEED)
    text = np.concatenate([corpus.make_block("text", rng)
                           for _ in range(N_BLOCKS)]).reshape(-1, row)
    engines = {"shared": (text, True, 8), "table": (
        blocks_np.reshape(-1, row), False, 11)}
    out = []
    for engine, (rows, shared, max_log) in engines.items():
        n_in = rows.size
        H.byte_histograms.launches = 0
        t0 = time.perf_counter()
        with _TableCapture(f"huff0_{engine}") as tables:
            conts, accel = huff0.compress_4x_batch(
                rows, return_accel=True, shared_table=shared,
                max_log=max_log)
            torch.cuda.synchronize()
        t_enc = (time.perf_counter() - t0) * 1e3
        hist_launches = H.byte_histograms.launches
        huff_launches = tables.run["launches"]["huff"]
        if hist_launches != 1 or huff_launches != 1:
            raise AssertionError(f"huff0 {engine} encode: {hist_launches} "
                                 "launches of the histogram kernel, "
                                 f"{huff_launches} of the Huffman build")
        kept = [i for i, c in enumerate(conts) if c is not None]
        ratio = sum(len(conts[i]) for i in kept) / (len(kept) * row)
        _say(f"huff0 {engine}: {len(rows)} rows of {row} bytes ({n_in} "
             f"bytes, max_log {max_log}); {len(rows) - len(kept)} rows None; "
             f"ratio of the others {ratio:.6f}; encode {t_enc:.1f} ms "
             f"(host clock, first call), histogram launches {hist_launches}"
             f", Huffman build launches {huff_launches}")
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
            "ratio": ratio, "histogram_launches": hist_launches})
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
    kernel's JSON entries (per-item and shared table), this path's
    numbers for the huff0 and exec rows, the text inputs, and 16 of the
    plain frames with their inputs (for phase 27)."""
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
    want_host = sum(DD._route(f)[0] == "host" for f in frames)
    if any(v != 1 for v in launches.values()) or host_frames != want_host \
            or want_host < len(host_data):
        raise AssertionError(f"zstd decode: launches {launches}, host frames "
                             f"{host_frames} (routed to the host: "
                             f"{want_host})")
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
    return rows_out, extra, text_data, (frames[:16], datas[:16])


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
    h2d = _say_trace(what, lambda: DD.decompress_frames_device(items),
                     warm=False, every_name=True, tries=3)
    return {"call_ms": t_call, "calls_ms": times, "stages_s": stats["s"],
            "h2d_ms": h2d}


def accel_paths(dev, texts, ctas: int) -> tuple:
    """Phases 20-21: the accel and multi-block accel routes (``ctas``: the
    history kernel's CTAs per SM, from phase 2).  Returns the history
    kernel's JSON entry, the launches and call numbers of both routes,
    and their items, inputs and whole-call milliseconds (for phase
    27)."""
    from compress_tpu_torch import _cuda, corpus
    from compress_tpu_torch.ops import execute as X
    from compress_tpu_torch.ops.exec_kern import HIST_CLUSTER
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
    items = items20 = [it for b in blobs for it in AC.split_stream_accel(b)]
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
    want = X.execute_blocks_hist_ref(*hargs, hb * 512)
    err = _hold("execute_blocks_hist",
                [X.execute_blocks_hist(*hargs, hb * 512)], [want])
    t_k = cuda_ms(lambda: X.execute_blocks_hist(*hargs, hb * 512), 20)
    t_dev = cuda_ms(lambda: X.execute_blocks_hist(*hargs, hb * 512), 20,
                    True)
    t_plain = cuda_ms(lambda: X.execute_blocks_hist_ref(*hargs, hb * 512),
                      1)
    # every cluster size measured: the kernel's choice, one CTA a frame
    # (the old walk's shape) and the portable and non-portable maxima
    lib = _cuda.library()
    by_c = {}
    for C in HIST_CLUSTERS:
        _hold(f"execute_blocks_hist (cluster {C})",
              [X.execute_blocks_hist(*hargs, hb * 512, cluster=C)], [want])
        by_c[C] = {"device_ms": cuda_ms(
            lambda C=C: X.execute_blocks_hist(*hargs, hb * 512, cluster=C),
            20, True), "ctas_per_sm": lib.ct_exec_hist_occupancy(C),
            "max_active_clusters": lib.ct_exec_hist_clusters(C)}
        _say(f"history execute, cluster of {C} CTAs: device time "
             f"{by_c[C]['device_ms']:.4f} ms, CTAs per SM "
             f"{by_c[C]['ctas_per_sm']}, cudaOccupancyMaxActiveClusters "
             f"{by_c[C]['max_active_clusters']}")
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
         f"bytes read, {B_} frames x {K_} blocks, {gstart.shape[2] - 1} "
         f"groups a block; kernel (cluster of {HIST_CLUSTER}) {t_k:.4f} ms "
         f"(device time {t_dev:.4f}), plain {t_plain:.4f} ms, bound "
         f"{b[0]:.4f} ms ({b[1]}), CTAs per SM {ctas}, "
         f"cudaOccupancyMaxActiveClusters "
         f"{by_c[HIST_CLUSTER]['max_active_clusters']}, launches on the "
         f"path {l21['exec_hist']}")
    call21 = _call_times(items, n_out, "multi-block decode")
    row = {"name": "execute_blocks_hist", "route": "cuda",
           "source": "compress_tpu_torch/csrc/exec.cu",
           "replaces": "compress_tpu/ops/execute.py:414",
           "replaces_kind": "XLA lax.scan (no Pallas site)",
           "launches": l21["exec_hist"], "max_abs_err": err,
           "equal_to_plain": True, "ms": t_k, "device_ms": t_dev,
           "plain_ms": t_plain, "bound_ms": b[0], "bound_by": b[1],
           "library_ms": None, "ctas_per_sm": ctas,
           "cluster": HIST_CLUSTER, "clusters": by_c,
           "groups": int(gstart.shape[2] - 1),
           "pieces": int(len(pieces)), "history_pieces": int(hist.sum()),
           "history_bytes": hist_bytes, "frames": B_, "blocks": K_,
           "hist_blocks": hb, "call": call21, "first_s": first21}
    extra = {"huff0": {"accel_launches": l20["huff0"],
                       "accel_mb_launches": l21["huff0"]},
             "exec": {"accel_launches": l20["exec"]},
             "accel_call": {**call20, "first_s": first20}}
    items = {"items20": items20, "texts": texts, "items21": items,
             "streams": streams, "accel_ms": call20["call_ms"],
             "accel_mb_ms": call21["call_ms"]}
    return row, extra, items


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
    from compress_tpu_torch.ops import lzkern, zdev, zenc2, zparse, zseqenc
    from compress_tpu_torch.utils import histogram as H
    from compress_tpu_torch.zstd import device as zdevice

    counted = {"find": lzkern.find_matches_blocks,
               "parse": zparse.parse_blocks, "rep": zseqenc.rep_scan,
               "fse": zseqenc.fse_chain, "litlut": zenc2._litlut,
               "hist": H.byte_histograms, "huff": zdev._huff_build,
               "norm": zdev._normalize_count}
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


def fse_path(dev, blocks_np) -> list:
    """Phase 23: the FSE batch codec on the phase-3 corpus as 1024 rows of
    16 KiB.  Returns the two FSE kernels' JSON entries and the histogram
    kernel's two (per-row and whole-input)."""
    from compress_tpu_torch import corpus, fse
    from compress_tpu_torch.ops import entropy as E
    from compress_tpu_torch.ops import entropy_dec as ED
    from compress_tpu_torch.utils import histogram as H

    row = 16 << 10
    rows = blocks_np.reshape(-1, row)
    N = len(rows)
    t = torch.from_numpy(rows).to(dev)
    # kernel 1 against its plain version on the path's own tables
    hist = E.byte_histograms(t)
    st, dnb, dfs, _ = E._fse_tables_bytes(hist, E.FSE_LOG)
    chain_in = (t, st, dnb, dfs)
    routes = torch.zeros(2, dtype=torch.int32, device=dev)
    chain_out = E.fse_encode_chain(*chain_in, routes=routes)
    err_enc = _hold(f"fse_encode_chain ({N} rows of {row})", chain_out,
                    E.fse_encode_chain_ref(*chain_in))
    routes = routes.tolist()
    _say(f"fse_encode_chain routes: {routes[0]} rows on the one-load step, "
         f"{routes[1]} on the exact step")
    E.fse_encode_chain.launches = H.byte_histograms.launches = 0
    t0 = time.perf_counter()
    with _TableCapture("fse_batch") as tables:
        conts = fse.compress_batch(rows)
        torch.cuda.synchronize()
    enc_first = (time.perf_counter() - t0) * 1e3
    enc_launches = E.fse_encode_chain.launches
    hist_launches = H.byte_histograms.launches
    norm_launches = tables.run["launches"]["norm"]
    if enc_launches != 1 or hist_launches != 1 or norm_launches != 1:
        raise AssertionError(f"compress_batch: {enc_launches} launches of "
                             f"the chain, {hist_launches} of the histogram, "
                             f"{norm_launches} of the normalisation")
    kept = [i for i, c in enumerate(conts) if c is not None]
    ratio = sum(len(conts[i]) for i in kept) / (len(kept) * row)
    t0 = time.perf_counter()
    host11 = [fse.compress(rows[i].tobytes(), table_log=11)
              for i in range(FSE_HOST_LOG11)]
    host_s = time.perf_counter() - t0
    _say(f"FSE compress_batch: {N} rows of {row} bytes, launches "
         f"{enc_launches} (histogram {hist_launches}, normalisation "
         f"{norm_launches}); {N - len(kept)} rows "
         f"None; ratio of the others "
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
    dec_routes = torch.zeros(2, dtype=torch.int32, device=dev)
    err_dec = _hold(f"fse_decode_chunks ({arrays[0].shape[0]} x "
                    f"{arrays[0].shape[1]} chunks)", ED.fse_decode_chunks(
                        *args, routes=dec_routes),
                    ED.fse_decode_chunks_ref(*args))
    # a CTA of DEC_TILE chunks whose chunks all have npair 0 takes the dead
    # route; here those are the rows the batch sends elsewhere
    npair = arrays[4]
    C = npair.shape[1]
    dead_rows = int((npair.max(axis=1) == 0).sum())
    want_dead = sum(min(DEC_TILE, C - c0) for row in npair
                    for c0 in range(0, C, DEC_TILE)
                    if row[c0:c0 + DEC_TILE].max() == 0)
    dec_routes = dec_routes.tolist()
    _say(f"fse_decode_chunks routes: {dec_routes[0]} chunks on the dead "
         f"route ({dead_rows} rows with no pair to decode, {want_dead} "
         f"chunks in tiles with none), {dec_routes[1]} walked")
    if dec_routes != [want_dead, npair.size - want_dead]:
        raise AssertionError(f"fse_decode_chunks routes {dec_routes}")
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
    # each class's rows (block i of the corpus is class i mod 8) as a
    # launch of their own, equal to their rows of the whole launch
    per_class = {}
    cls = (torch.arange(N, device=dev) // (N // len(blocks_np))) % len(
        corpus.CLASSES)
    for c, name in enumerate(corpus.CLASSES):
        idx = torch.nonzero(cls == c)[:, 0]
        sub = [a.index_select(0, idx).contiguous() for a in chain_in]
        _hold(f"fse_encode_chain ({name} rows alone)",
              E.fse_encode_chain(*sub), [a.index_select(0, idx)
                                         for a in chain_out])
        per_class[name] = cuda_ms(lambda sub=sub: E.fse_encode_chain(*sub),
                                  10, True)
    _say(f"fse_encode_chain device time of each class's {N // 8} rows as a "
         f"launch of their own (ms): " + ", ".join(
             f"{k} {v:.4f}" for k, v in per_class.items())
         + f"; the whole launch {t_enc_dev:.4f} ms, "
         f"{t_enc_dev * 1e6 / (row // 2 - 1):.2f} ns a step")
    t_dec = cuda_ms(lambda: ED.fse_decode_chunks(*args), 20)
    t_dec_dev = cuda_ms(lambda: ED.fse_decode_chunks(*args), 20, True)
    p_dec = cuda_ms(lambda: ED.fse_decode_chunks_ref(*args), 2)
    t_blocks = cuda_ms(lambda: E.fse_encode_blocks(t), 3)
    enc_call = host_ms(lambda: fse.compress_batch(rows), 2)
    dec_call = host_ms(lambda: fse.decompress_batch(decode, accel=accel), 2)
    # the histogram kernel: both entries against their plain versions and
    # torch.bincount, on the rows and on 1024 rows of each of a one-value,
    # a four-value and a random class alone (the contention cases)
    flat = t.reshape(-1)
    err_rows = _hold(f"byte_histograms ({N} rows of {row})",
                     [E.byte_histograms(t)], [E.byte_histograms_ref(t)])
    err_whole = _hold(f"histogram256_torch ({flat.numel()} bytes)",
                      [H.histogram256_torch(flat)],
                      [H.histogram256_torch_ref(flat)])
    if not torch.equal(H.histogram256_torch(flat),
                       torch.bincount(flat, minlength=256).to(torch.int32)):
        raise AssertionError("histogram256_torch differs from torch.bincount")
    rng = np.random.default_rng([SEED, 23])
    alone = {}
    for cls in UNIFORM_CLASSES:
        ct = torch.from_numpy(np.stack([corpus.make_block(cls, rng) for _ in
                                        range(len(blocks_np))]).reshape(
                                            -1, row)).to(dev)
        err_rows = max(err_rows, _hold(
            f"byte_histograms ({cls} x {N} rows)", [E.byte_histograms(ct)],
            [E.byte_histograms_ref(ct)]))
        alone[cls] = cuda_ms(lambda ct=ct: E.byte_histograms(ct), 20, True)
    # the masked route on the same rows: a random mask and a prefix mask
    masks = {"random": torch.from_numpy(rng.random(t.shape) < 0.5).to(dev),
             "prefix": (torch.arange(row, device=dev)[None, :]
                        < torch.from_numpy(rng.integers(
                            0, row + 1, (N, 1))).to(dev))}
    masked = {}
    for kind, m in masks.items():
        err_rows = max(err_rows, _hold(
            f"byte_histograms ({N} rows, {kind} mask)",
            [E.byte_histograms(t, m)], [E.byte_histograms_ref(t, m)]))
        masked[kind] = cuda_ms(lambda m=m: E.byte_histograms(t, m), 20, True)
    h_ms = cuda_ms(lambda: H.histogram256_torch(flat), 20)
    h_dev = cuda_ms(lambda: H.histogram256_torch(flat), 20, True)
    h_plain = cuda_ms(lambda: H.histogram256_torch_ref(flat), 3)
    lib_ms = cuda_ms(lambda: torch.bincount(flat, minlength=256), 20)
    lib_dev = cuda_ms(lambda: torch.bincount(flat, minlength=256), 20, True)
    rows_ms = cuda_ms(lambda: E.byte_histograms(t), 20)
    rows_dev = cuda_ms(lambda: E.byte_histograms(t), 20, True)
    rows_plain = cuda_ms(lambda: E.byte_histograms_ref(t), 3)
    threads, ctas, regs, regs_m, smem, held = _kernel_info(
        "ct_histogram_info", N, row, n=6)
    h_info = {"threads": threads, "ctas_per_sm": ctas, "registers": regs,
              "registers_masked": regs_m, "smem_bytes": smem,
              "ctas_at_once": held}

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
    # the histograms read each byte once and write the counts; one
    # operation a byte
    b_hist = bound(flat.numel() + 256 * 4, flat.numel())
    b_rows = bound(flat.numel() + N * 256 * 4, flat.numel())
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
    _say(f"histogram kernel (ms, CUDA events): per-row byte_histograms "
         f"({N} rows of {row}) {rows_ms:.4f} ({rows_dev:.4f} device time; "
         f"plain {rows_plain:.4f}), bound {b_rows[0]:.4f} ({b_rows[1]}); "
         f"device time of {N} rows of one class alone: " + ", ".join(
             f"{k} {v:.4f}" for k, v in alone.items())
         + f"; device time of the {N} rows masked (the masked route): "
         + ", ".join(f"{k} {v:.4f}" for k, v in masked.items())
         + f"; histogram256_torch of {flat.numel()} bytes {h_ms:.4f} "
         f"({h_dev:.4f} device time; plain {h_plain:.4f}), torch.bincount "
         f"{lib_ms:.4f} ({lib_dev:.4f} device time), bound {b_hist[0]:.4f} "
         f"({b_hist[1]}); the per-row launch: {threads} threads, {regs} "
         f"registers ({regs_m} masked), {smem} shared bytes a CTA, {ctas} "
         f"CTAs an SM ({held} at once on the card)")
    _say_trace("FSE encode", lambda: fse.compress_batch(rows))
    _say_trace("FSE decode", lambda: fse.decompress_batch(decode, accel=accel),
               warm=False, tries=3)
    common = {"route": "cuda", "library_ms": None, "equal_to_plain": True}
    return [
        {"name": "fse_encode_chain", **common,
         "source": "compress_tpu_torch/csrc/fseenc.cu",
         "replaces": "compress_tpu/ops/entropy.py:223",
         "launches": enc_launches, "max_abs_err": err_enc, "ms": t_enc,
         "plain_ms": p_enc, "bound_ms": b_enc[0], "bound_by": b_enc[1],
         "device_ms": t_enc_dev, "rows": N, "row_bytes": row,
         "class_device_ms": per_class, "routes": {"one_load": routes[0],
                                                  "exact": routes[1]},
         "chain_steps": row // 2 - 1, "none_rows": N - len(kept),
         "ratio": ratio, "call_ms": enc_call, "first_call_ms": enc_first,
         "fse_encode_blocks_ms": t_blocks},
        {"name": "fse_decode_chunks", **common,
         "source": "compress_tpu_torch/csrc/fsedec.cu",
         "replaces": "compress_tpu/ops/entropy_dec.py:185",
         "launches": dec_launches, "max_abs_err": err_dec, "ms": t_dec,
         "plain_ms": p_dec, "bound_ms": b_dec[0], "bound_by": b_dec[1],
         "device_ms": t_dec_dev, "chunks": nc, "host_containers": host_routed,
         "routes": {"dead": dec_routes[0], "walked": dec_routes[1]},
         "make_accel_s": accel_s, "prep_ms": prep_ms, "call_ms": dec_call,
         "first_call_ms": dec_first},
        {"name": "byte_histograms", **common,
         "source": "compress_tpu_torch/csrc/histogram.cu",
         "replaces": "compress_tpu/ops/entropy.py:175",
         "launches": hist_launches, "max_abs_err": err_rows, "ms": rows_ms,
         "plain_ms": rows_plain, "bound_ms": b_rows[0],
         "bound_by": b_rows[1], "device_ms": rows_dev, "rows": N,
         "row_bytes": row, "class_device_ms": alone,
         "masked_device_ms": masked, **h_info},
        {"name": "histogram256_torch", **common,
         "source": "compress_tpu_torch/csrc/histogram.cu",
         "replaces": "compress_tpu/utils/histogram.py:22",
         "launches": 0, "path": "on no path", "max_abs_err": err_whole,
         "ms": h_ms, "plain_ms": h_plain, "bound_ms": b_hist[0],
         "bound_by": b_hist[1], "library_ms": lib_ms, "device_ms": h_dev,
         "library_device_ms": lib_dev, "bytes": flat.numel()}]


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
    # xxHash64's lanes are chains of n / 32 dependent rounds: the clock
    # build of checksum.cu (compress_tpu_torch/tools/checksum_clock.py)
    # gives the cycles a round on the chain alone, and the rounds times
    # those cycles at the SM's largest clock is the floor of any layout
    from compress_tpu_torch.tools import checksum_clock as XC

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.split()[0])
    clock_lib = XC.build(REPO, XC.CLOCKS)
    clocked = XC.Run(clock_lib, "xxh64 clock build", blocks, True)
    clocked.check()
    chain = clocked.clocks(mhz)
    crc_clocked = XC.CrcRun(clock_lib, "crc32c clock build", blocks, True)
    crc_clocked.check()
    crc_parts = crc_clocked.clocks()
    _say(f"xxh64_batch chain: {chain['chain_cycles_a_round']:.2f} cycles a "
         f"round on the chain alone, {chain['loop_cycles_a_round']:.2f} in "
         f"the lanes' loop, median {chain['wait_cycles_median']} cycles "
         f"waiting for stages (clock build); {chain['rounds']} rounds a "
         f"lane: chain floor {chain['chain_floor_ms']:.4f} ms at {mhz:.0f} "
         f"MHz beside the byte bound {bnd['xxh'][0]:.4f} ms and the device "
         f"time {dev_t['xxh']:.4f} ms")
    _say(XC.say_crc("crc32c_batch (clock build)", crc_parts)
         + f"; {crc_parts['total_cycles_max'] / mhz / 1e3:.4f} ms for the "
         f"slowest CTA at {mhz:.0f} MHz beside the device time "
         f"{dev_t['crc']:.4f} ms")
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
             "device_ms": dev_t[key],
             **({"chain_floor_ms": chain["chain_floor_ms"],
                 "chain_cycles_a_round": chain["chain_cycles_a_round"]}
                if key == "xxh" else {"clock_cycles": crc_parts})}
            for name, key, replaces, es in rows]


class _Capture:
    """Record the arguments of each call of ``module.name`` (a kernel
    wrapper, called through its module) while the block runs.  The
    wrapper still runs; it counts its launches on its own module's name.
    Where that is ``module``, the spy stands there, so it carries the
    count and hands it back on exit; a wrapper imported into ``module``
    from elsewhere keeps counting on itself."""

    def __init__(self, module, name: str):
        self.module, self.name = module, name
        self.calls = []

    def __enter__(self):
        self.orig = getattr(self.module, self.name)
        orig, calls = self.orig, self.calls
        self.carry = orig.__module__ == self.module.__name__

        def spy(*args, **kw):
            calls.append(args)
            return orig(*args, **kw)

        spy.launches = orig.launches
        setattr(self.module, self.name, spy)
        return self

    def __exit__(self, *exc):
        if self.carry:
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


def _kernel_info(entry: str, *args, n: int = 5) -> list:
    """What a kernel's info entry reports of its launch: route, CTAs an
    SM, registers, shared memory and tiles a warp (``ct_tile_parse_info
    (tile)``); CTAs an SM, registers, shared memory, sequences a chunk and
    blocks a walk CTA (``ct_zdev_fse_info()``); for N rows of L bytes,
    threads a row, CTAs an SM, registers (unmasked, masked), shared memory
    a CTA and CTAs on the card at once (``ct_histogram_info(N, L)``,
    n = 6)."""
    from compress_tpu_torch import _cuda

    out = (ctypes.c_int * n)()
    _cuda.check(getattr(_cuda.library(), entry)(*args, out), entry)
    return list(out)


# the table builds' inputs and launches on each path (phases 10, 14-15, 23
# and 26), kept for phase 32
TABLE_RUNS = {}


class _TableCapture:
    """The calls of the two table builds (``ops/zdev._huff_build`` and
    ``_normalize_count``) while the block runs, wherever the encoders call
    them from (``zdev``, ``zenc2``, ``entropy``): their inputs, (counts,
    maxlog or log) pairs, and their launches in the block, kept under
    ``TABLE_RUNS[path]``.  The wrappers still run; they count on their
    module's names, where the spies stand, and the counts go back to them
    on exit."""

    def __init__(self, path: str):
        self.path = path

    def __enter__(self):
        from compress_tpu_torch.ops import entropy, zdev, zenc2

        self.run = TABLE_RUNS.setdefault(self.path, {
            "launches": {"huff": 0, "norm": 0}, "huff": [], "norm": []})
        self.saved, self.spies = [], {}
        for key, name, mods in (("huff", "_huff_build", (zdev, zenc2,
                                                         entropy)),
                                ("norm", "_normalize_count", (zdev,
                                                              entropy))):
            orig, calls = getattr(zdev, name), self.run[key]

            def spy(hist, *args, _orig=orig, _calls=calls, **kw):
                _calls.append((hist, args[0] if args
                               else kw.get("maxlog", 11)))
                return _orig(hist, *args, **kw)

            spy.launches = 0
            self.spies[key] = (orig, spy)
            for m in mods:
                self.saved.append((m, name, getattr(m, name)))
                setattr(m, name, spy)
        return self

    def __exit__(self, *exc):
        for m, name, f in self.saved:
            setattr(m, name, f)
        for key, (orig, spy) in self.spies.items():
            self.run["launches"][key] += spy.launches
            orig.launches += spy.launches


def tile_parse_numbers(L_t, tile: int, plain_reps: int = 2) -> dict:
    """The tile parse on L_t at ``tile``: the tiles on each route (a
    launch of its own), the launch's CTAs an SM and registers, and its
    times (yardstick and device time, median of 20; the plain version's)."""
    from compress_tpu_torch.ops import lz2

    routes = torch.zeros(2, dtype=torch.int32, device=L_t.device)
    lz2.tile_parse(L_t, tile, routes=routes)
    route, ctas, regs, smem, tpw = _kernel_info("ct_tile_parse_info", tile)
    return {"routes": {"warp": int(routes[0]), "chunked": int(routes[1])},
            "route": ("warp", "chunked")[route], "ctas_per_sm": ctas,
            "registers": regs, "smem_bytes": smem, "tiles_a_warp": tpw,
            "ms": cuda_ms(lambda: lz2.tile_parse(L_t, tile), 20),
            "device_ms": cuda_ms(lambda: lz2.tile_parse(L_t, tile), 20, True),
            "plain_ms": cuda_ms(lambda: lz2.tile_parse_ref(L_t, tile),
                                plain_reps)}


def fse_scan_numbers(fse_in) -> dict:
    """The v1 FSE scan's (block, stream) rows on each route (a launch of
    its own) and its launch's CTAs an SM, registers and layout."""
    from compress_tpu_torch.ops import zdev

    routes = torch.zeros(2, dtype=torch.int32, device=fse_in[0].device)
    zdev.fse_scan(*fse_in, routes=routes)
    ctas, regs, smem, chunk, bpc = _kernel_info("ct_zdev_fse_info")
    return {"routes": {"one_load": int(routes[0]), "exact": int(routes[1])},
            "ctas_per_sm": ctas, "registers": regs, "smem_bytes": smem,
            "chunk": chunk, "blocks_a_cta": bpc}


def _say_numbers(what: str, k: dict, bnd) -> None:
    _say(f"{what}: routes {k['routes']}, {k['ctas_per_sm']} CTAs an SM, "
         f"{k['registers']} registers, {k['smem_bytes']} bytes of shared "
         f"memory a CTA; device time {k['device_ms']:.4f} ms, yardstick "
         f"{k['ms']:.4f}, plain {k['plain_ms']:.4f}, bound {bnd[0]:.4f} "
         f"({bnd[1]})")


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
    # bound: each L_t read once (4 bytes), the two masks written once; a
    # few integer operations a position
    L_t = parse_in[(512, 1)]
    n_pos = L_t.numel()
    bnd = bound(6 * n_pos, 4 * n_pos)
    by_tile = {}
    for tile in (512, 256):
        by_tile[tile] = tile_parse_numbers(parse_in[(tile, 1)], tile)
        _say_numbers(f"tile_parse (S2 XLA engine, tile {tile}, level 1, "
                     f"{nb} blocks)", by_tile[tile], bnd)
    k512 = by_tile[512]
    t_engine = cuda_ms(lambda: lz2.s2_encode_blocks(blocks), 3)
    _say(f"S2 XLA engine whole call (encode_blocks_np, host clock, median "
         f"of 3): {t_call:.4f} ms ({len(data) / (t_call * 1e-3) / 1e9:.4f} "
         f"GB/s), s2_encode_blocks alone {t_engine:.4f} ms by CUDA events; "
         f"launches {{tile_parse {launches}}}; ratio {r_xla:.6f} against the "
         f"kernel path's {r_kern:.6f} ({(r_xla / r_kern - 1) * 100:+.3f}% "
         f"size); tile_parse {k512['ms']:.4f} ms ({k512['device_ms']:.4f} "
         f"device time), plain {k512['plain_ms']:.4f}, bound {bnd[0]:.4f} "
         f"({bnd[1]})")
    return {"name": "tile_parse", "route": "cuda",
            "source": "compress_tpu_torch/csrc/tileparse.cu",
            "replaces": "compress_tpu/ops/lz2.py:123",
            "launches": launches, "max_abs_err": max(errs.values()),
            "equal_to_plain": True, "ms": k512["ms"],
            "plain_ms": k512["plain_ms"], "bound_ms": bnd[0],
            "bound_by": bnd[1], "library_ms": None,
            "device_ms": k512["device_ms"], "call_ms": t_call,
            "engine_ms": t_engine, "ratio": r_xla,
            "kernel_path_ratio": r_kern,
            "tiles": {str(t): d for t, d in by_tile.items()}}


def zstd_v1_path(dev) -> tuple:
    """Phase 26: the zstd v1 engine.  Returns the FSE scan's JSON entry,
    and the tile parse's and the repeat scan's numbers on this path."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch import zstd as Z
    from compress_tpu_torch.ops import lz2, zdev, zseqenc
    from compress_tpu_torch.utils import histogram as H
    from compress_tpu_torch.zstd import device as zdevice

    job = zdev.JOB
    data = corpus.replica_jobs(ZSTD_JOBS, job, SEED).tobytes()
    n = len(data)
    counted = {"parse": (lz2, "tile_parse"), "rep": (zseqenc, "rep_scan"),
               "fse": (zdev, "fse_scan"), "hist": (H, "byte_histograms")}
    sizes, caps, launches = {}, {}, {}
    for level in (1, 2, 3):
        for mod, name in counted.values():
            getattr(mod, name).launches = 0
        with _Capture(lz2, "tile_parse") as c_p, \
                _Capture(zseqenc, "rep_scan") as c_r, \
                _Capture(zdev, "fse_scan") as c_f, \
                _Capture(zdev, "byte_histograms") as c_h, \
                _TableCapture(f"zstd_v1_level{level}") as tables:
            t0 = time.perf_counter()
            frame = zdevice.compress_device(data, engine="v1", level=level)
            torch.cuda.synchronize()
            call_s = time.perf_counter() - t0
        launches[level] = {k: getattr(mod, name).launches
                           for k, (mod, name) in counted.items()}
        launches[level].update(tables.run["launches"])
        if launches[level] != {"parse": 1, "rep": 1, "fse": 1, "hist": 1,
                               "huff": 1, "norm": 3}:
            raise AssertionError(f"zstd v1 (level {level}): launches "
                                 f"{launches[level]}")
        caps[level] = (c_p.calls[0], c_r.calls[0], c_f.calls[0],
                       c_h.calls[0])
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
    (L_t, tile), rep_in, fse_in, hist_in = caps[2]
    err_parse = _hold("tile_parse (v1, level 2)", lz2.tile_parse(L_t, tile),
                      lz2.tile_parse_ref(L_t, tile))
    err_rep = _hold("rep_scan (v1, level 2)", [zseqenc.rep_scan(*rep_in)],
                    [zseqenc.rep_scan_ref(*rep_in)])
    err_fse = _hold("fse_scan (v1, level 2)", zdev.fse_scan(*fse_in),
                    zdev.fse_scan_ref(*fse_in))
    err_hist = _hold("byte_histograms (v1, level 2: jobs, lit_b)",
                     [H.byte_histograms(*hist_in)],
                     [H.byte_histograms_ref(*hist_in)])
    hist_dev = cuda_ms(lambda: H.byte_histograms(*hist_in), 20, True)
    hist_plain = cuda_ms(lambda: H.byte_histograms_ref(*hist_in), 3)
    syms, n_seqs = fse_in[0], fse_in[1]
    R, _, MS = syms.shape
    ns = n_seqs.to(torch.int64)
    sum_seqs, max_seqs = int(ns.sum()), int(ns.max())
    k_parse = tile_parse_numbers(L_t, tile)
    k_fse = fse_scan_numbers(fse_in)
    t = {"parse": k_parse["ms"],
         "rep": cuda_ms(lambda: zseqenc.rep_scan(*rep_in), 20),
         "fse": cuda_ms(lambda: zdev.fse_scan(*fse_in), 20)}
    dev_t = {"parse": k_parse["device_ms"],
             "rep": cuda_ms(lambda: zseqenc.rep_scan(*rep_in), 20, True),
             "fse": cuda_ms(lambda: zdev.fse_scan(*fse_in), 20, True)}
    plain = {"parse": k_parse["plain_ms"],
             "rep": cuda_ms(lambda: zseqenc.rep_scan_ref(*rep_in), 1),
             "fse": cuda_ms(lambda: zdev.fse_scan_ref(*fse_in), 1)}
    k_fse.update(ms=t["fse"], device_ms=dev_t["fse"], plain_ms=plain["fse"])
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
    _say_numbers(f"tile_parse (zstd v1, tile {tile}, level 2)", k_parse,
                 b_parse)
    _say_numbers(f"fse_scan (zstd v1, level 2; chunks of {k_fse['chunk']} "
                 f"sequences, {k_fse['blocks_a_cta']} blocks a walk CTA)",
                 k_fse, b_fse)
    _say(f"zstd v1 kernels ({R} blocks, MS {MS}, sequences {sum_seqs}, "
         f"longest chain {max_seqs}; ms, CUDA events / device time / plain "
         f"/ bound): " + ", ".join(
             f"{k} {t[k]:.4f} / {dev_t[k]:.4f} / {plain[k]:.4f} / "
             f"{b[0]:.4f} ({b[1]})"
             for k, b in (("parse", b_parse), ("rep", b_rep),
                          ("fse", b_fse)))
         + f"; masked byte_histograms of the literals "
         f"({hist_in[0].shape[0]} rows of {hist_in[0].shape[1]}, "
         f"{int(hist_in[1].sum())} bytes counted) {hist_dev:.4f} device "
         f"time (plain {hist_plain:.4f})")
    row = {"name": "fse_scan", "route": "cuda",
           "source": "compress_tpu_torch/csrc/zdevfse.cu",
           "replaces": "compress_tpu/ops/zdev.py:445",
           "launches": launches[2]["fse"], "max_abs_err": err_fse,
           "equal_to_plain": True, "ms": t["fse"], "plain_ms": plain["fse"],
           "bound_ms": b_fse[0], "bound_by": b_fse[1], "library_ms": None,
           "device_ms": dev_t["fse"], "longest_chain": max_seqs,
           "call_ms": t_call, "sizes_by_level": sizes,
           "routes": k_fse["routes"], "ctas_per_sm": k_fse["ctas_per_sm"],
           "registers": k_fse["registers"],
           "blocks_a_cta": k_fse["blocks_a_cta"]}
    extra = {"parse": {"v1_launches": launches[2]["parse"],
                       "v1_max_abs_err": err_parse, "v1_ms": t["parse"],
                       "v1_device_ms": dev_t["parse"],
                       "v1_plain_ms": plain["parse"],
                       "v1_bound_ms": b_parse[0],
                       "v1_routes": k_parse["routes"],
                       "v1_ctas_per_sm": k_parse["ctas_per_sm"]},
             "rep": {"v1_launches": launches[2]["rep"],
                     "v1_max_abs_err": err_rep, "v1_ms": t["rep"],
                     "v1_device_ms": dev_t["rep"], "v1_plain_ms": plain["rep"],
                     "v1_bound_ms": b_rep[0], "v1_longest_chain": max_seqs},
             "hist": {"v1_launches": launches[2]["hist"],
                      "v1_masked_max_abs_err": err_hist,
                      "v1_masked_device_ms": hist_dev,
                      "v1_masked_plain_ms": hist_plain,
                      "v1_masked_rows": hist_in[0].shape[0]}}
    return row, extra


# rows b and c: the paths whose counts phase 32 holds the kernels on, and
# the main one (phase 10's v2 call), whose inputs give the row's times
TABLE_PATHS = {"huff": ("zstd_v2", "zstd_v1_level2", "huff0_shared",
                        "huff0_table"),
               "norm": ("zstd_v2", "zstd_v1_level2", "fse_batch")}


def _table_numbers(fn, ref, hist, arg, mhz: float, out_b: int) -> dict:
    """One table build's numbers on one input: CUDA events, device time,
    the plain version's time, the bound, and the serial walk (each row's
    steps and SM cycles from ``stats``: the longest walk, the cycles a
    step over all rows' walks, and their product at the SM's largest
    clock, the walk's floor)."""
    J, nsym = hist.shape
    stats = torch.zeros((J, 2), dtype=torch.int64, device=hist.device)
    fn(hist, arg, stats=stats)
    steps, cycles = (int(x) for x in stats.sum(dim=0).tolist())
    longest = int(stats[:, 0].max()) if J else 0
    a_step = cycles / steps if steps else 0.0
    # each count read once, each output (out_b bytes) written once;
    # operations: a sort of the row's symbols (n log2 n compares) and the
    # walk steps
    bnd = bound(hist.numel() * hist.element_size() + out_b,
                J * nsym * max(nsym.bit_length() - 1, 1) + steps)
    return {"rows": J, "symbols": nsym, "arg": arg,
            "ms": cuda_ms(lambda: fn(hist, arg), 20),
            "device_ms": cuda_ms(lambda: fn(hist, arg), 20, True),
            "plain_ms": cuda_ms(lambda: ref(hist, arg), 2),
            "bound_ms": bnd[0], "bound_by": bnd[1],
            "walk_steps": steps, "longest_walk": longest,
            "cycles_a_step": a_step,
            "walk_floor_ms": longest * a_step / (mhz * 1e3)}


def table_build_path(dev) -> list:
    """Phase 32: rows b and c, the per-row table builds
    (``csrc/tablebuild.cu``), on the counts their paths called them with
    (phases 10, 14-15, 23 and 26, captured on the way): each call held
    against its plain version, each path's first largest input timed
    (CUDA events, device time, the plain version) with its bound and its
    serial walk, beside a launch's floor (the device time of a
    one-element fill).  Returns the two kernels' JSON entries."""
    from compress_tpu_torch import _cuda
    from compress_tpu_torch.ops import zdev

    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader"],
        check=True, capture_output=True, text=True).stdout.split()[0])
    info = (ctypes.c_int * 6)()
    _cuda.check(_cuda.library().ct_tablebuild_info(info),
                "ct_tablebuild_info")
    tiny = torch.zeros(1, device=dev)
    floor = cuda_ms(lambda: tiny.fill_(1), 20, True)
    kernels = {"huff": ("huff_build", zdev._huff_build, zdev._huff_build_ref,
                        "compress_tpu/ops/zdev.py:139", info[0], info[2]),
               "norm": ("normalize_count", zdev._normalize_count,
                        zdev._normalize_count_ref,
                        "compress_tpu/ops/zdev.py:357", info[3], info[5])}
    rows = []
    for key, (name, fn, ref, replaces, regs, ctas) in kernels.items():
        err, held, by_path = 0, 0, {}
        for path in TABLE_PATHS[key]:
            calls = TABLE_RUNS[path][key]
            for hist, arg in calls:
                got, want = fn(hist, arg), ref(hist, arg)
                if key == "norm":
                    got, want = [got], [want]
                err = max(err, _hold(f"{name} ({path}, {tuple(hist.shape)}, "
                                     f"{arg})", got, want))
                held += 1
            hist, arg = max(calls, key=lambda c: c[0].shape[0])
            J, nsym = hist.shape
            # the lengths, max_bits and ok; the normalised counts
            out_b = J * nsym * 4 + (5 * J if key == "huff" else 0)
            by_path[path] = _table_numbers(fn, ref, hist, arg, mhz, out_b)
        launches = {path: run["launches"][key]
                    for path, run in TABLE_RUNS.items()}
        _say(f"{name}: {held} calls held bit for bit; launches by path "
             f"{launches}; {regs} registers, {ctas} CTAs an SM (NSYM 256); "
             f"a launch's floor {floor:.4f} ms (device time); "
             f"by path (ms, CUDA events / device time / plain / bound; walk: "
             f"steps, longest, cycles a step, floor at {mhz:.0f} MHz): "
             + "; ".join(
                 f"{p} ({k['rows']} x {k['symbols']}, {k['arg']}) "
                 f"{k['ms']:.4f} / {k['device_ms']:.4f} / {k['plain_ms']:.4f}"
                 f" / {k['bound_ms']:.6f} ({k['bound_by']}); "
                 f"{k['walk_steps']}, {k['longest_walk']}, "
                 f"{k['cycles_a_step']:.2f}, {k['walk_floor_ms']:.6f}"
                 for p, k in by_path.items()))
        main = by_path["zstd_v2"]
        row = {"name": name, "route": "cuda",
               "source": "compress_tpu_torch/csrc/tablebuild.cu",
               "replaces": replaces, "launches": launches["zstd_v2"],
               "launches_by_path": launches, "max_abs_err": err,
               "equal_to_plain": True, "ms": main["ms"],
               "plain_ms": main["plain_ms"], "bound_ms": main["bound_ms"],
               "bound_by": main["bound_by"], "library_ms": None,
               "device_ms": main["device_ms"],
               "walk_floor_ms": main["walk_floor_ms"],
               "launch_floor_ms": floor, "by_path": by_path,
               "registers": regs, "ctas_per_sm": ctas, "mhz": mhz}
        if key == "huff":
            row["literal_split_ms"] = TABLE_RUNS["zstd_v2"]["literal_split"]
        rows.append(row)
    return rows


def host_core_build() -> dict:
    """Phase 2's first half: builds the host core (``_native``) with
    ``g++`` and prints the seconds, the compiler line, the machine and the
    compiler's version.  Returns them."""
    from compress_tpu_torch import _native

    t0 = time.perf_counter()
    so = _native.build()
    _native.library()
    core_s = time.perf_counter() - t0
    line = " ".join(_native.command(str(so)))
    gxx = subprocess.run([_native.CXX, "--version"], check=True,
                         capture_output=True, text=True).stdout.splitlines()[0]
    machine = os.uname().machine
    bmi2 = "-mbmi2" in _native.flags()
    _say(f"host core build: {core_s:.1f} s -> {so.name}; machine {machine}, "
         f"{gxx}; BMI2 flags {'on' if bmi2 else 'off'}")
    _say(f"  {line}")
    return {"build_s": core_s, "command": line, "machine": machine,
            "cxx": gxx, "bmi2": bmi2}


def _both_ms(native, plain, reps: int = 1):
    """(native result, plain result, native ms, plain ms) on the host
    clock: the native call's median of ``reps`` calls, the plain call
    once."""
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        got = native()
        times.append((time.perf_counter() - t0) * 1e3)
    t0 = time.perf_counter()
    want = plain()
    return got, want, statistics.median(times), \
        (time.perf_counter() - t0) * 1e3


def host_core_path(dev, core: dict, data: bytes, blocks, bodies, zframe,
                   texts) -> dict:
    """Phase 29: each entry of the host core held against its plain Python
    version on this machine's host, on the inputs of earlier phases, with
    both times (host clock, ms).  Raises on any difference."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch import zstd as Z
    from compress_tpu_torch.ops import checksum as CK
    from compress_tpu_torch.ops import lz2, zdev
    from compress_tpu_torch.s2 import device_dec as SD
    from compress_tpu_torch.s2 import plan as SP
    from compress_tpu_torch.utils import crc, xxhash64
    from compress_tpu_torch.zstd import accel as AC
    from compress_tpu_torch.zstd import device as zdevice
    from compress_tpu_torch.zstd import encoder as E
    from compress_tpu_torch.zstd import sidecar
    from compress_tpu_torch.zstd.frame import parse_frame_header

    t_phase = time.perf_counter()
    res = {"build_s": core["build_s"]}

    def report(what, t_n, t_p, note=""):
        res[what] = {"native_ms": t_n, "python_ms": t_p}
        _say(f"host core {what}: native {t_n:.4f} ms, Python {t_p:.4f} ms "
             f"({t_p / max(t_n, 1e-9):.1f}x){note}")

    # S2 plans of phase 6's bodies, payload for payload
    n = lz2.B
    got, want, t_n, t_p = _both_ms(
        lambda: [SD.native_plan(b, n) for b in bodies],
        lambda: [SP.build_plan(b, n) for b in bodies])
    for i, (g, w) in enumerate(zip(got, want)):
        if g is None or w is None or g[0] != w[0] or g[1] != w[1] \
                or g[5] != w[5] or not all(np.array_equal(a, b)
                                           for a, b in zip(g[2:5], w[2:5])):
            raise AssertionError(f"S2 plan of body {i}: native and Python "
                                 "differ")
    report(f"S2 plan ({len(bodies)} bodies)", t_n, t_p)

    # the sidecars of 8 of phase 20's frames
    frames = [E.compress(t, level=1) for t in texts[:8]]
    heads = [parse_frame_header(f).header_size for f in frames]
    got, want, t_n, t_p = _both_ms(
        lambda: [AC.sidecar_payload(f[h:]) for f, h in zip(frames, heads)],
        lambda: [sidecar.build_payload(f[h:]) for f, h in zip(frames, heads)])
    if got != want or None in got:
        raise AssertionError("a sidecar payload: native and Python differ")
    report("sidecar payload (8 frames of 64 KiB)", t_n, t_p)

    # CRC-32C and xxHash64 of the corpus, whole and as rows
    rows = [data[i * lz2.B:(i + 1) * lz2.B] for i in range(len(bodies))]
    for name, nat, py in (("CRC-32C", crc.crc32c, crc.crc32c_py),
                          ("xxHash64", xxhash64.xxh64, xxhash64.xxh64_py)):
        g, w, t_n, t_p = _both_ms(lambda: nat(data), lambda: py(data), 3)
        if g != w:
            raise AssertionError(f"{name} of the corpus: native {g}, "
                                 f"Python {w}")
        report(f"{name} ({len(data)} bytes)", t_n, t_p)
        k = len(rows) if t_p < 30e3 else 32   # the Python rows' depth
        g, w, t_n, t_p = _both_ms(lambda: [nat(r) for r in rows],
                                  lambda: [py(r) for r in rows[:k]], 3)
        if g[:k] != w:
            raise AssertionError(f"{name} rows: native and Python differ")
        if name == "CRC-32C":
            card = CK.crc32c_batch(blocks).tolist()
        else:
            card = [lo | hi << 32 for lo, hi in
                    CK.xxh64_batch(blocks).tolist()]
        if g != card:
            raise AssertionError(f"{name} rows: the host core differs from "
                                 "the kernel's rows")
        report(f"{name} ({len(rows)} rows)", t_n, t_p,
               f"; Python on {k} rows; equal to the kernel's rows")

    # the host decode of phase 10's frame
    frame, fdata = zframe
    g, w, t_n, t_p = _both_ms(lambda: Z.decompress(frame),
                              lambda: Z.decompress_py(frame))
    if not g == w == fdata:
        raise AssertionError("phase 10's frame: the host decoders differ")
    report(f"zstd decode ({len(fdata)}-byte v2 frame)", t_n, t_p)

    # the ladder's frames through the Python decoder
    sizes = {}
    for level in (1, 2, 3, 4):
        g, w, t_n, t_p = _both_ms(
            lambda: [E.compress(t, level=level) for t in texts[:8]],
            lambda: [E.compress_matcher(t, level=level) for t in texts[:8]])
        if [Z.decompress_py(f) for f in g] != texts[:8] \
                or [Z.decompress(f) for f in w] != texts[:8]:
            raise AssertionError(f"level {level}: a frame does not decode "
                                 "to its input")
        sizes[level] = (sum(map(len, g)), sum(map(len, w)))
        report(f"zstd encode, level {level} (8 x 64 KiB; native frames "
               "decoded by the Python decoder)", t_n, t_p,
               f"; bytes: ladder {sizes[level][0]}, Matcher "
               f"{sizes[level][1]}")
    res["encode_bytes"] = sizes

    # job assembly on phase 26's first job (level 2)
    job = zdev.JOB
    jdata = corpus.replica_jobs(ZSTD_JOBS, job, SEED).tobytes()[:job]
    src = torch.frombuffer(bytearray(jdata), dtype=torch.uint8)
    jobs, prefixes, has_prefix = zdevice.launch_inputs(src, 0, 1, job)
    t = zdev.zstd_encode_jobs(jobs.to(dev), job=job, block=zdev.BLOCK,
                              prefixes=prefixes.to(dev),
                              has_prefix=has_prefix.to(dev), level=2)
    t = {k: v.cpu().numpy() for k, v in t.items()}
    g, w, t_n, t_p = _both_ms(
        lambda: zdevice._assemble_job(jdata, t, 0, zdev.BLOCK),
        lambda: zdevice._assemble_job_py(jdata, t, 0, zdev.BLOCK), 3)
    if g != w:
        raise AssertionError("job assembly: native and Python differ")
    report(f"job assembly ({job}-byte job, {len(g)} blocks)", t_n, t_p)
    res["phase_s"] = time.perf_counter() - t_phase
    _say(f"host core phase: every entry equal to its plain version "
         f"({res['phase_s']:.1f} s)")
    return res


def _sharded_counters():
    """The launch counters of the kernels on the sharded paths: rows 6,
    9-12, 17, 18, b and c of PERF.md's table."""
    from compress_tpu_torch.ops import entropy_dec as ED
    from compress_tpu_torch.ops import execute as X
    from compress_tpu_torch.ops import lz2, zdev, zseq_kern, zseqenc

    return {"rep_scan": [zseqenc.rep_scan],
            "huff0_decode": [ED.huff0_decode_chunks],
            "zseq_decode": [ED.zseq_decode_chunks_rep, ED.zseq_decode_chunks,
                            zseq_kern.zseq_decode_chunks_shared],
            "execute_pieces": [X.execute_pieces],
            "execute_blocks_hist": [X.execute_blocks_hist],
            "tile_parse": [lz2.tile_parse], "fse_scan": [zdev.fse_scan],
            "huff_build": [zdev._huff_build],
            "normalize_count": [zdev._normalize_count]}


def _count_launches(fn):
    """(fn(), launches of each sharded-path kernel in the call): every
    counter set to 0 just before and read just after."""
    counters = _sharded_counters()
    for fns in counters.values():
        for f in fns:
            f.launches = 0
    out = fn()
    torch.cuda.synchronize()
    return out, {k: sum(f.launches for f in fns)
                 for k, fns in counters.items()}


def sharded_world1(data, blocks, acc, plain) -> dict:
    """Phase 27: the block-parallel engine on one rank over NCCL, at the
    sizes of the unsharded phases (``data``/``blocks``: phase 3's corpus;
    ``acc``: phases 20-21's items and inputs and their call times;
    ``plain``: 16 of phase 16's plain frames and their inputs).  Every
    output must equal the unsharded call's.  Returns the launches of the
    sharded calls and the numbers the kernels line carries."""
    import tempfile

    import torch.distributed as dist

    from compress_tpu_torch import corpus
    from compress_tpu_torch.ops import lz2, zdev
    from compress_tpu_torch.parallel import engine as PE
    from compress_tpu_torch.s2 import device_dec as SD
    from compress_tpu_torch.s2 import stream as S2S
    from compress_tpu_torch.zstd import device as zdevice
    from compress_tpu_torch.zstd import device_dec as DD

    torch.cuda.set_device(0)
    launches, times = {}, {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_nccl_") as root:
        dist.init_process_group("nccl", init_method=f"file://{root}/rdv",
                                world_size=1, rank=0)
        try:
            mesh = PE.block_mesh()
            _say(f"phase 27: {mesh.backend} process group of {mesh.size} "
                 f"rank on {mesh.device}")
            # -- S2: the sharded encode against s2_encode_blocks -----------
            (out, lens), launches["encode_blocks_sharded"] = _count_launches(
                lambda: PE.encode_blocks_sharded(blocks, mesh))
            w_out, w_lens = lz2.s2_encode_blocks(blocks)
            if not (torch.equal(out, w_out) and torch.equal(lens, w_lens)):
                raise AssertionError("encode_blocks_sharded (world 1) differs "
                                     "from s2_encode_blocks")
            (o2, l2, total), launches["encode_step_stats"] = _count_launches(
                lambda: PE.encode_step_stats(blocks, mesh))
            if int(total) != int(l2.sum()) or not (
                    torch.equal(l2, w_lens) and torch.equal(o2, w_out)):
                raise AssertionError("encode_step_stats differs from "
                                     "s2_encode_blocks, or its total from "
                                     "the lengths' sum")
            times["encode_blocks_sharded"] = (
                host_ms(lambda: PE.encode_blocks_sharded(blocks, mesh), 3),
                host_ms(lambda: lz2.s2_encode_blocks(blocks), 3))
            times["encode_step_stats"] = (
                host_ms(lambda: PE.encode_step_stats(blocks, mesh), 3), None)
            # -- S2 stream: 16 MiB and a tail, walked chunk by chunk -------
            sdata = data + corpus.corpus_blocks(1, 27).tobytes()[:12_345]
            t0 = time.perf_counter()
            stream, launches["s2_stream_encode_device"] = _count_launches(
                lambda: PE.s2_stream_encode_device(sdata, mesh))
            t_stream = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            if S2S.Reader(io.BytesIO(stream),
                          max_block_size=lz2.B).read() != sdata:
                raise AssertionError("s2_stream_encode_device: the stream "
                                     "does not give back its input")
            _say(f"S2 stream: {len(sdata)} bytes -> {len(stream)} (ratio "
                 f"{len(stream) / len(sdata):.6f}), {len(sdata) // lz2.B + 1}"
                 f" chunks read back to the input by the S2 Reader "
                 f"({time.perf_counter() - t0:.2f} s)")
            times["s2_stream_encode_device"] = (t_stream, None)
            # -- zstd v1: the sharded job engine against compress_device ---
            zdata = (corpus.replica_jobs(ZSTD_JOBS, zdev.JOB, SEED).tobytes()
                     + corpus.corpus_blocks(8, 22).tobytes()[:TAIL_BYTES])
            stats = {}
            frame, launches["zstd_encode_sharded"] = _count_launches(
                lambda: PE.zstd_encode_sharded(zdata, mesh, level=2,
                                               stats=stats))
            want = zdevice.compress_device(zdata, engine="v1", level=2)
            if frame != want:
                raise AssertionError("zstd_encode_sharded (world 1) differs "
                                     "from compress_device(engine='v1')")
            # host-bound calls on a shared host: time them in turns
            # (sharded, unsharded) and keep the medians of 3 pairs
            turns = ([], [])
            for _ in range(3):
                for out_ms, fn in zip(turns, (
                        lambda: PE.zstd_encode_sharded(zdata, mesh, level=2,
                                                       stats=stats),
                        lambda: zdevice.compress_device(zdata, engine="v1",
                                                        level=2))):
                    t0 = time.perf_counter()
                    fn()
                    torch.cuda.synchronize()
                    out_ms.append((time.perf_counter() - t0) * 1e3)
            _say("zstd_encode_sharded / compress_device(engine='v1') in turns "
                 "(ms): " + ", ".join(f"{a:.4f} / {b:.4f}"
                                      for a, b in zip(*turns)))
            times["zstd_encode_sharded"] = tuple(statistics.median(t)
                                                 for t in turns)
            busy, wall, by_name = trace_path(lambda: PE.zstd_encode_sharded(
                zdata, mesh, level=2))
            _say(f"zstd_encode_sharded (world 1): {len(zdata)} bytes -> "
                 f"{len(frame)}, equal to compress_device(engine='v1'); "
                 f"last call's parts (s): halo {stats['halo_s']:.6f}, encode "
                 f"{stats['encode_s']:.4f}, assembly "
                 f"{stats['assemble_s']:.4f}, gather {stats['gather_s']:.6f}; "
                 f"trace: device busy "
                 f"{busy:.4f} ms of {wall:.4f} ms wall, idle share "
                 + (f"{1 - busy / wall:.4f}" if busy > 0 else "not measured")
                 + "; by name (ms): " + ", ".join(
                     f"{k[:50]} {v:.4f}" for k, v in by_name[:6]))
            zstd_parts = {k: stats[k] for k in ("halo_s", "encode_s",
                                                "assemble_s", "gather_s")}
            zstd_trace = {"busy_ms": busy, "wall_ms": wall,
                          "idle_share": 1 - busy / wall if busy > 0 else None}
            # -- decode: accel, multi-block accel, plain frames, S2 bodies --
            for key, items, want in (
                    ("accel", acc["items20"], acc["texts"]),
                    ("accel_mb", acc["items21"], acc["streams"]),
                    ("plain", plain[0], plain[1])):
                t0 = time.perf_counter()
                got, launches[f"zstd_decode_sharded_{key}"] = _count_launches(
                    lambda: PE.zstd_decode_sharded(items, mesh))
                t_sh = (time.perf_counter() - t0) * 1e3
                if key == "plain":
                    t0 = time.perf_counter()
                    unsharded = DD.decompress_frames_device(items)
                    t_un = (time.perf_counter() - t0) * 1e3
                else:   # phases 20-21 decoded the same items
                    unsharded, t_un = want, acc[f"{key}_ms"]
                if got != unsharded or got != want:
                    raise AssertionError(f"zstd_decode_sharded ({key}) "
                                         "differs from the unsharded call")
                times[f"zstd_decode_sharded_{key}"] = (t_sh, t_un)
            bodies, s2src = acc["s2_bodies"]
            t0 = time.perf_counter()
            got, launches["decode_blocks_device"] = _count_launches(
                lambda: SD.decode_blocks_device(bodies, mesh=mesh))
            t_sh = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            if got != SD.decode_blocks_device(bodies) or got != s2src:
                raise AssertionError("decode_blocks_device with a mesh "
                                     "differs from the call without one")
            times["decode_blocks_device"] = (
                t_sh, (time.perf_counter() - t0) * 1e3)
        finally:
            dist.destroy_process_group()
    for k, (t_sh, t_un) in times.items():
        _say(f"  {k}: sharded (world 1) {t_sh:.4f} ms, unsharded "
             + (f"{t_un:.4f} ms" if t_un is not None else "(none)")
             + f"; launches {launches[k]}")
    total = {k: sum(v.get(k, 0) for v in launches.values())
             for k in _sharded_counters()}
    _say(f"phase 27 launches of the sharded paths' kernels: {total}")
    if min(total.values()) < 1:
        raise AssertionError(f"a kernel of the sharded paths did not run: "
                             f"{total}")
    return {"launches": total, "by_call": launches, "times_ms": times,
            "zstd_parts_s": zstd_parts, "zstd_trace": zstd_trace}


def _two_ranks_rank(mesh, zdata, blocks_np, items):
    """Phase 28 on one of two gloo ranks (a spawned process): the sharded
    zstd encode, the step stats, the sharded decode and the dryrun, with
    this rank's launches and host-clock times."""
    from compress_tpu_torch.parallel import dryrun
    from compress_tpu_torch.parallel import engine as PE

    res = {"device": str(mesh.device)}
    stats = {}
    t0 = time.perf_counter()
    res["frame"], res["zstd_launches"] = _count_launches(
        lambda: PE.zstd_encode_sharded(zdata, mesh, level=2, stats=stats))
    res["zstd_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    PE.zstd_encode_sharded(zdata, mesh, level=2, stats=stats)
    res["zstd_ms_2"] = (time.perf_counter() - t0) * 1e3
    res["zstd_stats"] = stats
    t0 = time.perf_counter()
    (out, lens, total), res["ess_launches"] = _count_launches(
        lambda: PE.encode_step_stats(blocks_np, mesh))
    res["ess_ms"] = (time.perf_counter() - t0) * 1e3
    res["ess"] = (out.cpu(), lens.cpu(), int(total))
    t0 = time.perf_counter()
    res["dec"], res["dec_launches"] = _count_launches(
        lambda: PE.zstd_decode_sharded(items, mesh))
    res["dec_ms"] = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    res["dryrun"] = dryrun.dryrun_multichip(mesh)
    res["dryrun_ms"] = (time.perf_counter() - t0) * 1e3
    return res


def two_ranks(acc) -> dict:
    """Phase 28: two gloo ranks (spawned processes) whose kernels both run
    on ``cuda:0``, the collectives through host tensors: 4 jobs of 1 MiB
    and a tail through ``zstd_encode_sharded`` (both ranks' frames equal
    ``compress_device(engine="v1")``'s, rank 1's halo the tail of job 1),
    ``encode_step_stats`` of 64 blocks, ``zstd_decode_sharded`` of 33
    accel items (the padding path) and the dryrun."""
    from compress_tpu_torch import corpus
    from compress_tpu_torch.ops import lz2, zdev
    from compress_tpu_torch.parallel import launch
    from compress_tpu_torch.zstd import device as zdevice

    job = zdev.JOB
    zdata = (corpus.replica_jobs(4, job, SEED + 28).tobytes()
             + corpus.corpus_blocks(2, 28).tobytes()[:99_999])
    blocks_np = corpus.corpus_blocks(64, SEED + 28)
    items, texts = acc["items20"][:33], acc["texts"][:33]
    t0 = time.perf_counter()
    res = launch.run_ranks(_two_ranks_rank, 2, "gloo", "cuda:0", zdata,
                           blocks_np, items, timeout=600)
    wall = time.perf_counter() - t0
    want = zdevice.compress_device(zdata, engine="v1", level=2)
    t_un = host_ms(lambda: zdevice.compress_device(zdata, engine="v1",
                                                   level=2), 2)
    w_out, w_lens = lz2.s2_encode_blocks(
        torch.from_numpy(blocks_np).to("cuda"))
    for r, x in enumerate(res):
        if x["frame"] != want:
            raise AssertionError(f"phase 28: rank {r}'s frame differs from "
                                 "compress_device(engine='v1')")
        out, lens, total = x["ess"]
        if not (torch.equal(out, w_out.cpu()) and torch.equal(
                lens, w_lens.cpu())) or total != int(w_lens.sum()):
            raise AssertionError(f"phase 28: rank {r}'s step stats differ")
        if x["dec"] != texts:
            raise AssertionError(f"phase 28: rank {r}'s decode differs")
    halo = res[1]["zstd_stats"]["halo"]
    if res[0]["zstd_stats"]["halo"] is not None \
            or halo != zdata[2 * job - job // 8:2 * job]:
        raise AssertionError("phase 28: the halo bytes are not job 1's tail")
    launches = {k: [x[f"{k}_launches"] for x in res]
                for k in ("zstd", "ess", "dec")}
    need = {"zstd": ("tile_parse", "rep_scan", "fse_scan", "huff_build",
                     "normalize_count"),
            "ess": ("tile_parse",), "dec": ("huff0_decode", "execute_pieces")}
    _say(f"phase 28: 2 gloo ranks on {res[0]['device']} / {res[1]['device']}"
         f" ({wall:.2f} s from the start of the ranks to their end); both "
         f"frames equal compress_device(engine='v1') ({len(want)} bytes of "
         f"{len(zdata)}); rank 1 received job 1's last {job // 8} bytes; "
         f"step stats and the decode of {len(items)} items equal the "
         f"unsharded calls; dryrun {res[0]['dryrun']}")
    for r, x in enumerate(res):
        st = x["zstd_stats"]
        _say(f"  rank {r}: zstd_encode_sharded {x['zstd_ms']:.4f} ms (first)"
             f" / {x['zstd_ms_2']:.4f} ms (second; halo {st['halo_s']:.6f} s,"
             f" encode {st['encode_s']:.4f}, assembly {st['assemble_s']:.4f},"
             f" gather {st['gather_s']:.6f}); encode_step_stats "
             f"{x['ess_ms']:.4f} ms; zstd_decode_sharded {x['dec_ms']:.4f} "
             f"ms; dryrun {x['dryrun_ms']:.4f} ms")
    _say(f"  unsharded compress_device(engine='v1') of the same bytes "
         f"{t_un:.4f} ms; launches by rank {launches}")
    for k, per_rank in launches.items():
        for x in per_rank:
            if min(x[name] for name in need[k]) < 1:
                raise AssertionError(f"phase 28: a kernel did not run: {x}")
    return {"wall_s": wall, "unsharded_ms": t_un, "launches": launches,
            "ranks": [{k: x[k] for k in ("zstd_ms", "zstd_ms_2", "ess_ms",
                                         "dec_ms", "dryrun_ms")}
                      | {k: x["zstd_stats"][k] for k in (
                          "halo_s", "encode_s", "assemble_s", "gather_s")}
                      for x in res]}


def _stream_counters() -> dict:
    """The launch counters of the kernels under phase 30, by the names the
    kernels line gives them."""
    from compress_tpu_torch.ops import (execute, lz2, lzkern, zdev, zenc2,
                                        zparse, zseqenc)
    from compress_tpu_torch.utils import histogram as H

    return {"find_matches_blocks": lzkern.find_matches_blocks,
            "parse_blocks": zparse.parse_blocks, "rep_scan": zseqenc.rep_scan,
            "fse_chain": zseqenc.fse_chain, "litlut": zenc2._litlut,
            "byte_histograms": H.byte_histograms,
            "huff_build": zdev._huff_build,
            "normalize_count": zdev._normalize_count,
            "execute_pieces": execute.execute_pieces,
            "tile_parse": lz2.tile_parse}


def _s2_chunks(stream: bytes) -> list:
    """(type, payload) of each data chunk of an .s2 stream, the CRC cut."""
    from compress_tpu_torch.s2 import stream as S2S

    pos, out = len(S2S.MAGIC_CHUNK), []
    while pos < len(stream):
        kind = stream[pos]
        n = int.from_bytes(stream[pos + 1:pos + 4], "little")
        if kind in (S2S.CHUNK_COMPRESSED, S2S.CHUNK_UNCOMPRESSED):
            out.append((kind, stream[pos + 8:pos + 4 + n]))
        pos += 4 + n
    return out


def stream_tier_path(data: bytes) -> dict:
    """Phase 30: the stream tier (``s2/stream.py``, ``index.py``,
    ``seek.py``, ``zstd/stream.py``, ``zstd/dict.py``,
    ``zstd/snappy_convert.py``) on the card machine's host around
    device-made data.  Every mismatch raises.  Returns each call's host
    seconds and bytes and the launches of the kernels under the phase."""
    from compress_tpu_torch import corpus, s2
    from compress_tpu_torch import zstd as Z
    from compress_tpu_torch.parallel import engine as PE
    from compress_tpu_torch.s2 import index as S2I
    from compress_tpu_torch.s2 import seek as S2K
    from compress_tpu_torch.s2 import stream as S2S
    from compress_tpu_torch.zstd import device as zdevice
    from compress_tpu_torch.zstd import dict as ZD
    from compress_tpu_torch.zstd import snappy_convert
    from compress_tpu_torch.zstd import stream as ZS

    calls = {}

    def timed(what, fn, n_in):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        s = time.perf_counter() - t0
        n_out = len(out) if isinstance(out, (bytes, bytearray)) else None
        calls[what] = {"s": s, "in_bytes": n_in, "out_bytes": n_out}
        _say(f"  {what}: {s:.4f} s, {n_in} bytes in"
             + (f", {n_out} out" if n_out is not None else ""))
        return out

    def must(ok, what):
        if not ok:
            raise AssertionError(f"phase 30: {what}")

    def read_steps(r, step):
        out = bytearray()
        while True:
            x = r.read(step)
            if not x:
                return bytes(out)
            out += x

    counters = _stream_counters()
    for f in counters.values():
        f.launches = 0
    t_phase = time.perf_counter()

    # -- S2: the device-made stream, read back, indexed, seeked ------------
    sdata = data + corpus.corpus_blocks(1, 27).tobytes()[:12_345]
    stream = timed("s2_stream_encode_device",
                   lambda: PE.s2_stream_encode_device(sdata), len(sdata))
    back = timed("s2 Reader.read", lambda: S2S.Reader(io.BytesIO(
        stream)).read(), len(stream))
    must(back == sdata, "the port's S2 Reader does not give back the "
         "device-made stream's input")
    idx = timed("s2 index_stream", lambda: S2I.index_stream(stream),
                len(stream))
    must(idx.total_uncompressed == len(sdata)
         and len(idx.entries) == len(sdata) // (1 << 16) + 1,
         f"index_stream: {idx.total_uncompressed} bytes, "
         f"{len(idx.entries)} entries")
    rs = S2K.ReadSeeker(io.BytesIO(stream), idx)
    offs = np.random.default_rng([SEED, 30]).integers(0, len(sdata),
                                                      8).tolist()

    def seeks():
        for off in offs:
            rs.seek(off)
            must(rs.read(4096) == sdata[off:off + 4096],
                 f"ReadSeeker at {off}")
        return None

    timed("s2 ReadSeeker 8 x 4 KiB", seeks, 8 * 4096)
    chunks = read_steps(S2S.Reader(io.BytesIO(stream)), 1 << 16)
    per_chunk = [chunks[i:i + (1 << 16)]
                 for i in range(0, len(chunks), 1 << 16)]
    kinds = _s2_chunks(stream)
    must(len(kinds) == len(per_chunk), "chunk count")
    comp = [(i, p) for i, (k, p) in enumerate(kinds)
            if k == S2S.CHUNK_COMPRESSED]
    dec = timed("s2.decode_blocks_device of the compressed chunks",
                lambda: s2.decode_blocks_device([p for _, p in comp]),
                sum(len(p) for _, p in comp))
    must(all(d == per_chunk[i] for (i, _), d in zip(comp, dec)),
         "decode_blocks_device of the stream's chunks differs from the "
         "Reader's chunks")
    must(len(dec) == len(comp), "decode_blocks_device: chunk count")
    s2_writes = {}
    for level in (1, 2, 3):
        outs = []
        for workers in (1, 4):
            def write(level=level, workers=workers):
                buf = io.BytesIO()
                w = S2S.Writer(buf, add_index=True, level=level,
                               workers=workers)
                w.write(sdata)
                w.close()
                return buf.getvalue()

            outs.append(timed(f"s2 Writer level {level} workers {workers}",
                              write, len(sdata)))
        must(outs[0] == outs[1], f"s2 Writer level {level}: workers=4 "
             "differs from serial")
        must(S2S.Reader(io.BytesIO(outs[0])).read() == sdata,
             f"s2 Writer level {level}: read back")
        must(S2I.Index.load_stream(outs[0]).total_uncompressed == len(sdata),
             f"s2 Writer level {level}: its index")
        s2_writes[level] = len(outs[0])

    # -- zstd: device frames and Writer streams, read back ------------------
    zdata = corpus.replica_jobs(8, 1 << 20, SEED).tobytes()
    frames = timed("zstd compress_device (v2)",
                   lambda: zdevice.compress_device(zdata), len(zdata))
    got = timed("zstd Reader.read(1 MiB) steps of the device frames",
                lambda: read_steps(ZS.Reader(io.BytesIO(frames)), 1 << 20),
                len(frames))
    must(got == zdata, "zstd Reader over compress_device's frames")
    rng = np.random.default_rng([SEED, 31])
    samples = [zdata[i:i + 4096]
               for i in rng.integers(0, len(zdata) - 4096, 32).tolist()]
    blob = timed("zstd build_dict (32 x 4 KiB samples)",
                 lambda: ZD.build_dict(samples, b"".join(samples)[:64 << 10],
                                       dict_id=30), 32 * 4096)
    zd = ZD.load_dict(blob)
    streams = {}
    for level in (1, 2, 3, 4, "dict"):
        def write(level=level):
            buf = io.BytesIO()
            w = ZS.Writer(buf, level=2 if level == "dict" else level,
                          checksum=True,
                          dict_=zd if level == "dict" else None)
            w.write(zdata)
            w.close()
            return buf.getvalue()

        f = streams[level] = timed(f"zstd Writer {level}", write, len(zdata))
        dicts = [zd] if level == "dict" else None
        must(timed(f"zstd Reader {level}", lambda: read_steps(ZS.Reader(
            io.BytesIO(f), dicts=dicts), 1 << 20), len(f)) == zdata,
            f"zstd Reader of the level-{level} stream")
        must(timed(f"zstd decompress {level}", lambda: Z.decompress(
            f, dicts=dicts), len(f)) == zdata,
            f"zstd decompress of the level-{level} stream")
    plain = b"".join([frames] + [streams[k] for k in (1, 2, 3, 4)])
    spans = Z.split_frames(plain)
    must(len(spans) == len(Z.split_frames(frames)) + 4, "split_frames")
    must(timed("zstd decode_concurrent of the 4 streams and the device "
               "frames", lambda: Z.decode_concurrent(plain, workers=4),
               len(plain)) == zdata * 5, "decode_concurrent")

    # -- converters: a snappy-mode S2 stream to one zstd frame -------------
    def snappy_stream():
        buf = io.BytesIO()
        w = S2S.Writer(buf, snappy=True)
        w.write(zdata[:4 << 20])
        w.close()
        return buf.getvalue()

    sn = timed("snappy-mode S2 Writer (4 MiB)", snappy_stream, 4 << 20)
    conv = timed("snappy_convert.convert", lambda: snappy_convert.convert(sn),
                 len(sn))
    must(Z.decompress(conv) == zdata[:4 << 20], "snappy_convert: decode")

    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    phase_s = time.perf_counter() - t_phase
    _say(f"phase 30 launches: {launches}; {phase_s:.2f} s in all")
    if min(launches.values()) < 1:
        raise AssertionError(f"phase 30: a kernel under the stream tier did "
                             f"not run: {launches}")
    return {"launches": launches, "seconds": phase_s, "calls": calls,
            "s2_writer_bytes": s2_writes,
            "zstd_stream_bytes": {str(k): len(v)
                                  for k, v in streams.items()},
            "device_frames_bytes": len(frames), "s2_stream_bytes":
                len(stream), "converted_bytes": len(conv)}


ZIP_S2_BLOCKS = 0xC2   # phase 31: a zip method registered for the run


def _zip_s2_blocks_c(data: bytes) -> bytes:
    """The registered zip method's compressor: the device S2 block encoder
    (finder and emit) on whole 64 KiB blocks, each body after its length
    as a uvarint."""
    from compress_tpu_torch.ops import lz2
    from compress_tpu_torch.utils.varint import put_uvarint

    out = bytearray()
    for body in lz2.encode_blocks_np(bytes(data)):
        put_uvarint(out, len(body))
        out += body
    return bytes(out)


def _zip_s2_blocks_d(blob: bytes, n: int) -> bytes:
    """Its decompressor: the bodies through ``decode_blocks_device``."""
    from compress_tpu_torch import s2
    from compress_tpu_torch.ops import lz2
    from compress_tpu_torch.utils.varint import put_uvarint, read_uvarint

    hdr = bytearray()
    put_uvarint(hdr, lz2.B)
    blocks, pos = [], 0
    while pos < len(blob):
        ln, pos = read_uvarint(blob, pos)
        blocks.append(bytes(hdr) + blob[pos:pos + ln])
        pos += ln
    return b"".join(s2.decode_blocks_device(blocks))


def _deflate_counters() -> dict:
    """The launch counters of the kernels under phase 31, by the names the
    kernels line gives them."""
    from compress_tpu_torch.ops import entropy_dec, lzemit2

    return {**_stream_counters(), "emit_blocks": lzemit2.emit_blocks,
            "huff0_decode_chunks": entropy_dec.huff0_decode_chunks}


def deflate_tier_path(data: bytes) -> dict:
    """Phase 31: the deflate family and the applications (``flate``,
    ``gzip``, ``zlib``, ``zip``, ``gzhttp``, ``cli``, ``dictbuilder``,
    ``estimate``) on the card machine's host around device-made data.
    Every mismatch raises.  Returns each call's host seconds and bytes and
    the launches of the kernels under the phase."""
    import importlib
    import tempfile
    import zipfile
    import zlib as stdzlib

    import compress_tpu_torch
    from compress_tpu_torch import corpus, dictbuilder
    from compress_tpu_torch import gzhttp, gzip as G, zip as ZP
    from compress_tpu_torch import zlib as ZL
    from compress_tpu_torch import zstd as Z
    from compress_tpu_torch.cli import s2c, s2d, s2sx, zstdio
    from compress_tpu_torch.zstd import accel as AC
    from compress_tpu_torch.zstd import device as zdevice
    from compress_tpu_torch.zstd import device_dec as DD
    from compress_tpu_torch.zstd.dict import load_dict

    FD = importlib.import_module("compress_tpu_torch.flate.deflate")
    FI = importlib.import_module("compress_tpu_torch.flate.inflate")
    calls = {}

    def timed(what, fn, n_in):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        sec = time.perf_counter() - t0
        n_out = len(out) if isinstance(out, (bytes, bytearray)) else None
        calls[what] = {"s": sec, "in_bytes": n_in, "out_bytes": n_out}
        _say(f"  {what}: {sec:.4f} s, {n_in} bytes in"
             + (f", {n_out} out" if n_out is not None else ""))
        return out

    def must(ok, what):
        if not ok:
            raise AssertionError(f"phase 31: {what}")

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    counters = _deflate_counters()
    for f in counters.values():
        f.launches = 0
    t_phase = time.perf_counter()
    res = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_p31_") as root:
        root = pathlib.Path(root)
        src = root / "corpus.bin"
        src.write_bytes(data)
        s2p = str(src) + ".s2"

        # -- the CLIs: s2c -device, s2d, s2sx, zstdio -accel ------------------
        must(timed("s2c -device -index", lambda: s2c.main(
            ["-device", "-index", "-q", str(src)]), len(data)) == 0, "s2c")
        stream = read(s2p)
        res["s2c_device_bytes"] = len(stream)
        must(timed("s2d", lambda: s2d.main(
            ["-q", "-o", str(root / "back"), s2p]), len(stream)) == 0
            and read(root / "back") == data, "s2d read back")
        offs = np.random.default_rng([SEED, 311]).integers(
            0, len(data), 4).tolist()

        def seeks():
            for off in offs:
                out = root / f"at{off}"
                must(s2d.main(["-q", "-offset", str(off), "-o", str(out),
                               s2p]) == 0 and read(out) == data[off:],
                     f"s2d -offset {off}")

        timed("s2d -offset x 4", seeks, len(stream))
        head = root / "head.bin"
        head.write_bytes(data[:4 << 20])
        sx = timed("s2sx build_sx (4 MiB)", lambda: s2sx.build_sx(
            str(head)), 4 << 20)
        head.unlink()
        t0 = time.perf_counter()
        subprocess.run([sys.executable, sx], cwd=root, check=True,
                       capture_output=True, timeout=300)
        calls["s2sx extractor (subprocess)"] = {
            "s": time.perf_counter() - t0, "in_bytes": os.path.getsize(sx),
            "out_bytes": 4 << 20}
        _say(f"  s2sx extractor (subprocess): "
             f"{calls['s2sx extractor (subprocess)']['s']:.4f} s")
        must(read(head) == data[:4 << 20], "the s2sx extractor's output")

        rng = np.random.default_rng([SEED, 312])
        text = b"".join(corpus.make_block("text", rng).tobytes()
                        for _ in range(TEXT_FRAMES))
        tp = root / "text.bin"
        tp.write_bytes(text)
        must(timed("zstdio -accel (8 MiB)", lambda: zstdio.main(
            ["-accel", str(tp)]), len(text)) == 0, "zstdio -accel")
        zst = read(str(tp) + ".zst")
        items = AC.split_stream_accel(zst)
        DD.decompress_frames_device.host_frames = 0
        stats = {}
        with _Walks() as walks:
            out = timed("decompress_frames_device of the zstdio items",
                        lambda: b"".join(DD.decompress_frames_device(
                            items, stats=stats)), len(zst))
        must(out == text, "decompress_frames_device of zstdio -accel")
        must(set(stats["routes"]) == {"accel"} and walks.n == 0
             and DD.decompress_frames_device.host_frames == 0,
             f"zstdio -accel items: routes {stats['routes']}, walks "
             f"{walks.n}, host frames "
             f"{DD.decompress_frames_device.host_frames}")
        tp.unlink()
        must(timed("zstdio -d", lambda: zstdio.main(
            ["-d", "-o", str(tp), str(tp) + ".zst"]), len(zst)) == 0
            and read(tp) == text, "zstdio -d")
        res["zstdio_accel_bytes"] = len(zst)

    # -- flate, gzip, zlib ---------------------------------------------------
    sizes = {}
    for level in (1, 6, 9):
        blob = timed(f"deflate level {level}", lambda: FD.deflate(
            data, level), len(data))
        sizes[level] = len(blob)
        must(timed(f"inflate level {level}", lambda: FI.inflate(blob),
                   len(blob)) == data, f"inflate of level {level}")
        must(stdzlib.decompress(blob, wbits=-15) == data,
             f"stdlib zlib of level {level}")
    res["deflate_bytes"] = sizes

    def gz_write():
        buf = io.BytesIO()
        w = G.Writer(buf, level=6, header=G.Header(name="corpus.bin"))
        for i in range(0, len(data), 3 << 20):
            w.write(data[i:i + (3 << 20)])
        w.close()
        return buf.getvalue()

    gzb = timed("gzip Writer", gz_write, len(data))
    must(timed("gzip Reader", lambda: G.Reader(io.BytesIO(gzb)).read(),
               len(gzb)) == data, "gzip Reader")
    import gzip as stdgzip
    must(stdgzip.decompress(gzb) == data, "stdlib gzip")
    one = G.compress(data[:1 << 20], 6)
    must(timed("gzip.decompress (1 MiB, Python inflate)",
               lambda: G.decompress(one)[0], len(one)) == data[:1 << 20],
         "gzip.decompress")

    def zl_write():
        buf = io.BytesIO()
        w = ZL.Writer(buf, level=6)
        w.write(data)
        w.close()
        return buf.getvalue()

    zlb = timed("zlib Writer", zl_write, len(data))
    must(timed("zlib Reader", lambda: ZL.Reader(io.BytesIO(zlb)).read(),
               len(zlb)) == data, "zlib Reader")
    must(stdzlib.decompress(zlb) == data, "stdlib zlib of the zlib stream")

    # -- zip: the device-made stream and device-encoded entries -------------
    ZP.register_compressor(ZIP_S2_BLOCKS, _zip_s2_blocks_c)
    ZP.register_decompressor(ZIP_S2_BLOCKS, _zip_s2_blocks_d)
    zhead = data[:4 << 20]
    mtime = (2024, 1, 2, 3, 4, 6)

    def zip_write():
        buf = io.BytesIO()
        w = ZP.Writer(buf)
        for name, method in (("corpus.s2", ZP.DEFLATE),
                             ("corpus.s2.zst", ZP.ZSTD),
                             ("corpus.s2.raw", ZP.STORE)):
            w.create(name, stream, method=method, mtime=mtime)
        frame = zdevice.compress_device(zhead, job=1 << 20)
        w.create_raw(ZP.FileHeader(
            "head.zst", method=ZP.ZSTD, mtime=mtime,
            crc32=stdzlib.crc32(zhead), uncompressed_size=len(zhead)), frame)
        w.create("head.s2b", zhead, method=ZIP_S2_BLOCKS, mtime=mtime)
        w.close()
        return buf.getvalue()

    arch = timed("zip Writer (5 entries)", zip_write,
                 3 * len(stream) + 2 * len(zhead))
    r = ZP.Reader(arch)
    want = {"corpus.s2": stream, "corpus.s2.zst": stream,
            "corpus.s2.raw": stream, "head.zst": zhead, "head.s2b": zhead}
    got = timed("zip Reader", lambda: {h.name: r.read(h) for h in r.entries},
                len(arch))
    must(got == want, "zip Reader")
    must([h.method for h in r.entries] == [ZP.DEFLATE, ZP.ZSTD, ZP.STORE,
                                           ZP.ZSTD, ZIP_S2_BLOCKS],
         f"zip methods {[h.method for h in r.entries]}")
    zf = zipfile.ZipFile(io.BytesIO(arch))
    must(zf.read("corpus.s2") == stream and zf.read("corpus.s2.raw")
         == stream, "stdlib zipfile")
    res["zip_bytes"] = len(arch)

    # -- gzhttp: a 4 MiB body with gzip and with zstd ------------------------
    body = data[:4 << 20]

    def app(environ, start_response):
        start_response("200 OK", [("Content-Type", "application/octet-stream"),
                                  ("Content-Length", str(len(body)))])
        return [body]

    mws = {"gzip": gzhttp.GzipMiddleware(app, enable_zstd=True),
           "zstd": gzhttp.GzipMiddleware(app, enable_zstd=True,
                                         prefer_zstd=True)}

    def inner(mw, headers):
        environ = {"HTTP_ACCEPT_ENCODING": headers["Accept-Encoding"],
                   "wsgi.input": io.BytesIO(b"")}
        cap = {}

        def sr(status, hdrs, exc_info=None):
            cap["status"], cap["headers"] = status, hdrs
            return lambda b: None

        out = b"".join(mw(environ, sr))
        return int(cap["status"].split()[0]), cap["headers"], out

    for enc, zstd_on in (("gzip", False), ("zstd", True)):
        seen = {}

        def spy(method, url, headers, req_body, seen=seen, mw=mws[enc]):
            st, hd, b = inner(mw, headers)
            seen["encoding"] = dict(hd).get("Content-Encoding")
            seen["bytes"] = len(b)
            return st, hd, b

        t = gzhttp.Transport(spy, enable_zstd=zstd_on)
        st, hd, got = timed(f"gzhttp {enc} 4 MiB (serve and Transport)",
                            lambda: t("GET", "/corpus"), len(body))
        must(st == 200 and got == body and seen["encoding"] == enc,
             f"gzhttp {enc}: {seen}")
        res[f"gzhttp_{enc}_bytes"] = seen["bytes"]

    # -- estimate and dictbuilder ---------------------------------------------
    blocks = np.frombuffer(data, np.uint8).reshape(-1, 1 << 16)
    est = {}
    t0 = time.perf_counter()
    for i, cls in enumerate(corpus.CLASSES):
        x = blocks[i::len(corpus.CLASSES)].reshape(-1)
        est[cls] = [compress_tpu_torch.estimate(x),
                    compress_tpu_torch.shannon_entropy_bits(x) / (8 * x.size)]
        must(0.0 <= est[cls][0] <= 1.0, f"estimate of {cls}")
    calls["estimate of each class"] = {"s": time.perf_counter() - t0,
                                       "in_bytes": len(data),
                                       "out_bytes": None}
    _say("  estimate, entropy share of each class: " + ", ".join(
        f"{k} {v[0]:.4f} {v[1]:.4f}" for k, v in est.items()))
    res["estimate"] = est
    samples = [text[i:i + 4096] for i in np.random.default_rng(
        [SEED, 313]).integers(0, len(text) - 4096, 32).tolist()]
    raw = timed("dictbuilder raw (32 x 4 KiB)", lambda: (
        dictbuilder.build_raw_dict(samples, 16 << 10)), 32 * 4096)
    zd = timed("dictbuilder zstd (32 x 4 KiB)", lambda: (
        dictbuilder.build_zstd_dict(samples, 16 << 10, dict_id=31)),
        32 * 4096)
    d = load_dict(zd)
    must(d.id == 31 and 16 <= len(raw) <= 16 << 10, "the dictionaries")
    fr = Z.compress(samples[0], level=2, dict_=d)
    must(Z.decompress(fr, dicts=[d]) == samples[0], "a dictionary frame")
    res["dict_bytes"] = {"raw": len(raw), "zstd": len(zd),
                         "frame_with_dict": len(fr),
                         "frame_without": len(Z.compress(samples[0],
                                                         level=2))}

    torch.cuda.synchronize()
    launches = {k: f.launches for k, f in counters.items()}
    phase_s = time.perf_counter() - t_phase
    _say(f"phase 31 launches: {launches}; {phase_s:.2f} s in all")
    if min(launches.values()) < 1:
        raise AssertionError(f"phase 31: a kernel under the deflate tier "
                             f"did not run: {launches}")
    return {"launches": launches, "seconds": phase_s, "calls": calls, **res}


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false", file=sys.stderr)
        return 1

    from compress_tpu_torch import _cuda, corpus
    from compress_tpu_torch.ops import exec_kern, lz2, lzemit2, lzkern
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
    core = host_core_build()
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
            "execute_blocks_hist": lib.ct_exec_hist_occupancy(
                exec_kern.HIST_CLUSTER),
            "fse_encode_chain": lib.ct_fse_encode_occupancy(9)}
    _say("CTAs per SM (occupancy query; exec at M = 1, the history "
         f"execute at its cluster of {exec_kern.HIST_CLUSTER}, the FSE "
         "encode chain at log 9): " + ", ".join(
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

    zstd_kernels, zstd_find, zstd_launches, zstd_hist, zstd_frame = \
        zstd_path(dev)
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
    zseq_rows, zdec, texts, plain = zstd_decode_path(dev)
    hist_row, acc, acc_items = accel_paths(dev, texts,
                                           ctas["execute_blocks_hist"])
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
    fse_rows = fse_path(dev, blocks_np)
    fse_rows[0]["ctas_per_sm"] = ctas["fse_encode_chain"]
    hist = next(r for r in fse_rows if r["name"] == "byte_histograms")
    hist["zstd_v2_launches"] = zstd_launches["hist"]
    hist.update(zstd_hist)
    hist["huff0_launches"] = {row["engine"]: row["histogram_launches"]
                              for row in kernels
                              if "histogram_launches" in row}
    kernels += fse_rows
    kernels += checksum_path(blocks)
    kernels.append(s2_xla_path(dev, data, blocks, bodies))
    fse_scan_row, v1 = zstd_v1_path(dev)
    kernels[-1].update(v1["parse"])
    for row in kernels:
        if row["name"] == "rep_scan":
            row.update(v1["rep"])
    kernels.append(fse_scan_row)
    kernels += table_build_path(dev)
    for row in kernels:
        if row["name"] == "byte_histograms":
            row.update(v1["hist"])
            row["max_abs_err"] = max(row["max_abs_err"],
                                     row["v2_masked_max_abs_err"],
                                     row["v1_masked_max_abs_err"])
    host_core_path(dev, core, data, blocks, bodies, zstd_frame, texts)
    acc_items["s2_bodies"] = (
        [bytes(hdr) + b for b in bodies[:32]],
        [data[i * lz2.B:(i + 1) * lz2.B] for i in range(32)])
    p27 = sharded_world1(data, blocks, acc_items, plain)
    p28 = two_ranks(acc_items)
    by_row = {"rep_scan": "rep_scan", "huff0_decode_chunks": "huff0_decode",
              "zseq_decode_chunks_rep": "zseq_decode",
              "execute_pieces": "execute_pieces",
              "execute_blocks_hist": "execute_blocks_hist",
              "tile_parse": "tile_parse", "fse_scan": "fse_scan",
              "huff_build": "huff_build",
              "normalize_count": "normalize_count"}
    for row in kernels:
        if row["name"] in by_row:
            row["sharded_launches"] = p27["launches"][by_row[row["name"]]]
    kernels += other_routes(dev, blocks_np, route_counts())
    _say("phase 30: the stream tier")
    p30 = stream_tier_path(data)
    _say("phase 31: the deflate tier and the CLIs")
    p31 = deflate_tier_path(data)

    _say(json.dumps({"sharded": {"world1_nccl": p27, "two_gloo_ranks": p28}},
                    default=str))
    _say(json.dumps({"stream_tier": p30}))
    _say(json.dumps({"deflate_tier": p31}))
    _say(smi)
    _say(json.dumps({"kernels": kernels}))
    _say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
