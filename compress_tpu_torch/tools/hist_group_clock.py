"""Cycles a group of the multi-block history execute, on one card.

    python3 compress_tpu_torch/tools/hist_group_clock.py [--cluster C ...]

Builds ``csrc/exec.cu`` once more with ``nvcc`` and ``-DCT_HIST_CLOCK``
into ``compress_tpu_torch/_build/clock/`` (a library of its own, beside
the package's): the history kernel then reads the SM clock (``clock64``)
in thread 0 of every CTA of frame 0's cluster around each group of each
step, after the CTA's copy (a CTA barrier) and after the cluster barrier,
and records the CTA's pieces.  The inputs are ``chip_smoke.py``'s phase
21: ``corpus.history_streams(8, 1 MiB, 0)`` through
``compress_accel(level=1, multi_block=True, hist_blocks=8)`` (in a pool of
worker processes), decoded by ``decompress_frames_device``'s own host
halves to the packed plan.  At each cluster size (8, the wrapper's, by
default) the output is held against ``execute_blocks_hist_ref``; then it
prints, for each group, the cycles of the copy summed over the steps (the
slowest CTA of each step), of the copy and the barrier (CTA 0), and the
pieces, and one JSON line.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import concurrent.futures
import ctypes
import json
import multiprocessing
import os
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
from compress_tpu_torch import _cuda, corpus  # noqa: E402
from compress_tpu_torch.ops import exec_kern as X  # noqa: E402
from compress_tpu_torch.tools.clockbuild import compile_source  # noqa: E402

STREAMS, SIZE, SEED, HIST_BLOCKS = 8, 1 << 20, 0, 8


def _encode(data):
    from compress_tpu_torch.zstd import accel
    return accel.compress_accel(data, level=1, multi_block=True,
                                hist_blocks=HIST_BLOCKS)


def phase21_inputs(dev):
    """(lit_rows, pieces, gstart, history rows) of phase 21's launch."""
    from compress_tpu_torch.zstd import accel
    from compress_tpu_torch.zstd import device_dec as DD

    streams = corpus.history_streams(STREAMS, SIZE, SEED)
    with concurrent.futures.ProcessPoolExecutor(
            max_workers=min(8, os.cpu_count() or 1),
            mp_context=multiprocessing.get_context("spawn")) as pool:
        blobs = list(pool.map(_encode, streams))
    items = [it for b in blobs for it in accel.split_stream_accel(b)]
    metas = [DD._route(f) for f in items]
    scratch = dict.fromkeys(("lit_walk", "lit_prep", "lit_kernel"), 0.0)
    groups, host = DD._mb_groups(metas, DD._literals(metas, dev, scratch))
    if host or len(groups) != 1:
        raise AssertionError(f"multi-block groups {list(groups)}")
    (hb, (_idx, _plans, rows, pieces, gstart)), = groups.items()
    return [torch.from_numpy(a).to(dev) for a in (rows, pieces, gstart)] \
        + [hb * 512]


def build() -> ctypes.CDLL:
    lib = compile_source("exec.cu", ("-DCT_HIST_CLOCK",))
    lib.ct_exec_hist.argtypes = _cuda._SIGNATURES["ct_exec_hist"]
    lib.ct_exec_hist.restype = ctypes.c_int
    lib.ct_hist_clock_read.argtypes = [ctypes.c_void_p]
    lib.ct_hist_clock_read.restype = ctypes.c_int
    return lib


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--cluster", type=int, action="append")
    clusters = ap.parse_args().cluster or [X.HIST_CLUSTER]
    if not torch.cuda.is_available():
        print("hist_group_clock: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    lit, pieces, gstart, hist_rows = phase21_inputs(dev)
    want = X.execute_blocks_hist_ref(lit, pieces, gstart, hist_rows)
    B, K = lit.shape[:2]
    P, G = pieces.shape[0], gstart.shape[2] - 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"{B} frames x {K} blocks, {G} groups a block, {P} pieces")
    lib = build()
    result = {}
    for C in clusters:
        out = torch.empty_like(want)
        rc = lib.ct_exec_hist(lit.data_ptr(), pieces.data_ptr(),
                              gstart.data_ptr(), G, P, B, K, hist_rows, C,
                              out.data_ptr(), _cuda.stream(dev))
        torch.cuda.synchronize()
        if rc:
            raise RuntimeError(f"cluster {C}: CUDA error {rc}")
        if not torch.equal(out, want):
            raise AssertionError(f"cluster {C}: output differs from the "
                                 "plain version")
        buf = np.zeros(16 * 16 * 8 * 3, np.int64)
        if lib.ct_hist_clock_read(buf.ctypes.data):
            raise RuntimeError("reading the clock records failed")
        e = buf.reshape(16, 16, 8, 3)[:C, :K, :G]   # rank, step, group
        copy = e[:, :, :, 0].max(0).sum(0)          # slowest CTA a step
        total = e[0, :, :, 1].sum(0)
        n = e[:, :, :, 2].sum((0, 1))
        result[C] = {"copy_cycles": copy.tolist(),
                     "copy_and_barrier_cycles": total.tolist(),
                     "pieces": n.tolist(),
                     "cycles_a_step": float(total.sum() / K)}
        print(f"cluster {C}: frame 0, by group (history, then rounds): "
              "copy cycles (the slowest CTA, summed over the steps) "
              f"{copy.tolist()}; with the cluster barrier (CTA 0) "
              f"{total.tolist()}; pieces {n.tolist()}; "
              f"{total.sum() / K:.0f} cycles a step")
    print(json.dumps({"hist_group_clock": result, "device": smi}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
