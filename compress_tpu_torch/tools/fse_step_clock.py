"""Cycles a step of the FSE batch encode chain's walker, by route, on one
card.

    python3 compress_tpu_torch/tools/fse_step_clock.py

Builds ``csrc/fseenc.cu`` twice more with ``nvcc`` into
``compress_tpu_torch/_build/clock/`` (``tools/clockbuild.py``; each a
library of its own, beside the package's): with ``-DCT_FSE_CLOCK`` the kernel reads the SM clock
(``clock64``) around each row's walk and writes the cycles and the row's
route, and with ``-DCT_FSE_CLOCK -DCT_FSE_EXACT`` every row takes the
exact step (the reference's arithmetic, clips included) in the same
kernel.  The inputs are ``chip_smoke.py``'s phase 23: the seeded corpus
as 1024 rows of 16 KiB at table log 9.  Both builds' items are held
against ``fse_encode_chain_ref``.  Prints, for each build and each
corpus class, the walker's cycles a step (the row's walk cycles over its
8,191 steps: median and largest over the class's rows) and the rows on
each route, then one JSON line.  Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
from compress_tpu_torch import _cuda, corpus  # noqa: E402
from compress_tpu_torch.ops import entropy as E  # noqa: E402
from compress_tpu_torch.tools.clockbuild import (  # noqa: E402
    compile_source, device_ms)

BUILDS = {"one_load": ("-DCT_FSE_CLOCK",),
          "exact": ("-DCT_FSE_CLOCK", "-DCT_FSE_EXACT")}
N_BLOCKS, SEED, ROW = 256, 0, 16 << 10


def build(defines) -> ctypes.CDLL:
    lib = compile_source("fseenc.cu", defines)
    lib.ct_fse_encode.argtypes = _cuda._SIGNATURES["ct_fse_encode"]
    lib.ct_fse_encode.restype = ctypes.c_int
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("fse_step_clock: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    rows = corpus.corpus_blocks(N_BLOCKS, SEED).reshape(-1, ROW)
    N = rows.shape[0]
    t = torch.from_numpy(rows).to(dev)
    st, dnb, dfs, _ = E._fse_tables_bytes(E.byte_histograms(t), E.FSE_LOG)
    want = E.fse_encode_chain_ref(t, st, dnb, dfs)
    names = np.array(corpus.CLASSES)[
        (np.arange(N) // (N // N_BLOCKS)) % len(corpus.CLASSES)]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}")
    result = {}
    for name, defines in BUILDS.items():
        result[name] = run(build(defines), name, t, st, dnb, dfs, want,
                           names)
    print(json.dumps({"fse_step_clock": result, "device": smi}))
    return 0


def run(lib, name, t, st, dnb, dfs, want, names) -> dict:
    """One build's walker cycles a step on the rows t, by class."""
    dev = t.device
    N, L = t.shape
    W = E._chain_width(L)
    out = torch.empty((2, N, W), dtype=torch.int32, device=dev)
    clk = torch.zeros((N, 2), dtype=torch.int64, device=dev)
    ptr = out.data_ptr()
    for _ in range(2):  # the second launch is the one read
        rc = lib.ct_fse_encode(
            t.data_ptr(), st.data_ptr(), dnb.data_ptr(), dfs.data_ptr(), N,
            L, E.FSE_LOG, W, ptr, ptr + 4 * N * W, clk.data_ptr(),
            _cuda.stream(dev))
        if rc:
            raise RuntimeError(f"{name}: CUDA error {rc}")
    torch.cuda.synchronize()
    if not (torch.equal(out[0], want[0]) and torch.equal(out[1], want[1])):
        raise AssertionError(f"{name}: items differ from the plain version")
    def call():
        lib.ct_fse_encode(
            t.data_ptr(), st.data_ptr(), dnb.data_ptr(), dfs.data_ptr(), N,
            L, E.FSE_LOG, W, ptr, ptr + 4 * N * W, clk.data_ptr(),
            _cuda.stream(dev))
    ms = device_ms(call)
    cyc = clk[:, 0].cpu().numpy() / (L // 2 - 1)
    fast = clk[:, 1].cpu().numpy()
    per = {c: {"median": float(np.median(cyc[names == c])),
               "max": float(cyc[names == c].max())} for c in corpus.CLASSES}
    print(f"{name}: device time {ms:.4f} ms; walker cycles a step, median "
          f"{np.median(cyc):.2f} over "
          f"{N} rows ({int(fast.sum())} on the one-load step); by class "
          "(median / largest): " + ", ".join(
              f"{c} {v['median']:.2f} / {v['max']:.2f}"
              for c, v in per.items()), flush=True)
    return {"device_ms": ms, "cycles_per_step": per,
            "median": float(np.median(cyc)),
            "rows_one_load": int(fast.sum()),
            "rows_exact": int(N - fast.sum())}


if __name__ == "__main__":
    sys.exit(main())
