"""Cycles a step of the zstd v1 FSE scan's walker, by route, on one card.

    python3 compress_tpu_torch/tools/zdevfse_clock.py [--root DIR]
        [--builds NAME ...]

Builds ``compress_tpu_torch/csrc/zdevfse.cu`` of the checkout at DIR
(default: this one) with ``nvcc`` into ``compress_tpu_torch/_build/clock/``
(``tools/clockbuild.py``; each build a library of its own, beside the
package's):

- ``one_load``: ``-DCT_ZDEVFSE_CLOCK``: the entry ``ct_zdev_fse_clock``
  reads the SM clock (``clock64``) around each row's walk of each chunk
  and writes, a (block, stream) row, its cycles, its steps, its route and
  its CTA's cycles to the tables built and to the row's end;
- ``exact``: the same with ``-DCT_ZDEVFSE_EXACT`` (every chunk on the
  exact step, the reference's arithmetic);
- ``library``: the library's own flags, for the device time.

The checkout at DIR must have this one's entries.  The inputs are
``chip_smoke.py``'s phase 26: the FSE scan's arguments in
``compress_device(engine="v1", level=2)`` of ``corpus.replica_jobs(8, 1
MiB, 0)``, captured with the plain versions standing in for the tile
parse and the FSE scan.  Every build's outputs
are held against ``fse_scan_ref``.  Prints, for each build, its device
time (median of 10 launches queued behind a device spin, in the order
given and again reversed), and for the clock builds the walker's cycles
a step (a row's cycles over the steps its loop ran: median, and the row
with the most steps) and the rows on each route; then one JSON line.
Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
from compress_tpu_torch import _cuda, corpus  # noqa: E402
from compress_tpu_torch.ops import lz2, zdev  # noqa: E402
from compress_tpu_torch.tools.clockbuild import (  # noqa: E402
    compile_source, device_ms)

BUILDS = {"one_load": ("-DCT_ZDEVFSE_CLOCK",),
          "exact": ("-DCT_ZDEVFSE_CLOCK", "-DCT_ZDEVFSE_EXACT"),
          "library": ()}
JOBS, SEED = 8, 0


def build(root: pathlib.Path, defines) -> ctypes.CDLL:
    lib = compile_source("zdevfse.cu", defines, root)
    sig = _cuda._SIGNATURES["ct_zdev_fse"]
    lib.ct_zdev_fse.argtypes = sig
    lib.ct_zdev_fse.restype = ctypes.c_int
    if "-DCT_ZDEVFSE_CLOCK" in defines:  # the entry with its clk output
        lib.ct_zdev_fse_clock.argtypes = sig[:-1] + [ctypes.c_void_p,
                                                     sig[-1]]
        lib.ct_zdev_fse_clock.restype = ctypes.c_int
    return lib


def capture(dev):
    """The FSE scan's arguments in phase 26's level-2 call."""
    from compress_tpu_torch.zstd import device as zdevice

    caps = []
    f_scan, f_parse = zdev.fse_scan, lz2.tile_parse

    def scan(*a, **kw):
        caps.append(a)
        return zdev.fse_scan_ref(*a)

    zdev.fse_scan = scan
    lz2.tile_parse = lambda L, tile, **kw: lz2.tile_parse_ref(L, tile)
    try:
        data = corpus.replica_jobs(JOBS, zdev.JOB, SEED).tobytes()
        zdevice.compress_device(data, engine="v1", level=2, device=dev)
    finally:
        zdev.fse_scan, lz2.tile_parse = f_scan, f_parse
    return caps[0]


class Run:
    """One build's launch on the captured inputs."""

    def __init__(self, lib, name: str, clocked: bool, args):
        self.lib, self.name, self.clocked, self.args = lib, name, clocked, args
        syms = args[0]
        R, _, MS = syms.shape
        dev = syms.device
        self.R, self.MS, self.nj = R, MS, args[2].shape[0]
        self.out = torch.empty(2 * R * 3 * MS + 3 * R, dtype=torch.int32,
                               device=dev)
        self.routes = torch.zeros(2, dtype=torch.int32, device=dev)
        self.clk = torch.zeros((R, 3, 5), dtype=torch.int64, device=dev)

    def __call__(self):
        p = self.out.data_ptr()
        n = 4 * self.R * 3 * self.MS
        args = [*(a.data_ptr() for a in self.args), self.R, self.MS,
                self.nj, p, p + n, p + 2 * n, self.routes.data_ptr()]
        stream = _cuda.stream(self.args[0].device)
        rc = (self.lib.ct_zdev_fse_clock(*args, self.clk.data_ptr(), stream)
              if self.clocked else self.lib.ct_zdev_fse(*args, stream))
        if rc:
            raise RuntimeError(f"{self.name}: CUDA error {rc}")

    def check(self, want):
        self()
        torch.cuda.synchronize()
        n = self.R * 3 * self.MS
        got = (self.out[:n].view(self.R, 3, self.MS),
               self.out[n:2 * n].view(self.R, 3, self.MS),
               self.out[2 * n:].view(self.R, 3))
        for g, w, what in zip(got, want, ("val", "nb", "fin")):
            if not torch.equal(g, w):
                raise AssertionError(f"{self.name}: {what} differs from the "
                                     "plain version")

    def clocks(self) -> dict:
        clk = self.clk.view(-1, 5).cpu().numpy()
        walked = clk[:, 2] >= 0
        cyc, steps, route = clk[walked, 0], clk[walked, 1], clk[walked, 2]
        per = cyc / np.maximum(steps, 1)
        top = int(np.argmax(steps))
        built, total = clk[walked, 3], clk[walked, 4]  # the CTA's cycles
        return {"median": float(np.median(per)),
                "longest_row": float(per[top]),
                "longest_steps": int(steps[top]),
                "rows_one_load": int((route == 1).sum()),
                "rows_exact": int((route == 0).sum()),
                "build_cycles_median": float(np.median(built)),
                "longest_row_total": int(total[top]),
                "longest_row_walk": int(cyc[top]),
                "longest_row_build": int(built[top])}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(pathlib.Path(__file__).resolve()
                                          .parents[2]))
    ap.add_argument("--builds", nargs="+", default=list(BUILDS),
                    choices=list(BUILDS))
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("zdevfse_clock: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}; "
          f"kernel source: {opt.root}", flush=True)
    args = [a.contiguous() for a in capture(dev)]
    want = zdev.fse_scan_ref(*args)
    n = args[1].to(torch.int64)
    print(f"inputs: {args[0].shape[0]} blocks x 3 streams, MS "
          f"{args[0].shape[2]}, sequences {int(n.sum())}, longest chain "
          f"{int(n.max())}", flush=True)
    root = pathlib.Path(opt.root)
    runs = []
    for name in opt.builds:
        lib = build(root, BUILDS[name])
        run = Run(lib, name, "-DCT_ZDEVFSE_CLOCK" in BUILDS[name], args)
        run.check(want)
        print(f"{name}: built and equal to the plain version; ptxas: "
              f"{'; '.join(lib.ptxas)}", flush=True)
        runs.append(run)
    result = {}
    for order in (runs, runs[::-1]):
        for run in order:
            result.setdefault(run.name, {"device_ms": []})[
                "device_ms"].append(device_ms(run))
    for run in runs:
        r = result[run.name]
        if run.clocked:
            run()
            torch.cuda.synchronize()
            r.update(run.clocks())
        line = f"{run.name}: device time {r['device_ms'][0]:.4f} / " \
               f"{r['device_ms'][1]:.4f} ms"
        if run.clocked:
            line += (f"; walker cycles a step: median {r['median']:.2f}, "
                     f"longest row ({r['longest_steps']} steps) "
                     f"{r['longest_row']:.2f}; rows one-load "
                     f"{r['rows_one_load']}, exact {r['rows_exact']}; the "
                     f"longest row's CTA: {r['longest_row_total']} cycles "
                     f"to its end, {r['longest_row_build']} to its tables, "
                     f"{r['longest_row_walk']} walking (median table build "
                     f"{r['build_cycles_median']:.0f})")
        print(line, flush=True)
    print(json.dumps({"zdevfse_clock": result, "device": smi,
                      "root": opt.root}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
