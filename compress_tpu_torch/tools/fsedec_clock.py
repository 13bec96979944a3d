"""Cycles of the FSE chunk decode's CTAs by part, on one card.

    python3 compress_tpu_torch/tools/fsedec_clock.py [--root DIR ...]

Builds ``compress_tpu_torch/csrc/fsedec.cu`` of each checkout given
(default: this one) with ``nvcc`` into ``compress_tpu_torch/_build/clock/``
(``tools/clockbuild.py``; each build a library of its own, beside the
package's):

- ``clock``: ``-DCT_FSEDEC_CLOCK``: the entry ``ct_fse_decode_clock``
  reads the SM clock (``clock64``) in each CTA and writes, a CTA, its
  cycles staging the table and the windows, walking, storing the symbols,
  in all, and whether it had a pair to decode;
- ``library``: the library's own flags, for the device time.

A checkout whose ``fsedec.cu`` has no clock entry (an older kernel, whose
entry takes no ``routes``) gets its library build timed only.  The inputs
are ``chip_smoke.py``'s phase 23: the corpus's 1024 rows of 16 KiB through
``fse.compress_batch`` on the card, 4 host containers of table log 11,
``make_accel`` and ``prep_decode_batch`` (1028 rows of 512 chunks).  Every
build's outputs are held against ``fse_decode_chunks_ref``.  Prints, for
each build, its device time (median of 20 launches queued behind a device
spin, in the order given and again reversed) on those inputs and on the
same inputs with every ``npair`` set to 0 (nothing to decode); for the
clock builds the CTAs' median cycles by part, live and dead CTAs apart,
and the chunks on each route; then one JSON line.  Needs a CUDA card and
``nvcc``.
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
from compress_tpu_torch import _cuda, corpus, fse  # noqa: E402
from compress_tpu_torch.ops import entropy_dec as ED  # noqa: E402
from compress_tpu_torch.tools.clockbuild import (  # noqa: E402
    compile_source, device_ms)

ROW, HOST_LOG11 = 16 << 10, 4
PARTS = ("staging", "walk", "stores", "total")


def build(root: pathlib.Path, defines) -> ctypes.CDLL:
    lib = compile_source("fsedec.cu", defines, root)
    sig = _cuda._SIGNATURES["ct_fse_decode"]
    # a source with the clock entry takes routes; an older one does not
    src = root / "compress_tpu_torch" / "csrc" / "fsedec.cu"
    lib.routed = "ct_fse_decode_clock" in src.read_text()
    lib.ct_fse_decode.argtypes = sig if lib.routed else sig[:-2] + sig[-1:]
    lib.ct_fse_decode.restype = ctypes.c_int
    if hasattr(lib, "ct_fse_decode_clock"):  # the entry with its clk output
        lib.ct_fse_decode_clock.argtypes = sig[:-1] + [ctypes.c_void_p,
                                                       sig[-1]]
        lib.ct_fse_decode_clock.restype = ctypes.c_int
    return lib


def capture(dev):
    """Phase 23's chunk-decode arguments (numpy) and k."""
    rows = corpus.corpus_blocks(256, 0).reshape(-1, ROW)
    conts = fse.compress_batch(rows, device=dev)
    conts += [fse.compress(rows[i].tobytes(), table_log=11)
              for i in range(HOST_LOG11)]
    accel = fse.make_accel(conts)
    return fse.prep_decode_batch(conts, accel)[1], int(accel["k"])


class Run:
    """One build's launch on the given inputs."""

    def __init__(self, lib, name: str, args, k: int, clocked: bool):
        self.lib, self.name, self.args, self.k = lib, name, args, k
        self.clocked = clocked
        N, C, self.win = args[0].shape
        self.N, self.C = N, C
        dev = args[0].device
        self.syms = torch.empty((N, C, k), dtype=torch.uint8, device=dev)
        self.endl = torch.empty((N, C), dtype=torch.int32, device=dev)
        self.routes = torch.zeros(2, dtype=torch.int32, device=dev)
        # a row for each CTA of the launch: at most one a chunk
        self.clk = torch.zeros((N * C, 5), dtype=torch.int64, device=dev)

    def __call__(self):
        head = [*(a.data_ptr() for a in self.args), self.N, self.C, self.win,
                self.k, self.syms.data_ptr(), self.endl.data_ptr()]
        stream = _cuda.stream(self.args[0].device)
        if self.clocked:
            rc = self.lib.ct_fse_decode_clock(*head, self.routes.data_ptr(),
                                              self.clk.data_ptr(), stream)
        elif self.lib.routed:
            rc = self.lib.ct_fse_decode(*head, self.routes.data_ptr(), stream)
        else:
            rc = self.lib.ct_fse_decode(*head, stream)
        if rc:
            raise RuntimeError(f"{self.name}: CUDA error {rc}")

    def check(self, want):
        self.routes.zero_()
        self()
        torch.cuda.synchronize()
        if not (torch.equal(self.syms, want[0])
                and torch.equal(self.endl, want[1])):
            raise AssertionError(f"{self.name}: differs from the plain "
                                 "version")
        return self.routes.tolist()

    def clocks(self) -> dict:
        self.clk.zero_()
        self()
        torch.cuda.synchronize()
        clk = self.clk.cpu().numpy()
        used = clk[:, 3] > 0
        out = {}
        for what, sel in (("live", used & (clk[:, 4] == 1)),
                          ("dead", used & (clk[:, 4] == 0))):
            out[f"{what}_ctas"] = int(sel.sum())
            for i, part in enumerate(PARTS):
                out[f"{what}_{part}"] = (float(np.median(clk[sel, i]))
                                         if sel.any() else None)
        return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", nargs="+", default=[str(
        pathlib.Path(__file__).resolve().parents[2])])
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("fsedec_clock: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    arrays, k = capture(dev)
    args = [torch.from_numpy(a).to(dev) for a in arrays]
    empty = list(args)
    empty[4] = torch.zeros_like(args[4])        # npair 0 everywhere
    want = ED.fse_decode_chunks_ref(*args, k=k)
    want_empty = ED.fse_decode_chunks_ref(*empty, k=k)
    live_rows = int((arrays[4].sum(axis=1) > 0).sum())
    print(f"inputs: {args[0].shape[0]} rows x {args[0].shape[1]} chunks of "
          f"{k} symbols, {args[0].shape[2]}-byte windows; rows with a pair "
          f"to decode {live_rows}", flush=True)
    runs = []
    for i, root in enumerate(pathlib.Path(r) for r in opt.root):
        src = (root / "compress_tpu_torch" / "csrc" / "fsedec.cu").read_text()
        builds = {"library": ()}
        if "ct_fse_decode_clock" in src:
            builds["clock"] = ("-DCT_FSEDEC_CLOCK",)
        for name, defines in builds.items():
            lib = build(root, defines)
            tag = f"{i}:{name}"
            clocked = "-DCT_FSEDEC_CLOCK" in defines
            run = Run(lib, tag, args, k, clocked)
            routes = run.check(want)
            Run(lib, tag + " (npair 0)", empty, k,
                clocked).check(want_empty)
            print(f"{tag} ({root}): built and equal to the plain version; "
                  f"routes {routes}; ptxas: {'; '.join(lib.ptxas)}",
                  flush=True)
            runs.append((tag, run, None if clocked else
                         Run(lib, tag, empty, k, False), routes))
    result = {}
    for order in (runs, runs[::-1]):
        for tag, run, run_empty, _ in order:
            r = result.setdefault(tag, {"device_ms": [],
                                        "empty_device_ms": []})
            r["device_ms"].append(device_ms(run, 20))
            if run_empty is not None:
                r["empty_device_ms"].append(device_ms(run_empty, 20))
    for tag, run, run_empty, routes in runs:
        r = result[tag]
        r["routes"] = {"dead": routes[0], "walked": routes[1]}
        line = f"{tag}: device time {r['device_ms'][0]:.4f} / " \
               f"{r['device_ms'][1]:.4f} ms"
        if run_empty is not None:
            line += (f"; with every npair 0 {r['empty_device_ms'][0]:.4f} / "
                     f"{r['empty_device_ms'][1]:.4f} ms")
        if run.clocked:
            r.update(run.clocks())
            for what in ("live", "dead"):
                if r[f"{what}_ctas"]:
                    line += f"; {r[what + '_ctas']} {what} CTAs, median " \
                            "cycles " + ", ".join(
                                f"{p} {r[what + '_' + p]:.0f}" for p in PARTS)
        print(line, flush=True)
    print(json.dumps({"fsedec_clock": result, "device": smi,
                      "roots": opt.root}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
