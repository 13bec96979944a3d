"""Cycles a round of the xxHash64 kernel's lanes, on one card.

    python3 compress_tpu_torch/tools/checksum_clock.py [--root DIR ...]

Builds ``compress_tpu_torch/csrc/checksum.cu`` of each checkout given
(default: this one) with ``nvcc`` into ``compress_tpu_torch/_build/clock/``
(``tools/clockbuild.py``; each build a library of its own, beside the
package's):

- ``clock``: ``-DCT_XXH64_CLOCK``: the entry ``ct_xxh64_batch_clock``
  writes, a lane, the SM clock (``clock64``) cycles of its loop over the
  row, of the same number of rounds on words already in registers (the
  chain alone), the rounds, and, where the kernel reads it, its cycles
  waiting for its words to arrive (else -1);
- ``library``: the library's own flags, for the device time.

The inputs are ``chip_smoke.py``'s phase 24: the corpus's 256 rows of 64
KiB on the card.  Every build's digests (seeds 0 and 2^64 - 1) are held
against ``xxh64_batch_ref``.  Prints, for each build, its device time
(median of 20 launches queued behind a device spin, in the order given
and again reversed), and for the clock builds the lanes' median cycles a
round, in the loop and on the chain alone, their median cycles waiting,
and the chain's floor: the rounds of a lane times the chain's cycles a
round at the card's largest SM clock; then one JSON line.  Needs a CUDA
card and ``nvcc``.
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
from compress_tpu_torch.ops import checksum as CK  # noqa: E402
from compress_tpu_torch.tools.clockbuild import (  # noqa: E402
    compile_source, device_ms)

SEEDS = (0, (1 << 64) - 1)


def build(root: pathlib.Path, defines) -> ctypes.CDLL:
    lib = compile_source("checksum.cu", defines, root)
    sig = _cuda._SIGNATURES["ct_xxh64_batch"]
    lib.ct_xxh64_batch.argtypes = sig
    lib.ct_xxh64_batch.restype = ctypes.c_int
    if hasattr(lib, "ct_xxh64_batch_clock"):  # the entry with its clk output
        lib.ct_xxh64_batch_clock.argtypes = sig[:-1] + [ctypes.c_void_p,
                                                        sig[-1]]
        lib.ct_xxh64_batch_clock.restype = ctypes.c_int
    return lib


class Run:
    """One build's launch on the rows."""

    def __init__(self, lib, name: str, rows, clocked: bool):
        self.lib, self.name, self.rows, self.clocked = lib, name, rows, clocked
        B = rows.shape[0]
        self.out = torch.empty((B, 2), dtype=torch.int64, device=rows.device)
        self.clk = torch.zeros((B, 4, 5), dtype=torch.int64,
                               device=rows.device)

    def __call__(self, seed: int = 0):
        B, n = self.rows.shape
        head = [self.rows.data_ptr(), B, n, seed, self.out.data_ptr()]
        stream = _cuda.stream(self.rows.device)
        rc = (self.lib.ct_xxh64_batch_clock(*head, self.clk.data_ptr(),
                                            stream)
              if self.clocked else self.lib.ct_xxh64_batch(*head, stream))
        if rc:
            raise RuntimeError(f"{self.name}: CUDA error {rc}")

    def check(self):
        for seed in SEEDS:
            self(seed)
            torch.cuda.synchronize()
            if not torch.equal(self.out, CK.xxh64_batch_ref(self.rows, seed)):
                raise AssertionError(f"{self.name}: seed {seed} differs from "
                                     "the plain version")

    def clocks(self, mhz: float) -> dict:
        self()
        torch.cuda.synchronize()
        clk = self.clk.view(-1, 5)[:, :4].cpu().numpy().astype(np.float64)
        rounds = np.maximum(clk[:, 2], 1)
        chain = float(np.median(clk[:, 1] / rounds))
        waited = clk[:, 3]
        return {"loop_cycles_a_round": float(np.median(clk[:, 0] / rounds)),
                "chain_cycles_a_round": chain,
                "loop_cycles_max": float(clk[:, 0].max()),
                "wait_cycles_median": (float(np.median(waited))
                                       if (waited >= 0).all() else None),
                "rounds": int(clk[:, 2].max()),
                "chain_floor_ms": float(clk[:, 2].max() * chain / mhz
                                        / 1e3)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", nargs="+", default=[str(
        pathlib.Path(__file__).resolve().parents[2])])
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("checksum_clock: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    mhz = float(smi.split(",")[-1].split()[0])
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    rows = torch.from_numpy(corpus.corpus_blocks(256, 0)).to(dev)
    print(f"inputs: {rows.shape[0]} rows of {rows.shape[1]} bytes",
          flush=True)
    runs = []
    for i, root in enumerate(pathlib.Path(r) for r in opt.root):
        src = (root / "compress_tpu_torch" / "csrc" /
               "checksum.cu").read_text()
        builds = {"library": ()}
        if "CT_XXH64_CLOCK" in src:
            builds["clock"] = ("-DCT_XXH64_CLOCK",)
        for name, defines in builds.items():
            lib = build(root, defines)
            run = Run(lib, f"{i}:{name}", rows, "-DCT_XXH64_CLOCK" in defines)
            run.check()
            print(f"{run.name} ({root}): built and equal to the plain "
                  f"version; ptxas: {'; '.join(lib.ptxas)}", flush=True)
            runs.append(run)
    result = {}
    for order in (runs, runs[::-1]):
        for run in order:
            result.setdefault(run.name, {"device_ms": []})[
                "device_ms"].append(device_ms(run, 20))
    for run in runs:
        r = result[run.name]
        line = f"{run.name}: device time {r['device_ms'][0]:.4f} / " \
               f"{r['device_ms'][1]:.4f} ms"
        if run.clocked:
            r.update(run.clocks(mhz))
            line += (f"; cycles a round: loop {r['loop_cycles_a_round']:.2f},"
                     f" chain alone {r['chain_cycles_a_round']:.2f} "
                     f"({r['rounds']} rounds a lane: chain floor "
                     f"{r['chain_floor_ms']:.4f} ms at {mhz:.0f} MHz); the "
                     f"slowest lane's loop {r['loop_cycles_max']:.0f} "
                     "cycles; median cycles waiting "
                     f"{r['wait_cycles_median']}")
        print(line, flush=True)
    print(json.dumps({"checksum_clock": result, "device": smi,
                      "roots": opt.root}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
