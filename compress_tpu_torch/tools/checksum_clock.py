"""Cycles of the checksum kernels (xxHash64's rounds, CRC-32C's parts), on
one card.

    python3 compress_tpu_torch/tools/checksum_clock.py [--root DIR ...]

Builds ``compress_tpu_torch/csrc/checksum.cu`` of each checkout given
(default: this one) with ``nvcc`` into ``compress_tpu_torch/_build/clock/``
(``tools/clockbuild.py``; each build a library of its own, beside the
package's):

- ``clock``: ``-DCT_XXH64_CLOCK`` and ``-DCT_CRC32C_CLOCK``.  The entry ``ct_xxh64_batch_clock`` writes, a lane, the
  SM clock (``clock64``) cycles of its loop over the row, of the same
  number of rounds on words already in registers (the chain alone), the
  rounds, and, where the kernel reads it, its cycles waiting for its words
  to arrive (else -1).  The entry ``ct_crc32c_batch_clock`` writes, a CTA,
  the cycles of its tables (built, or copied in), of the chunk walk (loads
  and steps, to a barrier), of the combine, in all, and thread 0's walk of
  its steps again on words in registers (the chain alone), with the steps;
- ``library``: the library's own flags, for the device time.

The inputs are ``chip_smoke.py``'s phase 24: the corpus's 256 rows of 64
KiB on the card.  Every build's digests (xxHash64 at seeds 0 and 2^64 - 1,
CRC-32C of whole rows and of their first 65536 - 4097 bytes) are held
against ``xxh64_batch_ref`` / ``crc32c_batch_ref``.  Prints, for each
build, its device time for each kernel (median of 20 launches queued behind
a device spin, in the order given and again reversed), and for the clock
builds xxHash64's lanes' median cycles a round, in the loop and on the
chain alone, their median cycles waiting, and the chain's floor (the
rounds of a lane times the chain's cycles a round at the card's largest SM
clock), and CRC-32C's median cycles a CTA by part; then one JSON line.
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
from compress_tpu_torch.ops import checksum as CK  # noqa: E402
from compress_tpu_torch.tools.clockbuild import (  # noqa: E402
    compile_source, device_ms)

SEEDS = (0, (1 << 64) - 1)


CLOCKS = ("-DCT_XXH64_CLOCK", "-DCT_CRC32C_CLOCK")


def build(root: pathlib.Path, defines) -> ctypes.CDLL:
    lib = compile_source("checksum.cu", defines, root)
    for name in ("ct_xxh64_batch", "ct_crc32c_batch"):
        sig = _cuda._SIGNATURES[name]
        getattr(lib, name).argtypes = sig
        getattr(lib, name).restype = ctypes.c_int
        if hasattr(lib, name + "_clock"):  # the entry with its clk output
            fn = getattr(lib, name + "_clock")
            fn.argtypes = sig[:-1] + [ctypes.c_void_p, sig[-1]]
            fn.restype = ctypes.c_int
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


class CrcRun:
    """One build's CRC-32C launch on the rows."""

    def __init__(self, lib, name: str, rows, clocked: bool):
        self.lib, self.name, self.rows, self.clocked = lib, name, rows, clocked
        B = rows.shape[0]
        self.out = torch.empty(B, dtype=torch.int64, device=rows.device)
        self.clk = torch.zeros((B, 6), dtype=torch.int64, device=rows.device)

    def __call__(self, length=None):
        B = self.rows.shape[0]
        n, lc, _, cond = CK._crc_args(self.rows, length)
        shifts = CK._shift_buffer(n, self.rows.device)
        head = [self.rows.data_ptr(), self.rows.stride(0), B, n, lc,
                shifts.data_ptr(), cond, self.out.data_ptr()]
        stream = _cuda.stream(self.rows.device)
        rc = (self.lib.ct_crc32c_batch_clock(*head, self.clk.data_ptr(),
                                             stream)
              if self.clocked else self.lib.ct_crc32c_batch(*head, stream))
        if rc:
            raise RuntimeError(f"{self.name}: CUDA error {rc}")

    def check(self):
        for length in (None, self.rows.shape[1] - 4097):
            self(length)
            torch.cuda.synchronize()
            if not torch.equal(self.out,
                               CK.crc32c_batch_ref(self.rows, length)):
                raise AssertionError(f"{self.name}: CRC-32C of length "
                                     f"{length} differs from the plain "
                                     "version")

    def clocks(self) -> dict:
        """Median cycles a CTA by part, on whole rows."""
        self()
        torch.cuda.synchronize()
        clk = self.clk.cpu().numpy()
        steps = clk[:, 5] & 0xFFFFFFFF
        lc = CK._crc_consts(self.rows.shape[1])[0]
        parts = ("tables", "walk", "combine", "total")
        out = {f"{k}_cycles": float(np.median(clk[:, i]))
               for i, k in enumerate(parts)}
        out["total_cycles_max"] = float(clk[:, 3].max())
        out["alone_cycles"] = float(np.median(clk[:, 4]))
        out["alone_steps"] = int(steps.max())
        out["alone_cycles_8_bytes"] = out["alone_cycles"] * 8 / lc
        return out


def say_crc(name: str, r: dict) -> str:
    """One line of a CRC clock build's parts."""
    return (f"{name} CRC-32C cycles a CTA (median): tables "
            f"{r['tables_cycles']:.0f}, walk {r['walk_cycles']:.0f}, "
            f"combine {r['combine_cycles']:.0f}, in all "
            f"{r['total_cycles']:.0f} (slowest CTA "
            f"{r['total_cycles_max']:.0f}); thread 0's steps alone "
            f"{r['alone_cycles']:.0f} cycles ({r['alone_steps']} steps, "
            f"{r['alone_cycles_8_bytes']:.2f} cycles a 8 bytes)")


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
    runs, crc_runs = [], []
    for i, root in enumerate(pathlib.Path(r) for r in opt.root):
        for name, defines in (("library", ()), ("clock", CLOCKS)):
            lib = build(root, defines)
            run = Run(lib, f"{i}:{name}", rows, "-DCT_XXH64_CLOCK" in defines)
            run.check()
            crc = CrcRun(lib, f"{i}:{name}", rows,
                         "-DCT_CRC32C_CLOCK" in defines)
            crc.check()
            print(f"{run.name} ({root}): built and equal to the plain "
                  f"versions; ptxas: {'; '.join(lib.ptxas)}", flush=True)
            runs.append(run)
            crc_runs.append(crc)
    result = {}
    for order in (list(zip(runs, crc_runs)), list(zip(runs, crc_runs))[::-1]):
        for run, crc in order:
            r = result.setdefault(run.name, {"device_ms": [],
                                             "crc_device_ms": []})
            r["device_ms"].append(device_ms(run, 20))
            r["crc_device_ms"].append(device_ms(crc, 20))
    for run, crc in zip(runs, crc_runs):
        r = result[run.name]
        print(f"{run.name}: CRC-32C device time {r['crc_device_ms'][0]:.4f} "
              f"/ {r['crc_device_ms'][1]:.4f} ms", flush=True)
        if crc.clocked:
            r["crc"] = crc.clocks()
            print(say_crc(run.name, r["crc"]), flush=True)
        line = f"{run.name}: xxHash64 device time {r['device_ms'][0]:.4f} / " \
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
