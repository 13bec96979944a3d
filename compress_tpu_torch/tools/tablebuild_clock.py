"""Device time and cycles of the table-build kernels (rows b and c), on
one card.

    python3 compress_tpu_torch/tools/tablebuild_clock.py [--root DIR ...]

Builds ``compress_tpu_torch/csrc/tablebuild.cu`` of each checkout given
(default: this one; another, such as the parent commit's kernels unpacked
beside it with ``git archive <commit> compress_tpu_torch/csrc | tar -x -C
_ckout/parent``) with ``nvcc`` into ``compress_tpu_torch/_build/clock/``
(``tools/clockbuild.py``; each build a library of its own, beside the
package's):

- ``library``: the library's own flags, for the device time;
- ``clock``: ``-DCT_TABLEBUILD_CLOCK``, where the checkout's source has
  that build.  Its entries ``ct_huff_build_clock`` /
  ``ct_normalize_count_clock`` write each row's SM clock (``clock64``)
  cycles before its ranks, in its ranks, in its walks (the Huffman build)
  or its deficit scan (the normalisation), in all, and its passes (the
  normalisation: 0 with nothing to move, 1 a surplus, 2 a deficit).

The inputs are the counts ``chip_smoke.py`` phase 32 holds the kernels
on, captured the same way (``chip_smoke._TableCapture``) on the same
calls (``tools/tablebuild_ab.inputs``, seed 0): the v2 ``compress_device``
of 8 jobs of 4 MiB, ``compress_device(engine="v1", level=2)`` of 8 jobs
of 1 MiB, both huff0 encodes of 1024 rows of 16 KiB (text at maxlog 8
with one table, the corpus at maxlog 11 with a table a row) and the FSE
``compress_batch`` of the corpus rows.  Every build's outputs on every
captured call are held against ``_huff_build_ref`` /
``_normalize_count_ref``.  On each path's largest input it prints each
build's device time (median of 20 launches queued behind a device spin,
in the order given and again reversed) beside a launch's floor (a
one-element fill), its walk (``stats``: the steps, the longest row's, the
cycles a step) and, for the clock build, a row's median cycles by part
(before the ranks, ranks, walk or scan, in all; the slowest row's in
all), its passes, and the slowest row launched alone (its cycles by part
and its walk's cycles a step with the SM to itself);
each build's ptxas lines and ``ct_tablebuild_info`` (registers, shared
bytes, CTAs an SM); then one JSON line.  Needs a CUDA card and ``nvcc``.
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
from compress_tpu_torch import _cuda  # noqa: E402
from compress_tpu_torch.ops import zdev  # noqa: E402
from compress_tpu_torch.tools.clockbuild import (  # noqa: E402
    compile_source, device_ms)

CLOCK = "-DCT_TABLEBUILD_CLOCK"
# the paths phase 32 times, and the builds each reaches
PATHS = {"huff": ("zstd_v2", "zstd_v1_level2", "huff0_shared",
                  "huff0_table"),
         "norm": ("zstd_v2", "zstd_v1_level2", "fse_batch")}


def build(root: pathlib.Path, defines) -> ctypes.CDLL:
    lib = compile_source("tablebuild.cu", defines, root)
    for name in ("ct_huff_build", "ct_normalize_count", "ct_tablebuild_info"):
        getattr(lib, name).argtypes = _cuda._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    if CLOCK in defines:
        for name in ("ct_huff_build", "ct_normalize_count"):
            sig = _cuda._SIGNATURES[name]
            f = getattr(lib, name + "_clock")
            f.argtypes = sig[:-1] + [ctypes.c_void_p, sig[-1]]
            f.restype = ctypes.c_int
    return lib


class Build:
    """One build's launches of the two kernels."""

    def __init__(self, name: str, lib, clocked: bool):
        self.name, self.lib, self.clocked = name, lib, clocked

    def _check(self, rc: int, what: str) -> None:
        if rc:
            raise RuntimeError(f"{self.name}: {what}: CUDA error {rc}")

    def huff(self, hist, maxlog, stats=None, clk=None):
        J = hist.shape[0]
        dev = hist.device
        nbits = torch.empty((J, 256), dtype=torch.int32, device=dev)
        max_bits = torch.empty(J, dtype=torch.int32, device=dev)
        ok = torch.empty(J, dtype=torch.bool, device=dev)
        head = [hist.data_ptr(), zdev._COUNT_KINDS[hist.dtype], J, maxlog,
                nbits.data_ptr(), max_bits.data_ptr(), ok.data_ptr(),
                None if stats is None else stats.data_ptr()]
        stream = _cuda.stream(dev)
        self._check(self.lib.ct_huff_build(*head, stream) if clk is None
                    else self.lib.ct_huff_build_clock(*head, clk.data_ptr(),
                                                      stream), "huff")
        return nbits, max_bits, ok

    def norm(self, hist, log, stats=None, clk=None):
        N, nsym = hist.shape
        out = torch.empty((N, nsym), dtype=torch.int32, device=hist.device)
        head = [hist.data_ptr(), zdev._COUNT_KINDS[hist.dtype], N, nsym, log,
                out.data_ptr(), None if stats is None else stats.data_ptr()]
        stream = _cuda.stream(hist.device)
        self._check(self.lib.ct_normalize_count(*head, stream) if clk is None
                    else self.lib.ct_normalize_count_clock(
                        *head, clk.data_ptr(), stream), "norm")
        return out

    def info(self) -> dict:
        cells = (ctypes.c_int * 6)()
        self._check(self.lib.ct_tablebuild_info(cells), "info")
        return {"huff": dict(zip(("registers", "smem_bytes", "ctas_per_sm"),
                                 cells[:3])),
                "norm_256": dict(zip(("registers", "smem_bytes",
                                      "ctas_per_sm"), cells[3:]))}

    def call(self, key, hist, arg, **kw):
        return (self.huff if key == "huff" else self.norm)(hist, arg, **kw)

    def walk(self, key, hist, arg) -> dict:
        """The walk steps from ``stats``: all rows', the longest row's and
        the cycles a step (the deficit's: the steps its scan stands for
        and the scan's cycles)."""
        stats = torch.zeros((hist.shape[0], 2), dtype=torch.int64,
                            device=hist.device)
        self.call(key, hist, arg, stats=stats)
        st = stats.cpu().numpy()
        steps, cycles = int(st[:, 0].sum()), int(st[:, 1].sum())
        return {"steps": steps, "longest": int(st[:, 0].max()),
                "cycles_a_step": cycles / steps if steps else 0.0}

    def clocks(self, key, hist, arg) -> dict:
        """A row's median cycles by part (before its ranks, its ranks, its
        walks or scan, in all), the slowest row's in all, the passes (the
        normalisation's: rows by kind), and the slowest row launched
        alone, with its SM to itself: its cycles by part and its walk."""
        def run(h):
            clk = torch.zeros((h.shape[0], 5), dtype=torch.int64,
                              device=h.device)
            self.call(key, h, arg, clk=clk)
            return clk.cpu().numpy()

        parts = ("before", "rank", "walk", "total")
        c = run(hist)
        out = {f"{k}_cycles": float(np.median(c[:, i]))
               for i, k in enumerate(parts)}
        out["total_cycles_max"] = int(c[:, 3].max())
        if key == "huff":
            out["passes_max"] = int(c[:, 4].max())
            out["rank_cycles_a_pass"] = float(c[:, 1].sum() / max(
                c[:, 4].sum(), 1))
        else:
            out["rows_by_kind"] = {k: int((c[:, 4] == i).sum()) for i, k in
                                   enumerate(("none", "surplus", "deficit"))}
        slow = int(c[:, 3].argmax())
        one = hist[slow:slow + 1].contiguous()
        c1 = run(one)[0]
        alone = {f"{k}_cycles": int(c1[i]) for i, k in enumerate(parts)}
        alone["passes"] = int(c1[4])
        alone.update(self.walk(key, one, arg))
        out["slowest_alone"] = alone
        return out


def captured(dev) -> dict:
    """path -> {"huff": [(counts, maxlog)], "norm": [(counts, log)]}, as
    phase 32 captures them."""
    import chip_smoke
    from compress_tpu_torch import fse, huff0
    from compress_tpu_torch.tools import tablebuild_ab as TB
    from compress_tpu_torch.zstd import device as zdevice

    x = TB.inputs(dev)
    calls = {
        "zstd_v2": lambda: zdevice.compress_device(x["v2"], job=TB.ZSTD_JOB),
        "zstd_v1_level2": lambda: zdevice.compress_device(
            x["v1"], engine="v1", level=2),
        "huff0_shared": lambda: huff0.compress_4x_batch(
            x["text"], shared_table=True, max_log=8),
        "huff0_table": lambda: huff0.compress_4x_batch(x["rows"],
                                                        max_log=11),
        "fse_batch": lambda: fse.compress_batch(x["rows"])}
    for path, fn in calls.items():
        with chip_smoke._TableCapture(path):
            fn()
    torch.cuda.synchronize()
    return {p: chip_smoke.TABLE_RUNS[p] for p in calls}


def check(b: Build, runs: dict) -> int:
    """Every captured call of b against the plain versions; returns the
    calls held."""
    held = 0
    for path, run in runs.items():
        for key, ref in (("huff", zdev._huff_build_ref),
                         ("norm", zdev._normalize_count_ref)):
            for hist, arg in run[key]:
                got, want = b.call(key, hist, arg), ref(hist, arg)
                got = got if key == "huff" else [got]
                want = want if key == "huff" else [want]
                torch.cuda.synchronize()
                for g, w in zip(got, want):
                    if not torch.equal(g, w):
                        raise AssertionError(
                            f"{b.name}: {key} on {path} "
                            f"{tuple(hist.shape)} ({arg}) differs from the "
                            "plain version")
                held += 1
    return held


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", nargs="+", default=[str(
        pathlib.Path(__file__).resolve().parents[2])])
    ap.add_argument("--reps", type=int, default=20)
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("tablebuild_clock: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    _cuda.library()
    runs = captured(dev)
    # each path's largest input of each kernel, as phase 32 times it
    timed = {(key, path): max(runs[path][key], key=lambda c: c[0].shape[0])
             for key, paths in PATHS.items() for path in paths}
    print("inputs: " + "; ".join(
        f"{key} {path} {tuple(h.shape)} {h.dtype} ({arg})"
        for (key, path), (h, arg) in timed.items()), flush=True)
    plan = []
    for i, root in enumerate(pathlib.Path(r) for r in opt.root):
        plan.append((f"{i}:library", root, ()))
        src = root / "compress_tpu_torch" / "csrc" / "tablebuild.cu"
        if CLOCK[2:] in src.read_text():
            plan.append((f"{i}:clock", root, (CLOCK,)))
    builds, result = [], {}
    for name, root, defines in plan:
        lib = build(root, defines)
        b = Build(name, lib, CLOCK in defines)
        held = check(b, runs)
        info = b.info()
        result[name] = {"root": str(root), "defines": list(defines),
                        "ptxas": lib.ptxas, "info": info, "held": held,
                        "device_ms": {f"{k} {p}": [] for k, p in timed},
                        "walk": {f"{k} {p}": b.walk(k, *timed[k, p])
                                 for k, p in timed}}
        print(f"{name} ({root}{' ' + ' '.join(defines) if defines else ''}):"
              f" {held} captured calls equal to the plain versions; ptxas: "
              f"{'; '.join(lib.ptxas)}; info {info}", flush=True)
        builds.append(b)
    for order in (builds, builds[::-1]):
        for b in order:
            for (key, path), (hist, arg) in timed.items():
                result[b.name]["device_ms"][f"{key} {path}"].append(
                    device_ms(lambda b=b, k=key, h=hist, a=arg:
                              b.call(k, h, a), opt.reps))
    tiny = torch.zeros(1, device=dev)
    floor = device_ms(lambda: tiny.fill_(1), opt.reps)
    print(f"a launch's floor (device ms of a one-element fill): "
          f"{floor:.4f}", flush=True)
    for key, path in timed:
        k = f"{key} {path}"
        print(f"{k}: device ms (in order / reversed); walk steps, longest, "
              f"cycles a step: " + "; ".join(
                  f"{b.name} {result[b.name]['device_ms'][k][0]:.4f} / "
                  f"{result[b.name]['device_ms'][k][1]:.4f}, "
                  f"{result[b.name]['walk'][k]['steps']}, "
                  f"{result[b.name]['walk'][k]['longest']}, "
                  f"{result[b.name]['walk'][k]['cycles_a_step']:.2f}"
                  for b in builds), flush=True)
    for b in builds:
        if b.clocked:
            cyc = result[b.name]["cycles"] = {
                f"{k} {p}": b.clocks(k, *timed[k, p]) for k, p in timed}
            for k, r in cyc.items():
                print(f"{b.name} cycles a row (median), {k}: "
                      + ", ".join(f"{n} {v:.0f}" if isinstance(v, float)
                                  else f"{n} {v}" for n, v in r.items()),
                      flush=True)
    print(json.dumps({"tablebuild_clock": result, "device": smi,
                      "launch_floor_ms": floor, "roots": opt.root}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
