"""Device time and cycles of the byte-histogram kernels, on one card.

    python3 compress_tpu_torch/tools/histogram_clock.py [--root DIR ...]

Builds ``compress_tpu_torch/csrc/histogram.cu`` of each checkout given
(default: this one; another, such as a ``git archive`` of a parent commit
unpacked under ``_ckout/``, or a patched copy of ``csrc/`` there, beside
it) with ``nvcc`` into ``compress_tpu_torch/_build/clock/``
(``tools/clockbuild.py``; each build a library of its own, beside the
package's):

- ``library``: the library's own flags, for the device time;
- ``clock``: ``-DCT_BYTE_HIST_CLOCK``, where the checkout's source has
  that build.  Its entry ``ct_byte_histograms_clock`` writes a CTA's SM
  clock (``clock64``) cycles zeroing its counters, counting, merging and
  in all.

The inputs, on the card: ``chip_smoke.py`` phase 23's rows (the corpus,
``corpus.corpus_blocks(256, 0)``, as 1024 rows of 16 KiB), 1024 such rows
of each class alone, the corpus rows under a random and under a prefix
mask (phase 23's kinds of mask); the v2 literal stage's shape (512 rows of 64 KiB,
``corpus.corpus_blocks(512, 1)``, under a prefix mask as its ``is_lit``)
and the v1 engine's (512 rows of 16 KiB under a scattered mask, three
bytes in ten, as its ``lit_b``), seeded stand-ins for the literals of
phases 11 and 26; and the 16 MiB of the corpus, and of zeros, as one
whole input.  Every build's outputs are held against ``byte_histograms_ref``
/ ``histogram256_torch_ref`` (and every dtype of the whole-input entry on
a short input with values outside 0..255).  Prints each build's ptxas
lines (registers, spills), its launch's threads a row, CTAs an SM,
registers and shared bytes on each shape (``ct_histogram_info``, where it
has it), its kernels' shared-memory atomics, loads and stores in SASS
(``ATOMS``, ``LDS``, ``STS``, from ``cuobjdump`` where the toolkit has
it), its device time on each input (median of 20
launches queued behind a device spin, in the order given and again
reversed) beside a launch's floor (a one-element fill) and, for the clock
build, a CTA's median cycles by part on the corpus rows and the v2 shape,
with the most CTAs an SM held at once (from each CTA's SM and its start
and end on the global timer) and the launch's span; then one JSON line.
Needs a CUDA card and ``nvcc``.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[2]))
from compress_tpu_torch import _cuda, corpus  # noqa: E402
from compress_tpu_torch.utils import histogram as H  # noqa: E402
from compress_tpu_torch.tools.clockbuild import (  # noqa: E402
    compile_source, device_ms)

ROW = 16 << 10
CLOCK = "-DCT_BYTE_HIST_CLOCK"
DTYPES = (torch.uint8, torch.int8, torch.int16, torch.int32, torch.int64)


def build(root: pathlib.Path, defines) -> ctypes.CDLL:
    lib = compile_source("histogram.cu", defines, root)
    for name in ("ct_byte_histograms", "ct_histogram256"):
        getattr(lib, name).argtypes = _cuda._SIGNATURES[name]
        getattr(lib, name).restype = ctypes.c_int
    if hasattr(lib, "ct_histogram_info"):
        lib.ct_histogram_info.argtypes = _cuda._SIGNATURES["ct_histogram_info"]
        lib.ct_histogram_info.restype = ctypes.c_int
    if CLOCK in defines:
        sig = _cuda._SIGNATURES["ct_byte_histograms"]
        lib.ct_byte_histograms_clock.argtypes = sig[:-1] + [ctypes.c_void_p,
                                                            sig[-1]]
        lib.ct_byte_histograms_clock.restype = ctypes.c_int
    return lib


OPS = ("ATOMS", "LDS", "STS")


def sass_ops(lib) -> dict:
    """Each kernel's count of the SASS opcodes in OPS (``ATOMS``: a
    shared-memory atomic), from ``cuobjdump`` where the toolkit has it
    (else None)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        return None
    sass = subprocess.run([tool, "-sass", lib._name], capture_output=True,
                          text=True).stdout
    out, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = re.sub(r"^_ZN\w*?_GLOBAL__N__\w+?_\d+", "", m.group(1))
            out[name] = dict.fromkeys(OPS, 0)
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9]+)",
                      line)
        if name and m and m.group(1) in OPS:
            out[name][m.group(1)] += 1
    return out


def info(lib, N: int = 1024, L: int = ROW):
    """The per-row launch's threads, CTAs an SM, registers, shared bytes and
    CTAs on the card at once for N rows of L bytes (``ct_histogram_info``),
    or None where the build has no such entry."""
    if not hasattr(lib, "ct_histogram_info"):
        return None
    cells = (ctypes.c_int * 6)()
    _cuda.check(lib.ct_histogram_info(N, L, cells), "ct_histogram_info")
    return dict(zip(("threads", "ctas_per_sm", "registers",
                     "registers_masked", "smem_bytes", "ctas_at_once"),
                    cells))


class Build:
    """One build's launches on the inputs."""

    def __init__(self, name: str, lib, clocked: bool):
        self.name, self.lib, self.clocked = name, lib, clocked

    def rows(self, t, mask=None, clk=None):
        N, L = t.shape
        out = torch.empty((N, 256), dtype=torch.int32, device=t.device)
        head = [t.data_ptr(), t.stride(0), N, L,
                None if mask is None else mask.data_ptr(),
                0 if mask is None else mask.stride(0), out.data_ptr()]
        stream = _cuda.stream(t.device)
        rc = (self.lib.ct_byte_histograms(*head, stream) if clk is None else
              self.lib.ct_byte_histograms_clock(*head, clk.data_ptr(),
                                                stream))
        if rc:
            raise RuntimeError(f"{self.name}: CUDA error {rc}")
        return out

    def whole(self, x):
        out = torch.empty(256, dtype=torch.int32, device=x.device)
        rc = self.lib.ct_histogram256(x.data_ptr(), x.numel(),
                                      DTYPES.index(x.dtype), out.data_ptr(),
                                      _cuda.stream(x.device))
        if rc:
            raise RuntimeError(f"{self.name}: CUDA error {rc}")
        return out

    def clocks(self, t, mask=None) -> dict:
        """A CTA's median cycles by part, the slowest CTA's in all, and from
        the CTAs' SMs and global start and end: the most CTAs an SM held
        at once, the most an SM ran, and the launch's span."""
        clk = torch.zeros((t.shape[0], 7), dtype=torch.int64,
                          device=t.device)
        self.rows(t, mask, clk)
        torch.cuda.synchronize()
        c = clk.cpu().numpy()
        out = {f"{k}_cycles": float(np.median(c[:, i]))
               for i, k in enumerate(("zero", "count", "merge", "total"))}
        out["total_cycles_max"] = float(c[:, 3].max())
        held = ran = 0
        for sm in np.unique(c[:, 4]):
            s0, s1 = c[c[:, 4] == sm, 5], c[c[:, 4] == sm, 6]
            ran = max(ran, len(s0))
            held = max(held, max(int(((s0 <= t0) & (s1 > t0)).sum())
                                 for t0 in s0))
        out.update(ctas_held_an_sm=held, ctas_run_an_sm=ran,
                   sms=int(len(np.unique(c[:, 4]))),
                   span_ms=float(c[:, 6].max() - c[:, 5].min()) / 1e6)
        return out


def inputs(dev) -> dict:
    """name -> ("rows", rows, mask) or ("whole", x)."""
    rng = np.random.default_rng([0, 23])
    blocks = corpus.corpus_blocks(256, 0)
    t = torch.from_numpy(blocks.reshape(-1, ROW)).to(dev)
    N = t.shape[0]
    out = {"corpus": ("rows", t, None)}
    for cls in corpus.CLASSES:
        ct = np.stack([corpus.make_block(cls, rng) for _ in range(256)])
        out[cls] = ("rows", torch.from_numpy(ct.reshape(-1, ROW)).to(dev),
                    None)
    out["corpus, random mask"] = ("rows", t, torch.from_numpy(
        rng.random(t.shape) < 0.5).to(dev))
    out["corpus, prefix mask"] = ("rows", t, (
        torch.arange(ROW, device=dev)[None, :]
        < torch.from_numpy(rng.integers(0, ROW + 1, (N, 1))).to(dev)))
    v2 = torch.from_numpy(corpus.corpus_blocks(512, 1)).to(dev)
    out["v2 literals (512 x 64 KiB, prefix mask)"] = ("rows", v2, (
        torch.arange(v2.shape[1], device=dev)[None, :]
        < torch.from_numpy(rng.integers(0, v2.shape[1] + 1,
                                        (v2.shape[0], 1))).to(dev)))
    v1 = t[:512]
    out["v1 literals (512 x 16 KiB, scattered mask)"] = ("rows", v1, (
        torch.from_numpy(rng.random(v1.shape) < 0.3).to(dev)))
    out["whole 16 MiB corpus"] = ("whole", t.reshape(-1))
    out["whole 16 MiB zeros"] = ("whole", torch.zeros(N * ROW,
                                                      dtype=torch.uint8,
                                                      device=dev))
    return out


def check(b: Build, ins: dict, dev) -> None:
    """Every input, and every dtype on a short input, against the plain
    versions."""
    for name, (kind, x, *m) in ins.items():
        got = b.rows(x, m[0]) if kind == "rows" else b.whole(x)
        want = (H.byte_histograms_ref(x, m[0]) if kind == "rows"
                else H.histogram256_torch_ref(x))
        if not torch.equal(got, want):
            raise AssertionError(f"{b.name}: {name} differs from the plain "
                                 "version")
    rng = np.random.default_rng(5)
    x = torch.from_numpy(rng.integers(-300, 300, 100_003)).to(dev)
    for dt in DTYPES:
        v = x.to(dt)[1:]
        if not torch.equal(b.whole(v), H.histogram256_torch_ref(v)):
            raise AssertionError(f"{b.name}: {dt} differs from the plain "
                                 "version")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", nargs="+", default=[str(
        pathlib.Path(__file__).resolve().parents[2])])
    opt = ap.parse_args()
    if not torch.cuda.is_available():
        print("histogram_clock: no CUDA card", file=sys.stderr)
        return 1
    dev = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    print(f"device: {torch.cuda.get_device_name(0)}; nvidia-smi: {smi}",
          flush=True)
    ins = inputs(dev)
    plan = []
    for i, root in enumerate(pathlib.Path(r) for r in opt.root):
        plan.append((f"{i}:library", root, ()))
        src = root / "compress_tpu_torch" / "csrc" / "histogram.cu"
        if CLOCK[2:] in src.read_text():
            plan.append((f"{i}:clock", root, (CLOCK,)))
    builds, result = [], {}
    for name, root, defines in plan:
        lib = build(root, defines)
        b = Build(name, lib, CLOCK in defines)
        check(b, ins, dev)
        sass = sass_ops(lib)
        result[name] = {"root": str(root), "defines": list(defines),
                        "ptxas": lib.ptxas, "sass_ops": sass,
                        "info": {k: info(lib, *x.shape) for k, (kind, x, *_)
                                 in ins.items() if kind == "rows"}
                        if info(lib) else None,
                        "device_ms": {k: [] for k in ins}}
        print(f"{name} ({root}{' ' + ' '.join(defines) if defines else ''}):"
              f" built and equal to the plain versions; ptxas: "
              f"{'; '.join(lib.ptxas)}; launch on 1024 rows of 16 KiB: "
              f"{info(lib)}; SASS by kernel: {sass}", flush=True)
        builds.append(b)
    for order in (builds, builds[::-1]):
        for b in order:
            for k, (kind, x, *m) in ins.items():
                fn = ((lambda b=b, x=x, m=m[0]: b.rows(x, m))
                      if kind == "rows" else (lambda b=b, x=x: b.whole(x)))
                result[b.name]["device_ms"][k].append(device_ms(fn, 20))
    tiny = torch.zeros(1, device=dev)
    floor = device_ms(lambda: tiny.fill_(1), 20)
    print(f"a launch's floor (device ms of a one-element fill): {floor:.4f}",
          flush=True)
    for k in ins:
        print(f"{k}: device ms (in order / reversed): " + ", ".join(
            f"{b.name} {result[b.name]['device_ms'][k][0]:.4f} / "
            f"{result[b.name]['device_ms'][k][1]:.4f}" for b in builds),
            flush=True)
    for b in builds:
        if b.clocked:
            for k in ("corpus", "v2 literals (512 x 64 KiB, prefix mask)"):
                _, x, m = ins[k]
                r = result[b.name].setdefault("cycles", {})[k] = b.clocks(x, m)
                print(f"{b.name} cycles a CTA (median), {k}: zero "
                      f"{r['zero_cycles']:.0f}, count {r['count_cycles']:.0f},"
                      f" merge {r['merge_cycles']:.0f}, in all "
                      f"{r['total_cycles']:.0f} (slowest CTA "
                      f"{r['total_cycles_max']:.0f}); at most "
                      f"{r['ctas_held_an_sm']} CTAs held by an SM at once, "
                      f"{r['ctas_run_an_sm']} run by one, on {r['sms']} SMs; "
                      f"span {r['span_ms']:.4f} ms", flush=True)
    print(json.dumps({"histogram_clock": result, "device": smi,
                      "launch_floor_ms": floor, "roots": opt.root}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
