"""The clock tools' shared pieces: a kernel source built on its own with
extra defines, and a launch's device time.

``compile_source`` builds ``compress_tpu_torch/csrc/<source>`` of a
checkout with ``nvcc``, the library's flags and the defines given, into a
library of its own under ``compress_tpu_torch/_build/clock/``, named by a
digest of the flags and of the checkout's kernel sources, so a build
already made is loaded again and not recompiled.  Needs ``nvcc``;
``device_ms`` needs a CUDA card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import subprocess
import tempfile

import torch

from compress_tpu_torch import _cuda

REPO = pathlib.Path(__file__).resolve().parents[2]


def compile_source(source: str, defines=(), root: pathlib.Path = REPO
                   ) -> ctypes.CDLL:
    """Build (or find built) ``csrc/<source>`` of the checkout at root with
    the library's flags and ``defines``; load it, its ptxas lines (the
    registers and spills of each kernel) as ``.ptxas``."""
    csrc = pathlib.Path(root) / "compress_tpu_torch" / "csrc"
    flags = [*_cuda.NVCC_FLAGS, *defines]
    h = hashlib.sha256(" ".join(flags).encode())
    for p in sorted(csrc.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    out = _cuda.BUILD_DIR / "clock"
    out.mkdir(parents=True, exist_ok=True)
    tag = f"{source.split('.')[0]}_{h.hexdigest()[:16]}"
    so, log = out / f"lib{tag}.so", out / f"{tag}.ptxas"
    if not so.exists():
        nvcc = _cuda._nvcc()
        with tempfile.TemporaryDirectory(dir=out) as tmp:
            obj, tmp_so = os.path.join(tmp, "k.o"), os.path.join(tmp, "k.so")
            logs = []
            for cmd in ([nvcc, *flags, "-c", str(csrc / source), "-o", obj],
                        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                         "-shared", "-o", tmp_so, obj]):
                run = subprocess.run(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True)
                if run.returncode:
                    raise RuntimeError(f"nvcc failed:\n{run.stdout}")
                logs.append(run.stdout)
            log.write_text(logs[0])
            os.replace(tmp_so, so)
    lib = ctypes.CDLL(str(so))
    lib.ptxas = [ln.strip() for ln in log.read_text().splitlines()
                 if "registers" in ln or "spill" in ln]
    return lib


def device_ms(fn, reps: int = 10) -> float:
    """Median device time of fn() (each call queued behind a device spin,
    as ``chip_smoke.cuda_ms(..., spin=True)``)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(2_000_000)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return sorted(times)[len(times) // 2]
