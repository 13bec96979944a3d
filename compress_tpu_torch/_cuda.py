"""Device selection, and the build and binding of the CUDA kernels.

The kernels in ``csrc/*.cu`` have a plain C interface.  At first use each
source is compiled by its own ``nvcc`` (all started together) for
``sm_90a``, the objects are linked into one shared library under
``_build/`` (named by a digest of the sources and flags, so an edited
source rebuilds), and the library is loaded with ``ctypes``.  Nothing is
built or loaded at import time: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile

import torch

_PKG = pathlib.Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("lzkern.cu", "lzemit.cu", "zparse.cu", "zseqenc.cu", "litlut.cu",
           "exec.cu", "huff0dec.cu", "zseqdec.cu", "fseenc.cu", "fsedec.cu",
           "checksum.cu", "tileparse.cu", "zdevfse.cu", "histogram.cu",
           "tablebuild.cu")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U = ctypes.c_uint
_U64 = ctypes.c_uint64
_SIGNATURES = {
    "ct_find_matches": [_P, _P, _P, _I, _I, _P],
    "ct_emit_blocks": [_P, _P, _P, _P, _P, _P, _I, _I, _P],
    "ct_parse_blocks": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _P],
    "ct_rep_scan": [_P, _P, _P, _P, _I, _I, _P],
    "ct_fse_chain": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    "ct_litlut": [_P, _P, _P, _P, _I, _I, _P],
    "ct_exec_pieces": [_P, _P, _P, _I, _I, _I, _I, _P, _P],
    "ct_exec_sum": [_P, _P, _P, _I, _I, _I, _I, _P, _P, _P, _P],
    "ct_exec_hist": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P, _P],
    "ct_exec_occupancy": [_I],
    "ct_exec_hist_occupancy": [_I],
    "ct_exec_hist_clusters": [_I],
    "ct_rep_occupancy": [],
    "ct_fse_occupancy": [],
    "ct_parse_occupancy": [],
    "ct_emit_occupancy": [],
    "ct_huff0_decode": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _P, _P, _P],
    "ct_zseq_decode": [_P] * 11 + [_I] * 8 + [_P] * 6,
    "ct_huff0_occupancy": [_I],
    "ct_zseq_occupancy": [_I],
    "ct_fse_encode": [_P] * 4 + [_I] * 4 + [_P] * 4,
    "ct_fse_encode_occupancy": [_I],
    "ct_fse_decode": [_P] * 8 + [_I] * 4 + [_P] * 4,
    "ct_crc32c_batch": [_P, _L, _I, _I, _I, _P, _U, _P, _P],
    "ct_xxh64_batch": [_P, _I, _I, _U64, _P, _P],
    "ct_tile_parse": [_P, _L, _I, _P, _P, _P, _P],
    "ct_tile_parse_info": [_I, _P],
    "ct_zdev_fse": [_P] * 7 + [_I] * 3 + [_P] * 5,
    "ct_zdev_fse_info": [_P],
    "ct_byte_histograms": [_P, _L, _I, _I, _P, _L, _P, _P],
    "ct_histogram256": [_P, _L, _I, _P, _P],
    "ct_histogram_info": [_I, _I, _P],
    "ct_huff_build": [_P, _I, _I, _I, _P, _P, _P, _P, _P],
    "ct_normalize_count": [_P, _I, _I, _I, _I, _P, _P, _P],
    "ct_tablebuild_info": [_P],
}

_lib = None


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: CUDA unless the caller names
    another.  With no card and no device given, raise — never fall back."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "compress_tpu_torch: no CUDA device; pass device='cpu' to "
                "run the plain PyTorch versions")
        return torch.device("cuda")
    return torch.device(device)


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = shutil.which("nvcc") or os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError(f"nvcc not found (looked on PATH and in {home})")
    return path


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for name in sorted(p.name for p in CSRC.iterdir()):
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile and link the kernels if this source digest is not built yet;
    return the library's path.  The compiler's report (registers, shared
    memory, spills per kernel) is kept in ``_build/ptxas.log``."""
    BUILD_DIR.mkdir(exist_ok=True)
    so = BUILD_DIR / f"libct_kernels_{_digest()}.so"
    if so.exists():
        return so
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, src.replace(".cu", ".o")) for src in SOURCES]
        procs = [subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-c", str(CSRC / src), "-o", obj],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
            for src, obj in zip(SOURCES, objs)]
        logs = [p.communicate()[0] for p in procs]
        (BUILD_DIR / "ptxas.log").write_text("".join(logs))
        for src, p, log in zip(SOURCES, procs, logs):
            if p.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src}:\n{log}")
        tmp_so = os.path.join(tmp, so.name)
        link = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
             "-o", tmp_so, *objs],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        if link.returncode != 0:
            raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
        os.replace(tmp_so, so)
    return so


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.ct_error_string.argtypes = [ctypes.c_int]
        lib.ct_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a kernel's C entry point reported a CUDA error."""
    if rc != 0:
        msg = library().ct_error_string(rc).decode()
        raise RuntimeError(f"{what}: CUDA error {rc} ({msg})")


def stream(device: torch.device) -> int:
    """The handle of PyTorch's current stream on ``device``, read without
    building a ``torch.cuda.Stream`` object, which is much of a small
    kernel wrapper's host work."""
    index = device.index
    if index is None:
        index = torch.cuda.current_device()
    return torch._C._cuda_getCurrentRawStream(index)


def require_cuda_input(t: torch.Tensor, name: str, dtype, shape) -> None:
    """Validate a kernel argument (device, dtype, shape, contiguity)."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, "
                         f"got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def aligned(t: torch.Tensor, align: int = 16) -> torch.Tensor:
    """``t``, or a fresh (aligned) copy of it where its data does not start
    on an ``align``-byte boundary: the kernels load 16 bytes at a time."""
    return t if t.data_ptr() % align == 0 else t.clone()

