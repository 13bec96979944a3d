"""The port's host core: C++ for the serial byte work beside the device
paths (checksums, the S2 block codec and planner, the zstd host codec and
ladder, the accel sidecar builder, job assembly, the FSE and huff0 host
codecs), under the stream tier (the streaming xxHash64, the zstd job
encoder and the incremental block decoder's state) and under the deflate
family (the deflate levels, the streaming deflate continuation and the
one-shot and streaming inflate).

``src/`` holds copies of the six sources of the JAX package's native core
(``compress_tpu/_native/src``: ``checksum.cpp``, ``s2.cpp``,
``zstd_dec.cpp``, ``zstd_enc.cpp``, ``entropy_standalone.cpp``,
``flate.cpp``).  At
first use they are compiled by ``g++`` with the reference's flags (plus
``-Bsymbolic``) into one shared library under ``_build/``, named by a
digest of the sources and the flags; the build writes a temporary file and
renames it, under a file lock, so that concurrent processes build once.
The library is loaded ``RTLD_LOCAL``: its ``ct_*`` symbols, and its
``ct_g_force_predef`` flag, stay apart from any other library that
exports the same names (the JAX package's, in the tests).

There is no fallback: a failed build raises with the compiler's output.
The pure-Python versions stay beside their native entries as the plain
versions the tests and ``chip_smoke.py`` hold them against.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import pathlib
import subprocess
import tempfile
import threading

import numpy as np

_PKG = pathlib.Path(__file__).resolve().parent
SRC_DIR = _PKG / "src"
BUILD_DIR = _PKG.parent / "_build"
SOURCES = ("checksum.cpp", "s2.cpp", "zstd_dec.cpp", "zstd_enc.cpp",
           "entropy_standalone.cpp", "flate.cpp")
CXX = "g++"   # the compiler; a test points it at a path that does not exist
BASE_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-msse4.2", "-mavx2",
              "-fno-exceptions", "-Wl,-Bsymbolic")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_U64 = ctypes.c_uint64
# name: (restype, argtypes); every pointer is a void pointer (bytes, numpy
# addresses and out_buf's pointers all pass as one)
_SIGNATURES = {
    # checksum.cpp
    "ct_crc32c": (ctypes.c_uint32, [_P, _U64, ctypes.c_uint32]),
    "ct_xxh64": (_U64, [_P, _U64, _U64]),
    "ct_xxh64_new": (_P, [_U64]),
    "ct_xxh64_update": (None, [_P, _P, _U64]),
    "ct_xxh64_digest": (_U64, [_P]),
    "ct_xxh64_free": (None, [_P]),
    # s2.cpp
    "ct_s2_encode_block": (ctypes.c_int64, [_P, _P, _U64, _I]),
    "ct_s2_encode_block_level": (ctypes.c_int64, [_P, _P, _U64, _I, _I]),
    "ct_s2_decode_block": (_I, [_P, _U64, _P, _U64, _I]),
    # zstd_dec.cpp
    "ct_zstd_decode_frame": (_L, [_P, _L, _P, _L, _P, _L]),
    "ct_zstd_decode_all": (_L, [_P, _L, _P, _L, _L, _I]),
    "ct_zstd_scan_size": (_L, [_P, _L]),
    "ct_s2_build_plan": (_L, [_P, _L, _L, _I, _I, _P, _L]),
    "ct_zstd_build_sidecar": (_L, [_P, _L, _I, _I, _I, _P, _L]),
    "ct_huf0_decompress_body": (_L, [_P, _L, _I, _P, _L]),
    "ct_zstd_state_new": (_P, [_L]),
    "ct_zstd_state_append": (None, [_P, _P, _L]),
    "ct_zstd_state_free": (None, [_P]),
    "ct_zstd_decode_block": (_L, [_P, _P, _L, _P, _L]),
    # zstd_enc.cpp
    "ct_zstd_compress_level": (_L, [_P, _L, _P, _L, _I, ctypes.c_ulonglong,
                                    _I]),
    "ct_zstd_compress_frame_bs": (_L, [_P, _L, _P, _L, _I,
                                       ctypes.c_ulonglong, _I, _I, _L]),
    "ct_zstd_force_predef": (None, [_I]),
    "ct_zstd_compress_blocks_level": (_L, [_P, _L, _L, _P, _L, _I]),
    "ct_zstd_assemble_job": (_L, [_P, _L, _I, _I, *[_P] * 6, _P, _L, _P, _L,
                                  _P, _P, _P, _L, _P, _L, _P, _L, _P]),
    "ct_huf_write_table": (_L, [_P, _I, _P, _L]),
    # entropy_standalone.cpp
    "ct_fse_encode_i2": (_L, [_P, _L, _P, _I, _I, _P, _L]),
    "ct_fse_decode_i2": (_L, [_P, _L, _P, _I, _I, _P, _L]),
    "ct_fse_write_ncount": (_L, [_P, _I, _I, _P, _L]),
    "ct_fse_decompress_body": (_L, [_P, _L, _P, _L]),
    "ct_huf0_encode_stream": (_L, [_P, _L, _P, _P, _P, _L]),
    "ct_huf0_decode_stream": (_L, [_P, _L, _P, _P, _I, _P, _L]),
    "ct_huf0_package_merge": (_L, [_P, _I, _P]),
    # flate.cpp
    "ct_deflate_level": (_L, [_P, _L, _P, _L, _I]),
    "ct_deflate_blocks": (_L, [_P, _L, _L, _P, _L, _I, _I]),
    "ct_deflate": (_L, [_P, _L, _P, _L]),
    "ct_inflate_stream": (_L, [_P, _L, _P, _P, _L, _L, _P]),
    "ct_inflate": (_L, [_P, _L, _P, _L]),
}

_lock = threading.Lock()
_lib = None


def flags() -> list[str]:
    """The compiler flags: the reference's, with BMI/BMI2/LZCNT where this
    machine's CPU has BMI2 (the library is built where it runs)."""
    out = list(BASE_FLAGS)
    try:
        with open("/proc/cpuinfo") as f:
            if " bmi2" in f.read():
                out += ["-mbmi", "-mbmi2", "-mlzcnt"]
    except OSError:
        pass
    return out


def command(target: str) -> list[str]:
    """The compiler line that builds ``target``."""
    return [CXX, *flags(), "-o", target, *(str(SRC_DIR / s) for s in SOURCES)]


def _digest() -> str:
    h = hashlib.sha256(" ".join([CXX, *flags()]).encode())
    for name in SOURCES:
        h.update(name.encode())
        h.update((SRC_DIR / name).read_bytes())
    return h.hexdigest()[:16]


def build() -> pathlib.Path:
    """Compile the core if this digest is not built yet; return its path.
    Raises RuntimeError with the compiler's output when the build fails."""
    BUILD_DIR.mkdir(exist_ok=True)
    so = BUILD_DIR / f"libct_host_{_digest()}.so"
    if so.exists():
        return so
    with open(BUILD_DIR / "host.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if so.exists():      # another process built it meanwhile
            return so
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        try:
            try:
                r = subprocess.run(command(tmp), stdout=subprocess.PIPE,
                                   stderr=subprocess.STDOUT, text=True)
            except OSError as e:
                raise RuntimeError(f"host core build failed: {e}") from e
            if r.returncode != 0:
                raise RuntimeError(
                    f"host core build failed ({' '.join(command(tmp))}):\n"
                    f"{r.stdout}")
            os.replace(tmp, so)
        finally:
            if os.path.exists(tmp):
                os.unlink(tmp)
    return so


def library() -> ctypes.CDLL:
    """The loaded host core (built on first use), its entries typed."""
    global _lib
    if _lib is not None:
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()), mode=os.RTLD_LOCAL)
            for name, (res, args) in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.restype = res
                fn.argtypes = args
            _lib = lib
    return _lib


def out_buf(cap: int):
    """An output buffer of ``cap`` bytes without a zero fill: (array,
    pointer).  Take the used prefix with ``arr[:r].tobytes()``; the pointer
    keeps a reference to the array."""
    arr = np.empty(cap, np.uint8)
    return arr, arr.ctypes.data_as(ctypes.c_char_p)


_tls = threading.local()
_PAD_KEEP = 1 << 20   # the largest scratch kept for the next call


def pad_scratch(data, pos: int = 0):
    """(pointer, n): ``data[pos:]`` and 16 zero bytes after it, in a
    thread-local buffer reused across calls (the native bit readers may
    read up to 16 bytes past their input).  A buffer over 1 MiB is not
    kept."""
    n = len(data) - pos
    buf = getattr(_tls, "pad", None)
    if buf is None or buf.shape[0] < n + 16:
        buf = np.empty(max(n + 16, 1 << 16), np.uint8)
        if buf.shape[0] <= _PAD_KEEP:
            _tls.pad = buf
    buf[:n] = np.frombuffer(data, np.uint8, n, pos)
    buf[n:n + 16] = 0
    return buf.ctypes.data_as(ctypes.c_char_p), n


def ptr(a: np.ndarray):
    """The address of a contiguous numpy array, as a native argument."""
    return a.ctypes.data_as(ctypes.c_void_p)
